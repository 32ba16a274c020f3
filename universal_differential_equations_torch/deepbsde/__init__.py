from .solver import (BSDEResult, NNPDENS, TerminalPDEProblem, make_train_step, mc_analytical_hjb,
                     solve_terminal_pde)
