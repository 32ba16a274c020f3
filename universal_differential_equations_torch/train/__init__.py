from .bfgs import BFGSResult, bfgs_minimize, bfgs_minimize_lanes
from .fit import FitResult, fit, fit_bfgs, reduce_on_plateau
from .lm import LMResult, levenberg_marquardt
from .shooting import multiple_shoot, shooting_windows

__all__ = ["BFGSResult", "bfgs_minimize", "bfgs_minimize_lanes", "FitResult", "fit",
           "fit_bfgs", "reduce_on_plateau", "LMResult", "levenberg_marquardt",
           "multiple_shoot", "shooting_windows"]
