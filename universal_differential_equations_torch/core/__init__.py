from .controller import PIController
from .problem import DAEProblem, ODEProblem, SDEProblem, remake
from .solution import DenseInterpolation, Solution
