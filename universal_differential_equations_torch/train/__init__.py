from .bfgs import BFGSResult, bfgs_minimize, bfgs_minimize_lanes
from .fit import FitResult, fit, fit_bfgs, reduce_on_plateau
from .lm import LMResult, lane_jacobian, levenberg_marquardt, levenberg_marquardt_lanes
from .shooting import multiple_shoot, shooting_windows

__all__ = ["BFGSResult", "bfgs_minimize", "bfgs_minimize_lanes", "FitResult", "fit",
           "fit_bfgs", "reduce_on_plateau", "LMResult", "lane_jacobian", "levenberg_marquardt",
           "levenberg_marquardt_lanes", "multiple_shoot", "shooting_windows"]
