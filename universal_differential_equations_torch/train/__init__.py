from .lm import LMResult, levenberg_marquardt

__all__ = ["LMResult", "levenberg_marquardt"]
