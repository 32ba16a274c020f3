from .runner import EnsembleResult, ensemble_run, noise_schedule

__all__ = ["EnsembleResult", "ensemble_run", "noise_schedule"]
