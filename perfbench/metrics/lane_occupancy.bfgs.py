"""Percent of each BFGS evaluation's lanes that were still in their line
search: the program's counters (``train/bfgs.py``) over the calls of
``bfgs_minimize_lanes`` that ran wholly in the traced window, 100 ×
``bfgs.lane_trials`` ÷ (``bfgs.evaluations`` × ``bfgs.lanes``).  Each
evaluation replays the lane loss for every lane; the rest serve lanes that
have finished their iterations.  ``None`` where no such call was recorded
(a program without ``profiling.recorded``)."""


def read(run):
    tr = run.trace
    counts = program_counts(tr.window) if tr else None
    trials = slots = 0
    lanes = evals = None
    for name, _, n in counts or []:
        if name == "bfgs.lanes":
            lanes, evals = n, 0
        elif name == "bfgs.evaluations" and evals is not None:
            evals += n
        elif name == "bfgs.lane_trials" and evals is not None:
            trials += n
            slots += evals * lanes
            lanes = evals = None
    return 100.0 * trials / slots if slots else None


def program_counts(window):
    """The program's counts ``(name, time_ns, n)`` inside ``window``, in time
    order."""
    from universal_differential_equations_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    lo, hi = window
    return sorted((c for c in recorded()["counts"] if lo <= c[1] <= hi), key=lambda c: c[1])
