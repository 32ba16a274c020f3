"""Optimizer iterations completed in the window over the window's seconds
(each iteration updates every lane, or the whole batch)."""


def read(run):
    if run.iterations and run.window_s > 0:
        return run.iterations / run.window_s
    return None
