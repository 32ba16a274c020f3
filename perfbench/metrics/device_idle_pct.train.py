"""Percent of the traced window in which no device activity ran."""


def read(run):
    tr = run.trace
    if not tr or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
