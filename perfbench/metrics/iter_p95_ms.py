"""95th percentile of all the window's iteration times, in milliseconds."""
import statistics


def read(run):
    xs = run.iter_times
    if not xs or len(xs) < 20:
        return None
    return 1e3 * statistics.quantiles(xs, n=100, method="inclusive")[94]
