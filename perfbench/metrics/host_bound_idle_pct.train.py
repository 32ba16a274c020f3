"""Percent of the traced window in which no device activity ran while the
host was inside one of the program's own spans (``utils.profiling.span``)
that does not wait for the device: the device idling on the port's host
code.

Over each idle gap of the window, the time in which the host's innermost
open program span is not a ``waits`` span and the host is not inside a CUDA
graph launch (``cudaGraphLaunch``), by exact interval overlap; ÷ the window.
Idle while the host is blocked in a read (a ``waits`` span), or outside
every program span (the benchmark's own code), is left out.  So is idle
inside a graph launch: traced, the profiler submits a graph's kernels one
at a time inside that call (a 68k-kernel replay of the lane loss holds the
host there for tens of ms, against ~1 ms untraced), and its spacing of
them falls there.  Spans are clipped to the window.  ``None`` where the
trace has no device activity, or the program recorded no span in the
window (a program without ``profiling.recorded``)."""


def read(run):
    tr = run.trace
    if not tr or not tr.device_ops or tr.window_s <= 0:
        return None
    spans = program_spans(tr.window)
    if not spans:
        return None
    lo, hi = tr.window
    launching = merged(sorted((s, e) for n, s, e, _ in tr.runtime
                              if n.startswith("cudaGraphLaunch")))
    idle = without(tr.idle_gaps(), launching)
    return 100.0 * overlap(idle, merged(host_bound(spans))) / (hi - lo)


def program_spans(window):
    """``(start, end, waits, key)`` of each closed program span that meets
    ``window``, clipped to it; ``key`` orders spans by their own start (a
    child after its parent)."""
    from universal_differential_equations_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    lo, hi = window
    return [(max(s, lo), min(e, hi), w, (s, i))
            for i, (_, s, e, _, w) in enumerate(recorded()["spans"])
            if e is not None and e > lo and s < hi]


def host_bound(spans):
    """The stretches in which the innermost open span (the latest started)
    does not wait, in time order."""
    edges = sorted({t for s, e, _, _ in spans for t in (s, e)})
    by_start = sorted(spans)
    out, active, j = [], [], 0
    for t0, t1 in zip(edges[:-1], edges[1:]):
        while j < len(by_start) and by_start[j][0] <= t0:
            active.append(by_start[j])
            j += 1
        active = [sp for sp in active if sp[1] > t0]
        if active and not max(active, key=lambda sp: sp[3])[2]:
            out.append((t0, t1))
    return out


def merged(iv):
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def without(a, b):
    """The time-ordered disjoint intervals ``a`` less the union of ``b`` (likewise)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def overlap(a, b):
    """Total overlap of two time-ordered lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
