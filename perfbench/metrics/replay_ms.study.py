"""Device milliseconds per CUDA-graph replay of the study's lane loss and
gradient: for each ``cudaGraphLaunch`` in the trace, the union of the
intervals of the kernels it launched (the profiler spaces a replay's
kernels apart, so its first-to-last span would count the profiler's own
gaps); the mean over the replays."""


def read(run):
    tr = run.trace
    launches = tr.graph_launches() if tr else set()
    per = {}
    for _, s, e, corr in (tr.kernels if tr else []):
        if corr in launches:
            per.setdefault(corr, []).append((s, e))
    if not per:
        return None
    total = 0
    for iv in per.values():
        iv.sort()
        end = iv[0][0]
        for s, e in iv:
            total += max(0, e - max(s, end))
            end = max(end, e)
    return total / len(per) / 1e6
