"""Loss-and-gradient evaluations per BFGS iteration: the CUDA-graph replays
in the traced slice (the first evaluation, line-search trials) over the
iterations every lane ran."""


def read(run):
    tr = run.trace
    launches = tr.graph_launches() if tr else set()
    if not launches or not tr.iterations:
        return None
    return len(launches) / tr.iterations
