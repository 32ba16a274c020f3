"""CUDA kernels per optimizer iteration in the traced slice, those replayed
from CUDA graphs included."""


def read(run):
    tr = run.trace
    if not tr or not tr.kernels or not tr.iterations:
        return None
    return len(tr.kernels) / tr.iterations
