"""The whole training iteration's share of the card's float32 peak: the
products' operations that an iteration needs, from the shapes
(``roofline``), times the iterations of the traced run's untraced slice,
over that slice's host-clock seconds, in percent of 67 TFLOP/s.  The
untraced slice, not the traced one: the profiler stretches a replay of many
small kernels."""
from perfbench import roofline


def read(run):
    flop = run.work.get("flop_per_iter")
    if not flop or not run.plain_iters or not run.plain_s > 0:
        return None
    return 100.0 * flop * run.plain_iters / run.plain_s / roofline.PEAK_F32_FLOPS
