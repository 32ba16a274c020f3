"""Share of the roofline that the deep-BSDE rollout's dense products reach:
their operations and bytes from the configuration's shapes and the batch
(forward and backward, ``roofline.bsde_gemm_per_iter``), against the
summed device time of the GEMM kernels in the trace, in percent of the
float32 bound (or the bytes bound, whichever is larger)."""
from perfbench import roofline


def read(run):
    tr = run.trace
    secs = sum(e - s for name, s, e, _ in (tr.kernels if tr else [])
               if "gemm" in name.lower()) / 1e9
    flop = run.work.get("gemm_flop_per_iter")
    if not secs or not flop:
        return None
    share, _ = roofline.roofline_share(flop * tr.iterations,
                                       run.work["gemm_bytes_per_iter"] * tr.iterations, secs)
    return share
