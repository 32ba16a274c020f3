"""Profile deep-BSDE iterations of the 100-D HJB on the card.

    python3 tools/torch_bsde_probe.py

Builds the HJB of ``examples/hjb_100d.py`` at full width (d = 100, m = 100,
float32, ``torch.Generator(0)``'s weights) and, for 20 and 50 time steps,
runs 3 warm-up iterations and profiles 10 (``utils.profiling.trace``, the
Chrome trace in ``build/trace/``), then times 10 more unprofiled.  Prints
one JSON object: per iteration the wall (profiled and not), the device
kernels' time and count, the host's profiler events, the busy share (kernel
time over the profiled wall) and the six kernels with the most device
time.  Needs a CUDA card.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from universal_differential_equations_torch import deepbsde  # noqa: E402
from universal_differential_equations_torch.examples import hjb_100d  # noqa: E402
from universal_differential_equations_torch.utils import card_name, profiling  # noqa: E402


def main():
    dev = torch.device("cuda", 0)
    prob, alg = hjb_100d.hjb_problem(dev)
    g = torch.Generator().manual_seed(0)
    params = {"u0": alg.u0_net.init(g, device=dev), "grad": alg.grad_net.init(g, device=dev)}
    out = {"device": card_name(dev)}
    for n in (20, 50):
        step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, n)
        z = torch.randn((100, n, 100), device=dev)
        for _ in range(3):
            float(step(z))
        k = 10
        with profiling.trace() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(k):
                float(step(z))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = prof.key_averages()
        # the kernels themselves: an operator's device time, and a user
        # annotation's span (the optimizer step's), repeat its kernels'
        gpu = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        dev_us = sum(e.self_device_time_total for e in gpu)
        kernels = sum(e.count for e in gpu)
        cpu_ops = sum(e.count for e in evs if e.device_type == torch.autograd.DeviceType.CPU)
        top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:6]
        out[n] = dict(wall_s_per_iter_profiled=wall / k, device_us_per_iter=dev_us / k,
                      kernels_per_iter=kernels / k, cpu_events_per_iter=cpu_ops / k,
                      busy_share=dev_us / 1e6 / wall,
                      top=[(e.key[:70], round(e.self_device_time_total / k, 1), e.count / k)
                           for e in top])
        t0 = time.perf_counter()
        for _ in range(k):
            float(step(z))
        out[n]["wall_s_per_iter_unprofiled"] = (time.perf_counter() - t0) / k
    print(json.dumps(out))


if __name__ == "__main__":
    main()
