#!/usr/bin/env python3
"""Seconds and launches of the Lotka-Volterra noise study's training evaluations on a CUDA card.

    python3 tools/torch_study_probe.py [--lanes 25 500] [--out study_probe.json]

For each lane count, on the study's own lanes (``examples/run_loops.py``,
inputs from the JAX draw, float32), times one training evaluation (the mean
squared residual of every lane's 120-step fixed Tsit5 solve and its gradient,
as ADAM and BFGS use it: on the card one launch of the lane kernel,
``ops/lv_lanes.py``) and one LM Jacobian (``lane_jacobian``, 87
tangents), each run eagerly and replayed as a captured CUDA graph: CUDA-event
medians, the operators one evaluation dispatches, the graph's capture
seconds, and the largest difference between the graph's outputs and the
eager ones.  Then times the study's stages as the pipeline runs them: 10
ADAM steps, one BFGS round of 10 iterations and one LM round of 3
iterations.  Prints one JSON object and writes it to ``--out``.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[25, 500])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.utils import card_name

    device = torch.device("cuda", 0)
    st = rl.build_stages(device=device)
    out = dict(device=card_name(device), torch=torch.__version__, rows=[])

    def timed(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    for lanes in args.lanes:
        idx = (np.arange(lanes) * 500) // lanes  # spread over the five levels
        data, theta, _ = st.lane_inputs(idx, 100)
        row = dict(lanes=lanes)
        for name, fn in (("loss_and_grad", st.loss_and_grad), ("lane_jac", st.lane_jac)):
            count = rl.OpCounter()
            with count:
                ref = fn(theta, data)
            eager_s = timed(lambda: fn(theta, data), 3)
            t0 = time.perf_counter()
            graphed = rl._Graphed(fn, theta, data)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            got = graphed(theta, data)
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            graph_s = timed(lambda: graphed(theta, data), 10)
            row[name] = dict(ops=count.ops, graph_ops=graphed.ops, eager_s=eager_s,
                             graph_s=graph_s, capture_s=capture_s, max_abs_diff=err)
            del graphed
        for name, fn, units in (
                ("adam_10_steps", lambda: st.adam_stage(theta, data, steps=10), 10),
                ("bfgs_10_iterations", lambda: st.bfgs_round(theta, data, maxiters=10), 10),
                ("lm_3_iterations", lambda: st.lm_round(theta, data, maxiters=3), 3)):
            row[name] = timed(fn, 1)
            row[name + "_per_unit"] = row[name] / units
        row["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
