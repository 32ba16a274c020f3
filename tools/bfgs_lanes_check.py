#!/usr/bin/env python3
"""Hold the port's lane-batched BFGS to ``jax.vmap(bfgs_minimize)`` on one problem.

    python3 tools/bfgs_lanes_check.py [--lanes 4] [--maxiters 250] [--out FILE]

The problem is the Lotka-Volterra noise study's training loss (the mean
squared residual of the fixed-step Tsit5 lane solve, float32, x64 off) on the
study's first lanes of each noise level, from their initial weights in
``universal_differential_equations_torch/examples/data/lv_study_lanes.npz``,
with the study's BFGS settings (``initial_stepnorm=0.01, gtol=1e-12``).  Both
packages run on the CPU.  Prints, per lane, each package's iterations,
evaluations, stop reason (gtol, a failed line search, or the iteration
budget) and final loss, and writes them as JSON to ``--out``.

A tool of both packages: it imports JAX and the PyTorch port.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reason(iters, conv, maxiters):
    return "gtol" if conv else ("maxiters" if iters >= maxiters else "line search")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--maxiters", type=int, default=250)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from jax.flatten_util import ravel_pytree
    from universal_differential_equations_tpu import Tsit5
    from universal_differential_equations_tpu.core.integrate import integrate_fixed
    from universal_differential_equations_tpu.models import lotka_volterra as lv
    from universal_differential_equations_tpu.train import bfgs_minimize
    from universal_differential_equations_torch.examples import run_loops as rl

    z = np.load(ROOT / "universal_differential_equations_torch/examples/data/lv_study_lanes.npz")
    lanes = (np.arange(args.lanes) % 5) * 100 + np.arange(args.lanes) // 5
    data, theta0 = z["data"][lanes], z["theta0"][0][lanes]

    rhs, params0, _ = lv.make_ude(jax.random.PRNGKey(7))
    _, unravel = ravel_pytree(params0)
    t_end, n_step = float(z["ts"][-1]), (len(z["ts"]) - 1) * rl.SUB

    def mean_loss(theta, d):
        _, ys = integrate_fixed(rhs, d[0], 0.0, t_end, unravel(theta), Tsit5(), n_step)
        return jnp.mean((ys[::rl.SUB] - d) ** 2)

    @jax.jit
    @jax.vmap
    def jax_round(theta, d):
        r = bfgs_minimize(lambda t_: mean_loss(t_, d), theta, maxiters=args.maxiters,
                          initial_stepnorm=0.01, gtol=1e-12)
        return r.iterations, r.num_evals, r.converged, r.value

    j_it, j_ev, j_conv, j_val = (np.asarray(a) for a in jax_round(theta0, data))
    st = rl.build_stages(device="cpu")
    from universal_differential_equations_torch.train import bfgs_minimize_lanes

    d_t = torch.as_tensor(data)
    r = bfgs_minimize_lanes(lambda th: st.mean_loss(th, d_t), torch.as_tensor(theta0),
                            maxiters=args.maxiters, initial_stepnorm=0.01, gtol=1e-12)
    rows = []
    for k, lane in enumerate(lanes):
        row = dict(lane=int(lane),
                   jax=dict(iterations=int(j_it[k]), num_evals=int(j_ev[k]),
                            stop=reason(int(j_it[k]), bool(j_conv[k]), args.maxiters),
                            loss=float(j_val[k])),
                   port=dict(iterations=int(r.iterations[k]), num_evals=int(r.num_evals[k]),
                             stop=reason(int(r.iterations[k]), bool(r.converged[k]),
                                         args.maxiters),
                             loss=float(r.value[k])))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
