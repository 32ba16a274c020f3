#!/usr/bin/env python3
"""Lanes, shooting and scenario-2 LM on one CUDA card: seconds and launches.

    python3 tools/torch_lanes_probe.py [--pkg-root DIR] [--out FILE] [--lanes 1,5,64]

Imports ``universal_differential_equations_torch`` from ``--pkg-root``
(default: this checkout), so the same probe can time an older checkout of
the package.  Measures, in this order, and prints one JSON object (also
written to ``--out``):

* ``solo``: one adaptive solve of the Lotka-Volterra scenario-1 UDE (the
  2→5→5→5→2 RBF net, float32, rtol = atol = 1e-6, ``NoAdjoint``): seconds
  (median of 5), CUDA kernels (``torch.profiler``), PyTorch ops dispatched,
  and both per step attempt; and the same for one ``jacfwd`` of its
  ``ForwardSensitivity`` solve in float64 (the LM path's per-attempt cost);
* ``lanes``: the same solve under ``torch.func.vmap`` over L initial states
  against a Python loop of L solo solves, for each L of ``--lanes``;
* ``shooting``: the Hudson Bay shooting loss's gradient
  (``examples/hudson_bay.py``, 5 segments in one vmapped solve) in float32
  and float64, against a Python loop over the 5 segment solves (its data
  terms only, uncheckpointed like the vmapped loop);
* ``lm``: seconds per Levenberg-Marquardt iteration of scenario 2
  (``examples/lv_scenario_2.py``'s residuals, float32, 3 iterations).

A part the package at ``--pkg-root`` cannot run is recorded with its error.
The card's name and power limit come from ``nvidia-smi``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--lanes", default="1,5,64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu only rehearses the script (no kernel counts)")
    args = ap.parse_args()
    sys.path.insert(0, args.pkg_root)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import lotka_volterra as lv

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_lanes_probe.py needs a CUDA card")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu (a rehearsal: no device numbers)"
    out = {"card": card, "pkg_root": args.pkg_root, "torch": torch.__version__}

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.n += 1
            return func(*a, **(kw or {}))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def seconds(fn, reps=5):
        fn()
        walls = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    def kernels(fn):
        if dev.type != "cuda":
            return None
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    def ops(fn):
        with Ops() as counter:
            fn()
        return counter.n

    def measure(fn, attempts=None, reps=5):
        res = {"s": seconds(fn, reps), "kernels": kernels(fn), "ops": ops(fn)}
        if attempts:
            res.update(attempts=attempts, ops_per_attempt=res["ops"] / attempts,
                       kernels_per_attempt=res["kernels"] and res["kernels"] / attempts)
        return res

    def guarded(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # an older package lacks the part
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps({name: out[name]}), flush=True)

    # the scenario-1 UDE at its initial parameters, float32
    gen = torch.Generator().manual_seed(1234)
    ts64, _, Xn64 = lv.generate_data(gen, device=dev)
    ts, Xn = ts64.float(), Xn64.float()
    rhs, params, _ = lv.make_ude(torch.Generator().manual_seed(0), device=dev)

    def solve(u0, adjoint=None, p=params):
        return ude.solve(ude.ODEProblem(rhs, u0, (0.0, 3.0), p), ude.Tsit5(), saveat=ts,
                         rtol=1e-6, atol=1e-6, adjoint=adjoint or ude.NoAdjoint())

    def solo():
        sol = solve(Xn[0])
        attempts = int(sol.num_accepted) + int(sol.num_rejected)
        res = {"forward": measure(lambda: solve(Xn[0]), attempts)}
        # in float64 (under jacfwd a 0-d float32 value times a Python scalar
        # gets a float64 tangent, which the net's matmul refuses)
        flat, unravel = ravel_pytree(params)
        sol64 = solve(Xn64[0], p=unravel(flat.double()))
        jac = torch.func.jacfwd(
            lambda x: solve(Xn64[0], ude.ForwardSensitivity(), unravel(x)).ys)
        res["jacfwd"] = measure(lambda: jac(flat.double()),
                                int(sol64.num_accepted) + int(sol64.num_rejected), reps=3)
        return res

    guarded("solo", solo)

    def lanes():
        res = {}
        rng = np.random.default_rng(0)
        for L in (int(x) for x in args.lanes.split(",")):
            u0s = (Xn[0] * torch.tensor(rng.uniform(0.7, 1.3, (L, 2)), dtype=torch.float32,
                                        device=dev))
            vm = lambda: torch.func.vmap(lambda u: solve(u).ys)(u0s)  # noqa: E731
            loop = lambda: [solve(u).ys for u in u0s]  # noqa: E731
            n_acc = torch.func.vmap(lambda u: solve(u).num_accepted)(u0s)
            res[L] = {"vmap": measure(vm, reps=3), "loop": measure(loop, reps=1),
                      "accepted_max": int(n_acc.max()), "accepted_sum": int(n_acc.sum())}
        return res

    guarded("lanes", lanes)

    def shooting():
        from universal_differential_equations_torch.examples import hudson_bay as hb

        res = {}
        net = hb.make_net()
        rhs_hb = hb.make_rhs(net)
        for dt in (torch.float32, torch.float64):
            t_hb, Xn_hb, _ = hb.load_data(dt, dev)
            flat, unravel = ravel_pytree(hb.init_params(net, hb.SEEDS[0], dt, dev))
            loss = hb.shooting_loss(rhs_hb, t_hb, Xn_hb)
            idx, _ = ude.shooting_windows(Xn_hb.shape[0], hb.GROUP, device=dev)

            def grad(fn):
                x = flat.clone().requires_grad_(True)
                return torch.autograd.grad(fn(unravel(x)), x)[0]

            def looped(p):
                # the segments' solves one after another, uncheckpointed as
                # the vmapped loop runs
                total = hb.reg(p)
                for k in range(idx.shape[0]):
                    tw = t_hb[idx[k]]
                    sol = ude.solve(ude.ODEProblem(rhs_hb, Xn_hb[idx[k, 0]], (tw[0], tw[-1]),
                                                   p), ude.Tsit5(), saveat=tw, rtol=1e-6,
                                    atol=1e-6, adjoint=ude.DiscreteAdjoint(checkpoint=False),
                                    max_steps=256)
                    total = total + torch.sum((sol.ys - Xn_hb[idx[k]]) ** 2)
                return total

            res[str(dt).split(".")[-1]] = {"vmap": measure(lambda: grad(loss), reps=3),
                                            "loop": measure(lambda: grad(looped), reps=3)}
        return res

    guarded("shooting", shooting)

    def lm():
        from universal_differential_equations_torch.examples import lv_scenario_2 as s2

        gen2 = torch.Generator().manual_seed(s2.SEED)
        ts2, _, Xn2 = s2.make_data(gen2, device=dev)
        rhs2, p2, _ = s2.make_model(gen2, device=dev)
        res2 = s2.make_residuals(rhs2, *s2.segments(ts2, Xn2))
        walls, last = [], [time.perf_counter()]

        def on_iter(k, loss):
            sync()
            now = time.perf_counter()
            walls.append(now - last[0])
            last[0] = now

        sync()
        last[0] = time.perf_counter()
        r = ude.levenberg_marquardt(res2, p2, maxiters=3, callback=on_iter)
        return {"s_per_iteration": walls, "loss": float(r.loss),
                "kernels_one_jacobian": kernels(
                    lambda: torch.func.jacfwd(lambda x: res2(ravel_pytree(p2)[1](x)))(
                        ravel_pytree(p2)[0]))}

    guarded("lm", lm)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
