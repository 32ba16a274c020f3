#!/usr/bin/env python3
"""Host cost of the port's collectives on a one-rank NCCL group, and the
deep-BSDE iteration and the RT step with and without a mesh, in turns.

    python3 tools/torch_collectives_probe.py [--pairs 10] [--out build/collectives.json]

Needs a CUDA card (it does not fall back to the CPU).  Starts a one-rank NCCL
group, then times on the host clock, after 5 warm-up calls, 100 calls of
each collective of ``parallel/collectives.py`` at the shapes the mesh paths
give them (``psum`` of a (5, 2) tensor, ``halo_x`` of the RT step's 4 fields
at (64, 2, 128), ``transpose`` of a (3, 128, 2, 256) complex64 spectrum),
the card synchronised before and after.  Then ``--pairs`` alternated pairs
(plain, mesh; mesh, plain; ...) of: one deep-BSDE iteration at the 100-D
HJB's width (``make_train_step``, 20 and 50 steps; median of 5 calls each)
and one RT chunk at 128×2×128 (``rt_step_seconds``, both ``bc``s, CUDA
events); prints each pair and the medians, and writes them as JSON with
the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def host_us(fn, calls=100, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe measures the card")
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.examples import hjb_100d
    from universal_differential_equations_torch.models import climate_datagen as dg
    from universal_differential_equations_torch.parallel import collectives as C
    from universal_differential_equations_torch.parallel import ensemble_mesh
    from universal_differential_equations_torch.utils import profiling

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    mesh = ensemble_mesh(device=device)
    xmesh = ensemble_mesh(axis="x", device=device)
    out = dict(card=card, torch=torch.__version__)
    try:
        small = torch.zeros(5, 2, device=device)
        fields = [torch.zeros(64, 2, 128, device=device) for _ in range(4)]
        spec = torch.zeros(3, 128, 2, 256, dtype=torch.complex64, device=device)
        out["collective_host_us"] = dict(
            psum=host_us(lambda: C.psum(small, mesh)),
            halo_x_4_fields=host_us(lambda: C.halo_x(fields, mesh)),
            transpose=host_us(lambda: C.transpose(spec, mesh, 3, 1)))
        print(f"collectives on {card}, host µs per call: {out['collective_host_us']}", flush=True)

        prob, alg = hjb_100d.hjb_problem(device)
        g = torch.Generator().manual_seed(0)
        params = {"u0": alg.u0_net.init(g, device=device),
                  "grad": alg.grad_net.init(g, device=device)}
        rows = {}
        for n in (20, 50):
            z = torch.randn((100, n, 100), generator=torch.Generator().manual_seed(n)).to(device)
            steps = {m is not None: deepbsde.make_train_step(prob, alg, prob.x0, params, n,
                                                             mesh=m)[0]
                     for m in (None, mesh)}
            rows[f"bsde_ms_n{n}"] = {False: [], True: []}
            for k in range(args.pairs):
                for sharded in ((False, True) if k % 2 == 0 else (True, False)):
                    st = profiling.benchmark(steps[sharded], z, repeats=5, warmup=1)
                    rows[f"bsde_ms_n{n}"][sharded].append(st["median_s"] * 1e3)
        for bc in ("periodic", "rigid_lid"):
            rows[f"rt_ms_per_step_{bc}"] = {False: [], True: []}
            for k in range(args.pairs):
                for sharded in ((False, True) if k % 2 == 0 else (True, False)):
                    ms = dg.rt_step_seconds((128, 2, 128), repeats=3, bc=bc,
                                            mesh=xmesh if sharded else None, device=device) * 1e3
                    rows[f"rt_ms_per_step_{bc}"][sharded].append(ms)
        for name, r in rows.items():
            plain, sharded = statistics.median(r[False]), statistics.median(r[True])
            wins = sum(b > a for a, b in zip(r[False], r[True]))
            out[name] = dict(plain=r[False], mesh=r[True], plain_median=plain,
                             mesh_median=sharded, mesh_slower_in_pairs=wins)
            print(f"{name}: median {plain:.3f} without the mesh, {sharded:.3f} with it "
                  f"({sharded - plain:+.3f}); the mesh slower in {wins} of {len(r[False])} "
                  f"pairs on {card}", flush=True)
    finally:
        dist.destroy_process_group()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if not k.startswith(("bsde", "rt"))}))


if __name__ == "__main__":
    main()
