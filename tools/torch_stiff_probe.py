#!/usr/bin/env python3
"""Host costs of slice F's implicit solvers and BDF DAE solver on one CUDA card.

    python3 tools/torch_stiff_probe.py [--out stiff_probe.json]

Measures, in one process on ``cuda:0``:

* the Robertson solves of ``chip_smoke.py`` phase 14 (a) with each implicit
  solver, cold (first call in the process) and warm, and the host syncs
  per solve that ``torch.cuda.set_sync_debug_mode`` reports;
* one linear solve on an LU factorization at n = 3 and 6 by
  ``torch.linalg.lu_solve`` and by two ``torch.linalg.solve_triangular``
  calls after a row permutation (the same arithmetic as LAPACK's
  ``getrs``), wall µs per call over 2000 calls, and their syncs;
* the warm Robertson solves and the FENE-P BDF truth of phase 14 (b) with
  either solve wired into ``solvers/sdirk.py:_factor``, alternated
  (lu_solve, triangular, triangular, lu_solve) in this one call.

Prints one JSON object as its last line (and writes it to ``--out``).
"""
import argparse
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _syncs(fn):
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in ws)


def _triangular_factor(W):
    """``_factor`` by a row permutation and two triangular solves."""
    import torch

    lu, piv, _ = torch.linalg.lu_factor_ex(W)
    P, L, U = torch.lu_unpack(lu, piv)
    perm = P.argmax(0)

    def solve(b):
        x = torch.linalg.solve_triangular(L, b[..., perm].unsqueeze(-1), upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(U, x, upper=True).squeeze(-1)

    return solve


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe measures the card")
    import chip_smoke as cs
    from universal_differential_equations_torch.solvers import sdirk

    dev = torch.device("cuda", 0)
    out = dict(device=cs.phase_device())
    rober = {}
    for name in cs.STIFF:
        n, _, cold = cs._robertson(name, dev)
        _, _, warm = cs._robertson(name, dev)
        rober[name] = dict(attempts=n[1] + n[2], cold_s=cold, warm_s=warm,
                           syncs=_syncs(lambda: cs._robertson(name, dev)))
        print(name, rober[name], flush=True)
    out["robertson"] = rober
    out["fenep_truth_syncs"] = _syncs(lambda: cs._fenep_truth(dev))

    solves = {}
    for n in (3, 6):
        A = torch.rand(n, n, dtype=torch.float64, device=dev) + 3 * torch.eye(
            n, dtype=torch.float64, device=dev)
        b = torch.rand(n, dtype=torch.float64, device=dev)
        for label, make in (("lu_solve", sdirk._factor), ("triangular", _triangular_factor)):
            solve = make(A)
            for _ in range(50):
                solve(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                solve(b)
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / 2000 * 1e6
            syncs = _syncs(lambda: [solve(b) for _ in range(10)]) / 10
            err = float((A @ solve(b) - b).abs().max())
            solves[f"{label}_n{n}"] = dict(us_per_call=us, syncs_per_call=syncs, residual=err)
            print(label, n, solves[f"{label}_n{n}"], flush=True)
    out["solve"] = solves

    from universal_differential_equations_torch.solvers import bdf, rosenbrock

    factor = sdirk._factor
    users = (sdirk, rosenbrock, bdf)  # the modules that call _factor
    runs = []
    for label, make in (("lu_solve", factor), ("triangular", _triangular_factor),
                        ("triangular", _triangular_factor), ("lu_solve", factor)):
        for mod in users:
            mod._factor = make
        try:
            row = dict(variant=label)
            for name in cs.STIFF:
                n, y, wall = cs._robertson(name, dev)
                row[name] = dict(counts=n, seconds=wall, y_final=y.tolist())
            t0 = time.perf_counter()
            _, ok, counts, _, _, _ = cs._fenep_truth(dev)
            torch.cuda.synchronize()
            row["fenep_truth"] = dict(counts=counts, seconds=time.perf_counter() - t0)
        finally:
            for mod in users:
                mod._factor = factor
        runs.append(row)
        print(label, {k: v["seconds"] for k, v in row.items() if isinstance(v, dict)},
              flush=True)
    out["alternation"] = runs
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
