"""Readings that the limits of ``perfbench/checks/<cell>.json`` are set from.

    python3 -m perfbench.tools.calibrate --workload <cell> --seeds 12 [--faults 4] \\
        [--out readings.json]

On the card, at the cell's own size, in one process: for each seed the
program's first steps against the reference (the sound readings), and on
the first ``--faults`` seeds the control and the planted faults, each put in
the program's place and held to the reference the same way:

* ``control``: the reference with its products in TF32;
* ``half_batch``: the reference on half of the batch, the mean taken over
  the rest (half of each lane's samples; half of the paths);
* ``b2_wrong`` (ADAM): the reference with β2 = 0.9, β1's value;
* ``h_skipped`` (BFGS): the reference with its inverse Hessian not carried
  from one iteration to the next;
* ``unchanged``: a step that returns its state unchanged (no change);
* ``altered``: the answer altered where it is produced (the change of the
  leaf that moves most, doubled, at every step).

Seeds after the first reuse the program's built state: a lane cell copies
the new seed's lanes into the same ``data`` tensor, so the captured graph
is replayed, not captured again.
"""
import argparse
import json
import time

import torch

from perfbench import run
from perfbench.trace import Tracer


def faults(drv, ref):
    """``{fault: (record, reference record)}``: each fault's record made in
    the program's place (the reference there, or the program's own record
    broken), with the reference's record of it."""
    prog = drv.first
    made = {"control": drv.stand_in(tf32=True), "half_batch": drv.stand_in(half=True)}
    made.update({k: drv.stand_in(**kw) for k, kw in drv.fault_kinds().items()})
    out = {k: (rec, drv.reference(rec)) for k, rec in made.items()}
    zero = [{k: torch.zeros_like(v) for k, v in ch.items()} for ch in prog["change"]]
    still = dict(prog, change=zero, points=[prog["points"][0]] * len(prog["points"]))
    out["unchanged"] = (still, drv.reference(still))
    last = prog["change"][-1]
    big = max(last, key=lambda k: float(last[k].norm()))
    doubled = [dict(ch, **{big: 2 * ch[big]}) for ch in prog["change"]]
    out["altered"] = (dict(prog, change=doubled), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=4)
    ap.add_argument("--base", type=int, default=3_000_000_017)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse at a small size")
    ap.add_argument("--override", default="{}",
                    help='JSON {"cfg": {...}, "traffic": {...}}, to rehearse at a small size')
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = run.Cell(args.workload)
    for key, extra in json.loads(args.override).items():
        getattr(cell, key).update(extra)
    mod = __import__(f"perfbench.drivers.{cell.traffic['driver']}", fromlist=["Driver"])
    rows = []
    drv = None
    for i in range(args.seeds):
        seed = args.base + 7919 * i
        t = time.perf_counter()
        if drv is None:
            drv = mod.Driver(cell.cfg, cell.traffic, seed, device, Tracer(False))
            drv.setup()
        else:
            drv.seed = seed
            drv.reseed()
            drv.first_steps()
        drv.collect()
        ref = drv.reference()
        row = {"seed": seed, "sound": mod.readings(drv.first, ref)}
        if i < args.faults:
            for k, (rec, rec_ref) in faults(drv, ref).items():
                row[k] = mod.readings(rec, rec_ref)
        row["s"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for kind in rows[0]:
        if kind in ("seed", "s"):
            continue
        vals = [r[kind] for r in rows if kind in r]
        summary[kind] = {k: [min(v[k] for v in vals), max(v[k] for v in vals)] for k in vals[0]}
    print("summary", json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
