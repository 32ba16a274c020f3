#!/usr/bin/env python3
"""The SEIR exposure pipeline's two halves one at a time, for runs that must fit a time limit.

    python3 tools/seir_stages.py --stage neural_ode|exposure [--quick] [--device cuda] [--out FILE]

``examples/seir_exposure.py``'s ``main`` runs the truth, then variant (a),
the black-box neural ODE (its result feeds no later stage), then variant
(b), the exposure UDE, and the recovery arms on it (the ideal recovery, the
UDE and weak-form arms, the day-60 extrapolations).  Each stage here runs the
truth and then:

* ``neural_ode``: trains variant (a);
* ``exposure``: trains variant (b) and runs the recovery arms on it, with
  the script's gates.

With the same seeds and budgets, the two stages together are the pipeline.
The JSON of stage walls and results is the last line of the output, and is
also written to ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from universal_differential_equations_torch.examples import seir_exposure as se  # noqa: E402
from universal_differential_equations_torch.examples.lv_scenario_1 import stopwatch  # noqa: E402
from universal_differential_equations_torch.utils import card_name  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=("neural_ode", "exposure"), required=True)
    ap.add_argument("--quick", action="store_true", help="the pipeline's --quick budgets")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls, lap = stopwatch(device)
    ts64, _, data64 = se.truth(torch.Generator().manual_seed(se.SEEDS["noise"]), device=device)
    ts, data = ts64.float(), data64.float()
    lap("truth")
    res = {}
    if args.stage == "neural_ode":
        res["neural_ode"] = se.neural_ode_arm(ts, data, args.quick, device)
        lap("train_neural_ode")
    else:
        rhs, net, p_ude, res["exposure_ude"] = se.exposure_ude_arm(ts, data, args.quick, device)
        lap("train_exposure_ude")
        res.update(se.recovery_arms(rhs, net, p_ude, ts, data, lap))
        res["gates"] = se.gates(res, args.quick)
    out = dict(device=card_name(device), stage=args.stage, quick=args.quick, walls=walls,
               total_s=sum(walls.values()), **res)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if all(res.get("gates", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
