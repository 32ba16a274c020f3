"""The port's headline benchmark: Fisher-KPP universal-PDE training wall-clock.

    python -m universal_differential_equations_torch.bench [--device cuda]

The counterpart of the repo's ``bench.py`` (which times the JAX package): the
Fourier-reaction universal PDE (3 spectral reaction weights, a learnable
3-tap stencil and D0, ``models/fisher_kpp.py``) trained by
Levenberg-Marquardt with forward-mode Jacobians through the adaptive Tsit5
stepper (rtol 1e-4, atol 1e-6, ``ForwardSensitivity``, ``max_steps=192``, inf
residuals where a solve fails) to loss < 0.01 in at most 100 iterations,
from the initial weights of seeds 0–3.  The reference takes 236.8 s on a CPU
(``Fisher-KPP-CNN-Fourier.jl:305-329``, mean of 5 runs).

Each run's wall is a host clock between two ``torch.cuda.synchronize()``
calls.  Every seed must reach loss < 0.01.  Prints one JSON line:
``{"metric", "value", "unit", "vs_baseline", "extra"}``, where ``value`` is
the median wall over the seeds (the upper one of the middle two, as
``bench.py`` takes it; seed 0 carries the first calls' warm-up) and
``vs_baseline`` = 236.8 s / ``value`` (> 1: faster than the reference).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from universal_differential_equations_torch import levenberg_marquardt
from universal_differential_equations_torch.flatten_util import tree_flatten
from universal_differential_equations_torch.models import fisher_kpp as fk
from universal_differential_equations_torch.utils import card_name

BASELINE_SECONDS = 236.8  # Fisher-KPP-CNN-Fourier.jl:305-329, mean of 5 runs
SEEDS = (0, 1, 2, 3)


def initial_params(seed, device):
    """The Fourier model's initial parameters for ``seed``."""
    return fk.make_model(torch.Generator().manual_seed(seed), "fourier", device=device)[1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_run(params0, residuals, maxiters=100):
    """LM from ``params0`` to loss < 0.01: ``(wall seconds, LMResult)``."""
    device = tree_flatten(params0)[0][0].device
    _sync(device)
    t0 = time.perf_counter()
    res = levenberg_marquardt(residuals, params0, maxiters=maxiters, loss_tol=0.01)
    _sync(device)
    return time.perf_counter() - t0, res


def main(device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    ts, data = fk.generate_data(device=device)
    # the right-hand side does not depend on the seed: one residual closure
    rhs, _ = fk.make_model(torch.Generator().manual_seed(0), "fourier", device=device)
    residuals = fk.make_residuals(rhs, ts, data)
    walls, losses, iterations = [], [], []
    for seed in SEEDS:
        wall, res = train_run(initial_params(seed, device), residuals)
        walls.append(wall)
        losses.append(float(res.loss))
        iterations.append(res.iterations)
    if not all(loss < 0.01 for loss in losses):
        raise RuntimeError(f"convergence failed: losses {losses}")
    median = sorted(walls)[len(walls) // 2]
    return {
        "metric": "fisherkpp_fourier_train_to_loss_0.01",
        "value": median,
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / median,
        "extra": {
            "walls_s": walls,
            "losses": losses,
            "lm_iterations": iterations,
            "seeds": list(SEEDS),
            "device": card_name(device),
            "torch": torch.__version__,
        },
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    print(json.dumps(main(ap.parse_args().device)), flush=True)
