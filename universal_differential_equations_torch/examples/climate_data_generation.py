"""Climate training-data generation on the port: the forced tracer and the Rayleigh-Taylor slab.

    python -m universal_differential_equations_torch.examples.climate_data_generation
        [--quick] [--full-res] [--bc periodic|rigid_lid] [--plot] [--device cuda]

The port of ``examples/climate/data_generation.py``, the counterparts of the
reference's Oceananigans runs (``models/climate_datagen.py``):

* ``Climate/DataGeneration/advection_diffusion_3d.jl``: forced tracer
  diffusion on an N³ grid (48; 16 with ``--quick``, 128 with ``--full-res``)
  with Neumann top/bottom, the adaptive-dt wizard and horizontal averages
  every 0.01 time units, to t = 1.5 (0.05 with ``--quick``);
* ``Climate/DataGeneration/rayleigh_taylor_instability_3d.jl``: the
  Boussinesq Rayleigh-Taylor slab at 64×4×64 to t = 4 (16×2×16 to t = 0.2
  with ``--quick``; the reference's 128×2×128 with ``--full-res``), whose
  horizontal buoyancy averages b̄(z, t) are the training data of
  ``climate_training_rt``.

Gates, as in the JAX script: finite profiles; the mean tracer grows; outside
``--quick``, the RT mid-depth |db/dz| drops below 0.9× its start.  The
averages go to ``build/climate/rt_horizontal_averages[_quick][_rigid_lid].npz``
(never into ``examples/climate/data/``, which holds the JAX package's
committed dataset).  Every stage runs on ``--device`` (default ``cuda``);
the noise comes from ``torch.Generator`` seeds 0 and 1 (the JAX script's
keys), which draw other numbers than ``jax.random``.  ``--plot`` writes the
JAX script's ``rt_averages.pdf`` to ``build/plots/climate/``
(:func:`write_plots`); it needs matplotlib, imported before the runs.  The
last line of the output is a JSON object with the walls, steps per second
and gates.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from universal_differential_equations_torch.models.climate_datagen import (
    advection_diffusion_3d,
    rayleigh_taylor_3d,
)
from universal_differential_equations_torch.utils import card_name, require_viz

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "climate"
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "climate"


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def write_plots(ts, z, b, outdir=None):
    """The reference's horizontal-average diagnostic: the RT b̄(z, t) as one
    diverging z-t field, into ``outdir`` (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    viz.save(viz.plot_field(
        b.T, (float(ts[0]), float(ts[-1]), float(z[0]), float(z[-1])),
        title="Rayleigh-Taylor b̄(z, t) horizontal averages", ylabel="z", cbar_label="b̄",
        diverging=True), outdir / "rt_averages.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, full_res=False, bc="periodic", device="cuda", plot=False,
         out_dir=OUT_DIR):
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    out = dict(device=card_name(device), quick=quick, full_res=full_res, bc=bc)

    # --- forced advection-diffusion tracer (advection_diffusion_3d.jl) ---
    N = 128 if full_res else (16 if quick else 48)
    end = 0.05 if quick else 1.5
    (ts, prof), wall = _timed(lambda: advection_diffusion_3d(
        N=N, end_time=end, key=torch.Generator().manual_seed(0), device=device), device)
    print(f"advection-diffusion: N={N}^3, {len(ts)} saves to t={ts[-1]:.3f} in {wall:.2f}s",
          flush=True)
    tracer_finite = bool(np.isfinite(prof).all())
    # forcing F(c) > 0 for small c: the mean tracer must grow
    grows = bool(prof[-1].mean() > prof[0].mean())
    out["tracer"] = dict(N=N, saves=len(ts), t_end=float(ts[-1]), wall_s=wall)

    # --- Rayleigh-Taylor instability (rayleigh_taylor_instability_3d.jl) ---
    if full_res:
        shape, endt = (128, 2, 128), 4.0  # the reference's slab (:13-15)
    elif quick:
        shape, endt = (16, 2, 16), 0.2
    else:
        shape, endt = (64, 4, 64), 4.0
    (ts, z, b), wall = _timed(lambda: rayleigh_taylor_3d(
        N=shape, end_time=endt, save_every=0.1, key=torch.Generator().manual_seed(1), bc=bc,
        device=device), device)
    n_cells = shape[0] * shape[1] * shape[2]
    print(f"rayleigh-taylor: {shape} grid ({n_cells} cells, bc={bc}), {len(ts)} saves to "
          f"t={ts[-1]:.3f} in {wall:.2f}s", flush=True)
    rt_finite = bool(np.isfinite(b).all())
    out["rt"] = dict(shape=shape, saves=len(ts), t_end=float(ts[-1]), wall_s=wall)
    gates = dict(finite=tracer_finite and rt_finite, tracer_grows=grows)
    if not quick:
        # mixing: the initial ±1 step profile homogenizes — the mid-depth
        # gradient magnitude must shrink
        mid = len(z) // 2
        g0 = abs(b[0, mid + 1] - b[0, mid - 1])
        g1 = abs(b[-1, mid + 1] - b[-1, mid - 1])
        print(f"  mid-depth |db/dz| step drop: {g0:.3f} -> {g1:.3f}")
        out["rt"]["gradient_drop"] = [float(g0), float(g1)]
        gates["rt_mixes"] = bool(g1 < 0.9 * g0)

    out_name = "rt_horizontal_averages_quick.npz" if quick else "rt_horizontal_averages.npz"
    if bc != "periodic":
        out_name = out_name.replace(".npz", f"_{bc}.npz")
    path = Path(out_dir) / out_name
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, t=ts, z=z, b=b)
    print(f"wrote {path} (b shape {b.shape})")
    out["written"] = str(path)
    out["gates"] = gates
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"climate data-generation gate failed: {gates}")
    if plot:
        write_plots(ts, z, b)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full-res", action="store_true",
                    help="reference-scale grids (128 tracer, 128x2x128 RT)")
    ap.add_argument("--plot", action="store_true",
                    help="write the RT averages figure to build/plots/climate/")
    ap.add_argument("--bc", default="periodic", choices=("periodic", "rigid_lid"),
                    help="RT vertical boundary treatment: periodic-z (one FFT, default) or "
                         "the reference tank's rigid lids (image-charge FFT pressure solve)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, full_res=args.full_res, bc=args.bc,
                          device=args.device, plot=args.plot)), flush=True)
