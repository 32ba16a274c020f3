#!/usr/bin/env python3
"""Write the Lotka-Volterra noise study's lane inputs as a numpy fixture.

    python3 tools/lv_study_lanes.py [--out PATH]

The JAX study (``examples/lotka_volterra/run_loops.py``) draws each lane's
noisy data and initial network weights from ``jax.random`` keys, which torch
cannot reproduce.  This tool replays, with JAX on the CPU in float32 (x64
off), exactly the study's lines that draw those inputs, and stores them in
``universal_differential_equations_torch/examples/data/lv_study_lanes.npz``
for the PyTorch port's ``examples/run_loops.py --lanes jax``:

* ``ts, X, _ = lv.generate_data(PRNGKey(0), rtol=1e-7, atol=1e-9)`` and
  ``x_mean = mean(X, axis=0)`` (``build_stages``);
* ``keys = split(PRNGKey(42), 500)`` and ``k_noise, k_init = split(key)``
  per lane (``main``, ``adam_stage``);
* ``data = X + mag·x_mean·normal(k_noise, X.shape)``, with ``mag`` the
  noise level of the lane's block of 100;
* ``theta0[a]``: ``ravel_pytree(net.init(k))`` for attempt ``a`` (attempt 0
  takes ``k_init``, attempt 1 ``fold_in(k_init, 1)``), with the net of
  ``lv.make_ude(PRNGKey(7))``.

With ``--recover`` it also writes ``lv_study_recover.npz`` beside it: the
coefficients that the JAX study's own ``recover_stage`` selects from the 25
trained weight vectors of ``examples/lotka_volterra/results/
lane_theta_samples.npz`` on their lanes' data, for ``chip_smoke.py`` to hold
the port's selections against.

This is a tool of the JAX package's side: it imports JAX; the port only
reads the files it writes.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "universal_differential_equations_torch" / "examples" / "data" / "lv_study_lanes.npz"
NOISE_LEVELS = (1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2)  # run_loops.py:107
RUNS_PER_LEVEL = 100
ATTEMPTS = (0, 1)


def draw(lanes=None, runs_per_level=RUNS_PER_LEVEL):
    """The study's inputs for ``lanes`` (default: every lane), as a dict of
    numpy arrays.  Call it with x64 off (``jax.enable_x64(False)``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.flatten_util import ravel_pytree

    sys.path.insert(0, str(ROOT))
    from universal_differential_equations_tpu.models import lotka_volterra as lv

    n_runs = len(NOISE_LEVELS) * runs_per_level
    lanes = np.arange(n_runs) if lanes is None else np.asarray(lanes)
    ts, X, _ = lv.generate_data(jax.random.PRNGKey(0), rtol=1e-7, atol=1e-9)
    x_mean = jnp.mean(X, axis=0)
    _, _, net = lv.make_ude(jax.random.PRNGKey(7))
    keys = jax.random.split(jax.random.PRNGKey(42), n_runs)
    mags = jnp.repeat(jnp.asarray(NOISE_LEVELS, jnp.float32), runs_per_level)

    @jax.jit
    @jax.vmap
    def lane(key, mag):
        k_noise, k_init = jax.random.split(key)
        data = X + mag * x_mean * jax.random.normal(k_noise, X.shape)
        thetas = [ravel_pytree(net.init(k_init if a == 0 else jax.random.fold_in(k_init, a)))[0]
                  for a in ATTEMPTS]
        return data, jnp.stack(thetas)

    idx = jnp.asarray(lanes)
    data, theta0 = lane(keys[idx], mags[idx])
    return dict(ts=np.asarray(ts), X=np.asarray(X), x_mean=np.asarray(x_mean),
                mag=np.asarray(mags[idx]), data=np.asarray(data),
                theta0=np.asarray(jnp.swapaxes(theta0, 0, 1)), lane=np.asarray(lanes))


def jax_recover(lanes=None):
    """The JAX study's ``recover_stage`` on the archived trained weights of
    ``lane_theta_samples.npz`` (or its ``lanes`` rows): ``(lane, c1, c2)``.
    Call it with x64 off."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(ROOT / "examples" / "lotka_volterra"))
    import run_loops as jrl

    with np.load(ROOT / "examples/lotka_volterra/results/lane_theta_samples.npz") as z:
        rows = np.arange(len(z["lane"])) if lanes is None else np.searchsorted(z["lane"], lanes)
        lane, theta, loss, mag = z["lane"][rows], z["theta"][rows], z["loss"][rows], z["mag"][rows]
    data = draw(lane)["data"]
    out = jrl.build_stages().recover_stage(jnp.asarray(theta), jnp.asarray(data),
                                           jnp.asarray(loss), jnp.asarray(mag))
    return lane, np.asarray(out[3]), np.asarray(out[4])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--recover", action="store_true",
                    help="also write lv_study_recover.npz beside --out")
    args = ap.parse_args()
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    arrays = draw()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape} {v.dtype}" for k, v in arrays.items()))
    if args.recover:
        lane, c1, c2 = jax_recover()
        path = Path(args.out).with_name("lv_study_recover.npz")
        np.savez(path, lane=lane, coef1=c1, coef2=c2)
        print(f"wrote {path}: the JAX recover_stage's coefficients on {lane.size} lanes")


if __name__ == "__main__":
    main()
