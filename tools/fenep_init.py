#!/usr/bin/env python3
"""Write the FENE-P case study's initial surrogate weights as a numpy fixture.

    python3 tools/fenep_init.py [--out PATH]

The JAX script (``examples/non_newtonian/fenep.py``) starts both arms, the
neural surrogate and the linear baseline, from
``models.fenep.make_surrogate(jax.random.PRNGKey(3), linear=...)`` in
float32, which torch cannot reproduce.  This tool replays those two draws
with JAX on the CPU in float32 (x64 off) and stores them, 40 floats, in
``universal_differential_equations_torch/examples/data/fenep_init.npz`` for
the PyTorch port's ``examples/fenep.py --init jax``.  Keys are
``{arm}.{net}.{layer}.{leaf}``: arm ``neural`` or ``linear``, net ``f1`` or
``f0``, the layer's index in the chain, leaf ``w`` or ``b``.

This is a tool of the JAX package's side: it imports JAX; the port only
reads the file it writes.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "universal_differential_equations_torch" / "examples" / "data" / "fenep_init.npz"
KEY = 3  # examples/non_newtonian/fenep.py: make_surrogate(jax.random.PRNGKey(3), ...)


def draw():
    """Both arms' initial weights as a dict of float32 numpy arrays.  Call it
    with x64 off (``jax.enable_x64(False)``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from universal_differential_equations_tpu.models import fenep

    out = {}
    for arm, linear in (("neural", False), ("linear", True)):
        _, _, params = fenep.make_surrogate(jax.random.PRNGKey(KEY), linear=linear,
                                            dtype=jnp.float32)
        for net, layers in params.items():
            for i, layer in enumerate(layers):
                for leaf, value in layer.items():
                    out[f"{arm}.{net}.{i}.{leaf}"] = np.asarray(value)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    arrays = draw()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **arrays)
    n = sum(v.size for v in arrays.values())
    print(f"wrote {args.out}: {len(arrays)} arrays, {n} floats")


if __name__ == "__main__":
    main()
