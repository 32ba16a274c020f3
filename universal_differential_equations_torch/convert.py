"""Parameters from the JAX package to the port.

The JAX package keeps parameters as pytrees of arrays (dicts, lists, tuples);
the port keeps the same trees of tensors, with the same names (``"rx"``,
``"w"``, ``"D0"``, a ``Dense`` layer's ``"w"`` and ``"b"``) and the same layouts
(``Dense.w`` is (out, in) in both).  Hand this module the JAX tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``); it imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree, device=None, dtype=torch.float32):
    """The port's parameter tree for a JAX parameter tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)
