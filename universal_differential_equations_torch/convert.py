"""Parameters from the JAX package to the port.

The JAX package keeps parameters as pytrees of arrays (dicts, lists, tuples);
the port keeps the same trees of tensors, with the same names (``"rx"``,
``"w"``, ``"D0"``, a ``Dense`` layer's ``"w"`` and ``"b"``) and the same layouts
(``Dense.w`` is (out, in) in both).  Hand this module the JAX tree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``); it imports no
JAX.

A flat parameter vector (``jax.flatten_util.ravel_pytree``'s) needs no
reordering: the port's ``flatten_util.ravel_pytree`` visits dict keys sorted,
as JAX does, so a ``Dense`` layer ravels as ``b`` and then ``w`` in both.
:func:`theta_from_jax` checks the size against the port's tree and places
the vector.
"""
from __future__ import annotations

import numpy as np
import torch

from .flatten_util import tree_flatten_with_path

__all__ = ["params_from_jax", "theta_from_jax"]


def params_from_jax(tree, device=None, dtype=torch.float32):
    """The port's parameter tree for a JAX parameter tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def theta_from_jax(theta, like, device=None, dtype=torch.float32):
    """The port's flat parameter vector(s) for JAX ``ravel_pytree`` vectors
    ``theta`` of shape ``(..., n)``, where ``like`` is the port's parameter
    tree of the same model (its ``ravel_pytree`` order is JAX's)."""
    theta = torch.as_tensor(np.asarray(theta), dtype=dtype, device=device)
    n = sum(leaf.numel() for _, leaf in tree_flatten_with_path(like)[0])
    if theta.shape[-1] != n:
        raise ValueError(f"a JAX flat vector of {theta.shape[-1]} entries does not ravel "
                         f"a tree of {n} parameters")
    return theta
