"""Ravel a pytree of tensors into one flat vector, in ``jax.flatten_util`` order.

The port's counterpart of ``jax.flatten_util.ravel_pytree``.  Dict keys are
visited in sorted order, as JAX does, so a flat parameter vector of the port
lines up entry for entry with the JAX package's (``{"D0", "rx", "w"}`` ravels
as ``D0``, then ``rx``, then ``w``); lists and tuples are visited in order.
The LM parity tests compare iterates of the two packages directly on this
vector.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

__all__ = ["ravel_pytree"]


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List], Any]]:
    """Leaves in JAX order and a function that rebuilds the tree from them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        leaves = [leaf for p in parts for leaf in p[0]]
        sizes = [len(p[0]) for p in parts]

        def build(xs):
            out, i = {}, 0
            for k, (_, b), n in zip(keys, parts, sizes):
                out[k] = b(xs[i:i + n])
                i += n
            return out

        return leaves, build
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        leaves = [leaf for p in parts for leaf in p[0]]
        sizes = [len(p[0]) for p in parts]
        kind = type(tree)

        def build(xs):
            out, i = [], 0
            for (_, b), n in zip(parts, sizes):
                out.append(b(xs[i:i + n]))
                i += n
            return kind(out)

        return leaves, build
    if tree is None:
        return [], lambda xs: None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"pytree leaf must be a tensor, got {type(tree).__name__}")
    return [tree], lambda xs: xs[0]


def ravel_pytree(tree):
    """``(flat, unravel)``: ``flat`` is the 1-D concatenation of the leaves.

    ``unravel`` accepts the flat vector with any leading batch dimensions,
    ``(*batch, size)``, and returns the tree with leaves of shape
    ``(*batch, *leaf.shape)``.
    """
    leaves, build = _flatten(tree)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    if len(leaves) == 1:  # a bare tensor state: a view, no copy
        flat = leaves[0].reshape(-1)
    elif leaves:
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    else:
        flat = torch.zeros(0)

    def unravel(vec):
        lead = vec.shape[:-1]
        parts = torch.split(vec, sizes, dim=-1)
        return build([p.reshape((*lead, *s)) for p, s in zip(parts, shapes)])

    return flat, unravel
