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

__all__ = ["ravel_pytree", "tree_flatten", "tree_flatten_with_path"]


def tree_flatten_with_path(tree, path: str = ""):
    """``(pairs, build)``: ``pairs`` lists ``(path, leaf)`` in JAX order, with
    ``path`` spelled as ``jax.tree_util.keystr`` spells it (``['rx'][0]['w']``),
    and ``build`` rebuilds a tree of the same structure from a list of
    leaves.  A leaf is anything that is not a dict, list, tuple or None; no
    leaf is checked, so callers can name the ones they refuse."""
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        parts = [tree_flatten_with_path(tree[k], f"{path}[{k!r}]") for k in keys]
        pairs = [pair for p in parts for pair in p[0]]
        sizes = [len(p[0]) for p in parts]

        def build(xs):
            out, i = [], 0
            for (_, b), n in zip(parts, sizes):
                out.append(b(xs[i:i + n]))
                i += n
            return dict(zip(keys, out)) if isinstance(tree, dict) else type(tree)(out)

        return pairs, build
    if tree is None:
        return [], lambda xs: None
    return [(path, tree)], lambda xs: xs[0]


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List], Any]]:
    """``(leaves, build)``: the tree's tensors in JAX order, and a function
    that rebuilds a tree of the same structure from a list of leaves."""
    pairs, build = tree_flatten_with_path(tree)
    for _, leaf in pairs:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"pytree leaf must be a tensor, got {type(leaf).__name__}")
    return [leaf for _, leaf in pairs], build


def ravel_pytree(tree):
    """``(flat, unravel)``: ``flat`` is the 1-D concatenation of the leaves.

    ``unravel`` accepts the flat vector with any leading batch dimensions,
    ``(*batch, size)``, and returns the tree with leaves of shape
    ``(*batch, *leaf.shape)``.
    """
    leaves, build = tree_flatten(tree)
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
