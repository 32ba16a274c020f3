"""Problem utilities.

Port of ``rescale_problem`` from ``universal_differential_equations_tpu/utils``.
The rest of that module (device probes, the XLA compilation cache) serves the
TPU and has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch

from ..flatten_util import tree_flatten

__all__ = ["rescale_problem"]


def _leaves_like(tree, other):
    """The parts of ``other`` that sit where ``tree`` has its tensors, in
    ``tree_flatten`` order (``other`` may have array or float leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_like(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, o in zip(tree, other) for x in _leaves_like(t, o)]
    return [] if tree is None else [other]


def _map2(fn, a, b):
    """``fn`` over the leaves of ``a`` and the matching parts of ``b``."""
    leaves, build = tree_flatten(a)
    return build([fn(x, y) for x, y in zip(leaves, _leaves_like(a, b))])


def rescale_problem(problem, scales):
    """Diagonal state rescaling: solve in units ``v = scales ⊙ u``.

    The dynamics are preserved exactly (``dv/dt = scales ⊙ f(t, v/scales)``)
    while every state component is conditioned to O(1) — what float32
    training needs where states span many decades (the SEIR case:
    susceptibles ~1, infected ~1e-5).  ``scales`` is a tree matching ``u0``
    (tensors, arrays or sequences), cast to each leaf's dtype and device.
    Returns a new problem; map solutions back with ``ys / scales``.
    """
    scales = _map2(lambda u, s: torch.as_tensor(s, dtype=u.dtype, device=u.device),
                   problem.u0, scales)
    f = problem.f

    def f_scaled(t, v, args):
        u = _map2(lambda vv, ss: vv / ss, v, scales)
        return _map2(lambda dd, ss: dd * ss, f(t, u, args), scales)

    u0_s = _map2(lambda uu, ss: uu * ss, problem.u0, scales)
    return dataclasses.replace(problem, f=f_scaled, u0=u0_s)
