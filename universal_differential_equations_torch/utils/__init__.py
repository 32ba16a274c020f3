"""Problem and device utilities.

Port of ``rescale_problem`` and the tree helpers (``flat_dim``,
``zeros_like_tree``, ``tree_where``, ``tree_add``, ``tree_scale``) from
``universal_differential_equations_tpu/utils``, its re-exports
(``ravel_pytree`` and ``profiling``'s ``benchmark``, ``trace`` and
``StepTimer``), ``card_name``, the device line that the pipelines and the
benchmark print, and ``require_viz``, the examples' ``--plot`` import.  The
rest of that module (device probes, the XLA compilation cache) serves the
TPU and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import subprocess

import torch

from ..flatten_util import ravel_pytree, tree_flatten
from .profiling import StepTimer, benchmark, trace

__all__ = ["card_name", "require_viz", "flat_dim", "rescale_problem", "tree_add",
           "tree_scale", "tree_where", "zeros_like_tree", "ravel_pytree", "benchmark", "trace",
           "StepTimer"]


def card_name(device):
    """The card's name and power limit as ``nvidia-smi`` prints them, or the
    CPU's thread count when ``device`` is not a CUDA device."""
    if device.type != "cuda":
        return f"cpu ({torch.get_num_threads()} threads)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def require_viz():
    """The port's ``viz`` module, imported at once: an example's ``--plot``
    calls this before any data or training, so a host without matplotlib
    stops before the run instead of after it."""
    try:
        from .. import viz
    except ImportError as e:
        raise ImportError(f"--plot needs matplotlib (and Pillow for the GIF): {e}") from e
    return viz


def flat_dim(tree) -> int:
    """Total number of scalar entries in a tree of tensors."""
    return sum(leaf.numel() for leaf in tree_flatten(tree)[0])


def zeros_like_tree(tree):
    return _map2(lambda x, _: torch.zeros_like(x), tree, tree)


def tree_where(pred, a, b):
    return _map2(lambda x, y: torch.where(pred, x, y), a, b)


def tree_add(a, b):
    return _map2(torch.add, a, b)


def tree_scale(c, a):
    return _map2(lambda x, _: c * x, a, a)


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
