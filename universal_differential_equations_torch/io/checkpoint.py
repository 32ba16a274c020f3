"""Checkpointing: pytree saves and keyed, group-appendable archives.

Port of ``universal_differential_equations_tpu/io/checkpoint.py``, on the
same files, so each package loads the other's archives.  It covers the
reference's persistence patterns: JLD2 keyed result saves
(``scenario_1.jl:210-213``), append-mode per-run groups for the 500-run study
(``loop_recoveries.jl:132-140``), BSON model checkpoints
(``Fisher-KPP-CNN.jl:243-248``) and best-loss checkpointing
(``neural_pde_rayleigh_taylor_instability.jl:166-171``).

Format: one ``.npz`` file per group, its leaves named ``leaf_{i}`` in JAX
flatten order (sorted dict keys, lists and tuples in order), plus a
``.tree.json`` sidecar whose ``paths`` are spelled as
``jax.tree_util.keystr`` spells them (``['rx'][0]['w']``).  Leaves go through
numpy on the host; loading puts them on the device the caller names.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..flatten_util import tree_flatten_with_path

__all__ = ["save_pytree", "load_pytree", "KeyedArchive", "BestCheckpoint"]


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    """Save any pytree of tensors or arrays to ``<path>.npz`` (and the
    ``.tree.json`` sidecar recording each leaf's path)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pairs, _ = tree_flatten_with_path(tree)
    flat = {f"leaf_{i}": _numpy(leaf) for i, (_, leaf) in enumerate(pairs)}
    p = str(path)
    np.savez(p if p.endswith(".npz") else p + ".npz", **flat)
    with open(p.removesuffix(".npz") + ".tree.json", "w") as f:
        json.dump({"paths": [keypath for keypath, _ in pairs]}, f)


def load_pytree(path, like, device=None):
    """Load into the structure of ``like`` (its leaves in the saved order),
    as tensors on ``device`` (default: the CPU)."""
    p = str(path)
    if not p.endswith(".npz"):
        p += ".npz"
    pairs, build = tree_flatten_with_path(like)
    with np.load(p) as data:
        if len(data.files) != len(pairs):
            raise ValueError(f"{p} holds {len(data.files)} leaves; the structure of "
                             f"`like` has {len(pairs)}")
        return build([torch.as_tensor(data[f"leaf_{i}"], device=device)
                      for i in range(len(pairs))])


class KeyedArchive:
    """Keyed, group-appendable result store (the JLD2 ``jldopen("a+")``
    pattern of ``loop_recoveries.jl:132-140``).

    Each group is a file ``<root>/<group>.npz`` holding named arrays; append
    different groups freely across runs and processes.  A value that is a
    pytree is stored leaf by leaf as ``<name>__<i>``.
    """

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def save(self, group: str, **arrays):
        flat = {}
        for name, value in arrays.items():
            pairs, _ = tree_flatten_with_path(value)
            if len(pairs) == 1 and not isinstance(value, (dict, list, tuple)):
                flat[name] = _numpy(value)
            else:
                for i, (_, leaf) in enumerate(pairs):
                    flat[f"{name}__{i}"] = _numpy(leaf)
        np.savez(self.root / f"{group}.npz", **flat)

    def load(self, group: str, device=None) -> Dict[str, torch.Tensor]:
        with np.load(self.root / f"{group}.npz") as data:
            return {k: torch.as_tensor(data[k], device=device) for k in data.files}

    def groups(self) -> List[str]:
        return sorted(p.stem for p in self.root.glob("*.npz"))

    def __contains__(self, group: str) -> bool:
        return (self.root / f"{group}.npz").exists()


class BestCheckpoint:
    """Best-loss checkpointing hook for ``fit`` callbacks
    (``neural_pde_rayleigh_taylor_instability.jl:166-171``)."""

    def __init__(self, path):
        self.path = Path(path)
        self.best = float("inf")

    def __call__(self, step, loss, params) -> bool:
        if loss < self.best:
            self.best = float(loss)
            save_pytree(self.path, params)
        return False  # never stops training
