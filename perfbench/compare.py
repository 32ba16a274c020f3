"""The numbers that decide ``correct`` for a training cell.

A record of a training's first steps holds each step's loss, the first
gradient by leaf (where the program hands it out) and the parameters'
changes by leaf: one per step where the reference follows the program step
by step, or one over all the steps.  The program's record is held to the
reference's:

* ``loss_gap``: over the steps, the largest relative gap of the loss;
  ``first_loss_gap`` the first step's alone;
* ``grad_gap``: over the leaves, the largest gap between the two norms of
  the first gradient, relative to the reference's norm of that leaf or of
  the median leaf, whichever is larger;
* ``change_gap``: the same for each change of the parameters, the largest
  over the changes, over the leaves that the reference's first gradient
  moves (norm at least ``MOVED`` of the median leaf's); a leaf whose
  gradient is nought to rounding moves under ADAM by round-off alone.
"""
from __future__ import annotations

import math
import statistics

import torch

MOVED = 1e-3


def norms(leaves):
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in leaves.items()}


def worst_leaf_gap(prog, ref, keep=None):
    """Largest ``|‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)`` over the leaves ``keep``."""
    keys = sorted(ref if keep is None else keep)
    if set(keys) - set(prog):
        return math.inf
    n_p, n_r = norms({k: prog[k] for k in keys}), norms({k: ref[k] for k in keys})
    med = statistics.median(n_r.values())
    return _worst(abs(n_p[k] - n_r[k]) / max(n_r[k], med) for k in keys)


def moved(grad):
    """The leaves whose gradient norm is at least ``MOVED`` of the median leaf's."""
    n = norms(grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= MOVED * med]


def loss_gap(prog, ref):
    prog, ref = [float(x) for x in prog], [float(x) for x in ref]
    if len(prog) != len(ref) or not ref:
        return math.inf
    return _worst(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _worst(gaps):
    """The largest gap; infinite where any is not a finite number."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def training_readings(prog, ref):
    """``{name: value}`` of a program record against a reference record; a
    gap that is not a finite number reads as infinite."""
    keep = moved(ref["grad"])
    changes = list(zip(prog["change"], ref["change"]))
    out = {
        "loss_gap": loss_gap(prog["loss"], ref["loss"]),
        "first_loss_gap": loss_gap(prog["loss"][:1], ref["loss"][:1]),
        "change_gap": (_worst(worst_leaf_gap(p, r, keep) for p, r in changes)
                       if len(prog["change"]) == len(ref["change"]) else math.inf),
    }
    if "grad" in prog:
        out["grad_gap"] = worst_leaf_gap(prog["grad"], ref["grad"])
    return out
