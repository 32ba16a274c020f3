"""Ensemble / Monte-Carlo experiment runner.

Port of ``universal_differential_equations_tpu/ensemble/runner.py``.  The
reference's 500-run noise-robustness study is a sequential Julia loop with
``try/catch`` fault isolation (``run_loops.jl:55-62``).  Here the whole
ensemble is one ``torch.func.vmap`` of the run function: the lanes of an
adaptive solve share one eager stepping loop (``core/integrate.py``), and a
finished lane passes through.  Fault tolerance is mask-and-continue: each
run carries a success flag instead of an exception, and failed runs are
excluded from aggregation as the reference marks failures ``Inf`` and skips
them (``loop_evaluation.jl:45-53``).

``sharded=True`` splits the lanes over the ranks of a mesh
(``parallel.ensemble_mesh``): each rank runs its contiguous share as the
same one ``vmap``, and the results are gathered back to the global batch on
every rank, as the JAX package's sharded arrays are global.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..flatten_util import tree_flatten
from ..parallel.collectives import gather_tree
from ..parallel.mesh import ensemble_mesh, shard_ensemble

__all__ = ["EnsembleResult", "ensemble_run", "noise_schedule"]


@dataclasses.dataclass
class EnsembleResult:
    outputs: object  # pytree with a leading run axis
    success: torch.Tensor  # (n_runs,) bool: the run reported ok and every output is finite

    @property
    def num_success(self):
        return int(self.success.sum())

    def successful(self, leaf):
        """A leaf's rows of the successful runs."""
        return leaf[self.success]


def ensemble_run(run_fn: Callable, batch_args, *, mesh=None,
                 sharded: bool = False) -> EnsembleResult:
    """``torch.func.vmap`` of ``run_fn`` over the leading axis of ``batch_args``.

    ``run_fn(args) -> (outputs, ok)`` where ``ok`` is a 0-d bool tensor (for
    example ``solution.success``).  A run succeeds when it reports ok and
    every output leaf is finite (NaN isolation in place of try/catch).

    With ``sharded=True`` the batch is split over ``mesh`` (default
    ``parallel.ensemble_mesh()`` on the batch's device type); every rank of
    the mesh makes the call and gets the whole result.  ``mesh`` is ignored
    without ``sharded``, as in the JAX package.
    """
    if sharded:
        leaves = tree_flatten(batch_args)[0]
        n_runs = leaves[0].shape[0]
        mesh = mesh or ensemble_mesh(device=leaves[0].device)
        batch_args = shard_ensemble(batch_args, mesh, mesh.axis_names[0])
    outputs, ok = torch.func.vmap(run_fn)(batch_args)
    success = ok.to(torch.bool)
    for leaf in tree_flatten(outputs)[0]:
        success = success & torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(-1)
    if sharded:
        outputs, success = gather_tree((outputs, success), mesh, n_runs)
    return EnsembleResult(outputs=outputs, success=success)


def noise_schedule(i, levels=(1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2), runs_per_level=100):
    """The reference's escalating noise schedule: the level changes every
    ``runs_per_level`` runs (``run_loops.jl:40-46``).  ``i`` is a run index
    or a tensor of them; the levels come back in float64."""
    i = torch.as_tensor(i)
    idx = torch.clamp(torch.div(i, runs_per_level, rounding_mode="floor"), 0, len(levels) - 1)
    return torch.tensor(levels, dtype=torch.float64, device=i.device)[idx]
