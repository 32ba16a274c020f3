"""Ensemble data parallelism on ``torch.distributed``: meshes of ranks, the
collectives XLA inserts in the JAX package, a CPU launcher of gloo ranks
and the multi-rank dry run (``python -m
universal_differential_equations_torch.parallel.dryrun [n]``)."""
from .mesh import ENSEMBLE_AXIS, Mesh, ensemble_mesh, replicate, shard_ensemble
from .distributed import (
    global_ensemble_mesh,
    initialize_distributed,
    is_distributed,
    local_device_count,
    process_count,
    process_rank,
)

__all__ = ["ENSEMBLE_AXIS", "Mesh", "ensemble_mesh", "replicate", "shard_ensemble",
           "global_ensemble_mesh", "initialize_distributed", "is_distributed",
           "local_device_count", "process_count", "process_rank"]
