"""Multi-process initialization for ensemble scaling over several cards.

Port of ``universal_differential_equations_tpu/parallel/distributed.py``.
The JAX package initializes ``jax.distributed`` once per process and builds
one ``ensemble`` mesh over every process's devices.  Here each process (a
rank) drives one card: :func:`initialize_distributed` starts the
``torch.distributed`` process group, NCCL over the cards, and
:func:`global_ensemble_mesh` is one axis over every rank of the job.

Single-process runs need no initialization: every mesh helper starts a
one-rank group of its own where none exists (:func:`.mesh.ensemble_mesh`).

Typical launch on one host with four cards (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

    UDE_DISTRIBUTED=1 torchrun --nproc-per-node 4 -m \\
        universal_differential_equations_torch.examples.hjb_100d --quick

and in a script::

    initialize_distributed()          # no-op without the opt-in
    mesh = global_ensemble_mesh()     # one axis over every rank
    batch = shard_ensemble(batch, mesh)
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import ENSEMBLE_AXIS, Mesh, ensemble_mesh

__all__ = ["initialize_distributed", "global_ensemble_mesh", "is_distributed",
           "process_count", "process_rank", "local_device_count"]

# explicit opt-in, as in the JAX package: launchers can leave rank variables
# in the environment of a one-process run, so nothing is detected
_OPT_IN_ENV = "UDE_DISTRIBUTED"
_STATE = {"initialized": False}


def is_distributed() -> bool:
    """True once :func:`initialize_distributed` has started the group."""
    return _STATE["initialized"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Start the ``torch.distributed`` process group when running
    multi-process; no-op otherwise.

    Returns True if distributed mode is active.  Safe to call more than once
    and from one-process runs: without an argument or the ``UDE_DISTRIBUTED``
    opt-in it does nothing.  ``coordinator_address`` is ``host:port`` of rank
    0's store; without it the launcher's ``MASTER_ADDR``/``MASTER_PORT`` are
    read.  ``num_processes`` and ``process_id`` default to ``WORLD_SIZE``
    and ``RANK``.  On a card (``device`` ``"cuda"``, the default) the group
    is NCCL and the process takes card ``LOCAL_RANK``; gloo only where the
    caller asks for the CPU (``device="cpu"``).  A group started elsewhere
    is taken as it is.
    """
    if _STATE["initialized"]:
        return True
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if not explicit and not os.environ.get(_OPT_IN_ENV):
        return False
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' for a gloo group")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
            backend = "nccl"
        else:
            backend = "gloo"
        init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    _STATE["initialized"] = True
    return True


def process_count() -> int:
    """Ranks in the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank() -> int:
    """This process's rank in the job (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """Cards this process can address (1 on a host without one: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_ensemble_mesh(axis: str = ENSEMBLE_AXIS) -> Mesh:
    """One ``ensemble`` axis over every rank of the job, in rank order (a
    one-rank group is started where there is none)."""
    return ensemble_mesh(axis=axis)
