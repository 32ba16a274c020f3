"""Device-mesh helpers: ensemble data parallelism over ranks.

Port of ``universal_differential_equations_tpu/parallel/mesh.py``.  The JAX
package has one first-class mesh axis (``"ensemble"``) over which trajectory
batches, Monte-Carlo recovery runs, multiple-shooting segments and deep-BSDE
paths are sharded with ``jax.sharding``; XLA inserts the collectives.  Here
each rank of a ``torch.distributed`` process group drives one device, a mesh
is a 1-D :class:`torch.distributed.device_mesh.DeviceMesh` over ranks, and
a sharded value is this rank's contiguous slice of the global batch: the
consumers call the collectives of :mod:`.collectives` where XLA would have
inserted them.  Models are tiny, so parameters are always replicated.

The mesh's device type is its backend's: ``"cuda"`` over NCCL, ``"cpu"``
over gloo.  A tensor of the other type handed to a mesh raises; nothing is
copied between them.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..flatten_util import tree_flatten

__all__ = ["ENSEMBLE_AXIS", "Mesh", "ensemble_mesh", "replicate", "shard_ensemble",
           "split_sizes"]

ENSEMBLE_AXIS = "ensemble"


def split_sizes(n: int, parts: int):
    """Balanced contiguous split of ``n`` items over ``parts`` ranks: the
    first ``n % parts`` ranks hold one more."""
    return [n // parts + (1 if j < n % parts else 0) for j in range(parts)]


class Mesh:
    """A 1-D mesh of ranks, around a ``DeviceMesh``.

    Exposes what the JAX package's consumers read from a
    ``jax.sharding.Mesh``: ``axis_names``, ``size`` and ``shape[axis]``; and
    what the port's consumers need: ``group`` (the process group of the
    mesh's ranks), ``device_type`` and ``index`` (this rank's position on
    the axis, None where the rank is not on the mesh)."""

    def __init__(self, device_mesh: DeviceMesh, axis: str):
        self.axis_names = (axis,)
        self.ranks = tuple(int(r) for r in device_mesh.mesh.reshape(-1).tolist())
        self.size = len(self.ranks)
        self.shape = {axis: self.size}
        self.device_type = device_mesh.device_type
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.group = device_mesh.get_group() if self.index is not None else None

    def member(self):
        """This rank's index on the mesh; raises where it is not on it."""
        if self.index is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh {self.ranks}")
        return self.index

    def check(self, tensor, what="tensor"):
        """Raise unless ``tensor`` lives on the mesh's device type."""
        if tensor.device.type != self.device_type:
            raise ValueError(f"a {tensor.device.type} {what} handed to a {self.device_type} "
                             f"mesh (its backend is {dist.get_backend(self.group)}); move it "
                             f"first: a mesh copies nothing between device types")

    def axis(self, name: Optional[str]):
        """``name`` (default the mesh's axis) checked against the mesh."""
        if name is not None and name not in self.axis_names:
            raise ValueError(f"mesh axis {name!r} not in {self.axis_names}")
        return self.axis_names[0]

    def __repr__(self):
        return f"Mesh({self.axis_names[0]!r}: ranks {list(self.ranks)}, {self.device_type})"


def group_device_type() -> str:
    """The device type of the default process group's backend."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def start_single_rank(device=None):
    """Start a one-rank process group over a ``FileStore`` in a temporary
    directory: NCCL on the card (``device`` ``"cuda"``, the default), gloo
    where the caller asks for the CPU.  Raises where ``device`` is a card and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL mesh: pass device='cpu' for gloo")
        torch.cuda.set_device(dev.index or 0)
        backend = "nccl"
    else:
        backend = "gloo"
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="ude_pg_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def ensemble_mesh(n_devices: Optional[int] = None, axis: str = ENSEMBLE_AXIS,
                  device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (default: every rank).

    Without a process group, starts a one-rank group first
    (:func:`start_single_rank`), so one device works without a launcher.
    ``device``, where given, must match the group's device type.
    ``n_devices`` below the world size takes the first ranks as a subgroup
    (every rank must make the call); above it raises."""
    if not dist.is_initialized():
        start_single_rank(device)
    dev_type = group_device_type()
    if device is not None and torch.device(device).type != dev_type:
        raise ValueError(f"a {torch.device(device).type} mesh asked of a {dev_type} process "
                         f"group ({dist.get_backend()})")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks")
    return Mesh(DeviceMesh(dev_type, list(range(n)), mesh_dim_names=(axis,)), axis)


def _local_rows(x, mesh):
    sizes = split_sizes(x.shape[0], mesh.size)
    lo = sum(sizes[:mesh.index])
    return x[lo:lo + sizes[mesh.index]]


def shard_ensemble(batch, mesh: Mesh, axis: str = ENSEMBLE_AXIS):
    """This rank's contiguous slice of the leading (run/trajectory) axis of
    every leaf; a batch that does not divide by the mesh size gives the
    first ranks one row more (:func:`split_sizes`)."""
    mesh.axis(axis)
    mesh.member()
    leaves, build = tree_flatten(batch)
    for leaf in leaves:
        mesh.check(leaf, "batch")
    return build([_local_rows(leaf, mesh) for leaf in leaves])


def replicate(params, mesh: Mesh):
    """The parameters as the mesh's first rank holds them, on every rank of
    the mesh (one broadcast per leaf)."""
    mesh.member()
    leaves, build = tree_flatten(params)
    out = []
    for leaf in leaves:
        mesh.check(leaf, "parameter")
        buf = leaf.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
        out.append(buf)
    return build(out)
