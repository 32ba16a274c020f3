"""The collectives that XLA inserts implicitly in the JAX package.

Under ``jax.sharding`` the JAX package never names a collective: GSPMD adds
the ``psum`` of a loss over sharded lanes, the gradient ``psum`` of
replicated parameters, the gathers of lane results, the halo exchanges of a
rolled stencil on a sharded field and the transposes of a sharded FFT.  The
port's consumers call them here, on a :class:`~.mesh.Mesh`:

* :func:`psum`: a sum across the mesh's ranks that autograd, ``torch.func``'s
  transforms and forward mode go through (forward ``all_reduce``, backward
  identity: each rank differentiates its own share);
* :func:`grad_psum`: its partner on replicated parameters (forward
  identity, backward ``all_reduce``), so the gradient of a ``psum``-ed loss
  is the global one on every rank;
* :func:`all_gather`: lane results back to the global batch, in rank order
  (backward: this rank's rows of the incoming gradient);
* :func:`all_max`, :func:`halo_x` and :func:`transpose` for the x-slab
  domain decomposition of the climate generators.

Each checks that its tensors live on the mesh's device type.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..flatten_util import tree_flatten, tree_flatten_with_path
from .mesh import split_sizes

__all__ = ["psum", "grad_psum", "all_gather", "gather_tree", "all_max", "halo_x", "transpose"]


def _dense(x):
    return x.clone(memory_format=torch.contiguous_format)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = _dense(x)
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, tx, _):
        # through apply: under jacfwd the tangent is batched, and the vmap
        # rule below carries it
        return _PSum.apply(tx, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _all_reduce(x, group), in_dims[0]


class _GradPSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None

    @staticmethod
    def jvp(ctx, tx, _):
        return tx

    @staticmethod
    def vmap(info, in_dims, x, group):
        return x.clone(), in_dims[0]


def psum(x, mesh):
    """``x`` summed over the mesh's ranks; differentiable as a sum of the
    ranks' shares (the backward passes each rank its share's gradient)."""
    mesh.check(x)
    return _PSum.apply(x, mesh.group)


def grad_psum(tree, mesh):
    """Replicated parameters, unchanged, whose gradients are summed over the
    mesh's ranks: use them where every rank computes its share of a loss
    that :func:`psum` adds up.  Leaves that are not tensors pass through."""
    pairs, build = tree_flatten_with_path(tree)
    out = []
    for _, leaf in pairs:
        if isinstance(leaf, torch.Tensor):
            mesh.check(leaf, "parameter")
            leaf = _GradPSum.apply(leaf, mesh.group)
        out.append(leaf)
    return build(out)


def _gather_rows(x, mesh, sizes):
    """Rows of every rank (``sizes[j]`` from rank ``j``) in rank order; the
    ranks' blocks are padded to the largest for the one ``all_gather``."""
    big = max(sizes)
    buf = x.new_zeros((big,) + tuple(x.shape[1:]))
    buf[:x.shape[0]] = x
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, sizes):
        if x.dtype == torch.bool:
            return _gather_rows(x.to(torch.uint8), mesh, sizes).to(torch.bool)
        return _gather_rows(x, mesh, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, mesh, sizes = inputs
        ctx.lo, ctx.n = sum(sizes[:mesh.index]), sizes[mesh.index]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.n], None, None


def all_gather(x, mesh, n_global=None):
    """The global batch from each rank's rows of ``x`` (leading axis), in
    rank order, on every rank.  ``n_global`` (default: this rank's rows times
    the mesh size) fixes the ranks' row counts as :func:`~.mesh.split_sizes`
    deals them."""
    mesh.check(x)
    n_global = x.shape[0] * mesh.size if n_global is None else n_global
    sizes = split_sizes(n_global, mesh.size)
    if sizes[mesh.member()] != x.shape[0]:
        raise ValueError(f"rank {mesh.index} holds {x.shape[0]} rows of {n_global}; "
                         f"expected {sizes[mesh.index]}")
    return _AllGather.apply(x, mesh, sizes)


def gather_tree(tree, mesh, n_global=None):
    """:func:`all_gather` of every leaf of a tree."""
    leaves, build = tree_flatten(tree)
    return build([all_gather(leaf, mesh, n_global) for leaf in leaves])


def all_max(x, mesh):
    """Element-wise maximum over the mesh's ranks (no gradient)."""
    mesh.check(x)
    return _all_reduce(x.detach(), mesh.group, dist.ReduceOp.MAX)


def halo_x(fields, mesh):
    """Each field's x-neighbour planes on an x-slab decomposition: for
    fields of shape (nx, ...) holding this rank's planes of a periodic x
    axis, returns ``[(left, right), ...]`` with ``left`` the plane before
    the slab (the left neighbour's last) and ``right`` the plane after it
    (the right neighbour's first), each (1, ...).  One ``all_to_all`` for
    all fields: each rank sends its first planes to its left neighbour and
    its last planes to its right one (to itself, on a one-rank mesh)."""
    me, n = mesh.member(), mesh.size
    left, right = (me - 1) % n, (me + 1) % n
    first = torch.stack([f[0] for f in fields])
    last = torch.stack([f[-1] for f in fields])
    mesh.check(first, "field")
    plane = first.numel()
    send, in_sizes, out_sizes = [], [], []
    for j in range(n):
        blocks = ([first] if j == left else []) + ([last] if j == right else [])
        send += [b.reshape(-1) for b in blocks]
        in_sizes.append(plane * len(blocks))
        # from j: its first planes if j is my right neighbour, then its last
        # planes if j is my left one (the order j sends them in)
        out_sizes.append(plane * ((j == right) + (j == left)))
    recv = first.new_empty(sum(out_sizes))
    dist.all_to_all_single(recv, torch.cat(send), out_sizes, in_sizes, group=mesh.group)
    blocks = torch.split(recv, out_sizes)
    from_right = blocks[right][:plane].view_as(first)
    from_left = blocks[left][-plane:].view_as(first)
    return [(from_left[i:i + 1], from_right[i:i + 1]) for i in range(len(fields))]


def transpose(x, mesh, split_dim, gather_dim, split=None, gathered=None):
    """All-to-all transpose of a block-distributed tensor.

    ``x`` holds this rank's block along ``gather_dim`` and the whole of
    ``split_dim``; returns this rank's part of ``split_dim`` with the whole
    of ``gather_dim``, the ranks' blocks in rank order.  ``split`` gives the
    ranks' parts of ``split_dim`` (default :func:`~.mesh.split_sizes`),
    ``gathered`` the ranks' blocks along ``gather_dim`` (default: every rank
    holds as many as this one).  Dimensions count from 0; complex tensors
    travel as their real views."""
    mesh.check(x)
    me, n = mesh.member(), mesh.size
    split_dim, gather_dim = split_dim % x.ndim, gather_dim % x.ndim
    complex_in = x.is_complex()
    xr = torch.view_as_real(x) if complex_in else x
    split = split_sizes(x.shape[split_dim], n) if split is None else list(split)
    gathered = [x.shape[gather_dim]] * n if gathered is None else list(gathered)
    pieces = torch.split(xr, split, dim=split_dim)
    send = torch.cat([p.reshape(-1) for p in pieces])
    shapes = []
    for j in range(n):
        shape = list(xr.shape)
        shape[split_dim], shape[gather_dim] = split[me], gathered[j]
        shapes.append(shape)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    recv = xr.new_empty(sum(sizes))
    dist.all_to_all_single(recv, send, sizes, [p.numel() for p in pieces], group=mesh.group)
    out = torch.cat([r.view(s) for r, s in zip(recv.split(sizes), shapes)], dim=gather_dim)
    return torch.view_as_complex(out) if complex_in else out
