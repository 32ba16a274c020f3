"""Fused universal-PDE right-hand side: reaction MLP + periodic 3-tap stencil.

``out[i] = MLP(u[i]) + d0 · (taps₀·u[i−1] + taps₁·u[i] + taps₂·u[i+1])`` with a
periodic wrap, where ``MLP`` is pointwise, 1→h₁→…→1, tanh on the hidden
layers and identity on the output, with weights given as (h_in, h_out)
matrices.  It is the Fisher-KPP model's RHS, evaluated at every RK stage.

* :func:`fused_updet_rhs` is the wrapper.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/updet_rhs.cu`` (built for ``sm_90a`` by
  :mod:`._build`) or raises; it never falls back.  On a CPU tensor it
  computes :func:`updet_rhs_torch`, the plain version.
* :func:`updet_rhs_torch` is the line-for-line counterpart of the JAX
  package's ``updet_rhs_xla``.
* :class:`FusedUpdetRHS` makes the kernel trainable, as the JAX package's
  ``custom_jvp`` ``fused_updet_rhs_diff`` does: the kernel computes the
  primal, and the JVP and VJP are PyTorch math.  Its ``vmap`` rule sends a
  batch of states to the kernel as rows.
* ``launches`` counts kernel launches: the wrapper adds one after each
  launch and nowhere else.

The kernel replaces ``universal_differential_equations_tpu/ops/pallas_stencil.py``
``_kernel`` and ``_kernel_gridded``.  Those two exist because of the TPU's
(8, 128) tiling and its VMEM budget; on Hopper one launch over a grid of
thread blocks takes any N and any number of rows.  It is bound by f32
arithmetic and ``tanhf`` at large N (about 840 FLOP per point for the
1→10→20→10→1 net against 8 bytes of traffic) and by launch latency at the
model's N = 26; ``csrc/updet_rhs.cu`` has the details.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from . import _build

__all__ = [
    "FusedUpdetRHS",
    "fused_updet_rhs",
    "make_pointwise_mlp_params",
    "updet_rhs_torch",
]

# Kernel launches since import.  Read and reset it as ``stencil.launches``:
# ``from ... import launches`` copies the integer.
launches = 0


def make_pointwise_mlp_params(generator, sizes: Sequence[int], dtype=torch.float32,
                              device=None):
    """Glorot-uniform weights (h_in, h_out) and zero biases for a pointwise
    MLP with widths like (1, 10, 20, 10, 1), drawn on the CPU from
    ``generator`` and moved to ``device``."""
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lim = math.sqrt(6.0 / (n_in + n_out))
        w = (2.0 * torch.rand((n_in, n_out), generator=generator, dtype=torch.float64) - 1.0) * lim
        params.append((w.to(dtype=dtype, device=device),
                       torch.zeros((n_out,), dtype=dtype, device=device)))
    return params


def updet_rhs_torch(u, taps, d0, mlp_params):
    """Plain PyTorch version; ``u`` is (N,) or (rows, N), each row periodic."""
    h = u[..., None]
    for i, (w, b) in enumerate(mlp_params):
        h = h @ w + b
        if i < len(mlp_params) - 1:
            h = torch.tanh(h)
    rx = h[..., 0]
    conv = taps[0] * torch.roll(u, 1, -1) + taps[1] * u + taps[2] * torch.roll(u, -1, -1)
    return rx + d0 * conv


def _check(u, taps, d0, mlp_params) -> List[int]:
    """Validate shapes, dtypes and devices; return the layer widths."""
    if not isinstance(u, torch.Tensor) or u.ndim not in (1, 2) or u.shape[-1] < 1:
        raise ValueError(f"u must be a (N,) or (rows, N) tensor, got shape "
                         f"{tuple(getattr(u, 'shape', ()))}")
    if not u.is_floating_point():
        raise TypeError(f"u must be floating point, got {u.dtype}")
    if tuple(taps.shape) != (3,):
        raise ValueError(f"taps must have shape (3,), got {tuple(taps.shape)}")
    if d0.numel() != 1 or d0.ndim > 1:
        raise ValueError(f"d0 must be a scalar, got shape {tuple(d0.shape)}")
    if not mlp_params:
        raise ValueError("mlp_params must hold at least one (w, b) layer")
    sizes = [1]
    for w, b in mlp_params:
        if w.ndim != 2 or w.shape[0] != sizes[-1] or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not chain: w {tuple(w.shape)}, b {tuple(b.shape)} "
                f"after width {sizes[-1]}")
        sizes.append(w.shape[1])
    if sizes[-1] != 1:
        raise ValueError(f"the last layer must have one output, got {sizes[-1]}")
    tensors = [taps, d0] + [t for wb in mlp_params for t in wb]
    for t in tensors:
        if t.dtype != u.dtype:
            raise TypeError(f"all inputs must share u's dtype {u.dtype}, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"all inputs must be on u's device {u.device}, got {t.device}")
    return sizes


def _launch(u, taps, d0, mlp_params, sizes):
    global launches
    if u.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("the CUDA kernel needs a contiguous u")
    lib = _build.load()
    _, max_layers, max_width, max_packed = lib.limits
    n_layers = len(sizes) - 1
    if n_layers > max_layers or max(sizes) > max_width:
        raise ValueError(f"the CUDA kernel takes at most {max_layers} layers of width "
                         f"<= {max_width}, got widths {sizes}")
    rows = 1 if u.ndim == 1 else u.shape[0]
    if not 1 <= rows <= 65535:
        raise ValueError(f"the CUDA kernel takes 1..65535 rows, got {rows}")
    packed = torch.cat([taps.reshape(3), d0.reshape(1)]
                       + [t.reshape(-1) for wb in mlp_params for t in wb])
    if packed.numel() > max_packed:
        raise ValueError(f"the CUDA kernel takes at most {max_packed} packed "
                         f"parameters, got {packed.numel()}")
    out = torch.empty_like(u)
    widths = (ctypes.c_int * len(sizes))(*sizes)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = lib.ude_updet_rhs(u.data_ptr(), out.data_ptr(), packed.data_ptr(),
                               packed.numel(), widths, n_layers, u.shape[-1], rows,
                               stream)
    if rc != 0:
        raise RuntimeError(f"updet_rhs kernel launch failed: "
                           f"{lib.ude_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


def fused_updet_rhs(u, taps, d0, mlp_params):
    """Fused reaction+stencil RHS.  ``u``: (N,) or (rows, N); ``taps``: (3,);
    ``d0``: scalar; ``mlp_params``: list of (w (h_in, h_out), b (h_out,)).

    A CUDA ``u`` (float32, contiguous) goes to the kernel; a CPU ``u`` to
    :func:`updet_rhs_torch`.  Anything else raises.
    """
    sizes = _check(u, taps, d0, mlp_params)
    if u.device.type == "cpu":
        return updet_rhs_torch(u, taps, d0, mlp_params)
    if not u.is_cuda:
        raise ValueError(f"no kernel for device {u.device}")
    return _launch(u, taps, d0, mlp_params, sizes)


# ---------------------------------------------------------------------------
# derivatives: PyTorch math, as the JAX package's tangent rule is XLA math
# ---------------------------------------------------------------------------
def _pairs(flat) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return list(zip(flat[0::2], flat[1::2]))


def updet_rhs_jvp(u, taps, d0, mlp_params, du, dtaps, dd0, dmlp_params):
    """Tangent of :func:`updet_rhs_torch` along (du, dtaps, dd0, dmlp_params)."""
    h, dh = u[..., None], du[..., None]
    n = len(mlp_params)
    for i, ((w, b), (dw, db)) in enumerate(zip(mlp_params, dmlp_params)):
        z = h @ w + b
        dz = dh @ w + h @ dw + db
        if i < n - 1:
            h = torch.tanh(z)
            dh = (1 - h * h) * dz
        else:
            h, dh = z, dz
    left, right = torch.roll(u, 1, -1), torch.roll(u, -1, -1)
    conv = taps[0] * left + taps[1] * u + taps[2] * right
    dconv = (dtaps[0] * left + dtaps[1] * u + dtaps[2] * right
             + taps[0] * torch.roll(du, 1, -1) + taps[1] * du
             + taps[2] * torch.roll(du, -1, -1))
    return dh[..., 0] + dd0 * conv + d0 * dconv


def updet_rhs_vjp(u, taps, d0, mlp_params, g):
    """Cotangents of :func:`updet_rhs_torch` for output cotangent ``g``:
    ``(gu, gtaps, gd0, [(gw, gb), ...])``."""
    hs = [u[..., None]]
    n = len(mlp_params)
    for i, (w, b) in enumerate(mlp_params):
        z = hs[-1] @ w + b
        hs.append(torch.tanh(z) if i < n - 1 else z)
    left, right = torch.roll(u, 1, -1), torch.roll(u, -1, -1)
    conv = taps[0] * left + taps[1] * u + taps[2] * right
    gc = d0 * g
    gtaps = torch.stack([(gc * left).sum(), (gc * u).sum(), (gc * right).sum()])
    gd0 = (g * conv).sum().reshape(d0.shape)
    gu = taps[0] * torch.roll(gc, -1, -1) + taps[1] * gc + taps[2] * torch.roll(gc, 1, -1)
    gh = g[..., None]
    gmlp = []
    for i in range(n - 1, -1, -1):
        w = mlp_params[i][0]
        gz = gh if i == n - 1 else gh * (1 - hs[i + 1] * hs[i + 1])
        gz2 = gz.reshape(-1, w.shape[1])
        gmlp.append((hs[i].reshape(-1, w.shape[0]).T @ gz2, gz2.sum(0)))
        gh = gz @ w.T
    gmlp.reverse()
    return gu + gh[..., 0], gtaps, gd0, gmlp


class FusedUpdetRHS(torch.autograd.Function):
    """Trainable fused RHS: ``FusedUpdetRHS.apply(u, taps, d0, w0, b0, w1, b1, ...)``.

    The counterpart of the JAX package's ``fused_updet_rhs_diff``: the
    primal is :func:`fused_updet_rhs` (the kernel on CUDA), the JVP and the
    VJP are the PyTorch math of :func:`updet_rhs_torch`.  Written in the
    ``setup_context`` style so ``torch.func`` transforms (``jacfwd``,
    ``jvp``, ``grad``, ``vmap``) work through it.
    """

    @staticmethod
    def forward(u, taps, d0, *flat_params):
        return fused_updet_rhs(u, taps, d0, _pairs(flat_params))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        # absent tangents are zero; present ones take the primal's dtype (a
        # float64 tangent on a float32 primal would fail the matmuls)
        tangents = [torch.zeros_like(p) if t is None else t.to(p.dtype)
                    for p, t in zip(primals, tangents)]
        u, taps, d0, *flat = primals
        du, dtaps, dd0, *dflat = tangents
        return updet_rhs_jvp(u, taps, d0, _pairs(flat), du, dtaps, dd0, _pairs(dflat))

    @staticmethod
    def backward(ctx, g):
        u, taps, d0, *flat = ctx.saved_tensors
        gu, gtaps, gd0, gmlp = updet_rhs_vjp(u, taps, d0, _pairs(flat), g)
        return (gu, gtaps, gd0, *[t for wb in gmlp for t in wb])

    @staticmethod
    def vmap(info, in_dims, u, taps, d0, *flat_params):
        # The ctypes launch cannot see through functorch's wrapped tensors, so
        # a batch of states goes to the kernel as its rows.  Per-row weights
        # have no kernel.
        if in_dims[0] is None or any(d is not None for d in in_dims[1:]):
            raise NotImplementedError(
                "FusedUpdetRHS batches over the state u only; got batched "
                f"inputs at in_dims={in_dims}")
        ub = u.movedim(in_dims[0], 0)
        out = FusedUpdetRHS.apply(ub.reshape(-1, ub.shape[-1]).contiguous(), taps, d0,
                                  *flat_params)
        return out.reshape(ub.shape), 0
