"""Fused universal-PDE right-hand side: reaction MLP + periodic 3-tap stencil.

``out[i] = MLP(u[i]) + d0 · (taps₀·u[i−1] + taps₁·u[i] + taps₂·u[i+1])`` with a
periodic wrap, where ``MLP`` is pointwise, 1→h₁→…→1, tanh on the hidden
layers and identity on the output, with weights given as (h_in, h_out)
matrices.  It is the Fisher-KPP model's RHS, evaluated at every RK stage.

* :func:`fused_updet_rhs` is the wrapper of kernel A, the RHS itself.  On a
  CUDA tensor it launches the hand-written kernel ``csrc/updet_rhs.cu``
  (built for ``sm_90a`` by :mod:`._build`) or raises; it never falls back.
  On a CPU tensor it computes :func:`updet_rhs_torch`, the plain version.
* :func:`fused_updet_rhs_tangent` is the wrapper of kernel B, the RHS's JVP
  for T directions in one launch; its plain version is :func:`updet_rhs_jvp`.
* :func:`updet_rhs_torch` is the line-for-line counterpart of the JAX
  package's ``updet_rhs_xla``; :func:`updet_rhs_jvp` is ``jax.jvp`` of it.
* :class:`FusedUpdetRHS` makes the kernel trainable, as the JAX package's
  ``custom_jvp`` ``fused_updet_rhs_diff`` does: kernel A computes the
  primal; its JVP is the operator :func:`updet_tangent`, whose ``vmap``
  rule hands the whole tangent block of ``torch.func.jacfwd`` to kernel B in
  one launch (PyTorch math where the JVP is itself differentiated); the VJP
  is PyTorch math.  Its own ``vmap`` rule sends a batch of states to
  kernel A as rows.
* The widths listed in the kernel source (``UDE_NETS``: the four reaction
  nets of ``models/fisher_kpp.py``) run kernels compiled for them; other
  widths run the kernels' runtime-width versions.  Dispatch reads the
  compiled list from the library (``_library().nets``).
* ``launches`` counts kernel A's launches, ``tangent_launches`` kernel B's,
  and ``generic_launches`` those of either that took the runtime-width
  version.  Each wrapper adds one where it launches and nowhere else.

The kernels replace ``universal_differential_equations_tpu/ops/pallas_stencil.py``
``_kernel`` and ``_kernel_gridded`` (kernel A) and the tangent rule
``_fused_rhs_jvp`` (kernel B).  ``csrc/updet_rhs.cu`` says what bounds them on
an H100 and what the design does about it.
"""
from __future__ import annotations

import array
import contextlib
import ctypes
import math
from typing import List, Sequence, Tuple

import torch
from torch._C import _functorch

from . import _build

__all__ = [
    "FusedUpdetRHS",
    "fused_updet_rhs",
    "fused_updet_rhs_tangent",
    "make_pointwise_mlp_params",
    "updet_rhs_jvp",
    "updet_rhs_torch",
    "updet_tangent",
]

# Launch counts since import.  Read and reset them as ``stencil.launches``
# etc.: ``from ... import launches`` copies the integer.
launches = 0
tangent_launches = 0
generic_launches = 0


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


def updet_rhs_jvp(u, taps, d0, mlp_params, du, dtaps, dd0, dmlp_params):
    """Tangent of :func:`updet_rhs_torch` along (du, dtaps, dd0, dmlp_params).

    The tangents have the primals' shapes (one direction), or all carry one
    leading dimension of T directions; the result then is (T, *u.shape).
    """
    lead = du.ndim - u.ndim
    if lead not in (0, 1):
        raise ValueError(f"du must have u's shape or one leading dimension more, got "
                         f"{tuple(du.shape)} for u {tuple(u.shape)}")

    def lift(a, point_dims):
        # a direction's values against the point dimensions: (T, *rest) ->
        # (T, 1 x point_dims, *rest)
        return a.reshape(a.shape[:1] + (1,) * point_dims + a.shape[1:]) if lead else a

    h, dh = u[..., None], du[..., None]
    n = len(mlp_params)
    for i, ((w, b), (dw, db)) in enumerate(zip(mlp_params, dmlp_params)):
        z = h @ w + b
        dz = dh @ w + h @ lift(dw, u.ndim - 1) + lift(db, u.ndim)
        if i < n - 1:
            h = torch.tanh(z)
            dh = (1 - h * h) * dz
        else:
            h, dh = z, dz
    left, right = torch.roll(u, 1, -1), torch.roll(u, -1, -1)
    conv = taps[0] * left + taps[1] * u + taps[2] * right
    dt = [lift(dtaps[..., k], u.ndim) for k in range(3)]
    dconv = (dt[0] * left + dt[1] * u + dt[2] * right
             + taps[0] * torch.roll(du, 1, -1) + taps[1] * du
             + taps[2] * torch.roll(du, -1, -1))
    dd0 = lift(dd0.reshape(dd0.shape[:lead]), u.ndim) if lead else dd0
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


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------
def _same_kind(u, tensors):
    for t in tensors:
        if t.dtype != u.dtype:
            raise TypeError(f"all inputs must share u's dtype {u.dtype}, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"all inputs must be on u's device {u.device}, got {t.device}")


def _check(u, taps, d0, mlp_params) -> Tuple[int, ...]:
    """Validate shapes, dtypes and devices; return the layer widths."""
    if not isinstance(u, torch.Tensor) or u.ndim not in (1, 2) or u.shape[-1] < 1:
        raise ValueError(f"u must be a (N,) or (rows, N) tensor, got shape "
                         f"{tuple(getattr(u, 'shape', ()))}")
    if not u.is_floating_point():
        raise TypeError(f"u must be floating point, got {u.dtype}")
    if taps.shape != (3,):
        raise ValueError(f"taps must have shape (3,), got {tuple(taps.shape)}")
    if d0.numel() != 1 or d0.ndim > 1:
        raise ValueError(f"d0 must be a scalar, got shape {tuple(d0.shape)}")
    if not mlp_params:
        raise ValueError("mlp_params must hold at least one (w, b) layer")
    sizes = [1]
    for w, b in mlp_params:
        if w.ndim != 2 or w.shape[0] != sizes[-1] or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not chain: w {tuple(w.shape)}, b {tuple(b.shape)} "
                f"after width {sizes[-1]}")
        sizes.append(w.shape[1])
    if sizes[-1] != 1:
        raise ValueError(f"the last layer must have one output, got {sizes[-1]}")
    _same_kind(u, [taps, d0, *(t for wb in mlp_params for t in wb)])
    return tuple(sizes)


def _check_tangent(u, d0, mlp_params, du, dtaps, dd0, dmlp_params) -> int:
    """Validate the tangents against the (checked) primals; return 0 for one
    direction, 1 for a leading dimension of T directions."""
    lead = du.ndim - u.ndim
    if lead not in (0, 1) or du.shape[lead:] != u.shape:
        raise ValueError(f"du must be u's shape {tuple(u.shape)} or (T, *u.shape), got "
                         f"{tuple(du.shape)}")
    if len(dmlp_params) != len(mlp_params):
        raise ValueError(f"{len(dmlp_params)} tangent layers for {len(mlp_params)} layers")
    T = du.shape[:lead]
    pairs = [(dtaps, T + (3,)), (dd0, T + d0.shape)]
    for (w, b), (dw, db) in zip(mlp_params, dmlp_params):
        pairs += [(dw, T + w.shape), (db, T + b.shape)]
    for t, shape in pairs:
        if t.shape != shape:
            raise ValueError(f"tangent of shape {tuple(t.shape)}, expected {tuple(shape)}")
    _same_kind(u, [du] + [t for t, _ in pairs])
    return lead


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------
_C_WIDTHS = {}  # width tuple -> ctypes int array


def _library():
    """The loaded kernel library; ``.nets`` holds its compiled width tuples."""
    return _build.load()


def _stream(device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_guard(device):
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _widths_c(sizes):
    arr = _C_WIDTHS.get(sizes)
    if arr is None:
        arr = _C_WIDTHS[sizes] = (ctypes.c_int * len(sizes))(*sizes)
    return arr


def _primal_args(taps, d0, mlp_params):
    """The kernels' argument array: pointers (taps, d0, W0, b0, ...), then
    element strides (taps, then each layer's W rows, W columns and b)."""
    ptrs = [taps.data_ptr(), d0.data_ptr()]
    strides = [taps.stride(0)]
    for w, b in mlp_params:
        ptrs += (w.data_ptr(), b.data_ptr())
        strides += (*w.stride(), b.stride(0))
    return array.array("q", ptrs + strides)


def _tangent_args(dtaps, dd0, dmlp_params):
    """As :func:`_primal_args` for tangents with a leading T: each tensor's
    strides start with its direction stride."""
    ptrs = [dtaps.data_ptr(), dd0.data_ptr()]
    strides = [*dtaps.stride(), dd0.stride(0)]
    for dw, db in dmlp_params:
        ptrs += (dw.data_ptr(), db.data_ptr())
        strides += (*dw.stride(), *db.stride())
    return array.array("q", ptrs + strides)


def _kernel_net(u, sizes, rows):
    """Checks what every launch needs; returns (library, compiled net index
    or -1 for the runtime-width kernels)."""
    if u.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("the CUDA kernels need a contiguous u")
    if not 1 <= rows <= 65535:
        raise ValueError(f"the CUDA kernels take 1..65535 rows, got {rows}")
    lib = _library()
    try:
        return lib, lib.nets.index(sizes)
    except ValueError:
        pass
    _, max_layers, max_width, max_packed = lib.limits
    n_par = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    if len(sizes) - 1 > max_layers or max(sizes) > max_width or n_par > max_packed:
        raise ValueError(f"the runtime-width CUDA kernels take at most {max_layers} layers of "
                         f"width <= {max_width} and {max_packed} weights and biases, got "
                         f"widths {sizes}")
    return lib, -1


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.ude_error_string(rc).decode()} ({rc})")


def _launch(u, taps, d0, mlp_params, sizes, net=None):
    """Kernel A on a CUDA ``u``; ``net`` overrides the compiled-net index (a
    test hook: a mismatching index must raise, not fall back)."""
    global launches, generic_launches
    rows = 1 if u.ndim == 1 else u.shape[0]
    lib, found = _kernel_net(u, sizes, rows)
    net = found if net is None else net
    args = _primal_args(taps, d0, mlp_params)
    out = torch.empty_like(u)
    with _device_guard(u.device):
        rc = lib.ude_updet_rhs(net, u.data_ptr(), out.data_ptr(), args.buffer_info()[0],
                               _widths_c(sizes), len(sizes) - 1, u.shape[-1], rows,
                               _stream(u.device))
    _raise_on(lib, rc, "updet_rhs")
    launches += 1
    generic_launches += net < 0
    return out


def _launch_tangent(u, taps, d0, mlp_params, sizes, du, dtaps, dd0, dmlp_params, net=None):
    """Kernel B on a CUDA ``u`` and tangents with a leading T."""
    global tangent_launches, generic_launches
    rows = 1 if u.ndim == 1 else u.shape[0]
    lib, found = _kernel_net(u, sizes, rows)
    net = found if net is None else net
    if not du.is_contiguous():
        raise ValueError("the CUDA tangent kernel needs a contiguous du")
    T = du.shape[0]
    if not 1 <= T <= 65535:
        raise ValueError(f"the CUDA tangent kernel takes 1..65535 directions, got {T}")
    args = _primal_args(taps, d0, mlp_params)
    targs = _tangent_args(dtaps, dd0, dmlp_params)
    dout = torch.empty_like(du)
    with _device_guard(u.device):
        rc = lib.ude_updet_rhs_tangent(net, u.data_ptr(), du.data_ptr(), dout.data_ptr(),
                                       args.buffer_info()[0], targs.buffer_info()[0],
                                       _widths_c(sizes), len(sizes) - 1, u.shape[-1], rows,
                                       T, _stream(u.device))
    _raise_on(lib, rc, "updet_rhs tangent")
    tangent_launches += 1
    generic_launches += net < 0
    return dout


def empty_launch(device) -> None:
    """One launch of an empty kernel on ``device``'s current stream: the
    card's launch floor, for measurements."""
    lib = _library()
    with _device_guard(device):
        _raise_on(lib, lib.ude_empty(_stream(device)), "empty")


def fused_updet_rhs(u, taps, d0, mlp_params):
    """Fused reaction+stencil RHS.  ``u``: (N,) or (rows, N); ``taps``: (3,);
    ``d0``: scalar; ``mlp_params``: list of (w (h_in, h_out), b (h_out,)).

    A CUDA ``u`` (float32, contiguous) goes to kernel A; a CPU ``u`` to
    :func:`updet_rhs_torch`.  Anything else raises.
    """
    sizes = _check(u, taps, d0, mlp_params)
    if u.device.type == "cpu":
        return updet_rhs_torch(u, taps, d0, mlp_params)
    if not u.is_cuda:
        raise ValueError(f"no kernel for device {u.device}")
    return _launch(u, taps, d0, mlp_params, sizes)


def fused_updet_rhs_tangent(u, taps, d0, mlp_params, du, dtaps, dd0, dmlp_params):
    """JVP of the fused RHS along (du, dtaps, dd0, dmlp_params), which have the
    primals' shapes (one direction) or all carry a leading dimension of T
    directions (the result is then (T, *u.shape)).

    A CUDA ``u`` goes to kernel B, all directions in one launch (float32;
    ``u`` and ``du`` contiguous, the weights and their tangents at any
    strides); a CPU ``u`` to :func:`updet_rhs_jvp`.  Anything else raises.
    """
    sizes = _check(u, taps, d0, mlp_params)
    lead = _check_tangent(u, d0, mlp_params, du, dtaps, dd0, dmlp_params)
    if u.device.type == "cpu":
        return updet_rhs_jvp(u, taps, d0, mlp_params, du, dtaps, dd0, dmlp_params)
    if not u.is_cuda:
        raise ValueError(f"no kernel for device {u.device}")
    if lead:
        return _launch_tangent(u, taps, d0, mlp_params, sizes, du, dtaps, dd0, dmlp_params)
    one = [(dw[None], db[None]) for dw, db in dmlp_params]
    return _launch_tangent(u, taps, d0, mlp_params, sizes, du[None], dtaps[None],
                           dd0[None], one)[0]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _pairs(flat) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return list(zip(flat[0::2], flat[1::2]))


@torch.library.custom_op("ude_torch::updet_rhs_tangent", mutates_args=())
def updet_tangent(u: torch.Tensor, taps: torch.Tensor, d0: torch.Tensor,
                  params: List[torch.Tensor], du: torch.Tensor, dtaps: torch.Tensor,
                  dd0: torch.Tensor, dparams: List[torch.Tensor]) -> torch.Tensor:
    """One tangent of the fused RHS, ``params``/``dparams`` = [w0, b0, w1, b1, ...]:
    ``FusedUpdetRHS``'s JVP, :func:`fused_updet_rhs_tangent` as an operator.

    Its vmap rule, which ``torch.func.jacfwd`` reaches with the whole block of
    tangents batched and the primals not, sends all T directions to kernel B
    in one launch.  It is an operator rather than a second
    ``autograd.Function`` because ``torch.func`` passes an operator through
    its levels in C++, where a Function's twenty arguments are wrapped and
    unwrapped in Python at each level: on the LM main path that costs ~10 %
    of an iteration (PERF.md).  It has no derivative of its own, so
    ``FusedUpdetRHS.jvp`` calls it only where none is taken.
    """
    return fused_updet_rhs_tangent(u, taps, d0, _pairs(params), du, dtaps, dd0, _pairs(dparams))


@updet_tangent.register_vmap
def _updet_tangent_vmap(info, in_dims, u, taps, d0, params, du, dtaps, dd0, dparams):
    u_d, taps_d, d0_d, params_d, du_d, dtaps_d, dd0_d, dparams_d = in_dims
    if any(d is not None for d in (u_d, taps_d, d0_d, *params_d)):
        raise NotImplementedError(
            "updet_tangent batches over the tangents only; got batched primals at "
            f"in_dims={in_dims[:4]}")
    T = info.batch_size

    def front(t, d):
        # an absent batch dim is the same tangent in every direction: a
        # stride-0 view, which the kernel reads through its strides
        return t.movedim(d, 0) if d is not None else t.expand(T, *t.shape)

    dflat = [front(t, d) for t, d in zip(dparams, dparams_d)]
    out = fused_updet_rhs_tangent(u, taps, d0, _pairs(params), front(du, du_d).contiguous(),
                                  front(dtaps, dtaps_d), front(dd0, dd0_d), _pairs(dflat))
    return out, 0


def _tangent_flat(u, taps, d0, du, dtaps, dd0, *flat):
    """:func:`updet_rhs_jvp` with the weights, then their tangents, flat."""
    half = len(flat) // 2
    return updet_rhs_jvp(u, taps, d0, _pairs(flat[:half]), du, dtaps, dd0, _pairs(flat[half:]))


class _TangentMath(torch.autograd.Function):
    """:func:`_tangent_flat` as a function of its own, with its own PyTorch
    math as derivatives: the fused RHS's JVP where that JVP is differentiated.
    Autograd runs a ``jvp`` rule with forward-mode recording off, so the plain
    math would be invisible to a ``jvp`` transform outside; a function's
    ``forward`` and ``jvp`` run with it back on."""

    generate_vmap_rule = True

    @staticmethod
    def forward(*args):
        return _tangent_flat(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, *tangents):
        inputs = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(x) if t is None else t
                         for x, t in zip(inputs, tangents))
        return torch.func.jvp(_tangent_flat, inputs, tangents)[1]

    @staticmethod
    def backward(ctx, g):
        return torch.func.vjp(_tangent_flat, *ctx.saved_tensors)[1](g)


_DIFFERENTIATING = (_functorch.TransformType.Grad, _functorch.TransformType.Jvp)


def _jvp_is_differentiated(tensors) -> bool:
    """Whether the JVP being computed is itself differentiated: a ``grad`` or
    ``jvp`` transform outside the one that asked for it (``jacrev`` or
    ``jacfwd`` over ``jacfwd``), or autograd recording through its inputs."""
    levels = _functorch.get_interpreter_stack() or ()
    if sum(i.key() in _DIFFERENTIATING for i in levels) > 1:
        return True
    if not torch.is_grad_enabled():
        return False
    for t in tensors:
        # autograd's flag sits on the tensor under the transforms' wrappers
        while _functorch.is_functorch_wrapped_tensor(t):
            t = _functorch.get_unwrapped(t)
        if t.requires_grad:
            return True
    return False


class FusedUpdetRHS(torch.autograd.Function):
    """Trainable fused RHS: ``FusedUpdetRHS.apply(u, taps, d0, w0, b0, w1, b1, ...)``.

    The counterpart of the JAX package's ``fused_updet_rhs_diff``: the
    primal is :func:`fused_updet_rhs` (kernel A on CUDA), the JVP is
    :func:`updet_tangent` (kernel B on CUDA), and the VJP is the PyTorch
    math of :func:`updet_rhs_vjp`.  Written in the ``setup_context`` style
    so ``torch.func`` transforms (``jacfwd``, ``jvp``, ``grad``, ``vmap``)
    work through it.  Where the JVP is itself differentiated (``jacrev`` or
    ``jacfwd`` over ``jacfwd``, or autograd through a ``jacfwd``), it is the
    PyTorch math of :func:`updet_rhs_jvp`, as the JAX package's tangent rule
    is XLA math; kernel B has no derivative.
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
        # float64 tangent on a float32 primal would fail the kernel's checks)
        u, taps, d0, *flat = primals
        tangents_ = [torch.zeros_like(p) if t is None else t if t.dtype == p.dtype
                     else t.to(p.dtype) for p, t in zip(primals, tangents)]
        du, dtaps, dd0, *dflat = tangents_
        if _jvp_is_differentiated((*primals, *tangents_)):
            # kernel B has no derivative: the plain JVP, which has one
            return _TangentMath.apply(u, taps, d0, du, dtaps, dd0, *flat, *dflat)
        return updet_tangent(u, taps, d0, flat, du, dtaps, dd0, dflat)

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
