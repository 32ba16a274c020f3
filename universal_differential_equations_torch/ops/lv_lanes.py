"""Loss and gradient of the Lotka-Volterra noise study's lanes: one CUDA kernel.

Each lane is the scenario-1 UDE ``du1 = α·u1 + NN1(u)``, ``du2 = −δ·u2 +
NN2(u)`` with the 2→5→5→5→2 Gaussian-RBF net on the lane's own 87 parameters
(the flat layout of ``ravel_pytree(params0)``), solved by fixed-step Tsit5
from its first sample, ``sub`` steps per sample interval, and scored by the
mean of its squared residuals at the samples.  ``examples/run_loops.py``'s
``loss_and_grad`` computes each lane's loss and its gradient by autograd
through ``torch.func.vmap`` of ``integrate_fixed``; here the same numbers
come from:

* :class:`LaneLossGrad`, the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/lv_lanes.cu`` (built for ``sm_90a`` by
  :mod:`._build`): per lane the forward solve, the states it passes
  through, and the discrete adjoint of the same scheme back through them, in
  one launch for every lane.  It checks the net, the tensors' device, dtype,
  contiguity and shapes and raises on anything else (CPU tensors too); it
  never falls back.
* :func:`lanes_torch`, the plain PyTorch twin: the kernel's arithmetic over
  a lane batch, the forward solve with its states kept and the reverse sweep
  written out (each step's stages recomputed from its state, then the net's
  VJP at each stage, last stage first).
* :func:`tsit5_coefficients`, Tsit5's stage weights times the step, formed
  as ``integrate_fixed`` forms them, which both take.

``launches`` counts the wrapper's kernel launches (one a call, the one a CUDA
graph captures included; the graph's replays are not calls).
"""
from __future__ import annotations

import ctypes

import torch

from ..nn.layers import Dense, rbf
from ..solvers.tableaus import TABLEAUS
from . import _build
from .stencil import _device_guard, _raise_on, _stream

__all__ = ["LaneLossGrad", "lanes_torch", "tsit5_coefficients", "WIDTHS", "N_PARAMS"]

WIDTHS = (2, 5, 5, 5, 2)
N_PARAMS = sum(o * i + o for i, o in zip(WIDTHS[:-1], WIDTHS[1:]))  # 87

# Launch count since import.  Read and reset it as ``lv_lanes.launches``.
launches = 0


def tsit5_coefficients(t0, t1, n_steps, dtype=torch.float32):
    """``(a, b)``: Tsit5's stage weights times ``dt = (t1 − t0) / n_steps``,
    as 0-d tensors of ``dtype``, each product rounded as ``integrate_fixed``
    rounds it (``dt`` in ``dtype``, then ``dt * a_ij``).  ``a[i - 1][j]``
    weighs stage ``j`` in stage ``i``'s input (``i = 1 … 5``), ``b[j]`` stage
    ``j`` in the step (``j = 0 … 5``; the seventh stage, weight 0, is the next
    step's first)."""
    tab = TABLEAUS["Tsit5"]
    if not (tab.fsal and tab.num_stages == 7 and tab.b[6] == 0.0 and tab.a[6] == tab.b[:6]):
        raise ValueError("the lane kernel takes Tsit5's FSAL tableau")
    dt = (torch.tensor(t1, dtype=dtype) - torch.tensor(t0, dtype=dtype)) / n_steps
    return [[dt * aij for aij in row] for row in tab.a[1:6]], [dt * bj for bj in tab.b[:6]]


def _layers(theta):
    """(L, 87) → ``[(w (L, out, in), b (L, out)), …]``: per layer the bias,
    then the weight row-major, as ``ravel_pytree`` lays out ``{"b", "w"}``."""
    out, at = [], 0
    for n_in, n_out in zip(WIDTHS[:-1], WIDTHS[1:]):
        b = theta[:, at:at + n_out]
        w = theta[:, at + n_out:at + n_out + n_out * n_in].reshape(-1, n_out, n_in)
        out.append((w, b))
        at += n_out + n_out * n_in
    return out


def lanes_torch(theta, data, alpha, delta, sub, coef):
    """The kernel's arithmetic in plain PyTorch: ``(loss (L,), grad (L,
    87))`` of ``theta`` (L, 87) and ``data`` (L, S, 2) in any float dtype,
    ``coef`` from :func:`tsit5_coefficients` in the same dtype."""
    a, b = coef
    layers = _layers(theta)
    n_lanes, samples, _ = data.shape
    n_steps = (samples - 1) * sub

    def f(u):
        """f(u) for (L, 2) states, and its record (u, h1, a1, h2, a2, h3, a3)."""
        rec, x = [u], u
        for w, bias in layers[:-1]:
            h = (w @ x[..., None])[..., 0] + bias
            x = torch.exp(-(h * h))
            rec += [h, x]
        w, bias = layers[-1]
        o = (w @ x[..., None])[..., 0] + bias
        return torch.stack([alpha * u[:, 0] + o[:, 0], -delta * u[:, 1] + o[:, 1]], -1), rec

    def stages(y, first):
        """Stages 0 … 5 of the step from ``y`` (``first`` = f(y) and its record)."""
        ks, recs = [first[0]], [first[1]]
        for i in range(1, 6):
            u = y
            for j in range(i):
                u = u + a[i - 1][j] * ks[j]
            k, rec = f(u)
            ks.append(k)
            recs.append(rec)
        return ks, recs

    def vjp(rec, v, grads):
        """The cotangent of a stage's input for the cotangent ``v`` of its
        f; the weight terms added to ``grads``."""
        u, h1, a1, h2, a2, h3, a3 = rec
        xs, hs = (u, a1, a2, a3), (h1, h2, h3)
        w, _ = layers[-1]
        gw, gb = grads[-1]
        grads[-1] = (gw + v[:, :, None] * a3[:, None, :], gb + v)
        bx = (w.transpose(1, 2) @ v[..., None])[..., 0]
        for k in (2, 1, 0):
            bh = -2.0 * ((bx * xs[k + 1]) * hs[k])
            gw, gb = grads[k]
            grads[k] = (gw + bh[:, :, None] * xs[k][:, None, :], gb + bh)
            bx = (layers[k][0].transpose(1, 2) @ bh[..., None])[..., 0]
        return bx + torch.stack([alpha * v[:, 0], -delta * v[:, 1]], -1)

    # forward: the solve, every state kept
    y = data[:, 0]
    ys = [y]
    first = f(y)
    for _ in range(n_steps):
        ks, _ = stages(y, first)
        for j in range(6):
            y = y + b[j] * ks[j]
        ys.append(y)
        first = f(y)
    r = torch.stack(ys, 1)[:, ::sub] - data
    loss = (r * r).reshape(n_lanes, -1).mean(-1)

    # reverse: the adjoint of each state, from the last back
    weight = torch.ones((), dtype=data.dtype) / (2 * samples)
    seeds = 2.0 * (weight * r)
    grads = [(torch.zeros_like(w), torch.zeros_like(bias)) for w, bias in layers]
    lam = seeds[:, -1]
    for n in range(n_steps - 1, -1, -1):
        ks, recs = stages(ys[n], f(ys[n]))
        bk = [b[j] * lam for j in range(6)]
        by = lam
        for i in range(5, -1, -1):
            bu = vjp(recs[i], bk[i], grads)
            by = by + bu
            for j in range(i):
                bk[j] = bk[j] + a[i - 1][j] * bu
        lam = by
        if n > 0 and n % sub == 0:
            lam = lam + seeds[:, n // sub]
    grad = torch.cat([t for gw, gb in grads for t in (gb, gw.reshape(n_lanes, -1))], dim=1)
    return loss, grad


def _check_net(net):
    layers = getattr(net, "layers", None)
    if not layers or not all(isinstance(layer, Dense) for layer in layers):
        raise ValueError("the lane kernel takes an MLP, a chain of Dense layers")
    sizes = (layers[0].in_size,) + tuple(layer.out_size for layer in layers)
    if sizes != WIDTHS:
        raise ValueError(f"the lane kernel takes widths {WIDTHS}, got {sizes}")
    hidden = {layer.activation for layer in layers[:-1]}
    if not hidden <= {"rbf", rbf} or layers[-1].activation != "identity":
        raise ValueError("the lane kernel takes exp(-x^2) on the hidden layers and identity "
                         f"on the output, got {[layer.activation for layer in layers]}")
    if not all(layer.use_bias for layer in layers):
        raise ValueError("the lane kernel takes a bias on every layer")


class LaneLossGrad:
    """``(theta (L, 87), data (L, S, 2)) → (loss (L,), grad (L, 87))`` for
    the scenario-1 UDE on ``net`` (2→5→5→5→2, exp(−x²) hidden, identity
    out, with bias) with known rates ``alpha`` and ``delta``, integrated
    over ``(t0, t1)`` in ``(S − 1)·sub`` fixed Tsit5 steps; float32."""

    def __init__(self, net, alpha, delta, t0, t1, sub):
        _check_net(net)
        self.alpha, self.delta = float(alpha), float(delta)
        self.t0, self.t1, self.sub = float(t0), float(t1), int(sub)
        self._coef = {}  # samples -> the 21 coefficients as floats for the kernel

    def _check(self, theta, data):
        if not (isinstance(theta, torch.Tensor) and isinstance(data, torch.Tensor)):
            raise TypeError("theta and data must be tensors")
        if theta.dtype != torch.float32 or data.dtype != torch.float32:
            raise TypeError(f"the lane kernel takes float32, got {theta.dtype} and {data.dtype}")
        if theta.ndim != 2 or theta.shape[1] != N_PARAMS or theta.shape[0] < 1:
            raise ValueError(f"theta must be (lanes, {N_PARAMS}), got {tuple(theta.shape)}")
        if data.ndim != 3 or data.shape[0] != theta.shape[0] or data.shape[2] != 2 \
                or data.shape[1] < 2:
            raise ValueError(f"data must be ({theta.shape[0]}, samples >= 2, 2), got "
                             f"{tuple(data.shape)}")
        if not (theta.is_contiguous() and data.is_contiguous()):
            raise ValueError("the lane kernel needs contiguous theta and data")
        if theta.device != data.device or theta.device.type != "cuda":
            raise ValueError(f"the lane kernel takes theta and data on one CUDA device, got "
                             f"{theta.device} and {data.device}")

    def __call__(self, theta, data):
        global launches
        self._check(theta, data)
        lanes, samples, _ = data.shape
        if samples not in self._coef:
            a, b = tsit5_coefficients(self.t0, self.t1, (samples - 1) * self.sub)
            flat = [float(c) for row in a for c in row] + [float(c) for c in b]
            self._coef[samples] = (ctypes.c_float * len(flat))(*flat)
        lib = _build.load()
        max_steps = lib.lv_max_steps
        if (samples - 1) * self.sub > max_steps:
            raise ValueError(f"the lane kernel takes at most {max_steps} steps, got "
                             f"{(samples - 1) * self.sub}")
        loss = torch.empty(lanes, dtype=theta.dtype, device=theta.device)
        grad = torch.empty_like(theta)
        with _device_guard(theta.device):
            rc = lib.ude_lv_lanes(theta.data_ptr(), data.data_ptr(), loss.data_ptr(),
                                  grad.data_ptr(), lanes, samples, self.sub, self.alpha,
                                  self.delta, self._coef[samples], _stream(theta.device))
        _raise_on(lib, rc, "lv_lanes")
        launches += 1
        return loss, grad
