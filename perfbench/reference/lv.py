"""Plain reference of the Lotka-Volterra scenario-1 UDE and its study's lanes.

``du1 = α·u1 + NN1(u)``, ``du2 = −δ·u2 + NN2(u)``, NN a Gaussian-RBF
(``exp(−x²)``) MLP whose widths the configuration gives; each lane is one
such model with its own weights and its own noisy series, solved by
fixed-step Tsit5 from its first sample, ``substeps`` steps per sample
interval, and scored by the mean squared residual at the samples.

Plain PyTorch on whatever device its inputs are on, batched over lanes with
explicit per-lane weights; it imports nothing of the program.  Also here:
the truth series that the benchmark noises into lane data (float64 RK4 on
the host), and the layout of a lane's flat parameter vector.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tsit5
from .precision import product


def truth(cfg, fine=100):
    """(samples, 2) float64 Lotka-Volterra truth at the sample times:
    classical RK4 with ``fine`` steps per sample interval."""
    a, b, c, d = cfg["p_true"]

    def f(u):
        x, y = u
        return np.array([a * x - b * x * y, c * x * y - d * y])

    h = cfg["dt_save"] / fine
    u = np.array(cfg["u0"], dtype=np.float64)
    out = [u]
    for _ in range(cfg["samples"] - 1):
        for _ in range(fine):
            k1 = f(u)
            k2 = f(u + 0.5 * h * k1)
            k3 = f(u + 0.5 * h * k2)
            k4 = f(u + h * k3)
            u = u + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(u)
    return np.stack(out)


def layout(widths):
    """``[(layer, name, shape), ...]`` in the order of a lane's flat
    parameter vector: per layer its bias (out,), then its weight (out, in),
    row-major."""
    out = []
    for k, (i, o) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(k, "b", (o,)), (k, "w", (o, i))]
    return out


def n_params(widths):
    return sum(int(np.prod(s)) for _, _, s in layout(widths))


def unflatten(theta, widths):
    """(L, P) → ``[(W (L, out, in), b (L, out)), ...]`` per layer."""
    layers, at = {}, 0
    for k, name, shape in layout(widths):
        n = int(np.prod(shape))
        layers.setdefault(k, {})[name] = theta[:, at:at + n].reshape(theta.shape[0], *shape)
        at += n
    return [(layers[k]["w"], layers[k]["b"]) for k in sorted(layers)]


def leaves(theta, widths):
    """``{"<layer>.<b|w>": (L, ...)}``: the flat lane vectors cut into the
    net's leaves, all lanes together."""
    out, at = {}, 0
    for k, name, shape in layout(widths):
        n = int(np.prod(shape))
        out[f"{k}.{name}"] = theta[:, at:at + n]
        at += n
    return out


def mlp(u, layers, tf32=False):
    h = u
    last = len(layers) - 1
    for k, (w, b) in enumerate(layers):
        h = product(w, h[..., None], tf32)[..., 0] + b
        if k < last:
            h = torch.exp(-(h * h))
    return h


def lane_loss(theta, data, cfg, tf32=False):
    """(L, P), (L, S, 2) → (L,) mean squared residual of each lane's
    fixed-step Tsit5 solve from its first sample."""
    alpha, delta = cfg["p_true"][0], cfg["p_true"][3]
    layers = unflatten(theta, cfg["nn_widths"])

    def f(u):
        nn = mlp(u, layers, tf32)
        return torch.stack([alpha * u[:, 0] + nn[:, 0], -delta * u[:, 1] + nn[:, 1]], dim=-1)

    samples = data.shape[1]
    sub = cfg["substeps"]
    n_steps = (samples - 1) * sub
    dt = torch.tensor(cfg["dt_save"] * (samples - 1), dtype=data.dtype,
                      device=data.device) / n_steps
    y = data[:, 0]
    k = f(y)
    saved = [y]
    for i in range(n_steps):
        y, k = tsit5.step(f, y, k, dt)
        if (i + 1) % sub == 0:
            saved.append(y)
    r = torch.stack(saved, dim=1) - data
    return (r * r).reshape(r.shape[0], -1).mean(-1)


def loss_and_grad(theta, data, cfg, tf32=False):
    """Each lane's loss and the gradient of their sum (each lane's own)."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        loss = lane_loss(th, data, cfg, tf32)
        (g,) = torch.autograd.grad(loss.sum(), th)
    return loss.detach(), g
