"""Plain reference of the deep-BSDE loss for the 100-D Hamilton-Jacobi-Bellman
equation (Han, Jentzen & E 2018; ``highdim_pde/lambaem.jl``).

``u_t + Δu − λ‖∇u‖² = 0``, ``u(T, x) = log(½ + ½‖x‖²)``, as the forward-backward
SDE ``dX = √2 dW``, ``du = λ‖z‖² dt + z·dW`` with ``z = σᵀ∇u`` from the grad
net ``[x; t] → z`` and ``u(0, x0)`` from the u0 net; the loss is the mean
over paths of ``(u_T − g(X_T))²`` on an Euler grid of ``n_steps`` steps.
Both nets are ReLU MLPs with a linear last layer; a layer holds ``w`` (out,
in) and ``b`` (out,).  Plain PyTorch, in blocks of paths so that the
activations of a large batch fit; imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from .precision import product


def mlp(h, layers, tf32=False):
    last = len(layers) - 1
    for k, layer in enumerate(layers):
        h = product(h, layer["w"].T, tf32) + layer["b"]
        if k < last:
            h = torch.relu(h)
    return h


def leaves(params):
    """``{"<net>.<layer>.<b|w>": tensor}`` of a ``{"u0": [...], "grad": [...]}`` tree."""
    return {f"{net}.{k}.{name}": t for net in sorted(params)
            for k, layer in enumerate(params[net]) for name, t in sorted(layer.items())}


def tree(flat):
    """Inverse of :func:`leaves`."""
    out = {}
    for key, t in flat.items():
        net, k, name = key.split(".")
        layers = out.setdefault(net, [])
        while len(layers) <= int(k):
            layers.append({})
        layers[int(k)][name] = t
    return out


def loss_and_grad(flat, normals, cfg, block=16384, tf32=False):
    """Loss and gradients (by leaf) over the paths of ``normals`` (m,
    n_steps, d) standard normals, the increments being ``√dt·normals``."""
    m, n_steps, d = normals.shape
    lam, t_end = cfg["lam"], cfg["t_end"]
    dt = t_end / n_steps
    sqrt_dt = math.sqrt(dt)
    keys = list(flat)
    total = torch.zeros((), dtype=torch.float64, device=normals.device)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    x0 = torch.full((1, d), cfg["x0"], dtype=normals.dtype, device=normals.device)
    for lo in range(0, m, block):
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
            net = tree(p)
            dw = normals[lo:lo + block] * sqrt_dt
            rows = dw.shape[0]
            u = mlp(x0, net["u0"], tf32)[0, 0].expand(rows)
            x = x0.expand(rows, d)
            for k in range(n_steps):
                t = torch.full((rows, 1), k * dt, dtype=x.dtype, device=x.device)
                z = mlp(torch.cat([x, t], dim=1), net["grad"], tf32)
                u = u + lam * (z * z).sum(-1) * dt + (z * dw[:, k]).sum(-1)
                x = x + math.sqrt(2.0) * dw[:, k]
            g_t = torch.log(0.5 + 0.5 * (x * x).sum(-1))
            part = ((u - g_t) ** 2).sum() / m
            gs = torch.autograd.grad(part, [p[k] for k in keys])
        total += part.detach().double()
        for k, g in zip(keys, gs):
            grads[k] += g
    return total.float(), grads
