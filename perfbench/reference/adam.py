"""Plain ADAM (Kingma & Ba 2015), the arithmetic of ``optax.adam`` and of
Flux's ``ADAM``: ``θ ← θ − lr·m̂/(√v̂ + ε)`` with bias-corrected moments.

:func:`run` trains from a start; :func:`follow` follows a training that
another program ran, step by step from that program's own points."""
from __future__ import annotations

import torch


def _update(mu, nu, g, k, lr, b1, b2, eps):
    """Moments after step ``k``'s gradient ``g`` (dicts, updated in place)
    and the step's change of the parameters."""
    change = {}
    for n in g:
        mu[n] = (1 - b1) * g[n] + b1 * mu[n]
        nu[n] = (1 - b2) * g[n] * g[n] + b2 * nu[n]
        m_hat = mu[n] / (1 - b1**k)
        v_hat = nu[n] / (1 - b2**k)
        change[n] = -lr * (m_hat / (torch.sqrt(v_hat) + eps))
    return change


def run(fg, theta0, steps, lr, b1=0.9, b2=0.999, eps=1e-8):
    """``steps`` ADAM steps from ``theta0`` (a dict of tensors) with the
    moments starting at zero; ``fg(theta) -> (loss, grads)``.  Returns the
    loss of each step, the first step's gradient and the points
    ``[θ0, θ1, …, θ_steps]``."""
    theta = {k: v.detach().clone() for k, v in theta0.items()}
    mu = {k: torch.zeros_like(v) for k, v in theta.items()}
    nu = {k: torch.zeros_like(v) for k, v in theta.items()}
    losses, first, points = [], None, [theta]
    for k in range(1, steps + 1):
        loss, g = fg(theta)
        losses.append(loss)
        if first is None:
            first = {n: v.clone() for n, v in g.items()}
        change = _update(mu, nu, g, k, lr, b1, b2, eps)
        theta = {n: theta[n] + change[n] for n in theta}
        points.append(theta)
    return losses, first, points


def follow(fg, points, lr, b1=0.9, b2=0.999, eps=1e-8):
    """ADAM's steps along another run's ``points`` ``[θ0, …, θK]``: step
    ``k``'s loss and gradient at ``θ_{k−1}``, the moments built from these
    gradients, and the change that step ``k`` makes from ``θ_{k−1}``.
    Returns the losses, the gradients and the changes, one per step."""
    mu = {k: torch.zeros_like(v) for k, v in points[0].items()}
    nu = {k: torch.zeros_like(v) for k, v in points[0].items()}
    losses, grads, changes = [], [], []
    for k, theta in enumerate(points[:-1], start=1):
        loss, g = fg(theta)
        losses.append(loss)
        grads.append(g)
        changes.append(_update(mu, nu, g, k, lr, b1, b2, eps))
    return losses, grads, changes
