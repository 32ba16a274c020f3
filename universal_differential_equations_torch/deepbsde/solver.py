"""Deep-BSDE solver for terminal-value semilinear PDEs.

Port of ``universal_differential_equations_tpu/deepbsde/solver.py``, the
counterpart of ``TerminalPDEProblem`` + ``NNPDENS``
(``highdim_pde/lambaem.jl:14-34``; Han, Jentzen & E 2018): the PDE solution
at ``x0`` is learned by simulating the coupled forward-backward SDE

    dX = μ(t,X) dt + σ(t,X) dW
    du = -f(t, X, u, σᵀ∇u) dt + (σᵀ∇u)·dW

with two networks — ``u0_net: x → u(0,x)`` and ``grad_net: [x;t] → σᵀ∇u`` —
trained so the terminal condition ``u(T) ≈ g(X_T)`` holds in mean square.

The rollout carries an explicit trajectory dimension: the ``m`` paths step
together, the networks take the (m, ·) batch, and the time loop is a Python
loop that autograd differentiates.  The user's callables ``g``, ``f``,
``mu`` and ``sigma`` see one trajectory, as in the JAX package, and are
mapped over the paths with ``torch.func.vmap``.  Each training iteration
reads its loss to the host once, for the early stop.

Noise: by default from a ``torch.Generator``; ``normals=`` supplies the
standard normals of every draw instead (the JAX draws, in the parity
tests).  Everything runs on ``x0``'s device in the caller's ``dtype``.

``mesh=`` shards the trajectories over a ``parallel.Mesh``: every rank
draws the global batch of normals from the same generator and keeps its
rows, so the draws do not depend on placement (as in the JAX package); the
loss is the global mean, and one ``all_reduce`` per iteration adds up the
flat gradient and the loss before ADAM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import vmap

from ..core.problem import SDEProblem
from ..flatten_util import tree_flatten
from ..parallel.mesh import replicate, shard_ensemble
from ..solvers.sde import AdaptiveEM
from ..utils.profiling import StepTimer

__all__ = ["TerminalPDEProblem", "NNPDENS", "solve_terminal_pde", "BSDEResult",
           "make_train_step", "mc_analytical_hjb"]

PILOT_GRID = 1024  # AdaptiveEM's grid in the pilot


@dataclasses.dataclass(frozen=True)
class TerminalPDEProblem:
    """Terminal-value semilinear PDE (``TerminalPDEProblem(g,f,μ,σ,x0,tspan)``).

    ``g(x) -> scalar`` terminal condition; ``f(t, x, u, z) -> scalar``
    nonlinearity with ``z = σᵀ∇u``; ``mu(t, x) -> (d,)`` drift;
    ``sigma(t, x) -> scalar | (d,) | (d, d)`` diffusion.  Each sees one
    trajectory: ``x`` is (d,), ``u`` 0-d, ``z`` (d,) and ``t`` 0-d.
    """

    g: Callable
    f: Callable
    mu: Callable
    sigma: Callable
    x0: torch.Tensor
    tspan: tuple


@dataclasses.dataclass(frozen=True)
class NNPDENS:
    """Algorithm object bundling the two sub-networks (``lambaem.jl:23-31``)."""

    u0_net: object  # Chain: (d,) -> (1,)
    grad_net: object  # Chain: (d+1,) -> (d,)


class BSDEResult(NamedTuple):
    u0: torch.Tensor  # learned u(0, x0)
    losses: torch.Tensor
    params: dict
    converged: bool
    n_steps: int = 0  # time-grid resolution the final training stage used
    s_per_iter: float = float("nan")  # the last stage's rolling seconds per iteration


def _apply_sigma(sig, dw):
    sig = sig if isinstance(sig, torch.Tensor) else torch.as_tensor(
        sig, dtype=dw.dtype, device=dw.device)
    if sig.ndim <= 1:
        return sig * dw
    return sig @ dw


def _device_generator(generator, device):
    """A generator on ``device`` seeded from one draw of ``generator`` (the
    counterpart of splitting a JAX key): the draws then run on the device."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def make_train_step(problem, alg, x0, params, n_steps, learning_rate=0.03, mesh=None):
    """``(step, current)`` for ADAM on the deep-BSDE loss at ``n_steps``.

    ``step(normals)`` runs one iteration on standard normals of shape
    (m, n_steps, d), scaled by ``sqrt(dt)`` here, and returns the loss
    before the update (a device tensor; nothing is read to the host);
    ``current()`` returns the parameters.  A fresh ``torch.optim.Adam`` per
    call, as the JAX trainer initialises optax's state per stage.

    With ``mesh``, ``step`` takes this rank's rows of the global (M,
    n_steps, d) normals, every rank of the mesh calls it, and it returns
    the global mean loss; the gradient is the global one (one
    ``all_reduce`` of the flat gradient and the loss).
    """
    t0, t1 = problem.tspan
    dtype, device = x0.dtype, x0.device
    dt = (t1 - t0) / n_steps
    sqrt_dt = torch.sqrt(torch.tensor(dt, dtype=dtype, device=device))
    ts_grid = t0 + dt * torch.arange(n_steps, dtype=dtype, device=device)
    g_b = vmap(problem.g)

    def per_path(t):
        """f, μ·1 and σ·dW at time ``t``, mapped over the paths in one call."""
        def one(x, u, z, dw):
            return problem.f(t, x, u, z), problem.mu(t, x), _apply_sigma(problem.sigma(t, x), dw)
        return vmap(one)

    leaves, build = tree_flatten(params)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in leaves]
    opt = torch.optim.Adam(leaves, lr=learning_rate)

    def loss_fn(p, dws, m_global):
        m = dws.shape[0]
        x = x0.expand(m, -1)
        u = alg.u0_net.apply(p["u0"], x0)[0].expand(m)
        for k in range(n_steps):
            t, dw = ts_grid[k], dws[:, k]
            z = alg.grad_net.apply(p["grad"], torch.cat([x, t.expand(m, 1)], dim=1))
            f, mu, sigma_dw = per_path(t)(x, u, z, dw)
            u = u - f * dt + (z * dw).sum(-1)
            x = x + mu * dt + sigma_dw
        err = (u - g_b(x)) ** 2
        return torch.mean(err) if m_global is None else torch.sum(err) / m_global

    def step(normals):
        opt.zero_grad(set_to_none=True)
        m_global = None if mesh is None else normals.shape[0] * mesh.size
        loss = loss_fn(build(leaves), normals * sqrt_dt, m_global)
        loss.backward()
        if mesh is not None:
            # one collective: the flat gradient and this rank's share of the loss
            flat = torch.cat([leaf.grad.reshape(-1) for leaf in leaves] + [loss.detach()[None]])
            dist.all_reduce(flat, group=mesh.group)
            for leaf, g in zip(leaves, flat[:-1].split([leaf.numel() for leaf in leaves])):
                leaf.grad.copy_(g.view_as(leaf))
            loss = flat[-1]
        opt.step()
        return loss.detach()

    return step, lambda: build([leaf.detach() for leaf in leaves])


def solve_terminal_pde(
    problem: TerminalPDEProblem,
    alg: NNPDENS,
    generator: Optional[torch.Generator] = None,
    *,
    trajectories: int = 100,
    n_steps: int = 50,
    maxiters: int = 500,
    learning_rate: float = 0.03,
    pabstol: float = 1e-2,
    verbose: bool = False,
    dtype=torch.float32,
    mesh=None,
    adaptive: bool = False,
    sde_abstol: float = 1e-2,
    sde_reltol: float = 1e-2,
    pilot_paths: int = 8,
    max_refinements: int = 3,
    params=None,
    normals: Optional[Callable] = None,
) -> BSDEResult:
    """Train the deep-BSDE networks; returns the learned ``u(0, x0)``.

    Mirrors ``solve(prob, NNPDENS(u0, σᵀ∇u, opt), trajectories=m, maxiters,
    pabstol)`` (``lambaem.jl:33-34``): ADAM on the terminal mean-square error
    with early stop when the loss drops below ``pabstol``.

    ``adaptive=True`` is the ``alg=LambaEM(), abstol, reltol`` role of the
    reference: an :class:`~..solvers.sde.AdaptiveEM` pilot integrates
    ``pilot_paths`` coupled (X, u) trajectories (initial networks) at
    tolerances ``(sde_abstol, sde_reltol)`` to pick the starting
    resolution, then training runs on that grid and the grid is doubled —
    warm-starting the networks — until the learned ``u(0, x0)`` moves by
    less than ``sde_abstol + sde_reltol·|u0|`` between refinements.

    ``generator`` (a CPU ``torch.Generator``, default seed 0) draws the
    initial parameters, then seeds the generators that draw the increments
    on ``x0``'s device.  ``params`` (``{"u0": ..., "grad": ...}``, e.g.
    ``convert.params_from_jax`` of the JAX trainer's) replaces the drawn
    initial parameters; ``normals(stage, it, shape)`` replaces every draw of
    standard normals: stage ``0, 1, ...`` iteration ``it`` with shape
    (m, n_steps, d), and the pilot's as ``("pilot", 0, (pilot_paths,
    1024, d))``.

    ``mesh``: an optional ``parallel.Mesh`` (e.g.
    ``parallel.ensemble_mesh()``); every rank of the mesh makes the call.
    The trajectory batch is split over its ranks, each drawing the global
    normals and keeping its rows, and the parameters are replicated (rank
    0's); each iteration's gradient and loss are summed across the ranks in
    one ``all_reduce``.  ``trajectories`` must be a multiple of the mesh
    size.  The pilot (``adaptive=True``) runs whole on every rank.
    """
    x0 = torch.as_tensor(problem.x0).to(dtype)
    if mesh is not None:
        mesh.check(x0, "x0")
        mesh.member()
        if trajectories % mesh.size:
            raise ValueError(f"trajectories={trajectories} must be a multiple of the mesh "
                             f"size {mesh.size}")
    device = x0.device
    d = x0.shape[0]
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    if params is None:
        params = {"u0": alg.u0_net.init(generator, dtype, device),
                  "grad": alg.grad_net.init(generator, dtype, device)}
    if mesh is not None:
        params = replicate(params, mesh)
    if normals is None:
        g_train = _device_generator(generator, device)
        g_pilot = _device_generator(generator, device)

        def normals(stage, it, shape):
            gen = g_pilot if stage == "pilot" else g_train
            return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def draw(stage, it, shape):
        z = torch.as_tensor(normals(stage, it, shape)).to(dtype=dtype, device=device)
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"normals{(stage, it)} has shape {tuple(z.shape)}, not {shape}")
        return z

    def draw_paths(stage, it, n_steps):
        z = draw(stage, it, (trajectories, n_steps, d))
        return z if mesh is None else shard_ensemble(z, mesh, mesh.axis_names[0])

    def train_stage(params, n_steps, stage):
        step, current = make_train_step(problem, alg, x0, params, n_steps, learning_rate, mesh)
        timer = StepTimer()
        losses = []
        converged = False
        for it in range(maxiters):
            losses.append(float(step(draw_paths(stage, it, n_steps))))
            timer.tick()
            if verbose and it % 50 == 0:
                print(f"  bsde iter {it} (n={n_steps}): loss {losses[-1]:.5f}")
            if losses[-1] < pabstol:
                converged = True
                break
        return current(), losses, converged, timer.ms_per_step / 1e3

    def u0_of(params):
        with torch.no_grad():
            return alg.u0_net.apply(params["u0"], x0)[0]

    if adaptive:
        n_steps = _pilot_resolution(problem, alg, params, x0, draw, sde_abstol, sde_reltol,
                                    pilot_paths, verbose)

    params, losses, converged, s_iter = train_stage(params, n_steps, stage=0)
    u0_val = u0_of(params)

    if adaptive:
        # pinned-grid refinement: double the grid (warm-started training)
        # until the learned u(0, x0) stops moving at the SDE tolerances
        for stage in range(1, max_refinements + 1):
            n_fine = 2 * n_steps
            params, l2, conv2, s_iter = train_stage(params, n_fine, stage=stage)
            u0_fine = u0_of(params)
            losses += l2
            converged = conv2
            delta = abs(float(u0_fine) - float(u0_val))
            u0_val, n_steps = u0_fine, n_fine
            if verbose:
                print(f"  bsde refine -> n={n_fine}: u0 {float(u0_fine):.5f} "
                      f"(Δ {delta:.2e})")
            if delta <= sde_abstol + sde_reltol * abs(float(u0_fine)):
                break

    return BSDEResult(
        u0=u0_val,
        losses=torch.tensor(losses, dtype=torch.float64),
        params=params,
        converged=converged,
        n_steps=n_steps,
        s_per_iter=s_iter,
    )


def _pilot_resolution(problem, alg, params, x0, draw, sde_abstol, sde_reltol,
                      pilot_paths, verbose):
    """Pick a starting time-grid resolution with an AdaptiveEM pilot.

    The coupled (X, u) forward system, with general noise of width d, is
    integrated by the error-controlled Euler–Maruyama solver
    (``solvers.sde.AdaptiveEM``, the LambaEM role) at the requested
    tolerances, with the initial networks for the control ``z``, over
    ``pilot_paths`` lanes in one ``torch.func.vmap``; the grid is sized to
    the busiest lane's step count (rounded up to a power of two, floor 8).
    """
    t0, t1 = problem.tspan
    d = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    eye = torch.eye(d, dtype=dtype, device=device)

    def sigma_matrix(t, x):
        sig = problem.sigma(t, x)
        sig = sig if isinstance(sig, torch.Tensor) else torch.as_tensor(
            sig, dtype=dtype, device=device)
        if sig.ndim == 0:
            return sig * eye
        if sig.ndim == 1:
            return torch.diag(sig)
        return sig

    def coupled_f(t, s, p):
        x, u = s[:d], s[d]
        z = alg.grad_net.apply(p["grad"], torch.cat([x, t[None]]))
        du = -problem.f(t, x, u, z)
        return torch.cat([problem.mu(t, x), du[None]])

    def coupled_g(t, s, p):
        x = s[:d]
        z = alg.grad_net.apply(p["grad"], torch.cat([x, t[None]]))
        return torch.cat([sigma_matrix(t, x), z[None, :]], dim=0)

    with torch.no_grad():
        u_init = alg.u0_net.apply(params["u0"], x0)
        pilot_prob = SDEProblem(f=coupled_f, g=coupled_g, u0=torch.cat([x0, u_init]),
                                tspan=(t0, t1), args=params, noise_dim=d)
        pilot = AdaptiveEM(grid_resolution=PILOT_GRID, abstol=sde_abstol,
                           reltol=sde_reltol, max_steps=4096)
        h_min = (torch.tensor(t1, dtype=dtype, device=device)
                 - torch.tensor(t0, dtype=dtype, device=device)) / PILOT_GRID
        incs = draw("pilot", 0, (pilot_paths, PILOT_GRID, d)) * torch.sqrt(h_min.abs())
        n_used = vmap(lambda w: pilot.solve(pilot_prob, dws=w).num_steps)(incs)
    n_req = int(n_used.max())
    n_steps = 8
    while n_steps < n_req:
        n_steps *= 2
    if verbose:
        print(f"  bsde pilot: AdaptiveEM used {n_req} steps (max of "
              f"{pilot_paths} paths) -> starting grid n={n_steps}")
    return n_steps


def mc_analytical_hjb(g, x0, T, lam, generator=None, n_samples: int = 10**5,
                      batch: int = 10**4, normals=None):
    """Monte-Carlo closed-form value for the LQG/HJB problem:
    ``u(0,x) = -(1/λ)·log E[exp(−λ·g(x + √2·√T·W))]`` (``lambaem.jl:36-43``),
    in batches to bound device memory; ``g`` sees one sample.

    The draws come from ``generator`` (default seed 0; they run on
    ``x0``'s device), or ``normals`` of shape (n_batches, batch, d) gives
    them.  Returns a Python float.
    """
    d = x0.shape[0]
    batch = min(batch, n_samples)
    n_batches = -(-n_samples // batch)  # ceil: use ALL requested samples
    if normals is None:
        gen = _device_generator(
            torch.Generator().manual_seed(0) if generator is None else generator, x0.device)
    g_b = vmap(g)
    scale = math.sqrt(2.0) * math.sqrt(T)
    total = 0.0
    for b in range(n_batches):
        if normals is None:
            w = torch.randn((batch, d), generator=gen, dtype=x0.dtype, device=x0.device)
        else:
            w = torch.as_tensor(normals[b]).to(dtype=x0.dtype, device=x0.device)
        xT = x0[None, :] + scale * w
        total += float(torch.sum(torch.exp(-lam * g_b(xT))))
    return -(1.0 / lam) * math.log(total / (n_batches * batch))
