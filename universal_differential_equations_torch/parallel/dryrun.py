"""The multi-rank dry run: every sharded surface of the port, checked
against its unsharded computation.

    python -m universal_differential_equations_torch.parallel.dryrun [n]

The port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``.
Six surfaces, at the JAX dry run's tiny shapes, each on a mesh over ``n``
ranks and once more unsharded on rank 0:

1. one ensemble-data-parallel ADAM step of the Lotka-Volterra UDE, two
   trajectories per rank (the loss ``psum``-ed, the gradient of replicated
   parameters summed over the ranks);
2. one x-decomposed Rayleigh-Taylor generator chunk (halo exchanges and the
   slab-decomposed FFT) at (2n, 2, 8);
3. one lane-sharded SINDy recovery chunk (``ensemble_run(sharded=True)`` of
   the SR3→STRRidge protocol, 2n lanes);
4. a trajectory-sharded deep-BSDE training stage (3 iterations, 2n paths);
5. the segment-sharded multiple-shooting loss and gradient on a
   ``("segments",)`` mesh;
6. one window-data-parallel ADAM step of the climate neural-PDE column.

Rank 0 prints one line per surface; a surface that fails or disagrees with
its unsharded run raises.  Called with a process group of ``n`` ranks the
run happens in it, on the group's device type; alone, it spawns ``n`` gloo
ranks on the CPU (:func:`.launch.spawn`).
"""
from __future__ import annotations

import math
import sys

import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _agree(what, a, b, tol):
    r = _rel(a, b)
    if not r <= tol:
        raise AssertionError(f"{what}: sharded against unsharded rel {r:.2e} > {tol:g}")
    return r


def _dp_step(item_loss, params, items, mesh, lr):
    """Loss, gradient and the parameters after one ADAM step (its first,
    from zero moments) of the mean of ``item_loss(params, *item)`` over
    ``items``, split over ``mesh`` (None: all on this rank)."""
    from ..flatten_util import tree_flatten
    from .collectives import grad_psum, psum
    from .mesh import shard_ensemble

    n = items[0].shape[0]
    if mesh is not None:
        items = shard_ensemble(list(items), mesh, mesh.axis_names[0])

    def loss(p):
        if mesh is not None:
            p = grad_psum(p, mesh)
        total = torch.func.vmap(lambda *it: item_loss(p, *it))(*items).sum() / n
        return total if mesh is None else psum(total, mesh)

    grads, value = torch.func.grad_and_value(loss)(params)
    g = torch.cat([x.reshape(-1) for x in tree_flatten(grads)[0]])
    flat = torch.cat([x.reshape(-1) for x in tree_flatten(params)[0]])
    # optax.adam's first step: m̂ = g, v̂ = g², so the update is lr·g/(|g| + eps)
    return value.detach(), g, flat - lr * g / (g.abs() + 1e-8)


def _ude_step(mesh, device, n):
    import universal_differential_equations_torch as ude
    from ..models import lotka_volterra as lv

    f32 = torch.float32
    rhs, params0, _ = lv.make_ude(torch.Generator().manual_seed(0), device=device)
    ts = torch.arange(0.0, 0.5, 0.1, dtype=f32, device=device)
    t1 = float(ts[-1])
    b = 2 * n
    u0s = (lv.U0.to(f32) * (1.0 + 0.05 * torch.randn((b, 2), generator=torch.Generator()
                                                      .manual_seed(1)))).to(device)
    targets = torch.ones((b, ts.shape[0], 2), dtype=f32, device=device)

    def per_traj(params, u0, target):
        sol = ude.solve(ude.ODEProblem(rhs, u0, (0.0, t1), params), ude.Tsit5(), saveat=ts,
                        rtol=1e-4, atol=1e-4, adjoint=ude.DiscreteAdjoint(), max_steps=64)
        return torch.mean((sol.ys - target) ** 2)

    return _dp_step(per_traj, params0, (u0s, targets), mesh, 1e-2)


def _rt_chunk(mesh, device, n):
    from ..models.climate_datagen import _rt_stepper
    from .collectives import all_gather

    nx = 2 * n
    state, _, chunk, _ = _rt_stepper((nx, 2, 8), (1.0, 2 / nx, 1.0), 1e-4, 1e-4, 1.0, 3, None,
                                     torch.float32, mesh=mesh, device=device)
    state, umax = chunk(state, torch.tensor(1e-4, device=device))
    if mesh is not None:
        state = [all_gather(f, mesh) for f in state]
    return torch.stack(list(state)), umax


def _recovery(mesh, device, n):
    from .. import sindy as sd
    from ..ensemble import ensemble_run

    f32 = torch.float32
    basis = sd.polynomial_basis(2, 3) + sd.sin_basis(2)
    i_xy = basis.names.index("u1*u2")
    lams = tuple(10.0 ** e for e in torch.arange(-5.0, 5.0, 0.5).tolist())
    g = torch.Generator().manual_seed(3)
    xs = (0.5 + torch.rand((31, 2), generator=g)).to(device)
    theta = basis.theta(xs)
    y_clean = torch.stack([-0.9 * xs[:, 0] * xs[:, 1], 0.8 * xs[:, 0] * xs[:, 1]], -1)
    ys = y_clean[None] + 1e-3 * torch.randn((2 * n,) + tuple(y_clean.shape), generator=g).to(
        dtype=f32, device=device)

    def recover(y):
        C = sd.two_stage_recovery(theta, y, lams, denoise=False, sr3_maxiter=100)
        return C, (C[:, 0] != 0.0)[i_xy] & (C[:, 1] != 0.0)[i_xy]

    res = ensemble_run(recover, ys, mesh=mesh, sharded=mesh is not None)
    return res.outputs, res.success


def _bsde(mesh, device, n):
    import universal_differential_equations_torch as ude
    from ..deepbsde import NNPDENS, TerminalPDEProblem, solve_terminal_pde

    d = 3
    prob = TerminalPDEProblem(
        g=lambda x: torch.log(0.5 + 0.5 * torch.sum(x * x)),
        f=lambda t, x, u, z: -torch.sum(z * z), mu=lambda t, x: torch.zeros_like(x),
        sigma=lambda t, x: math.sqrt(2.0), x0=torch.zeros(d, device=device), tspan=(0.0, 1.0))
    alg = NNPDENS(u0_net=ude.MLP([d, 8, 1], activation="relu"),
                  grad_net=ude.MLP([d + 1, 8, d], activation="relu"))
    res = solve_terminal_pde(prob, alg, torch.Generator().manual_seed(5), mesh=mesh,
                             trajectories=2 * n, n_steps=4, maxiters=3, learning_rate=0.03,
                             pabstol=0.0)
    return res.losses, res.u0


def _shooting(mesh, device, n):
    import universal_differential_equations_torch as ude
    from ..models import lotka_volterra as lv

    f32 = torch.float32
    ts = torch.linspace(0.0, 1.6, 17, dtype=f32, device=device)
    p_true = lv.P_TRUE.to(dtype=f32, device=device)
    sol = ude.solve(ude.ODEProblem(lv.lotka_rhs, lv.U0.to(dtype=f32, device=device), (0.0, 1.6),
                                   p_true),
                    ude.Tsit5(), saveat=ts, rtol=1e-5, atol=1e-7, adjoint=ude.NoAdjoint(),
                    max_steps=256)
    if not bool(sol.success):
        raise AssertionError("the shooting target's solve failed")

    def loss(p):
        return ude.multiple_shoot(p, sol.ys, ts, lv.lotka_rhs, group_size=3,
                                  continuity_term=10.0, rtol=1e-4, atol=1e-6, max_steps=64,
                                  mesh=mesh, mesh_axis=None if mesh is None else "segments")

    grad, value = torch.func.grad_and_value(loss)(p_true * 1.1)
    return value.detach(), grad


def _column_step(mesh, device, n):
    import universal_differential_equations_torch as ude
    from ..models import climate_npde as cn

    f32 = torch.float32
    D1, D2, _ = cn.getops(8, device=device)
    rhs, params0, _ = cn.make_neural_rhs(torch.Generator().manual_seed(9), n=6, hidden=4,
                                         device=device)
    ts = torch.linspace(0.0, 0.2, 3, dtype=f32, device=device)
    g = torch.Generator().manual_seed(11)
    u0s = (0.1 * torch.randn((n, 6), generator=g)).to(device)
    tgts = (0.1 * torch.randn((n, 3, 6), generator=g)).to(device)

    def window_loss(p, u0, tw):
        s = ude.solve(ude.ODEProblem(lambda t, u, pp: rhs(t, u, (pp, D1, D2)), u0, (0.0, 0.2), p),
                      ude.Tsit5(), saveat=ts, rtol=1e-4, atol=1e-5,
                      adjoint=ude.DiscreteAdjoint(), max_steps=64)
        return torch.mean((s.ys - tw) ** 2)

    return _dp_step(window_loss, params0, (u0s, tgts), mesh, 1e-3)


def _body(n):
    """The six surfaces in a process group of ``n`` ranks; rank 0's lines."""
    from .mesh import ensemble_mesh

    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a group of {dist.get_world_size()} ranks")
    lead = dist.get_rank() == 0
    ens, xs, seg = (ensemble_mesh(n, axis=a) for a in ("ensemble", "x", "segments"))
    device = torch.device(ens.device_type)
    lines = []

    def surface(fn, mesh, check):
        out = fn(mesh, device, n)
        ref = fn(None, device, n) if lead else None
        if lead:
            lines.append(f"dryrun_multichip({n}): " + check(out, ref))

    def ude_check(out, ref):
        loss, g, p = out
        if not math.isfinite(float(loss)):
            raise AssertionError(f"multichip training step produced loss {float(loss)}")
        r = max(_agree("UDE loss", loss, ref[0], 1e-5), _agree("UDE gradient", g, ref[1], 1e-4))
        return f"one DP train step OK, loss={float(loss):.4f} (unsharded rel {r:.1e})"

    def rt_check(out, ref):
        state, umax = out
        if not bool(torch.isfinite(state).all()):
            raise AssertionError("the x-decomposed RT chunk went non-finite")
        r = _agree("RT state", state, ref[0], 5e-5)
        _agree("RT umax", umax, ref[1], 1e-5)
        return (f"one spatially-sharded RT datagen chunk OK, umax={float(umax):.2e} "
                f"(unsharded rel {r:.1e})")

    def rec_check(out, ref):
        C, found = out
        rate = float(found.float().mean())
        if rate != 1.0:
            raise AssertionError(f"sharded recovery chunk missed x*y: rate {rate}")
        if not torch.equal(C != 0, ref[0] != 0):
            raise AssertionError("sharded recovery selected other terms than unsharded")
        r = _agree("recovered coefficients", C, ref[0], 1e-5)
        return (f"one lane-sharded SINDy recovery chunk OK ({2 * n} lanes, x*y found on all; "
                f"unsharded rel {r:.1e})")

    def bsde_check(out, ref):
        losses, u0 = out
        if not (math.isfinite(float(u0)) and bool(torch.isfinite(losses).all())):
            raise AssertionError(f"sharded BSDE u0 {float(u0)}")
        r = max(_agree("BSDE losses", losses, ref[0], 1e-5), _agree("BSDE u0", u0, ref[1], 1e-5))
        return (f"one trajectory-sharded deep-BSDE train stage OK, u0={float(u0):.3f} "
                f"(unsharded rel {r:.1e})")

    def shoot_check(out, ref):
        loss, g = out
        if not (math.isfinite(float(loss)) and bool(torch.isfinite(g).all())):
            raise AssertionError(f"sharded shooting loss {float(loss)}")
        r = max(_agree("shooting loss", loss, ref[0], 1e-6),
                _agree("shooting gradient", g, ref[1], 1e-5))
        return (f"one segment-sharded multiple-shooting loss+grad OK, loss={float(loss):.4f} "
                f"(unsharded rel {r:.1e})")

    def column_check(out, ref):
        loss, g, _ = out
        if not math.isfinite(float(loss)):
            raise AssertionError(f"climate DP step loss {float(loss)}")
        r = max(_agree("column loss", loss, ref[0], 1e-5),
                _agree("column gradient", g, ref[1], 1e-4))
        return (f"one window-DP climate neural-PDE train step OK, loss={float(loss):.4f} "
                f"(unsharded rel {r:.1e})")

    surface(_ude_step, ens, ude_check)
    surface(_rt_chunk, xs, rt_check)
    surface(_recovery, ens, rec_check)
    surface(_bsde, ens, bsde_check)
    surface(_shooting, seg, shoot_check)
    surface(_column_step, ens, column_check)
    return lines


def dryrun_multichip(n_devices: int):
    """The six sharded surfaces over ``n_devices`` ranks, each against its
    unsharded run; prints and returns rank 0's lines.  Inside a process
    group of ``n_devices`` ranks (every rank calls it) the run uses it;
    without one it spawns ``n_devices`` gloo CPU ranks."""
    if dist.is_initialized():
        lines = _body(n_devices)
    else:
        from .launch import spawn

        lines = spawn(_body, n_devices, n_devices)[0]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    # through the package module, so that the ranks unpickle its ``_body``
    from universal_differential_equations_torch.parallel.dryrun import dryrun_multichip as run

    run(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
