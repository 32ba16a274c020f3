"""PyTorch port: the stabilized explicit solvers (RKC1, RKC2, ROCK2, ROCK4)
against the JAX package.

The derived coefficient tables equal JAX's bit for bit; one ``step`` of each
solver equals JAX's to 1e-12 (float64); adaptive solves of the climate
column (``getops(64)``, ``true_rhs``, rtol 1e-6, float64) take JAX's
accepted, rejected and RHS-evaluation counts and land within 1e-9 of its
save values, with no accepted step past ``dt_stab``; the orders that
``tests/test_shooting_ensemble_io.py`` measures hold; a float32 state stays
float32 through ``solve`` and ``jacfwd``; gradients through ROCK4 equal
``jax.grad`` / ``jax.jacfwd`` to 1e-6 (float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.convert import params_from_jax
from universal_differential_equations_torch.core.integrate import integrate_fixed
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import climate_npde as tcn
from universal_differential_equations_torch.solvers import rock as trock
from universal_differential_equations_tpu.models import climate_npde as jcn
from universal_differential_equations_tpu.solvers import rkc as jrkc
from universal_differential_equations_tpu.solvers import rock as jrock

torch.set_num_threads(1)

F64 = torch.float64
NAMES = ["RKC2", "RKC1", "ROCK2", "ROCK4"]


def _solver(pkg, name, rho):
    """The four solvers at small stage counts (ROCK2's derivation takes
    seconds at s ≥ 8)."""
    return {"RKC2": lambda: pkg.RKC2(stages=8, rho=rho),
            "RKC1": lambda: pkg.RKC1(stages=16, rho=rho),
            "ROCK2": lambda: pkg.ROCK2(stages=6, rho=rho),
            "ROCK4": lambda: pkg.ROCK4(stages=9, rho=rho)}[name]()


def test_derived_tables_equal_jax_bit_for_bit():
    assert trock._derive_rock2(6) == jrock._derive_rock2(6)
    assert trock._derive_rock4(9) == jrock._derive_rock4(9)
    for s in (5, 16):
        w0, w1, T, dT, ddT, b = jrkc.RKC2(stages=s)._coeffs()
        assert tude.RKC2(stages=s)._coeffs() == (w0, w1, tuple(T), tuple(dT), tuple(ddT),
                                                tuple(b))
        assert tude.RKC1(stages=s).dt_stab is None
        assert tude.RKC1(stages=s, rho=3.0).dt_stab == jude.RKC1(stages=s, rho=3.0).dt_stab
    for name in NAMES:
        t, j = _solver(tude, name, 7.0), _solver(jude, name, 7.0)
        assert (t.name, t.order, t.error_order, t.dt_stab) == (j.name, j.order, j.error_order,
                                                                j.dt_stab)
    assert tude.ROCK2(stages=6).interval == jude.ROCK2(stages=6).interval
    for cls in ("ROCK2", "ROCK4", "RKC2"):
        t = getattr(tude, cls).for_problem(900.0, (0.0, 2.0), 30)
        j = getattr(jude, cls).for_problem(900.0, (0.0, 2.0), 30)
        assert (t.stages, t.rho) == (j.stages, j.rho)


@pytest.mark.parametrize("bad", [("ROCK2", 2), ("ROCK2", 201), ("ROCK4", 5), ("ROCK4", 201)])
def test_stage_count_limits_raise_like_jax(bad):
    name, s = bad
    for pkg in (tude, jude):
        with pytest.raises(ValueError, match="stages must be"):
            getattr(pkg, name)(stages=s)


@pytest.mark.parametrize("name", NAMES)
def test_one_step_equals_jax(name):
    D1, D2, eig = jcn.getops(16, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 1.0, 14)
    dt, t = 0.3 / eig, 0.2
    j = _solver(jude, name, eig)
    ty = torch.as_tensor(y, dtype=F64)
    ops = tuple(torch.as_tensor(np.array(a)) for a in (D1, D2))
    f0j = jcn.true_rhs(t, jnp.asarray(y), (D1, D2))
    f0t = tcn.true_rhs(t, ty, ops)
    out_j = j.step(jcn.true_rhs, jnp.asarray(t), jnp.asarray(y), f0j, jnp.asarray(dt), (D1, D2))
    out_t = _solver(tude, name, eig).step(tcn.true_rhs, torch.tensor(t, dtype=F64), ty, f0t,
                                          torch.tensor(dt, dtype=F64), ops)
    for a, b in zip(out_j[:3], out_t[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
    assert out_t[3] == out_j[3]


def _column_solve(pkg, cn, name, arr, rtol):
    D1, D2, eig = cn.getops(64, dtype=arr["dtype"])
    u0 = cn.get_u0(64, arr["dtype"])
    ts = arr["ts"]
    sol = pkg.solve(pkg.ODEProblem(cn.true_rhs, u0, (0.0, 0.2), (D1, D2)),
                    _solver(pkg, name, eig * 1.1), saveat=ts, rtol=rtol, atol=rtol * 1e-2,
                    adjoint=pkg.NoAdjoint(), max_steps=4096, dense=True)
    return sol


@pytest.mark.parametrize("rtol", [1e-6, 1e-3])
@pytest.mark.parametrize("name", NAMES)
def test_adaptive_column_solve_matches_jax(name, rtol):
    """At rtol 1e-6 accuracy sets every solver's steps; at 1e-3 the stability
    cap sets ROCK4's (s = 9, the smallest interval here)."""
    ts = np.linspace(0.0, 0.2, 9)
    sj = _column_solve(jude, jcn, name, dict(dtype=jnp.float64, ts=jnp.asarray(ts)), rtol)
    st = _column_solve(tude, tcn, name, dict(dtype=F64, ts=torch.as_tensor(ts)), rtol)
    assert bool(st.success) and bool(sj.success)
    counts = lambda s: (int(s.num_accepted), int(s.num_rejected), int(s.num_rhs_evals))  # noqa: E731
    assert counts(st) == counts(sj)
    np.testing.assert_allclose(st.ys.numpy(), np.asarray(sj.ys), rtol=0, atol=1e-9)
    # no accepted step is longer than the stability interval allows, and the
    # steps are JAX's
    n = int(st.num_accepted)
    steps = np.diff(st.dense.ts[:n + 1].numpy())
    dt_stab = _solver(tude, name, tcn.getops(64)[2] * 1.1).dt_stab
    assert steps.max() <= dt_stab * (1 + 1e-12)
    if rtol == 1e-3 and name == "ROCK4":
        assert steps.max() >= 0.999 * dt_stab
    np.testing.assert_allclose(steps, np.diff(np.asarray(sj.dense.ts[:n + 1])), rtol=1e-9,
                               atol=1e-12)


def test_stability_cap_binds_where_the_controller_would_step_past_it():
    # a loose tolerance on the stiff column: without a spectral radius (no
    # dt_stab) the controller steps past the stability interval; with it the
    # steps grow to dt_stab and stay there, and the solve stays finite
    D1, D2, eig = tcn.getops(32, dtype=F64)
    prob = tude.ODEProblem(tcn.true_rhs, tcn.get_u0(32, F64), (0.0, 1.0), (D1, D2))
    steps = {}
    for rho in (None, eig * 1.1):
        sol = tude.solve(prob, tude.ROCK2(stages=5, rho=rho), rtol=1e-2, atol=1e-3,
                         adjoint=tude.NoAdjoint(), dense=True)
        n = int(sol.num_accepted)
        steps[rho] = np.diff(sol.dense.ts[:n + 1].numpy())
    dt_stab = tude.ROCK2(stages=5, rho=eig * 1.1).dt_stab
    assert bool(sol.success) and bool(torch.isfinite(sol.y_final).all())
    assert steps[None].max() > 1.2 * dt_stab
    assert steps[eig * 1.1].max() <= dt_stab * (1 + 1e-12)
    assert (steps[eig * 1.1] >= 0.999 * dt_stab).sum() >= 3  # the cap sets these steps


def test_capped_solves_under_vmap_lanes_equal_solo_solves():
    # lanes that take different step counts share one loop; the cap applies
    # per lane, and a finished lane passes through (its own counts and states)
    D1, D2, eig = tcn.getops(16, dtype=F64)
    solver = tude.ROCK2(stages=5, rho=eig * 1.1)
    ts = torch.linspace(0.0, 0.5, 6, dtype=F64)
    u0s = tcn.get_u0(16, F64)[None] * torch.tensor([[0.2], [1.0], [1.6]], dtype=F64)

    def solve(u0):
        sol = tude.solve(tude.ODEProblem(tcn.true_rhs, u0, (0.0, 0.5), (D1, D2)), solver,
                         saveat=ts, rtol=1e-6, atol=1e-8, adjoint=tude.NoAdjoint())
        return sol.ys, sol.num_accepted, sol.num_rhs_evals

    ys, n_acc, nfe = torch.func.vmap(solve)(u0s)
    solo = [solve(u0) for u0 in u0s]
    assert len({int(s[1]) for s in solo}) > 1  # the lanes differ in their steps
    for i, (ys_i, acc_i, nfe_i) in enumerate(solo):
        assert (int(n_acc[i]), int(nfe[i])) == (int(acc_i), int(nfe_i))
        np.testing.assert_allclose(ys[i].numpy(), ys_i.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,lo,hi", [("RKC2", 1.6, 9.0), ("RKC1", 0.7, 1.5),
                                        ("ROCK2", 1.6, 9.0), ("ROCK4", 3.5, 9.0)])
def test_convergence_order(name, lo, hi):
    """JAX's order tests mirrored: y' = y·cos t over [0, 3], fixed steps."""
    solver = {"RKC2": tude.RKC2(stages=5), "RKC1": tude.RKC1(stages=5),
              "ROCK2": tude.ROCK2(stages=6), "ROCK4": tude.ROCK4(stages=9)}[name]
    f = lambda t, y, args: y * torch.cos(t)  # noqa: E731
    ns = [10, 20, 40] if name == "ROCK4" else [20, 40, 80]
    errs = []
    for n in ns:
        _, ys = integrate_fixed(f, torch.tensor([1.0], dtype=F64), 0.0, 3.0, None, solver, n)
        errs.append(abs(float(ys[-1, 0]) - np.exp(np.sin(3.0))))
    order = np.log2(errs[-2] / errs[-1])
    assert lo < order < hi, f"{name}: measured order {order}"


def test_rock_float32_state_keeps_dtype_through_solve_and_jacfwd():
    y0 = torch.tensor([1.0], dtype=torch.float32)
    rhs = lambda t, y, a: -a * y  # noqa: E731
    for solver in (tude.ROCK2(stages=9, rho=4.0), tude.ROCK4(stages=9, rho=4.0)):
        sol = tude.solve(tude.ODEProblem(rhs, y0, (0.0, 1.0), torch.tensor(2.0)), solver,
                         rtol=1e-5, atol=1e-7, adjoint=tude.NoAdjoint())
        assert sol.y_final.dtype == torch.float32, solver.name
        assert abs(float(sol.y_final[0]) - np.exp(-2.0)) < 1e-3

        def final(a):
            return tude.solve(tude.ODEProblem(rhs, y0, (0.0, 1.0), a), solver, rtol=1e-5,
                              atol=1e-7, adjoint=tude.ForwardSensitivity()).y_final

        jac = torch.func.jacfwd(final)(torch.tensor(2.0))
        assert jac.dtype == torch.float32, solver.name
        assert abs(float(jac[0]) + np.exp(-2.0)) < 1e-3  # d/da e^{-a} at a = 2


@pytest.fixture(scope="module")
def rock4_grad_problem():
    """A 16-level column with a 14→4→14 flux net, ROCK4(s=6), float64: the
    JAX gradients (``jax.grad`` through the interpolating adjoint,
    ``jax.jacfwd`` through forward sensitivities) and the port's inputs."""
    D1, D2, eig = jcn.getops(16, dtype=jnp.float64)
    u0 = jcn.get_u0(16, jnp.float64)
    rhs, p0, _ = jcn.make_neural_rhs(jax.random.PRNGKey(3), n=14, hidden=4,
                                     dtype=jnp.float64)
    ts = jnp.linspace(0.0, 0.3, 4)
    target = 0.9 * u0

    def loss(p, adjoint):
        sol = jude.solve(jude.ODEProblem(rhs, u0, (0.0, 0.3), (p, D1, D2)),
                         jude.ROCK4(stages=6, rho=eig * 1.1), saveat=ts, rtol=1e-6, atol=1e-8,
                         adjoint=adjoint, max_steps=512)
        return jnp.sum((sol.ys - target) ** 2)

    g_int = jax.grad(lambda p: loss(p, jude.InterpolatingAdjoint()))(p0)
    g_fwd = jax.jacfwd(lambda p: loss(p, jude.ForwardSensitivity()))(p0)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(ops=[torch.as_tensor(np.array(a)) for a in (D1, D2, u0, ts, target)],
                eig=eig, p0=to_np(p0), g_int=to_np(g_int), g_fwd=to_np(g_fwd))


@pytest.mark.parametrize("mode", ["interpolating_autograd", "forward_jacfwd"])
def test_gradients_through_rock4_match_jax(rock4_grad_problem, mode):
    pr = rock4_grad_problem
    D1, D2, u0, ts, target = pr["ops"]
    rhs, _, _ = tcn.make_neural_rhs(torch.Generator().manual_seed(0), n=14, hidden=4,
                                    dtype=F64)
    p0 = params_from_jax(pr["p0"], dtype=F64)
    flat0, unravel = travel(p0)

    def loss(flat, adjoint):
        sol = tude.solve(tude.ODEProblem(rhs, u0, (0.0, 0.3), (unravel(flat), D1, D2)),
                         tude.ROCK4(stages=6, rho=pr["eig"] * 1.1), saveat=ts, rtol=1e-6,
                         atol=1e-8, adjoint=adjoint, max_steps=512)
        return torch.sum((sol.ys - target) ** 2)

    if mode == "interpolating_autograd":
        x = flat0.clone().requires_grad_(True)
        g = torch.autograd.grad(loss(x, tude.InterpolatingAdjoint()), x)[0]
        ref = pr["g_int"]
    else:
        g = torch.func.jacfwd(lambda x: loss(x, tude.ForwardSensitivity()))(flat0)
        ref = pr["g_fwd"]
    ref = travel(params_from_jax(ref, dtype=F64))[0]
    np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))
