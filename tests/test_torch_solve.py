"""PyTorch port: solve, the stepper, step control and dense output against JAX.

The same problem (the Fisher-KPP or Lotka-Volterra truth RHS, in float64)
goes through both packages' ``solve``; step counts must be equal and
trajectories agree to 1e-9.  Fixed-step integration agrees to 1e-12 and the
error norms to 1e-14.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.core.solution import DenseInterpolation
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_tpu.models import fisher_kpp as jfk

torch.set_num_threads(1)

F64 = torch.float64


def _problems(tspan=(0.0, 5.0), scale=1.0):
    """The same Fisher-KPP truth problem in both packages (float64)."""
    u0 = np.asarray(jfk.rho0(jnp.float64)) * scale
    pj = jude.ODEProblem(jfk.true_rhs, jnp.asarray(u0), tspan)
    pt = tude.ODEProblem(tfk.true_rhs, torch.tensor(u0), tspan)
    return pj, pt


_ADJOINTS = {
    "NoAdjoint": (jude.NoAdjoint, tude.NoAdjoint),
    "DiscreteAdjoint": (jude.DiscreteAdjoint, tude.DiscreteAdjoint),
    "ForwardSensitivity": (jude.ForwardSensitivity, tude.ForwardSensitivity),
}


def _assert_same_solution(sj, st, tol=1e-9):
    assert bool(st.success) == bool(sj.success)
    assert int(st.num_accepted) == int(sj.num_accepted)
    assert int(st.num_rejected) == int(sj.num_rejected)
    assert int(st.num_rhs_evals) == int(sj.num_rhs_evals)
    np.testing.assert_allclose(st.ys.numpy(), np.asarray(sj.ys), rtol=tol, atol=tol)


def test_tsit5_tableau_is_a_digit_for_digit_copy():
    from universal_differential_equations_torch.solvers.tableaus import TABLEAUS as T
    from universal_differential_equations_tpu.solvers.tableaus import TABLEAUS as J

    assert dataclasses.asdict(T["Tsit5"]) == dataclasses.asdict(J["Tsit5"])
    assert tude.Tsit5().dense_nodes == jude.Tsit5().dense_nodes == 3


@pytest.mark.parametrize("adjoint", ["NoAdjoint", "ForwardSensitivity"])
def test_truth_solve_step_to_saveat_matches_jax(adjoint):
    pj, pt = _problems()
    ts = np.arange(0.0, 5.25, 0.5)
    aj, at = _ADJOINTS[adjoint]
    kw = dict(rtol=1e-8, atol=1e-10, step_to_saveat=True)
    sj = jude.solve(pj, jude.Tsit5(), saveat=jnp.asarray(ts), adjoint=aj(), **kw)
    st = tude.solve(pt, tude.Tsit5(), saveat=torch.tensor(ts), adjoint=at(), **kw)
    _assert_same_solution(sj, st)


@pytest.mark.parametrize("adjoint", ["NoAdjoint", "DiscreteAdjoint"])
def test_dense_output_matches_jax(adjoint):
    # off-grid saves and sol(t, nu) go through the quintic Hermite window.
    # Tolerances tight enough that the error estimate stays well above
    # round-off: at rtol=1e-6 it reaches round-off size late in the run,
    # where the two packages' last-bit differences pick different step sizes
    # (same counts, saves 5e-7 apart).
    pj, pt = _problems()
    ts = np.linspace(0.0, 5.0, 23)
    aj, at = _ADJOINTS[adjoint]
    kw = dict(rtol=1e-8, atol=1e-10, dense=True, max_steps=256)
    sj = jude.solve(pj, jude.Tsit5(), saveat=jnp.asarray(ts), adjoint=aj(), **kw)
    st = tude.solve(pt, tude.Tsit5(), saveat=torch.tensor(ts), adjoint=at(), **kw)
    _assert_same_solution(sj, st)
    tq = np.array([0.013, 1.7, 3.33, 4.999])
    for nu in (0, 1):
        np.testing.assert_allclose(st(torch.tensor(tq), nu).numpy(),
                                   np.asarray(sj(jnp.asarray(tq), nu)),
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(st(2.5).numpy(), np.asarray(sj(2.5)), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["budget", "backward", "empty_span"])
def test_edge_solves_match_jax(case):
    # step-budget exhaustion (success False, clamped tail), a backward solve
    # (direction -1; short, since backward diffusion blows up) and a
    # zero-length span
    tspan = {"budget": (0.0, 5.0), "backward": (0.2, 0.0), "empty_span": (1.0, 1.0)}[case]
    pj, pt = _problems(tspan)
    ts = np.linspace(*tspan, 5)
    kw = dict(rtol=1e-7, atol=1e-9, max_steps=5 if case == "budget" else 512)
    sj = jude.solve(pj, jude.Tsit5(), saveat=jnp.asarray(ts), adjoint=jude.NoAdjoint(), **kw)
    st = tude.solve(pt, tude.Tsit5(), saveat=torch.tensor(ts), adjoint=tude.NoAdjoint(), **kw)
    assert bool(st.success) == (case != "budget")
    _assert_same_solution(sj, st)
    np.testing.assert_allclose(float(st.t_final), float(sj.t_final), rtol=1e-9, atol=1e-9)


def test_discrete_adjoint_gradient_matches_jax():
    # reverse mode through the stepping loop, with and without per-attempt
    # recomputation; the loss depends on a parameter scaling the reaction
    u0 = np.asarray(jfk.rho0(jnp.float64))
    ts = np.linspace(0.0, 1.0, 5)

    def rhs_j(t, u, p):
        return p[0] * u * (1.0 - u) + p[1] * jfk.periodic_laplacian(u)

    def rhs_t(t, u, p):
        return p[0] * u * (1.0 - u) + p[1] * tfk.periodic_laplacian(u)

    p_np = np.array([1.3, 0.02])

    def loss_j(p):
        sol = jude.solve(jude.ODEProblem(rhs_j, jnp.asarray(u0), (0.0, 1.0), p), jude.Tsit5(),
                         saveat=jnp.asarray(ts), rtol=1e-6, atol=1e-8,
                         adjoint=jude.DiscreteAdjoint(), max_steps=64)
        return jnp.sum(sol.ys ** 2)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(p_np)))
    for checkpoint in (True, False):
        p_t = torch.tensor(p_np, requires_grad=True)
        sol = tude.solve(tude.ODEProblem(rhs_t, torch.tensor(u0), (0.0, 1.0), p_t), tude.Tsit5(),
                         saveat=torch.tensor(ts), rtol=1e-6, atol=1e-8,
                         adjoint=tude.DiscreteAdjoint(checkpoint=checkpoint), max_steps=64)
        (g_t,) = torch.autograd.grad(torch.sum(sol.ys ** 2), p_t)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-9, atol=1e-9)
        assert sol.error_sum is not None and torch.isfinite(sol.error_sum)


def test_controller_pieces_match_jax():
    from universal_differential_equations_torch.core import controller as tc
    from universal_differential_equations_tpu.core import controller as jc

    rng = np.random.default_rng(0)
    err, y0, y1 = (rng.standard_normal(7) for _ in range(3))
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    np.testing.assert_allclose(float(tc.hairer_norm(t(err), t(y0), t(y1), 1e-3, 1e-6)),
                               float(jc.hairer_norm(err, y0, y1, 1e-3, 1e-6)), rtol=1e-14)
    for e, acc in ((0.3, True), (4.0, False), (1e-14, True)):
        dt_t, ep_t = tc.PIController().next_dt(t(0.1), t(e), t(2e-3), torch.tensor(acc), 5)
        dt_j, ep_j = jc.PIController().next_dt(0.1, e, 2e-3, acc, 5)
        np.testing.assert_allclose([float(dt_t), float(ep_t)], [float(dt_j), float(ep_j)],
                                   rtol=1e-14)
    u0 = np.asarray(jfk.rho0(jnp.float64))
    h_t = tc.initial_step_size(tfk.true_rhs, t(0.0), t(u0), tfk.true_rhs(0, t(u0), None),
                               5, 1e-4, 1e-6, None)
    h_j = jc.initial_step_size(jfk.true_rhs, 0.0, jnp.asarray(u0),
                               jfk.true_rhs(0, jnp.asarray(u0), None), 5, 1e-4, 1e-6, None)
    np.testing.assert_allclose(float(h_t), float(h_j), rtol=1e-13)


def test_dense_output_guards_the_inf_slot():
    # a one-point buffer pairs the start with an untouched +inf slot: h must
    # be guarded against inf as well as 0, or 0·inf = NaN
    ys = torch.tensor([[1.0, 2.0], [0.0, 0.0]], dtype=F64)
    fs = torch.tensor([[0.5, -1.0], [3.0, 0.0]], dtype=F64)
    dense = DenseInterpolation(
        ts=torch.tensor([0.0, float("inf")], dtype=F64), ys=ys, fs=fs,
        num_points=torch.tensor(1), direction=torch.tensor(1.0, dtype=F64), nodes=3)
    out = dense(torch.tensor([0.0, 0.5], dtype=F64))
    np.testing.assert_array_equal(out.numpy(), [[1.0, 2.0], [1.0, 2.0]])


def test_ravel_pytree_uses_jax_order():
    from jax.flatten_util import ravel_pytree as jravel

    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal(3), "D0": np.float64(2.0),
            "rx": [{"w": rng.standard_normal((2, 1)), "b": rng.standard_normal(2)},
                   {"w": rng.standard_normal((1, 2)), "b": rng.standard_normal(1)}]}
    flat_j, _ = jravel(jax.tree.map(jnp.asarray, tree))
    flat_t, unravel = ravel_pytree(tude.params_from_jax(tree, dtype=F64))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel(flat_t)
    np.testing.assert_array_equal(back["rx"][0]["w"].numpy(), tree["rx"][0]["w"])
    assert back["D0"].shape == ()
    batched = unravel(torch.stack([flat_t, 2 * flat_t]))
    assert batched["rx"][1]["w"].shape == (2, 1, 2)


@pytest.mark.parametrize("case", ["sde", "dae", "saveat_2d", "saveat_outside",
                                  "shape", "f_raises", "not_callable"])
def test_solve_rejects_bad_problems(case):
    from universal_differential_equations_torch.core.problem import DAEProblem, SDEProblem

    u0 = torch.ones(3, dtype=F64)

    def f(t, u, a):
        return -u

    prob = tude.ODEProblem(f, u0, (0.0, 1.0))
    kwargs = {}
    expect = ValueError
    if case == "sde":
        prob, expect = SDEProblem(f, f, u0, (0.0, 1.0)), TypeError
    elif case == "dae":
        prob, expect = DAEProblem(f, u0, u0, (0.0, 1.0)), TypeError
    elif case == "saveat_2d":
        kwargs["saveat"] = torch.zeros(2, 2, dtype=F64)
    elif case == "saveat_outside":
        kwargs["saveat"] = torch.tensor([0.0, 2.0], dtype=F64)
    elif case == "shape":
        prob = tude.remake(prob, f=lambda t, u, a: u[:2])
    elif case == "f_raises":
        prob, expect = tude.remake(prob, f=lambda t, u, a: u @ torch.ones(2, 2)), TypeError
    elif case == "not_callable":
        expect = TypeError
    with pytest.raises(expect):
        if case == "not_callable":
            prob = tude.ODEProblem(None, u0, (0.0, 1.0))
        tude.solve(prob, **kwargs)


def test_vern7_tableau_is_a_digit_for_digit_copy():
    from universal_differential_equations_torch.solvers.tableaus import TABLEAUS as T
    from universal_differential_equations_tpu.solvers.tableaus import TABLEAUS as J

    assert dataclasses.asdict(T["Vern7"]) == dataclasses.asdict(J["Vern7"])
    assert not T["Vern7"].fsal
    assert tude.Vern7().dense_nodes == jude.Vern7().dense_nodes == 4


def _lv_rhs(pkg_stack):
    def rhs(t, u, p):
        return pkg_stack([p[0] * u[0] - p[1] * u[0] * u[1], p[2] * u[0] * u[1] - p[3] * u[1]])
    return rhs


LV_P = np.array([1.3, 0.9, 0.8, 1.8])
LV_U0 = np.array([0.44249296, 4.6280594])


def test_vern7_lv_truth_matches_jax():
    # the scenario's truth solve: Vern7 at 1e-12 landing on every save point.
    # Vern7 is not FSAL: each attempt costs 10 RHS evaluations in both
    # packages, after 3 for f(t0) and the automatic initial step
    ts = np.arange(0.0, 3.05, 0.1)
    kw = dict(rtol=1e-12, atol=1e-12, step_to_saveat=True)
    sj = jude.solve(jude.ODEProblem(_lv_rhs(jnp.stack), jnp.asarray(LV_U0), (0.0, 3.0),
                                    jnp.asarray(LV_P)), jude.Vern7(), saveat=jnp.asarray(ts),
                    adjoint=jude.NoAdjoint(), **kw)
    st = tude.solve(tude.ODEProblem(_lv_rhs(torch.stack), torch.tensor(LV_U0), (0.0, 3.0),
                                    torch.tensor(LV_P)), tude.Vern7(), saveat=torch.tensor(ts),
                    adjoint=tude.NoAdjoint(), **kw)
    assert bool(st.success)
    assert int(st.num_rhs_evals) == 3 + 10 * (int(st.num_accepted) + int(st.num_rejected))
    _assert_same_solution(sj, st)


@pytest.mark.parametrize("solver", ["Tsit5", "Vern7"])
def test_integrate_fixed_matches_jax_and_lanes_match_single(solver):
    from universal_differential_equations_torch.core.integrate import integrate_fixed as t_fixed
    from universal_differential_equations_tpu.core.integrate import integrate_fixed as j_fixed

    ts_j, ys_j = j_fixed(_lv_rhs(jnp.stack), jnp.asarray(LV_U0), 0.0, 3.0, jnp.asarray(LV_P),
                         getattr(jude, solver)(), 24)
    ts_t, ys_t = t_fixed(_lv_rhs(torch.stack), torch.tensor(LV_U0), 0.0, 3.0,
                         torch.tensor(LV_P), getattr(tude, solver)(), 24)
    assert ys_t.shape == (25, 2)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-12, atol=1e-12)

    # lanes: (L, d) states with parameters batched along L; each lane equals
    # its own single-state run
    rng = np.random.default_rng(2)
    u0s = LV_U0 * rng.uniform(0.8, 1.2, size=(3, 2))
    ps = LV_P * rng.uniform(0.9, 1.1, size=(3, 4))

    def lane_rhs(t, u, p):
        return torch.stack([p[:, 0] * u[:, 0] - p[:, 1] * u[:, 0] * u[:, 1],
                            p[:, 2] * u[:, 0] * u[:, 1] - p[:, 3] * u[:, 1]], -1)

    _, ys_l = t_fixed(lane_rhs, torch.tensor(u0s), 0.0, 3.0, torch.tensor(ps),
                      getattr(tude, solver)(), 24)
    assert ys_l.shape == (3, 25, 2)
    for lane in range(3):
        _, ys_1 = t_fixed(_lv_rhs(torch.stack), torch.tensor(u0s[lane]), 0.0, 3.0,
                          torch.tensor(ps[lane]), getattr(tude, solver)(), 24)
        np.testing.assert_allclose(ys_l[lane].numpy(), ys_1.numpy(), rtol=1e-12, atol=1e-12)


def test_hairer_seminorm_matches_jax():
    from universal_differential_equations_torch.core import controller as tc
    from universal_differential_equations_tpu.core import controller as jc

    rng = np.random.default_rng(4)
    err, y0, y1 = (rng.standard_normal(9) for _ in range(3))
    w = (rng.uniform(size=9) > 0.4).astype(np.float64)
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    for weights in (w, np.zeros(9)):
        np.testing.assert_allclose(
            float(tc.hairer_norm(t(err), t(y0), t(y1), 1e-3, 1e-6, t(weights))),
            float(jc.hairer_norm(err, y0, y1, 1e-3, 1e-6, jnp.asarray(weights))), rtol=1e-14)


def test_err_weights_exclude_components_from_step_control():
    # mirrors tests/test_adjoint.py::test_error_weights_seminorm_step_control,
    # with the step counts held against the JAX package's
    from universal_differential_equations_torch.core.integrate import integrate_while as t_while
    from universal_differential_equations_tpu.core.integrate import integrate_while as j_while

    def f_t(t, y, args):
        return torch.stack([torch.cos(t), 200.0 * torch.cos(200.0 * t)])

    def f_j(t, y, args):
        return jnp.array([jnp.cos(t), 200.0 * jnp.cos(200.0 * t)])

    y0 = np.zeros(2)
    for w in (None, np.array([1.0, 0.0])):
        rt = t_while(f_t, torch.tensor(y0), 0.0, 3.0, None, tude.Tsit5(), 1e-8, 1e-8, None, 8192,
                     err_weights=None if w is None else torch.tensor(w))
        rj = j_while(f_j, jnp.asarray(y0), 0.0, 3.0, None, jude.Tsit5(), 1e-8, 1e-8, None, 8192,
                     err_weights=None if w is None else jnp.asarray(w))
        assert bool(rt.success) and int(rt.n_acc) == int(rj.n_acc)
        assert int(rt.n_rej) == int(rj.n_rej)
        np.testing.assert_allclose(rt.y_final[0].numpy(), np.asarray(rj.y_final[0]),
                                   rtol=1e-9, atol=1e-9)
        if w is None:
            # the 200 rad/s row integrates to sin(600) = 0.044: the packages'
            # last-bit step-size differences move it by 6e-9, inside the
            # solver's 1e-8 tolerance.  With weight 0 it is not controlled:
            # the coarse steps alias the oscillation to an O(100) value that
            # carries no accuracy to compare
            np.testing.assert_allclose(rt.y_final[1].numpy(), np.asarray(rj.y_final[1]),
                                       rtol=0.0, atol=1e-8)
        else:
            assert int(rt.n_acc) < 0.3 * n_full
            assert abs(float(rt.y_final[0]) - np.sin(3.0)) < 1e-6
        n_full = int(rt.n_acc)


def test_default_adjoint_is_interpolating_with_the_4096_budget():
    # solve() with no adjoint: InterpolatingAdjoint and its 4096-attempt
    # budget in both packages.  This oscillator needs ~630 steps, past the
    # discrete adjoint's 512, so a DiscreteAdjoint default would return
    # success=False here; the gradients must agree.
    ts = np.linspace(0.0, 3.0, 7)

    def loss_j(p):
        sol = jude.solve(jude.ODEProblem(lambda t, u, q: q[0] * jnp.stack([u[1], -u[0]]),
                                         jnp.array([1.0, 0.0]), (0.0, 3.0), p),
                         jude.Tsit5(), saveat=jnp.asarray(ts), rtol=1e-8, atol=1e-8)
        return jnp.sum(sol.ys)

    p = torch.tensor([20.0], dtype=F64, requires_grad=True)
    sol = tude.solve(tude.ODEProblem(lambda t, u, q: q[0] * torch.stack([u[1], -u[0]]),
                                     torch.tensor([1.0, 0.0], dtype=F64), (0.0, 3.0), p),
                     tude.Tsit5(), saveat=torch.tensor(ts), rtol=1e-8, atol=1e-8)
    assert bool(sol.success) and int(sol.num_accepted) > 512
    (g_t,) = torch.autograd.grad(sol.ys.sum(), p)
    g_j = np.asarray(jax.grad(loss_j)(jnp.array([20.0])))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-9)
