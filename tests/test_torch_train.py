"""PyTorch port: BFGS and the fit loop against the JAX package (float64).

BFGS takes the same iterations and line-search evaluations as JAX's and its
iterates agree to 1e-8; the lane-batched form equals the per-lane runs to
1e-10.  ``fit`` with ``torch.optim.Adam(lr=0.1)`` follows ``optax.adam(0.1)``
to 1e-10 over 10 steps, and its callback, early-stop, ragged-tail and
optimizer-state behaviour mirrors ``tests/test_train.py``.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import universal_differential_equations_torch as tude
from universal_differential_equations_tpu.train import bfgs_minimize as j_bfgs
from universal_differential_equations_tpu.train import fit as j_fit

torch.set_num_threads(1)

F64 = torch.float64
A_NP = np.array([[3.0, 1.0], [1.0, 2.0]])
B_NP = np.array([1.0, -1.0])


def _rosen(p):
    return (1 - p["x"]) ** 2 + 100 * (p["y"] - p["x"] * p["x"]) ** 2


def _quad_j(x):
    return 0.5 * x @ jnp.asarray(A_NP) @ x - jnp.asarray(B_NP) @ x


def _quad_t(x):
    return 0.5 * x @ torch.tensor(A_NP) @ x - torch.tensor(B_NP) @ x


CASES = {
    "rosenbrock": (_rosen, _rosen, {"x": -1.2, "y": 1.0}, 300),
    "quadratic": (_quad_j, _quad_t, np.zeros(2), 50),
}


@pytest.mark.parametrize("kw", [{}, {"initial_stepnorm": 0.01},
                                {"ftol": 1e-12, "allow_f_increases": False}],
                         ids=["plain", "stepnorm", "ftol"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bfgs_matches_jax(case, kw):
    fj, ft, x0, maxiters = CASES[case]
    if isinstance(x0, dict):
        p_j = {k: jnp.asarray(v) for k, v in x0.items()}
        p_t = {k: torch.tensor(v, dtype=F64) for k, v in x0.items()}
    else:
        p_j, p_t = jnp.asarray(x0), torch.tensor(x0)
    rj = j_bfgs(fj, p_j, maxiters=maxiters, **kw)
    rt = tude.bfgs_minimize(ft, p_t, maxiters=maxiters, **kw)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.num_evals) == int(rj.num_evals)
    assert bool(rt.converged) == bool(rj.converged)
    flat_j = np.ravel([np.asarray(v) for v in (rj.params.values() if isinstance(x0, dict)
                                                else [rj.params])])
    flat_t = np.ravel([v.numpy() for v in (rt.params.values() if isinstance(x0, dict)
                                            else [rt.params])])
    np.testing.assert_allclose(flat_t, flat_j, rtol=1e-8, atol=1e-8)
    # the iterates' losses, +inf past convergence in both.  Rosenbrock's path
    # amplifies rounding ~10x per iteration (JAX against itself from a start
    # one ulp away differs by 4e-9 at iteration 12), so its history is held
    # over the first 10 iterations
    n_held = 10 if case == "rosenbrock" else maxiters
    np.testing.assert_allclose(rt.loss_history.numpy()[:n_held],
                               np.asarray(rj.loss_history)[:n_held], rtol=1e-8, atol=1e-12)
    assert rt.loss_history.shape == (maxiters,)
    assert np.isinf(rt.loss_history.numpy()[int(rt.iterations):]).all()
    if case == "quadratic":
        np.testing.assert_allclose(rt.params.numpy(), np.linalg.solve(A_NP, B_NP), rtol=1e-6)


@pytest.mark.parametrize("stepnorm", [None, 0.01])
def test_lane_batched_bfgs_equals_per_lane_runs(stepnorm):
    # independent Rosenbrock valleys, one per lane, that converge after
    # different iteration counts: finished lanes must stay fixed
    rng = np.random.default_rng(7)
    x0 = torch.tensor(rng.uniform(-1.5, 1.5, size=(4, 2)))
    shift = torch.tensor(rng.uniform(0.5, 1.5, size=(4,)))

    def one(x, s):
        return (s - x[..., 0]) ** 2 + 100 * (x[..., 1] - x[..., 0] ** 2) ** 2

    res = tude.bfgs_minimize_lanes(lambda X: one(X, shift), x0, maxiters=200,
                                   initial_stepnorm=stepnorm)
    assert res.params.shape == (4, 2) and res.loss_history.shape == (4, 200)
    for lane in range(4):
        single = tude.bfgs_minimize(lambda x, lane=lane: one(x, shift[lane]), x0[lane],
                                    maxiters=200, initial_stepnorm=stepnorm)
        assert int(res.iterations[lane]) == int(single.iterations)
        assert int(res.num_evals[lane]) == int(single.num_evals)
        torch.testing.assert_close(res.params[lane], single.params, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(res.loss_history[lane], single.loss_history,
                                   rtol=1e-10, atol=1e-10)


def _adam_loss_j(p):
    return jnp.sum((p["a"] - 3.0) ** 2) + 0.1 * jnp.sum(p["b"] ** 4) + jnp.sum(
        jnp.sin(p["a"][:2]) * p["b"][0])


def _adam_loss_t(p):
    return torch.sum((p["a"] - 3.0) ** 2) + 0.1 * torch.sum(p["b"] ** 4) + torch.sum(
        torch.sin(p["a"][:2]) * p["b"][0])


def test_adam_matches_optax_to_1e_10():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal(3), "b": rng.standard_normal((2, 2))}
    rj = j_fit(_adam_loss_j, {k: jnp.asarray(v) for k, v in p0.items()}, optax.adam(0.1), 10,
               callback_every=4)
    rt = tude.fit(_adam_loss_t, {k: torch.tensor(v) for k, v in p0.items()},
                  lambda ps: torch.optim.Adam(ps, lr=0.1), 10, callback_every=4)
    for k in p0:
        np.testing.assert_allclose(rt.params[k].numpy(), np.asarray(rj.params[k]),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses), rtol=1e-10)


def test_fit_adam_converges():
    res = tude.fit(lambda p: torch.sum((p - 3.0) ** 2), torch.zeros(4, dtype=F64),
                   lambda ps: torch.optim.Adam(ps, lr=0.1), 300, callback_every=100)
    assert res.final_loss < 1e-8
    assert res.num_steps == 300 and res.losses.shape == (300,)


def test_fit_callback_early_stop_matches_jax():
    calls_j, calls_t = [], []

    def cb(calls):
        def f(step, loss, params):
            calls.append((step, loss))
            return loss < 1e-3  # stop
        return f

    rj = j_fit(lambda p: jnp.sum(p ** 2), jnp.ones(2), optax.adam(0.2), 1000,
               callback=cb(calls_j), callback_every=25)
    rt = tude.fit(lambda p: torch.sum(p ** 2), torch.ones(2, dtype=F64),
                  lambda ps: torch.optim.Adam(ps, lr=0.2), 1000, callback=cb(calls_t),
                  callback_every=25)
    assert rt.stopped_early and rt.num_steps < 1000
    assert rt.num_steps == rj.num_steps
    assert [s for s, _ in calls_t] == [s for s, _ in calls_j]
    np.testing.assert_allclose([v for _, v in calls_t], [v for _, v in calls_j], rtol=1e-10)


def test_fit_early_stop_loss_threshold():
    res = tude.fit(lambda p: torch.sum(p ** 2), torch.ones(2, dtype=F64),
                   lambda ps: torch.optim.Adam(ps, lr=0.2), 1000, callback_every=25,
                   early_stop_loss=1e-4)
    rj = j_fit(lambda p: jnp.sum(p ** 2), jnp.ones(2), optax.adam(0.2), 1000,
               callback_every=25, early_stop_loss=1e-4)
    assert res.stopped_early and res.num_steps == rj.num_steps


def test_fit_ragged_tail():
    steps = []
    res = tude.fit(lambda p: torch.sum(p ** 2), torch.ones(2, dtype=F64),
                   lambda ps: torch.optim.Adam(ps, lr=0.1), 130,
                   callback=lambda s, l, p: steps.append(s), callback_every=50)
    assert res.num_steps == 130 and res.losses.shape == (130,)
    assert steps == [50, 100, 130] and not res.stopped_early


def test_fit_opt_state_continuation():
    # two chained 50-step fits land where one 100-step fit does (the ADAM
    # moments and step count carry over), and differ from a fresh second fit
    def loss(p):
        return torch.sum((p - 3.0) ** 2) + 0.1 * torch.sum(p ** 2)

    p0 = torch.zeros(4, dtype=F64)

    def opt(ps):
        return torch.optim.Adam(ps, lr=0.05)

    r_one = tude.fit(loss, p0, opt, 100)
    r_a = tude.fit(loss, p0, opt, 50)
    r_b = tude.fit(loss, r_a.params, opt, 50, opt_state=r_a.opt_state)
    torch.testing.assert_close(r_b.params, r_one.params, rtol=1e-12, atol=1e-12)
    r_fresh = tude.fit(loss, r_a.params, opt, 50)
    assert not torch.allclose(r_fresh.params, r_one.params, rtol=1e-6, atol=1e-7)
    # the stored state is not changed by a continuation that used it
    r_b2 = tude.fit(loss, r_a.params, opt, 50, opt_state=r_a.opt_state)
    torch.testing.assert_close(r_b2.params, r_b.params, rtol=0.0, atol=0.0)
    # and the chain matches JAX's chained fits
    jl = lambda p: jnp.sum((p - 3.0) ** 2) + 0.1 * jnp.sum(p ** 2)  # noqa: E731
    j_a = j_fit(jl, jnp.zeros(4), optax.adam(0.05), 50)
    j_b = j_fit(jl, j_a.params, optax.adam(0.05), 50, opt_state=j_a.opt_state)
    np.testing.assert_allclose(r_b.params.numpy(), np.asarray(j_b.params), rtol=1e-10)


def test_fit_bfgs_is_bfgs_minimize():
    a = tude.fit_bfgs(_quad_t, torch.zeros(2, dtype=F64), maxiters=50)
    b = tude.bfgs_minimize(_quad_t, torch.zeros(2, dtype=F64), maxiters=50)
    torch.testing.assert_close(a.params, b.params, rtol=0.0, atol=0.0)


def test_reduce_on_plateau():
    sched = tude.reduce_on_plateau(0.1, factor=0.1, patience=1)
    assert sched(1.0) == 0.1
    assert sched(0.5) == 0.1  # improving
    assert sched(0.6) == 0.1  # stale 1
    assert abs(sched(0.6) - 0.01) < 1e-12  # stale 2 > patience → decay
