"""PyTorch port: simulation-validated SINDy selection against the JAX package (float64).

``sindy/select.py``'s ``best_per_support`` and ``cv_ladder`` select the same
supports as the JAX package's (coefficients to 1e-9 relative), and
``select_by_simulation``, handed JAX's own ladders, picks the same support and
total size k in each judging mode: trajectory error only, the BFGS refit
judge over every combination or the top ones per size with a holdout, and the
Levenberg-Marquardt refit judge.  The data are the Lotka-Volterra truth with
JAX's noise; the targets are the true interactions plus numpy noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import sindy as tsd
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.models import lotka_volterra as jlv

torch.set_num_threads(1)

F64 = torch.float64
LAMS = tuple(10.0 ** e for e in np.arange(-3.0, 2.0, 0.25))
ALPHA, DELTA = 1.3, 1.8


@pytest.fixture(scope="module")
def case():
    ts, X, Xn = jlv.generate_data(jax.random.PRNGKey(7))
    X, Xn = np.asarray(X), np.asarray(Xn)
    xy = X[:, 0] * X[:, 1]
    noise = 1e-3 * np.random.default_rng(3).standard_normal((X.shape[0], 2))
    Y = np.stack([-0.9 * xy, 0.8 * xy], -1) + noise
    basis_j = jsd.polynomial_basis(2, 3) + jsd.sin_basis(2)
    basis_t = tsd.polynomial_basis(2, 3) + tsd.sin_basis(2)
    assert basis_j.names == basis_t.names
    theta = np.asarray(basis_j.theta(jnp.asarray(X)))
    names = basis_t.names
    excl = ([names.index("u1")], [names.index("u2")])
    # JAX's ladders, the input of every select_by_simulation case
    ladders = [jsd.cv_ladder(theta, Y[:, e], jsd.STLSQ(LAMS), 3, exclude=excl[e])
               for e in (0, 1)]
    return dict(ts=np.asarray(ts), X=X, Xn=Xn, Y=Y, basis_j=basis_j, basis_t=basis_t,
                theta=theta, ladders=[tuple(np.asarray(a) for a in lad) for lad in ladders])


def test_best_per_support_matches_jax():
    rng = np.random.default_rng(0)
    active = rng.random((40, 8)) < 0.3
    xi = rng.standard_normal((40, 8)) * active
    score = rng.random(40)
    score[::7] = np.inf
    for per_size in (1, 2):
        xk_j, ok_j = jsd.best_per_support(xi, active, score, 4, per_size=per_size)
        xk_t, ok_t = tsd.best_per_support(torch.tensor(xi), torch.tensor(active),
                                          torch.tensor(score), 4, per_size=per_size)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(xk_t.numpy(), np.asarray(xk_j))


def test_cv_ladder_matches_jax(case):
    theta, names = case["theta"], case["basis_t"].names
    extra = np.zeros((3, theta.shape[1]), bool)
    extra[0, [names.index("u1*u2")]] = True
    extra[1, [names.index("u1*u2"), names.index("u1^2")]] = True
    extra[2, [names.index("u2"), names.index("u1*u2")]] = True
    for e, excl, kw in ((0, [names.index("u1")], dict()),
                        (1, [names.index("u2")], dict(extra_supports=extra, per_size=2))):
        xk_j, ok_j = jsd.cv_ladder(theta, case["Y"][:, e], jsd.STLSQ(LAMS), 3,
                                   exclude=excl, **kw)
        xk_t, ok_t = tsd.cv_ladder(torch.tensor(theta), torch.tensor(case["Y"][:, e]),
                                   tsd.STLSQ(LAMS), 3, exclude=excl, **kw)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(xk_t.numpy() != 0, np.asarray(xk_j) != 0)
        np.testing.assert_allclose(xk_t.numpy(), np.asarray(xk_j), rtol=1e-9, atol=1e-12)


def _jax_rhs(basis):
    def f(t, u, C):  # one lane, as the JAX package takes it
        th = basis.theta(u[None, :])[0]
        return jnp.stack([ALPHA * u[0] + th @ C[:, 0], -DELTA * u[1] + th @ C[:, 1]])
    return f


def _torch_rhs(basis):
    def f(t, u, C):  # a batch of lanes, as the port takes it
        z = torch.einsum("lm,lmd->ld", basis.theta(u), C)
        return torch.stack([ALPHA * u[:, 0] + z[:, 0], -DELTA * u[:, 1] + z[:, 1]], -1)
    return f


MODES = {
    "trajectory": dict(refit_iters=0, rel_factor=1.5),
    "bfgs_all": dict(refit_iters=6, refit_all=True, max_total_support=4, loss_floor=1e-6),
    "bfgs_top_holdout": dict(refit_iters=6, refit_top=[2, 1, 1, 1], max_total_support=5,
                             holdout_stride=3, loss_floor=1e-6),
    "lm": dict(refit_iters=4, refit_method="lm", refit_all=True, max_total_support=4,
               loss_floor=1e-6),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_select_by_simulation_from_jax_ladders_matches_jax(case, mode):
    ladders = case["ladders"]
    kw = dict(sub=2, **MODES[mode])
    n_steps = (case["Xn"].shape[0] - 1) * 2
    C_j, s_j, k_j = jsd.select_by_simulation(
        ladders, _jax_rhs(case["basis_j"]), jnp.asarray(case["Xn"][0]),
        0.0, 3.0, jnp.asarray(case["Xn"]), jude.Tsit5(), n_steps, **kw)
    C_t, s_t, k_t = tsd.select_by_simulation(
        [(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(o))) for x, o in ladders],
        _torch_rhs(case["basis_t"]), torch.tensor(case["Xn"][0]), 0.0,
        3.0, torch.tensor(case["Xn"]), tude.Tsit5(), n_steps, **kw)
    assert int(k_t) == int(k_j)
    np.testing.assert_array_equal(C_t.numpy() != 0, np.asarray(C_j) != 0)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
