"""PyTorch port: simulation-validated SINDy selection against the JAX package (float64).

``sindy/select.py``'s ``best_per_support`` and ``cv_ladder`` select the same
supports as the JAX package's (coefficients to 1e-9 relative), and
``select_by_simulation``, handed JAX's own ladders, picks the same support and
total size k in each judging mode: trajectory error only, the BFGS refit
judge over every combination or the top ones per size with a holdout, and the
Levenberg-Marquardt refit judge.  The data are the Lotka-Volterra truth with
JAX's noise; the targets are the true interactions plus numpy noise.  The
SR3 → STRRidge ``two_stage_recovery`` gives the same supports and
coefficients to 1e-10, also under ``torch.func.vmap``, and
``stability_selection`` handed JAX's Bernoulli row mask gives the same
frequencies (mirrors of ``tests/test_sindy.py``'s tests).  One float32 case
holds an exactly singular support: ``masked_lstsq`` returns JAX's inf/NaN
pattern and ``cv_ladder`` keeps JAX's rungs.
"""
import itertools

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

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

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


def test_singular_float32_support_carries_on_like_jax():
    # a library with u1 twice: every support holding both copies is an exactly
    # singular system, on which jnp.linalg.solve returns inf/NaN and the JAX
    # selection carries on (the port's masked_lstsq must not raise)
    from universal_differential_equations_tpu.sindy.optimizers import masked_lstsq as j_lstsq

    rng = np.random.default_rng(0)
    X = rng.uniform(0.5, 2.0, (60, 2)).astype(np.float32)
    theta = np.asarray(jsd.polynomial_basis(2, 2).theta(jnp.asarray(X)))
    theta = np.concatenate([theta, theta[:, 1:2]], 1).astype(np.float32)
    m = theta.shape[1]
    y = 1.5 * theta[:, 2] - 0.7 * theta[:, 4] + 1e-3 * rng.standard_normal(60)
    y = y.astype(np.float32)
    pairs = np.asarray([[i in c for i in range(m)] for c in itertools.combinations(range(m), 2)])
    extra = np.concatenate([np.eye(m, dtype=bool), pairs])
    assert (extra[:, 1] & extra[:, 6]).any()
    gram, corr = theta.T @ theta, theta.T @ y
    x_j = np.stack([np.asarray(j_lstsq(jnp.asarray(gram), jnp.asarray(corr), jnp.asarray(s)))
                    for s in extra])
    x_t = tsd.masked_lstsq(torch.tensor(gram), torch.tensor(corr), torch.tensor(extra))
    assert x_t.dtype == torch.float32
    np.testing.assert_array_equal(np.isfinite(x_t.numpy()), np.isfinite(x_j))
    assert not np.isfinite(x_j).all()
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-5, atol=1e-6)  # equal_nan
    lams = tuple(10.0 ** e for e in np.arange(-3.0, 1.0, 0.25))
    xk_j, ok_j = jsd.cv_ladder(jnp.asarray(theta), jnp.asarray(y), jsd.STLSQ(lams), 3,
                               per_size=2, extra_supports=extra)
    xk_t, ok_t = tsd.cv_ladder(torch.tensor(theta), torch.tensor(y), tsd.STLSQ(lams), 3,
                               per_size=2, extra_supports=extra)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(xk_t.numpy() != 0, np.asarray(xk_j) != 0)
    np.testing.assert_allclose(xk_t.numpy(), np.asarray(xk_j), rtol=1e-5, atol=1e-6)


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


def _lv_like_data(key, N=200):
    """tests/test_sindy.py's LV-like regression data."""
    X = jax.random.uniform(key, (N, 2), minval=0.2, maxval=3.0)
    Y = jnp.stack([1.5 * X[:, 0] - 0.7 * X[:, 0] * X[:, 1],
                   -2.0 * X[:, 1] + 0.4 * X[:, 0] * X[:, 1]], axis=1)
    return X, Y


@pytest.mark.parametrize("denoise", [False, True])
def test_two_stage_recovery_matches_jax(denoise):
    key = jax.random.PRNGKey(0)
    X, Y = _lv_like_data(key)
    basis = jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)
    theta = np.asarray(basis.theta(X))
    Yn = np.asarray(Y + 1e-3 * jax.random.normal(jax.random.fold_in(key, 1), Y.shape))
    lams = tuple(10.0 ** e for e in np.arange(-7.0, 7.0, 0.1))
    C_j = np.asarray(jsd.two_stage_recovery(theta, Yn, lams, denoise=denoise))
    C_t = tsd.two_stage_recovery(torch.tensor(theta), torch.tensor(Yn), lams,
                                 denoise=denoise).numpy()
    np.testing.assert_array_equal(np.abs(C_t) > 1e-10, np.abs(C_j) > 1e-10)
    np.testing.assert_allclose(C_t, C_j, rtol=1e-10, atol=1e-10 * np.abs(C_j).max())
    if not denoise:  # the reference protocol recovers the structure exactly
        names = basis.names
        want = np.zeros_like(C_t, bool)
        want[[names.index("u1"), names.index("u1*u2")], 0] = True
        want[[names.index("u2"), names.index("u1*u2")], 1] = True
        np.testing.assert_array_equal(np.abs(C_t) > 1e-10, want)


def test_two_stage_recovery_rejects_empty_and_vmaps_like_jax():
    X, Y = _lv_like_data(jax.random.PRNGKey(3), N=60)
    theta = np.asarray(jsd.polynomial_basis(2, 3).theta(X))
    lams = tuple(10.0 ** e for e in np.arange(-4.0, 6.0, 0.25))
    C_j = np.asarray(jsd.two_stage_recovery(theta, Y, lams, denoise=False))
    C_t = tsd.two_stage_recovery(torch.tensor(theta), torch.tensor(np.asarray(Y)), lams,
                                 denoise=False).numpy()
    # the g objective rejects the empty model: a term survives per target
    assert (np.abs(C_t) > 1e-10).any(axis=0).all()
    np.testing.assert_allclose(C_t, C_j, rtol=1e-10, atol=1e-10 * np.abs(C_j).max())
    # lanes of an ensemble: torch.func.vmap over a batch of targets
    Ys = np.stack([np.asarray(Y), 1.1 * np.asarray(Y), 0.9 * np.asarray(Y)])
    Cs_j = np.asarray(jax.vmap(lambda y: jsd.two_stage_recovery(theta, y, lams))(Ys))
    Cs_t = torch.func.vmap(lambda y: tsd.two_stage_recovery(torch.tensor(theta), y, lams))(
        torch.tensor(Ys)).numpy()
    assert Cs_t.shape == (3, theta.shape[1], 2)
    np.testing.assert_array_equal(np.abs(Cs_t) > 1e-10, np.abs(Cs_j) > 1e-10)
    np.testing.assert_allclose(Cs_t, Cs_j, rtol=1e-10, atol=1e-10 * np.abs(Cs_j).max())


def test_stability_selection_matches_jax_for_its_mask():
    from universal_differential_equations_torch.sindy.select import _selection_frequencies

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    N, m = 60, 10
    theta = jax.random.normal(k1, (N, m))
    xi_true = jnp.zeros((m,)).at[2].set(1.5).at[7].set(-0.8)
    y = theta @ xi_true + 0.05 * jax.random.normal(k2, (N,))
    lams = tuple(10.0 ** e for e in np.arange(-3.0, 1.0, 0.25))
    # the rows jax.random drew inside stability_selection
    keep = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(7), 0.7, (64, N)))
    th_t, y_t = torch.tensor(np.asarray(theta)), torch.tensor(np.asarray(y))
    for max_support in (4, 0):
        f_j = np.asarray(jsd.stability_selection(theta, y, jsd.STLSQ(lams),
                                                 jax.random.PRNGKey(7), n_subsets=64,
                                                 frac=0.7, max_support=max_support))
        f_t = _selection_frequencies(th_t, y_t, tsd.STLSQ(lams), torch.tensor(keep),
                                     max_support, True)
        np.testing.assert_array_equal(f_t.numpy(), f_j)
    # the generator form: deterministic, the true support stable
    kw = dict(n_subsets=64, frac=0.7, max_support=4)
    f_a = tsd.stability_selection(th_t, y_t, tsd.STLSQ(lams), torch.Generator().manual_seed(7),
                                  **kw).numpy()
    f_b = tsd.stability_selection(th_t, y_t, tsd.STLSQ(lams), torch.Generator().manual_seed(7),
                                  **kw).numpy()
    np.testing.assert_array_equal(f_a, f_b)
    np.testing.assert_array_equal(f_a >= 0.8, np.asarray(xi_true != 0.0))
