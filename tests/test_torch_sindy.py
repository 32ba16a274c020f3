"""PyTorch port: the SINDy layer against the JAX package (float64).

The same numpy data go through both packages: feature matrices agree to
1e-12 with the same term names; ``sindy`` (with and without ``normalize``,
a ``DataSampler``, ``denoise``, exhaustive small supports, a custom
objective, each optimizer) selects the same active sets, coefficients agree
to 1e-10 and ``equations()`` prints the same strings; kernel collocation
agrees to 1e-10; the recovered model evaluates the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_differential_equations_torch import sindy as ts
from universal_differential_equations_tpu import sindy as js

torch.set_num_threads(1)

LAMS = tuple(10.0 ** e for e in np.arange(-3.0, 2.0, 0.1))


def _lv_like_data(seed=0, N=200, noise=1e-3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.2, 3.0, size=(N, 2))
    Y = np.stack([1.5 * X[:, 0] - 0.7 * X[:, 0] * X[:, 1],
                  -2.0 * X[:, 1] + 0.4 * X[:, 0] * X[:, 1]], axis=1)
    return X, Y + noise * rng.standard_normal(Y.shape)


def _bases(pkg):
    return {
        "poly5+sin": pkg.polynomial_basis(2, 5) + pkg.sin_basis(2),
        "poly3+sin+cos": (pkg.polynomial_basis(2, 3) + pkg.sin_basis(2, (1, 2))
                          + pkg.cos_basis(2)),
        "monomial": pkg.monomial_basis(2, 4),
        "tensor": pkg.tensor_polynomial_basis(2, 2),
        "no-constant": pkg.polynomial_basis(2, 2, include_constant=False),
    }


@pytest.mark.parametrize("name", sorted(_bases(js)))
def test_theta_and_names_match_jax(name):
    bj, bt = _bases(js)[name], _bases(ts)[name]
    assert bt.names == bj.names and len(bt) == len(bj)
    X = np.random.default_rng(1).uniform(-2.0, 2.0, size=(17, 2))
    np.testing.assert_allclose(bt.theta(torch.tensor(X)).numpy(),
                               np.asarray(bj.theta(jnp.asarray(X))), rtol=1e-12, atol=1e-12)
    # one state: (n,) -> (m,)
    np.testing.assert_allclose(bt(torch.tensor(X[3])).numpy(),
                               np.asarray(bj(jnp.asarray(X[3]))), rtol=1e-12, atol=1e-12)


def _same_result(rt, rj):
    np.testing.assert_array_equal(rt.active, np.asarray(rj.active))
    np.testing.assert_allclose(rt.coefficients, np.asarray(rj.coefficients),
                               rtol=1e-10, atol=1e-10)
    assert rt.equations() == rj.equations()
    np.testing.assert_array_equal(rt.sparsity, np.asarray(rj.sparsity))
    # residual norms: relative 1e-8, or rounding level (1e-10) on exact data
    np.testing.assert_allclose(rt.l2_error, np.asarray(rj.l2_error), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(np.isnan(rt.chosen_thresholds),
                                  np.isnan(np.asarray(rj.chosen_thresholds)))


SINDY_CASES = {
    "plain": dict(),
    "normalize": dict(normalize=True),
    "sampler": dict(sampler="folds"),
    "normalize+sampler": dict(normalize=True, sampler="folds"),
    "normalize+denoise": dict(normalize=True, denoise=True),
    "normalize+exhaustive": dict(normalize=True, exhaustive_k=2),
    "cv_tolerance": dict(normalize=True, sampler="folds", cv_tolerance=25.0),
}


@pytest.mark.parametrize("case", list(SINDY_CASES))
def test_sindy_matches_jax(case):
    X, Y = _lv_like_data()
    kw_j, kw_t = dict(SINDY_CASES[case]), dict(SINDY_CASES[case])
    if "sampler" in kw_j:
        kw_j["sampler"], kw_t["sampler"] = js.DataSampler(n=4), ts.DataSampler(n=4)
    rj = js.sindy(js.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)),
                  _bases(js)["poly5+sin"], js.STLSQ(LAMS), **kw_j)
    rt = ts.sindy(ts.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)),
                  _bases(ts)["poly5+sin"], ts.STLSQ(LAMS), **kw_t)
    _same_result(rt, rj)
    if case == "normalize":
        # the true structure: u1, u1*u2 | u2, u1*u2
        names = _bases(ts)["poly5+sin"].names
        for eq, want in enumerate([{"u1", "u1*u2"}, {"u2", "u1*u2"}]):
            assert {names[j] for j in np.flatnonzero(rt.active[:, eq])} == want


@pytest.mark.parametrize("opt", ["SR3", "STRRidge"])
def test_other_optimizers_match_jax(opt):
    X, Y = _lv_like_data(seed=2)
    rj = js.sindy(js.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)),
                  _bases(js)["poly5+sin"], getattr(js, opt)(LAMS), normalize=True)
    rt = ts.sindy(ts.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)),
                  _bases(ts)["poly5+sin"], getattr(ts, opt)(LAMS), normalize=True)
    _same_result(rt, rj)


def test_custom_selection_and_float32_auto_precision_match_jax():
    X, Y = _lv_like_data(seed=3)

    def objective(pkg):
        def g(k, rss, N):
            return rss / N + 1e-3 * k
        return g

    rj = js.sindy(js.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)),
                  _bases(js)["poly5+sin"], js.STLSQ(LAMS), normalize=True,
                  selection=objective(jnp), sampler=js.DataSampler(n=4))
    rt = ts.sindy(ts.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)),
                  _bases(ts)["poly5+sin"], ts.STLSQ(LAMS), normalize=True,
                  selection=objective(torch), sampler=ts.DataSampler(n=4))
    _same_result(rt, rj)
    # float32 data: "auto" runs the sweep in float64 (JAX on its host CPU,
    # the port on the data's device) and both select the same model.  The
    # feature matrix is built in float32, where the two packages' sin and
    # products may differ by an ulp; the degree-5 fit amplifies that to
    # ~1e-4 relative in the coefficients of the small terms
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    rj = js.sindy(js.DirectDataDrivenProblem(jnp.asarray(X32), jnp.asarray(Y32)),
                  _bases(js)["poly5+sin"], js.STLSQ(LAMS), normalize=True)
    rt = ts.sindy(ts.DirectDataDrivenProblem(torch.tensor(X32), torch.tensor(Y32)),
                  _bases(ts)["poly5+sin"], ts.STLSQ(LAMS), normalize=True)
    np.testing.assert_array_equal(rt.active, np.asarray(rj.active))
    np.testing.assert_allclose(rt.coefficients, np.asarray(rj.coefficients), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("kernel", ["gaussian", "epanechnikov", "triangular"])
def test_collocation_matches_jax(kernel):
    t = np.linspace(0.0, 3.0, 61)
    rng = np.random.default_rng(4)
    X = np.stack([np.sin(2.0 * t), np.cos(t) + t], -1) + 1e-3 * rng.standard_normal((61, 2))
    aj, bj = js.collocate_data(jnp.asarray(X), jnp.asarray(t), kernel=kernel)
    at, bt = ts.collocate_data(torch.tensor(X), torch.tensor(t), kernel=kernel)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10, atol=1e-10)
    # and through the continuous problem, with an explicit bandwidth
    pj = js.ContinuousDataDrivenProblem(jnp.asarray(X), jnp.asarray(t), kernel=kernel,
                                        bandwidth=0.3)
    pt = ts.ContinuousDataDrivenProblem(torch.tensor(X), torch.tensor(t), kernel=kernel,
                                        bandwidth=0.3)
    for a, b in zip(pt.realize(), pj.realize()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)


def test_result_api_matches_jax():
    X, Y = _lv_like_data(seed=5, noise=0.0)
    rj = js.sindy(js.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)),
                  _bases(js)["poly5+sin"], js.STLSQ(LAMS), normalize=True)
    rt = ts.sindy(ts.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)),
                  _bases(ts)["poly5+sin"], ts.STLSQ(LAMS), normalize=True)
    _same_result(rt, rj)
    np.testing.assert_allclose(rt.parameters(), np.asarray(rj.parameters()), rtol=1e-10)
    assert [k for k, _ in rt.parameter_map()] == [k for k, _ in rj.parameter_map()]
    u = X[:5]
    np.testing.assert_allclose(rt(torch.tensor(u)).numpy(), np.asarray(rj(jnp.asarray(u))),
                               rtol=1e-10, atol=1e-10)
    p = rt.parameters() * 1.1
    np.testing.assert_allclose(rt.rhs()(0.0, torch.tensor(u[0]), torch.tensor(p)).numpy(),
                               np.asarray(rj.rhs()(0.0, jnp.asarray(u[0]), jnp.asarray(p))),
                               rtol=1e-10, atol=1e-10)
    # the recovered rhs is differentiable in its parameters
    pt = torch.tensor(p, requires_grad=True)
    (g,) = torch.autograd.grad(rt.rhs()(0.0, torch.tensor(u[0]), pt).sum(), pt)
    assert torch.isfinite(g).all() and g.shape == pt.shape
