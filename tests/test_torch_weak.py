"""PyTorch port: weak-form SINDy (``sindy/weak.py``) against the JAX package (float64).

The test-function matrices and the Lotka-Volterra weak pair agree to 1e-12,
the SEIR-exposure pair with derived features to 1e-10; the ``sindy`` front
end on a ``WeakDataDrivenProblem`` selects the same terms; and the weak
rows → CV ladders → simulation-refit judge pipeline of the Lotka-Volterra
study picks the same structure in each of 2 noisy lanes (mirrors of
``tests/test_sindy.py``'s weak-form tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import sindy as tsd
from universal_differential_equations_torch.examples import seir_exposure as tse
from universal_differential_equations_torch.models import seir as tseir
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.models import lotka_volterra as jlv
from universal_differential_equations_tpu.models import seir as jseir

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64


def _lv():
    """The clean Lotka-Volterra truth on the reference's 31-point grid."""
    ts, X, _ = jlv.generate_data(jax.random.PRNGKey(11))
    return np.asarray(ts), np.asarray(X)


def _known_j(u):
    return jnp.stack([1.3 * u[0], -1.8 * u[1]])


def _known_t(u):
    return torch.stack([1.3 * u[0], -1.8 * u[1]])


def _lv_bases(degree=5):
    return (jsd.polynomial_basis(2, degree) + jsd.sin_basis(2),
            tsd.polynomial_basis(2, degree) + tsd.sin_basis(2))


@pytest.mark.parametrize("case", [(61, 31, 1, 5), (31, 17, 1, 5), (31, 9, 3, 3), (40, 40, 1, 4)])
def test_test_function_matrices_match_jax(case):
    n, width, stride, p = case
    # an uneven grid: the trapezoid weights must follow it
    ts = np.sort(np.random.default_rng(n).uniform(0.0, 3.0, n))
    Pj, dPj = jsd.test_function_matrices(jnp.asarray(ts), width, stride=stride, p=p)
    Pt, dPt = tsd.test_function_matrices(torch.tensor(ts), width, stride=stride, p=p)
    assert Pt.shape == Pj.shape == ((n - width) // stride + 1, n)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dPt.numpy(), np.asarray(dPj), rtol=1e-12,
                               atol=1e-12 * float(np.abs(dPj).max()))


def test_degenerate_window_stays_finite_in_float32():
    ts = torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 4.0], dtype=torch.float32)
    Phi, dPhi = tsd.test_function_matrices(ts, width=3, p=5)
    assert Phi.dtype == torch.float32
    assert torch.isfinite(Phi).all() and torch.isfinite(dPhi).all()
    assert (Phi[0] == 0).all()


def test_lv_weak_pair_matches_jax():
    ts, X = _lv()
    bj, bt = _lv_bases()
    for kw in (dict(widths=(17,)), dict(widths=(9, 13, 17, 21, 25, 29)), dict()):
        Gj, Bj = jsd.weak_pair(jnp.asarray(ts), jnp.asarray(X), bj, _known_j, p=5, **kw)
        Gt, Bt = tsd.weak_pair(torch.tensor(ts), torch.tensor(X), bt, _known_t, p=5, **kw)
        np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(Gj).max()))
        np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(Bj).max()))
    # the true missing terms solve the clean pair to quadrature accuracy
    i_xy = bt.names.index("u1*u2")
    xi = torch.zeros(len(bt), 2, dtype=F64)
    xi[i_xy] = torch.tensor([-0.9, 0.8], dtype=F64)
    Gt, Bt = tsd.weak_pair(torch.tensor(ts), torch.tensor(X), bt, _known_t, widths=(17,))
    assert float((Gt @ xi - Bt).abs().max()) <= 1e-3 * float(Bt.abs().max())


def test_seir_features_pair_matches_jax():
    ts = np.arange(0.0, 21.1, 1.0)
    _, X, _ = tse.truth(np.zeros((22, 7)))
    X = X.numpy()
    basis_j = jsd.cos_basis(3) + jsd.sin_basis(3) + jsd.tensor_polynomial_basis(3, 2)
    basis_t = tse.scenario_basis()
    p_ = jseir.P_SEIR
    F_n, beta0 = float(p_[0] / jseir._S0), float(p_[1])
    mu_, sigma_, gamma_, d_, lam_ = [float(p_[i]) for i in (4, 5, 6, 7, 8)]

    def known_no_z(u):  # the JAX script's
        S, E, I, R, Nn, D, Cc = u
        imported = beta0 * S * F_n / Nn
        return jnp.stack([-imported - mu_ * S, imported - (sigma_ + mu_) * E,
                          sigma_ * E - (gamma_ + mu_) * I, gamma_ * I - mu_ * R, -mu_ * Nn,
                          d_ * gamma_ * I - lam_ * D, sigma_ * E])

    feats_fn = lambda u: jnp.stack([u[0] / u[4], 1e5 * u[2], 1e5 * u[5] / u[4]])
    Gj, Bj = jsd.weak_pair(jnp.asarray(ts), jnp.asarray(X), basis_j, known_no_z,
                           widths=tse.WIDTHS, p=5, features=feats_fn)
    Gt, Bt = tsd.weak_pair(torch.tensor(ts), torch.tensor(X), basis_t, tse.known_no_z,
                           widths=tse.WIDTHS, p=5, features=tse.exposure_features)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-10,
                               atol=1e-10 * float(np.abs(Bj).max()))
    # the E-row target is the quadrature of the true exposure
    Phi = torch.cat([tsd.test_function_matrices(torch.tensor(ts), w, p=5)[0]
                     for w in tse.WIDTHS])
    target = Phi @ tseir.true_exposure(torch.tensor(X))
    assert float((Bt[:, 1] - target).abs().max()) <= 2e-4 * float(target.abs().max())


def test_weak_sindy_front_end_matches_jax():
    ts, X = _lv()
    bj, bt = _lv_bases()
    lams = tuple(10.0 ** e for e in np.arange(-3.0, 2.0, 0.1))
    rj = jsd.sindy(jsd.WeakDataDrivenProblem(jnp.asarray(X), jnp.asarray(ts), known_rhs=_known_j,
                                             widths=(17,)), bj, jsd.STLSQ(lams), normalize=True)
    rt = tsd.sindy(tsd.WeakDataDrivenProblem(torch.tensor(X), torch.tensor(ts), known_rhs=_known_t,
                                             widths=(17,)), bt, tsd.STLSQ(lams), normalize=True)
    # statistical selection keeps extra terms on the 15 correlated weak rows
    # (the module docstring's caveat): the same ones in both packages; their
    # tiny coefficients come from an ill-conditioned fit and move by 1e-3
    # relative, the true term's do not
    np.testing.assert_array_equal(rt.active, np.asarray(rj.active))
    i_xy = bt.names.index("u1*u2")
    np.testing.assert_allclose(rt.coefficients[i_xy], np.asarray(rj.coefficients)[i_xy],
                               rtol=1e-6)
    np.testing.assert_allclose(rt.coefficients[i_xy], (-0.9, 0.8), atol=5e-3)


def test_weak_rows_with_the_simulation_judge_match_jax():
    # the LV study's weak arm in miniature (tests/test_sindy.py's
    # test_weak_plus_simulation_judge_recovers_structure): weak rows → CV
    # ladders → LM refit judge at 1e-2 noise, with JAX's draws; two of that
    # test's four lanes (the port's LM refit takes ~35 s per lane here)
    ts, X = _lv()
    bj, bt = _lv_bases()
    m = len(bt)
    i_xy = bt.names.index("u1*u2")
    lams = tuple(10.0 ** e for e in np.arange(-3.0, 5.0, 0.2))
    mag, sub = 1e-2, 4
    n_step = (len(ts) - 1) * sub
    x_mean = X.mean(axis=0)
    floor = 1.3 * mag**2 * float(np.mean(x_mean**2)) + 1e-7
    kw = dict(sub=sub, rel_factor=1.5, max_rel=1.0, refit_iters=8, loss_floor=floor,
              max_total_support=5, refit_top=(2, 1, 1, 1), refit_method="lm")
    masks1 = np.eye(m, dtype=bool)
    sizes = np.repeat(np.arange(1, 6), 2)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    lanes = np.stack([X + mag * x_mean * np.asarray(jax.random.normal(k, X.shape))
                      for k in keys[:2]])

    def rhs_j(t, u, C):
        th = bj.theta(u[None, :])[0]
        return jnp.stack([1.3 * u[0] + th @ C[:, 0], -1.8 * u[1] + th @ C[:, 1]])

    @jax.jit
    @jax.vmap
    def lane_j(data):
        G, B = jsd.weak_pair(jnp.asarray(ts), data, bj, _known_j, widths=(17,), p=5)
        lad = [jsd.cv_ladder(G, B[:, e], jsd.STLSQ(lams), 5, per_size=2, extra_supports=masks1)
               for e in (0, 1)]
        return jsd.select_by_simulation(lad, rhs_j, data[0], 0.0, float(ts[-1]), data,
                                        jude.Tsit5(), n_step, sizes=[sizes, sizes], **kw)

    def rhs_t(t, u, C):  # lanes of the judge
        z = torch.einsum("lm,lmd->ld", bt.theta(u), C)
        return torch.stack([1.3 * u[:, 0] + z[:, 0], -1.8 * u[:, 1] + z[:, 1]], -1)

    Cj, lj, kj = lane_j(jnp.asarray(lanes))
    want = np.zeros((m, 2), bool)
    want[i_xy] = True
    exact = 0
    for i, data in enumerate(lanes):
        d = torch.tensor(data)
        G, B = tsd.weak_pair(torch.tensor(ts), d, bt, _known_t, widths=(17,), p=5)
        lad = [tsd.cv_ladder(G, B[:, e], tsd.STLSQ(lams), 5, per_size=2, extra_supports=masks1)
               for e in (0, 1)]
        Ct, lt, kt = tsd.select_by_simulation(lad, rhs_t, d[0], 0.0, float(ts[-1]), d,
                                              tude.Tsit5(), n_step,
                                              sizes=[torch.tensor(sizes)] * 2, **kw)
        assert int(kt) == int(kj[i])
        np.testing.assert_array_equal(Ct.numpy() != 0, np.asarray(Cj[i]) != 0)
        np.testing.assert_allclose(float(lt), float(lj[i]), rtol=1e-6)
        exact += bool(((Ct.numpy() != 0) == want).all())
    assert exact == 2
