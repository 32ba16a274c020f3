"""PyTorch port: the FENE-P case study (``models/fenep.py``,
``examples/fenep.py``) against the JAX package.

The residual and the stiff RHS agree to 1e-14 relative on seeded inputs; the
BDF truth on 50 points agrees to 1e-9 of max|τ12|, as does the index-1
reduction solved by Kvaerno3 and SDIRK4; the committed initial weights are
``make_surrogate(jax.random.PRNGKey(3))``'s, bit for bit; the example's loss
and its gradient at those weights, on 2 of the 6 modes in float64, agree
with the JAX script's to 1e-8 relative with every solve at rtol 1e-10, and
to 1e-3 at the script's own rtol 1e-5.  ``main`` runs end to end on the CPU
at 2 ADAM steps per arm (one training mode, one cross-check solver).
"""
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
from universal_differential_equations_torch.examples import fenep as ex
from universal_differential_equations_torch.flatten_util import ravel_pytree, tree_flatten
from universal_differential_equations_torch.models import fenep as tf
from universal_differential_equations_tpu.models import fenep as jf

torch.set_num_threads(1)
# a batching-rule fallback (functorch's "performance drop" warning) is an error
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300))


def _gd(pkg_cos, omega):
    return lambda t: 12.0 * pkg_cos(omega * t)


def test_residual_and_stiff_rhs_equal_jax():
    rng = np.random.default_rng(11)
    Fj, Ft = jf.fenep_residual(_gd(jnp.cos, 1.3)), tf.fenep_residual(_gd(torch.cos, 1.3))
    rj, tau_j = jf.fenep_stiff_rhs(_gd(jnp.cos, 1.3))
    rt, tau_t = tf.fenep_stiff_rhs(_gd(torch.cos, 1.3))
    for _ in range(5):
        t = rng.uniform(0.0, 6.0)
        u, du = rng.standard_normal(6), rng.standard_normal(6)
        th = rng.uniform(-0.5, 0.5, 3)
        want = Fj(jnp.asarray(t), jnp.asarray(u), jnp.asarray(du), None)
        got = Ft(torch.tensor(t, dtype=F64), torch.tensor(u), torch.tensor(du), None)
        assert _rel(got.numpy(), want) < 1e-14
        want = rj(jnp.asarray(t), jnp.asarray(th), None)
        got = rt(torch.tensor(t, dtype=F64), torch.tensor(th), None)
        assert _rel(got.numpy(), want) < 1e-14
        assert _rel(tau_t(torch.tensor(th)).numpy(), tau_j(jnp.asarray(th))) < 1e-14
    assert tf.P_FENEP == jf.P_FENEP


def test_find_sigma_exact_equals_jax():
    ts = np.linspace(0.0, 6.2831, 50)
    sj, okj = jf.find_sigma_exact(jnp.asarray(ts), _gd(jnp.cos, 1.0))
    st, okt = tf.find_sigma_exact(torch.tensor(ts), _gd(torch.cos, 1.0))
    assert bool(okt) and bool(okj)
    assert st.dtype == F64
    assert float(np.max(np.abs(st.numpy() - np.asarray(sj)))) < 1e-9 * float(np.max(np.abs(sj)))
    s = st.numpy()  # tests/test_stiff_dae.py::test_fenep_truth_against_ida_role
    assert np.all(np.isfinite(s)) and 3.0 < np.abs(s).max() < 12.0


@pytest.mark.parametrize("name", ["Kvaerno3", "SDIRK4"])
def test_find_sigma_exact_ode_equals_jax(name):
    ts = np.linspace(0.0, 2.0, 20)
    sj, okj = jf.find_sigma_exact_ode(jnp.asarray(ts), _gd(jnp.cos, 1.5), getattr(__import__(
        "universal_differential_equations_tpu"), name)())
    st, okt = tf.find_sigma_exact_ode(torch.tensor(ts), _gd(torch.cos, 1.5),
                                      getattr(tude, name)())
    assert bool(okt) and bool(okj)
    assert float(np.max(np.abs(st.numpy() - np.asarray(sj)))) < 1e-9 * float(np.max(np.abs(sj)))
    # the reduction reproduces the BDF truth (tests/test_stiff_dae.py:288-305)
    s_dae, ok = tf.find_sigma_exact(torch.tensor(ts), _gd(torch.cos, 1.5))
    assert bool(ok) and _rel(st.numpy(), s_dae.numpy()) < 1e-4


def test_init_fixture_is_the_jax_draw():
    sys.path.insert(0, str(ROOT / "tools"))
    import fenep_init as tool

    with jax.enable_x64(False):
        want = tool.draw()
    with np.load(ex.INIT) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.float32
            np.testing.assert_array_equal(z[k], v)
    n = sum(v.size for v in want.values())
    assert n == 40
    for linear in (False, True):  # the port's nets take the fixture as it is
        f1, f0, params = ex.initial_surrogate(linear, "jax", device="cpu")
        x = torch.tensor([0.3, -1.2])
        assert f1.apply(params["f1"], x).shape == (1,) and f0.apply(params["f0"], x).shape == (1,)


@functools.lru_cache(maxsize=None)
def _truth(omegas):
    """The port's BDF truth for ``omegas`` on the script's training grid."""
    ts = torch.linspace(0.0, 6.2831, 100, dtype=F64)
    return np.stack([tf.find_sigma_exact(ts, _gd(torch.cos, w))[0].numpy() for w in omegas])


def _tight(solve, **tols):
    """``solve`` with ``tols`` in place of the caller's tolerances."""
    def wrapped(*args, **kw):
        return solve(*args, **{**kw, **tols})
    return wrapped


@pytest.mark.parametrize("tols", [{}, dict(rtol=1e-10, atol=1e-12, max_steps=4096)],
                         ids=["script_tolerances", "rtol_1e-10"])
def test_loss_and_gradient_on_two_modes_equal_jax(monkeypatch, tols):
    # At the script's rtol 1e-5 both packages' trajectories lie ~1e-3 from
    # the exact one, and round-off in the error estimate (XLA fuses the RK
    # sums into FMAs) moves their step sequences apart by that much: there
    # the loss agrees to 1e-3.  With every solve at rtol 1e-10 the same loss
    # and gradient agree to 1e-8.
    jx = _load("jax_fenep_script", "examples/non_newtonian/fenep.py")
    omegas = np.array([1.0, 1.6])
    monkeypatch.setattr(jx, "OMEGAS", omegas)
    monkeypatch.setattr(ex, "OMEGAS", omegas)
    if tols:
        monkeypatch.setattr(jx.ude, "solve", _tight(jx.ude.solve, **tols))
        monkeypatch.setattr(ex.ude, "solve", _tight(ex.ude.solve, **tols))
    tol = 1e-8 if tols else 1e-3
    ts = np.linspace(0.0, 6.2831, 100)
    sigmas = _truth(tuple(omegas))

    f1t, f0t, p_t = ex.initial_surrogate(False, "jax", device="cpu", dtype=F64)
    f1j, f0j, _ = jf.make_surrogate(jax.random.PRNGKey(3))
    p_j = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p_t)
    loss_j, _ = jx.make_loss(f1j, f0j, jnp.asarray(ts), jnp.asarray(sigmas))
    lj, gj = jax.value_and_grad(loss_j)(p_j)

    loss_t, _ = ex.make_loss(f1t, f0t, torch.tensor(ts), torch.tensor(sigmas))
    leaves, build = tree_flatten(p_t)
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    lt = loss_t(build(leaves))
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt) / float(lj) - 1.0) < tol
    g_flat = ravel_pytree(build(list(gt)))[0].numpy()
    assert _rel(g_flat, jravel(gj)[0]) < tol


def test_main_runs_end_to_end(monkeypatch, tmp_path):
    # the whole script on the CPU at 2 ADAM steps per arm; one training mode
    # and one cross-check solver keep it inside the file's time budget
    monkeypatch.setattr(ex, "OMEGAS", np.array([1.0]))
    monkeypatch.setattr(ex, "CROSSCHECK", ("SDIRK4",))
    monkeypatch.setattr(ex, "OUT_DIR", tmp_path)
    out = ex.main(device="cpu", steps=2)
    assert out["gates"]["neural_beats_linear"]
    assert out["crosscheck"]["SDIRK4"] < 1e-3
    for arm in ("neural", "linear"):
        assert np.isfinite(out[arm]["train_loss"]) and np.isfinite(out[arm]["test_err"])
    with np.load(tmp_path / "fenep_test_response.npz") as z:
        assert z["exact"].shape == z["neural"].shape == (100,)
    with pytest.raises(NotImplementedError, match="slice H"):
        ex.main(device="cpu", plot=True)
