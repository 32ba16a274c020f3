"""PyTorch port: multiple shooting against the JAX package (float64).

``train/shooting.py``: the segment windows equal JAX's; on the Hudson Bay
pelt record (``examples/lotka_volterra/data``) with the Hudson Bay model at
JAX's initial parameters (seed 11, carried over by ``params_from_jax``),
``multiple_shoot``'s value agrees to 1e-9 and its gradient to 1e-7 relative —
with the default discrete adjoint, with a custom segment loss through the
interpolating adjoint, and where every segment exhausts its step budget and
is penalised (1e4 per failed segment plus its error sum).  All segments are
one ``torch.func.vmap`` over ``solve``: one adaptive loop, not a loop over
segments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.examples import hudson_bay as thb
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_tpu.nn import Chain as JChain
from universal_differential_equations_tpu.nn import Dense as JDense
from universal_differential_equations_tpu.train import multiple_shoot as j_shoot
from universal_differential_equations_tpu.train import shooting_windows as j_windows

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64


@pytest.mark.parametrize("n,g", [(21, 5), (10, 4), (5, 2), (2, 5), (7, 7)])
def test_shooting_windows_match_jax(n, g):
    idx_j, mask_j = j_windows(n, g)
    idx_t, mask_t = tude.shooting_windows(n, g)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert mask_t.dtype == torch.float32
    with pytest.raises(ValueError, match="group_size"):
        tude.shooting_windows(n, 1)


@pytest.fixture(scope="module")
def hudson():
    """The Hudson Bay data and the JAX script's model at seed 11, in float64."""
    raw = np.loadtxt(thb.DATA)
    t = raw[:, 0] - raw[0, 0]
    Xn = raw[:, 1:3] / raw[:, 1:3].max(axis=0)
    net = JChain((JDense(2, 5, "rbf"), JDense(5, 5, "rbf"), JDense(5, 5, "tanh"),
                  JDense(5, 2)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    p_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       {"lin": jax.random.uniform(k1, (2,)), "nn": net.init(k2)})

    def rhs_j(tt, u, p):
        uhat = net.apply(p["nn"], u)
        return jnp.stack([p["lin"][0] * u[0] + uhat[0], -p["lin"][1] * u[1] + uhat[1]])

    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    return dict(t=t, Xn=Xn, p_j=p_j, rhs_j=rhs_j, p_t=p_t, rhs_t=thb.make_rhs(thb.make_net()))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _both(h, **kw):
    """(value, flat gradient) of multiple_shoot in both packages."""
    jkw = {k: getattr(jude, v.__class__.__name__)() if k == "adjoint" else v
           for k, v in kw.items() if k != "loss_fn"}
    if "loss_fn" in kw:
        jkw["loss_fn"] = kw["loss_fn"][1]
    tkw = dict(kw)
    if "loss_fn" in kw:
        tkw["loss_fn"] = kw["loss_fn"][0]
    v_j, g_j = jax.jit(jax.value_and_grad(lambda p: j_shoot(
        p, jnp.asarray(h["Xn"]), jnp.asarray(h["t"]), h["rhs_j"], **jkw)))(h["p_j"])
    flat, unravel = travel(h["p_t"])
    x = flat.clone().requires_grad_(True)
    v_t = tude.multiple_shoot(unravel(x), torch.tensor(h["Xn"]), torch.tensor(h["t"]),
                              h["rhs_t"], **tkw)
    (g_t,) = torch.autograd.grad(v_t, x)
    return (float(v_t.detach()), g_t.numpy()), (float(v_j), np.asarray(jravel(g_j)[0]))


BASE = dict(group_size=5, continuity_term=200.0, rtol=1e-6, atol=1e-6)


def test_multiple_shoot_matches_jax_on_hudson_bay(hudson):
    (v_t, g_t), (v_j, g_j) = _both(hudson, max_steps=256, **BASE)
    assert abs(v_t - v_j) <= 1e-9 * abs(v_j)
    assert _rel(g_t, g_j) <= 1e-7


def test_custom_segment_loss_through_the_interpolating_adjoint(hudson):
    def loss_t(pred, target, m):
        return torch.sum(m[..., None] * torch.abs(pred - target) ** 1.5)

    def loss_j(pred, target, m):
        return jnp.sum(m[..., None] * jnp.abs(pred - target) ** 1.5)

    (v_t, g_t), (v_j, g_j) = _both(hudson, max_steps=256, adjoint=tude.InterpolatingAdjoint(),
                                   loss_fn=(loss_t, loss_j), **BASE)
    assert abs(v_t - v_j) <= 1e-9 * abs(v_j)
    assert _rel(g_t, g_j) <= 1e-7


def test_failed_segments_are_penalised_as_in_jax(hudson):
    # 3 step attempts cannot cover a 4-year window at 1e-6: every segment
    # fails, adding 1e4 each plus its error sum / max_steps (differentiable)
    (v_t, g_t), (v_j, g_j) = _both(hudson, max_steps=3, **BASE)
    n_seg = tude.shooting_windows(len(hudson["t"]), 5)[0].shape[0]
    assert 1e4 * n_seg < v_t < 1e4 * (n_seg + 1)
    assert abs(v_t - v_j) <= 1e-9 * abs(v_j)
    assert np.all(np.isfinite(g_t)) and _rel(g_t, g_j) <= 1e-7
