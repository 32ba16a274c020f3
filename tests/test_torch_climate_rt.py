"""PyTorch port: the Rayleigh-Taylor one-step propagator
(``examples/climate_training_rt.py``) against the JAX package, at full width
on the CPU.

The committed JAX checkpoint ``examples/climate/data/dbdt_nn.npz``
(16→32→64→64→32→16, 9,424 parameters), loaded by both packages, gives the
same one-step loss over the 40 committed pairs (1e-5 relative, float32) and
the same 40-step free-rollout rel-L2 (2e-3 absolute); three ADAM(1e-3)
steps from the same initial parameters equal ``fit`` with ``optax.adam``
(1e-5); the pairs equal the JAX script's; the script runs end to end at a
tiny budget and evaluates a saved checkpoint.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.convert import params_from_jax
from universal_differential_equations_torch.examples import climate_training_rt as tx
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.io import load_pytree as tload
from universal_differential_equations_tpu.io import load_pytree as jload
from universal_differential_equations_tpu.models.climate_datagen import coarse_grain as jcg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "examples" / "climate" / "data" / "dbdt_nn.npz"


@pytest.fixture(scope="module")
def pairs():
    """The JAX script's pairs from the committed 41 × 64 averages."""
    with np.load(tx.DATA) as d:
        t, b = d["t"], d["b"]
    t_u = np.arange(0.0, t[-1] + 1e-9, 0.1)
    b_u = np.stack([np.interp(t_u, t, b[:, k]) for k in range(b.shape[1])], 1)
    b_cs = np.asarray(jcg(b_u, b_u.shape[1] // 16))
    return dict(t=t, b=b, b_cs=b_cs, n=min(100, len(t_u) - 1))


def _jax_model():
    net = jude.MLP([16, 32, 64, 64, 32, 16], activation="tanh")
    prop = jude.NeuralODE(net, (0.0, 0.1), rtol=1e-4, atol=1e-6, max_steps=64)
    return net, prop


def _jax_loss(prop, b_cs, n):
    bn = jnp.asarray(b_cs[:n], jnp.float32)
    bn1 = jnp.asarray(b_cs[1:n + 1], jnp.float32)
    return lambda p: jnp.mean((jax.vmap(lambda b0: prop(p, b0))(bn) - bn1) ** 2)


def _port_loss(prop, b_cs, n):
    bn = torch.as_tensor(b_cs[:n], dtype=torch.float32)
    bn1 = torch.as_tensor(b_cs[1:n + 1], dtype=torch.float32)
    return tx.make_loss(prop, bn, bn1)


def test_pairs_equal_the_jax_script(pairs):
    t_u, b_cs, n = tx.coarse_pairs(pairs["t"], pairs["b"], 16)
    assert n == pairs["n"] == 40 and b_cs.shape == (41, 16)
    np.testing.assert_array_equal(b_cs, pairs["b_cs"])


def test_committed_checkpoint_gives_jax_loss_and_rollout(pairs):
    b_cs, n = pairs["b_cs"], pairs["n"]
    net_j, prop_j = _jax_model()
    p_j = jload(CKPT, net_j.init(jax.random.PRNGKey(0), jnp.float32))
    loss_j = float(jax.jit(_jax_loss(prop_j, b_cs, n))(p_j))
    step = jax.jit(lambda p, b0: prop_j(p, b0))
    roll = [jnp.asarray(b_cs[0], jnp.float32)]
    for _ in range(len(b_cs) - 1):
        roll.append(step(p_j, roll[-1]))
    roll = np.stack([np.asarray(r) for r in roll])
    rel_j = np.linalg.norm(roll - b_cs) / np.linalg.norm(b_cs)

    net_t, prop_t = tx.make_model(16)
    p_t = tload(CKPT, net_t.init(torch.Generator().manual_seed(0)))
    loss_t = float(_port_loss(prop_t, b_cs, n)(p_t))
    rel_t, roll_t = tx.rollout_rel(prop_t, p_t, b_cs, len(b_cs) - 1)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert abs(rel_t - rel_j) < 2e-3, (rel_t, rel_j)
    assert rel_t < 0.20 and loss_t < 2e-4  # the checkpoint passes the script's gates
    out = tx.main(device="cpu", checkpoint=CKPT)
    assert out["loss"] == loss_t and out["rel"] == rel_t


def test_three_adam_steps_equal_optax(pairs):
    b_cs, n = pairs["b_cs"], pairs["n"]
    net_j, prop_j = _jax_model()
    p0 = net_j.init(jax.random.PRNGKey(42), jnp.float32)
    res_j = jude.fit(_jax_loss(prop_j, b_cs, n), p0, optax.adam(1e-3), 3, callback_every=3)
    _, prop_t = tx.make_model(16)
    p0_t = params_from_jax(jax.tree.map(np.asarray, p0))
    res_t = tude.fit(_port_loss(prop_t, b_cs, n), p0_t,
                     lambda ps: torch.optim.Adam(ps, lr=1e-3), 3, callback_every=3)
    np.testing.assert_allclose(res_t.losses.numpy(), np.asarray(res_j.losses), rtol=1e-5)
    x_t, x_j = travel(res_t.params)[0].numpy(), np.asarray(jravel(res_j.params)[0])
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-5 * np.abs(x_j).max())


def test_main_runs_end_to_end_at_a_tiny_budget(tmp_path):
    out = tx.main(quick=True, device="cpu", out_dir=tmp_path, epochs=1, steps_per_epoch=2)
    assert out["pairs"] == 6 and out["levels"] == 8 and out["adam_steps"] == 2
    assert np.isfinite(out["loss"]) and np.isfinite(out["rel"])
    saved = tmp_path / "dbdt_nn_quick.npz"
    assert saved.exists() and (tmp_path / "dbdt_nn_quick.tree.json").exists()
    again = tx.main(quick=True, device="cpu", checkpoint=saved)
    np.testing.assert_allclose(again["rel"], out["rel"], rtol=1e-6)
