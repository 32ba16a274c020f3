"""PyTorch port: the Fisher-KPP case study and the port's benchmark against JAX.

``examples/fisher_kpp.py`` against ``examples/fisher_kpp/fisher_kpp.py`` and
``bench.py`` against the repo's ``bench.py`` (both JAX scripts are loaded by
file path).  The gates and the restart ladder are compared with a stubbed
training attempt; the training itself (one ADAM step, 3 LM iterations and
the refine pass of the ``small`` variant) and the benchmark's ``train_run``
(3 LM iterations of the Fourier variant) run in float64 from the JAX
package's parameters (``params_from_jax``): stage losses to 1e-10 relative,
parameters to 1e-8 of their largest entry.  No test trains a model to
convergence.
"""
import importlib.util
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
from universal_differential_equations_torch import bench as tbench
from universal_differential_equations_torch.examples import fisher_kpp as tx
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_tpu.models import fisher_kpp as jfk

torch.set_num_threads(1)

F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jx = _load("jax_fisher_kpp_script", "examples/fisher_kpp/fisher_kpp.py")
jb = _load("jax_bench_script", "bench.py")


@pytest.fixture(scope="module")
def data():
    """Truth snapshots from the JAX package, float64, in both packages."""
    ts, ys = jfk.generate_data(dtype=jnp.float64)
    return (ts, ys), (torch.tensor(np.asarray(ts)), torch.tensor(np.asarray(ys)))


def _models(variant, seed):
    rhs_j, p_j = jfk.make_model(jax.random.PRNGKey(seed), variant, dtype=jnp.float64)
    rhs_t, _ = tfk.make_model(torch.Generator().manual_seed(seed), variant, dtype=F64)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    return rhs_j, p_j, rhs_t, p_t


def test_constants_equal_the_jax_script():
    assert tx.BASELINES == jx.BASELINES
    assert (tx.SMALL4_REFERENCE_FLOOR, tx.SMALL4_REFERENCE_WORST) == (
        jx.SMALL4_REFERENCE_FLOOR, jx.SMALL4_REFERENCE_WORST)
    assert tbench.BASELINE_SECONDS == jb.BASELINE_SECONDS
    assert set(tx.VARIANTS) == set(tx.BASELINES)


GOOD_W = [1.15, -2.30, 1.15]  # D0 = 5.8: D_eff = 0.01067, the reference's printed fit


def _params(w, d0):
    return ({"w": np.asarray(w), "D0": np.asarray(d0)},
            {"w": torch.tensor(w, dtype=F64), "D0": torch.tensor(d0, dtype=F64)})


@pytest.mark.parametrize("variant", ["mlp", "small4", "fourier"])
def test_run_gate_matches_jax(variant):
    cases = [(GOOD_W, 5.8), ([1.15, -2.25, 1.15], 5.8), ([1.15, -2.30, 1.15], 8.5),
             ([0.5, -1.0, 0.5], 5.8)]
    for w, d0 in cases:
        p_j, p_t = _params(w, d0)
        for final in (0.005, 0.0099, 0.01, 0.1, 0.2224, 0.3, 0.45, 0.46):
            assert tx._run_gate(variant, p_t, final) == bool(jx._run_gate(variant, p_j, final))
            # the script's per-run gate: small4's band top, else _run_gate
            expect = (final < jx.SMALL4_REFERENCE_WORST * 1.05 if variant == "small4"
                      else bool(jx._run_gate(variant, p_j, final)))
            assert tx.run_passes(variant, p_t, final) == expect


LADDERS = {
    "small4": [0.43, 0.30, 0.07, 0.44],  # the third attempt lands on the good shelf
    "small": [0.5, 0.2, 0.1],  # no attempt passes: three, the best carried
    "mlp": [0.02, 0.005, 0.008],  # the second has a bad stencil sum; the third passes
    "fourier": [0.004],  # the first passes
}


@pytest.mark.parametrize("variant", sorted(LADDERS) + ["small4-never"])
def test_restart_ladder_matches_jax(monkeypatch, variant):
    name = variant.split("-")[0]
    finals = [0.43] * 8 if variant.endswith("never") else LADDERS[variant]
    seeds = []

    def attempt(as_params):
        def stub(seed, v, ts, data, quick=False, hook=None, dashboard=None):
            k = (seed - 7) // 1000
            seeds.append(seed)
            w = [1.15, -2.25, 1.15] if (name == "mlp" and k == 1) else GOOD_W
            return as_params(w, 5.8 + 0.01 * k), finals[k]
        return stub

    monkeypatch.setattr(jx, "_train_attempt", attempt(lambda w, d: _params(w, d)[0]))
    monkeypatch.setattr(tx, "_train_attempt", attempt(lambda w, d: _params(w, d)[1]))
    p_j, f_j, _, ladder_j = jx.train_once(7, name, None, None)
    seeds_j, seeds[:] = list(seeds), []
    p_t, f_t, wall, ladder_t = tx.train_once(7, name, None, None)
    assert ladder_t == ladder_j and seeds == seeds_j
    assert seeds == [7 + 1000 * k for k in range(len(ladder_t))]
    assert f_t == f_j and float(p_t["D0"]) == float(p_j["D0"]) and wall >= 0.0
    if variant.endswith("never"):
        assert len(ladder_t) == 8


def test_training_stages_of_the_small_variant_match_jax(data):
    # one ADAM(0.01) step, 3 LM iterations, then (the loss is still ≥ 0.01)
    # the refine pass: one ADAM(0.001) step and 3 LM iterations
    (ts_j, ys_j), (ts_t, ys_t) = data
    rhs_j, p_j, rhs_t, p_t = _models("small", seed=0)
    stages_t = []
    params_t, final_t = tx.train("small", p_t, tfk.make_residuals(rhs_t, ts_t, ys_t),
                                 adam_steps=1, lm_iters=3, refine_steps=1,
                                 on_stage=lambda name, loss: stages_t.append((name, loss)))

    res_j = jb.make_residuals(rhs_j, ts_j, ys_j)

    def loss_j(p):
        return jnp.sum(res_j(p) ** 2)

    warm = jude.train.fit(loss_j, p_j, optax.adam(0.01), 1, callback_every=100,
                          early_stop_loss=0.01)
    lm = jude.train.levenberg_marquardt(res_j, warm.params, maxiters=3, loss_tol=0.01)
    stages_j = [("adam", warm.final_loss), ("lm", float(lm.loss))]
    assert float(lm.loss) >= 0.01  # the refine pass runs
    warm2 = jude.train.fit(loss_j, lm.params, optax.adam(0.001), 1, callback_every=100,
                           early_stop_loss=0.01)
    lm = jude.train.levenberg_marquardt(res_j, warm2.params, maxiters=3, loss_tol=0.01)
    stages_j += [("refine_adam", warm2.final_loss), ("refine_lm", float(lm.loss))]

    assert [s[0] for s in stages_t] == [s[0] for s in stages_j]
    np.testing.assert_allclose([s[1] for s in stages_t], [s[1] for s in stages_j], rtol=1e-10)
    assert stages_t[-1][1] < stages_t[0][1] and final_t == stages_t[-1][1]
    x_j = np.asarray(jravel(lm.params)[0])
    np.testing.assert_allclose(travel(params_t)[0].numpy(), x_j, rtol=0,
                               atol=1e-8 * np.abs(x_j).max())


def test_bench_train_run_matches_jax(data):
    # from the point JAX's benchmark LM reaches after 12 iterations of seed 0,
    # where the next steps are accepted (from the initial weights the first
    # ones are rejected and the iterates would not move)
    (ts_j, ys_j), (ts_t, ys_t) = data
    rhs_j, p_j, rhs_t, _ = _models("fourier", seed=0)
    res_j = jb.make_residuals(rhs_j, ts_j, ys_j)
    start = jude.train.levenberg_marquardt(res_j, p_j, maxiters=12, loss_tol=0.01).params
    lm_j = jude.train.levenberg_marquardt(res_j, start, maxiters=3, loss_tol=0.01)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, start), dtype=F64)
    wall, lm_t = tbench.train_run(p_t, tfk.make_residuals(rhs_t, ts_t, ys_t), maxiters=3)
    assert wall > 0.0 and lm_t.iterations == int(lm_j.iterations) == 3
    loss0 = float(jnp.sum(res_j(start) ** 2))
    assert float(lm_t.loss) < loss0  # the steps were accepted
    np.testing.assert_allclose(float(lm_t.loss), float(lm_j.loss), rtol=1e-10)
    np.testing.assert_allclose(float(lm_t.lam), float(lm_j.lam), rtol=1e-12)
    x_j = np.asarray(jravel(lm_j.params)[0])
    np.testing.assert_allclose(travel(lm_t.params)[0].numpy(), x_j, rtol=0,
                               atol=1e-8 * np.abs(x_j).max())


def test_bench_initial_params_are_the_fourier_model():
    p = tbench.initial_params(2, "cpu")
    _, p_ref = tfk.make_model(torch.Generator().manual_seed(2), "fourier")
    for a, b in zip(travel(p)[0], travel(p_ref)[0]):
        assert float(a) == float(b)
