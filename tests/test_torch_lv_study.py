"""PyTorch port: the LV noise study's trainers, inputs and ``main`` against the JAX package.

``train/lm.py:levenberg_marquardt_lanes`` equals ``jax.vmap(levenberg_marquardt)``
lane by lane (float64, one lane stopping by ``max_stall`` while another runs
to ``maxiters``).  The study's ``adam_stage`` and ``bfgs_round``
(``examples/run_loops.py``) follow the JAX study's math on the same lanes:
optax's ADAM(0.1) over ``jax.vmap(jax.value_and_grad)`` (float32) and
``jax.vmap(bfgs_minimize)`` (float64).  The lane fixture
(``examples/data/lv_study_lanes.npz``) is bit for bit what
``tools/lv_study_lanes.py`` draws with JAX; the selection passes' group
digests are the JAX study's (the names of its archived groups); resuming with
another chunk size is refused; and ``main`` runs end to end on the CPU at a
reduced budget.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.examples import run_loops as rl
from universal_differential_equations_torch.train import levenberg_marquardt_lanes
from universal_differential_equations_tpu.core.integrate import integrate_fixed as j_integrate_fixed
from universal_differential_equations_tpu.models import lotka_volterra as jlv

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

ROOT = Path(__file__).resolve().parents[1]
F32, F64 = torch.float32, torch.float64
LANES3 = np.array([0, 200, 400])


def _residual(x, p):
    """Three residuals in two unknowns: Rosenbrock's for p = (100, 0, 0),
    linear in x0 for p = 0, a third shape for other p."""
    return [p[0] * (x[1] - x[0] ** 2), 1.0 - x[0], p[1] * (x[0] * x[1] - p[2])]


def test_levenberg_marquardt_lanes_matches_jax_vmap():
    P = np.array([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0], [3.0, 1.0, 2.0]])
    X0 = np.array([[0.9, 1.0], [-1.2, 1.0], [0.5, 0.5]])
    kw = dict(maxiters=12, max_stall=3, gtol=0.0, lam0=1e-3)

    def jax_lane(x0, p):
        r = jude.levenberg_marquardt(lambda x: jnp.stack(_residual(x, p)), x0, **kw)
        return r.params, r.loss, r.iterations, r.lam, r.converged

    jx, jl, jk, jlam, jconv = (np.asarray(a) for a in
                               jax.jit(jax.vmap(jax_lane))(jnp.asarray(X0), jnp.asarray(P)))
    Pt = torch.tensor(P, dtype=F64)
    res = levenberg_marquardt_lanes(
        lambda X: torch.stack(_residual(X.T, Pt.T), -1), torch.tensor(X0, dtype=F64), **kw)
    # the linear lane converges to rounding and stops by max_stall, as does
    # the third at a local minimum; Rosenbrock's lane runs to maxiters
    assert int(jk[0]) < kw["maxiters"] and int(jk[2]) < int(jk[0]) and not jconv.any()
    assert int(jk[1]) == kw["maxiters"]
    np.testing.assert_array_equal(res.iterations.numpy(), jk)
    np.testing.assert_array_equal(res.converged.numpy(), jconv)
    np.testing.assert_allclose(res.params.numpy(), jx, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res.loss.numpy(), jl, rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(res.lam.numpy(), jlam, rtol=1e-8)


@pytest.fixture(scope="module")
def lanes3():
    """Three study lanes (one per noise level 1e-3, 1e-2, 5e-2) from the
    fixture, with the JAX study's loss on the JAX package."""
    st = rl.build_stages(device="cpu")
    data, theta0, _ = st.lane_inputs(LANES3, 100)
    unravel = {}
    for dt in (jnp.float32, jnp.float64):  # JAX's unravel casts to the tree's dtype
        rhs, params0, _ = jlv.make_ude(jax.random.PRNGKey(7), dtype=dt)
        unravel[jnp.dtype(dt)] = jax.flatten_util.ravel_pytree(params0)[1]
    t_end, n_step = float(st.ts[-1]), (len(st.ts) - 1) * rl.SUB

    def j_mean_loss(theta, d):
        p = unravel[theta.dtype](theta)
        _, ys = j_integrate_fixed(rhs, d[0], 0.0, t_end, p, jude.Tsit5(), n_step)
        return jnp.mean((ys[::rl.SUB] - d) ** 2)

    return st, data.numpy(), theta0.numpy(), j_mean_loss


def test_adam_stage_matches_jax_float32(lanes3):
    st, data, theta0, j_mean_loss = lanes3
    opt = optax.adam(0.1)

    @jax.jit
    @jax.vmap
    def j_adam(th, d):
        def step(carry, _):
            t_, s = carry
            loss, g = jax.value_and_grad(lambda x: j_mean_loss(x, d))(t_)
            up, s = opt.update(g, s, t_)
            return (optax.apply_updates(t_, up), s), loss

        (t_, _), ls = jax.lax.scan(step, (th, opt.init(th)), None, length=5)
        return t_, ls

    j_theta, j_hist = (np.asarray(a) for a in j_adam(jnp.asarray(theta0), jnp.asarray(data)))
    theta, hist = st.adam_stage(torch.tensor(theta0), torch.tensor(data), steps=5)
    assert hist.dtype == F32 and hist.shape == (3, 5)
    np.testing.assert_allclose(hist.numpy(), j_hist, rtol=1e-5)
    # the iterates after the fifth update: float32 rounding, amplified by
    # ADAM's normalized steps, stays below 1e-4 of the weights' scale
    np.testing.assert_allclose(theta.numpy(), j_theta, rtol=0.0,
                               atol=1e-4 * np.abs(j_theta).max())


def test_bfgs_round_matches_jax_float64(lanes3):
    st, data, theta0, j_mean_loss = lanes3
    d64, th64 = data.astype(np.float64), theta0.astype(np.float64)

    @jax.jit
    @jax.vmap
    def j_bfgs(th, d):
        r = jude.bfgs_minimize(lambda t_: j_mean_loss(t_, d), th, maxiters=10,
                               initial_stepnorm=0.01, gtol=1e-12)
        return r.params, r.value, r.loss_history

    j_theta, j_val, j_hist = (np.asarray(a) for a in j_bfgs(jnp.asarray(th64), jnp.asarray(d64)))
    theta, value, hist = st.bfgs_round(torch.tensor(th64), torch.tensor(d64), maxiters=10)
    assert value.dtype == F64 and hist.shape == (3, 10)
    np.testing.assert_allclose(hist.numpy(), j_hist, rtol=1e-8)
    np.testing.assert_allclose(value.numpy(), j_val, rtol=1e-8)


def test_fixture_is_the_jax_draw():
    spec = importlib.util.spec_from_file_location("lv_study_lanes",
                                                  ROOT / "tools" / "lv_study_lanes.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    lanes = np.array([0, 100, 200, 300, 400])
    with jax.enable_x64(False):
        got = tool.draw(lanes)
    with np.load(rl.FIXTURE) as z:
        for k in ("ts", "X", "x_mean"):
            np.testing.assert_array_equal(z[k], got[k], err_msg=k)
        np.testing.assert_array_equal(z["mag"][lanes], got["mag"])
        np.testing.assert_array_equal(z["data"][lanes], got["data"])
        np.testing.assert_array_equal(z["theta0"][:, lanes], got["theta0"])
        assert z["data"].shape == (500, 31, 2) and z["theta0"].shape == (2, 500, 87)


def test_group_digests_are_the_jax_studys():
    # the JAX study's archived groups carry these digests in their names
    results = ROOT / "examples" / "lotka_volterra" / "results"
    for tag, label in ((rl.judge_tag(), "oracle"),
                       (rl.judge_tag(("widths", (9, 13, 17, 21, 25, 29))), "weak")):
        assert (results / f"loop_{label}_r100_{tag}_0000.npz").exists(), (label, tag)
    with np.load(results / "loop_study.npz") as z:
        tag = rl.judge_tag(extras=(z["coef1"], z["coef2"], z["coef1_weak"], z["coef2_weak"]))
    assert (results / f"loop_combo_r100_{tag}_0000.npz").exists(), tag
    assert rl.judge_tag(("widths", (9, 13))) != rl.judge_tag(("widths", (9, 13, 17)))


def _shrink(monkeypatch):
    # every stage at a small budget: the study's control flow is what is under test
    for name, value in (("ADAM_STEPS", 3), ("BFGS_ROUNDS", 1), ("BFGS_ITERS_PER_ROUND", 3),
                        ("LM_ROUNDS", 1), ("LM_ITERS", 2), ("K_SEL", 2),
                        ("MAX_TOTAL_SUPPORT", 3), ("REFIT_ITERS", 2), ("REFIT_TOP", (2, 2))):
        monkeypatch.setattr(rl, name, value)


def test_resume_rejects_chunk_mismatch(monkeypatch, tmp_path):
    _shrink(monkeypatch)
    first = rl.main(runs_per_level=1, archive=True, resume=False, chunk=5, assert_gates=False,
                    device="cpu", results=tmp_path)
    assert (tmp_path / "loop_chunk_r1_0000.npz").exists()
    with np.load(tmp_path / "loop_study.npz") as z:
        assert z["exact"].shape == (5, 1) and z["coef1_combo"].shape == (5, 23)
        assert z["loss_hist"].dtype == np.float16
    # every group resumes: the same rates, nothing recomputed
    again = rl.main(runs_per_level=1, archive=True, resume=True, chunk=5, assert_gates=False,
                    device="cpu", results=tmp_path)
    assert again["exact_combo"] == first["exact_combo"] and again["probe"] == {}
    with pytest.raises(SystemExit, match="chunk"):
        rl.main(runs_per_level=1, archive=True, resume=True, chunk=3, assert_gates=False,
                device="cpu", results=tmp_path)
    # the judge-oracle playoff over the archived lanes
    ex, co = rl.attribution(device="cpu", results=tmp_path)
    assert ex.shape == co.shape == (5, 1) and (tmp_path / "attribution.npz").exists()
    # trained weights of the first lane of each level, archived
    with np.load(rl.sample_thetas(per_level=1, runs_per_level=1, device="cpu",
                                  results=tmp_path)) as z:
        assert z["theta"].shape == (5, 87) and z["lane"].tolist() == [0, 1, 2, 3, 4]
        assert np.all(np.isfinite(z["loss"]))


def test_main_end_to_end_on_cpu(monkeypatch, tmp_path):
    _shrink(monkeypatch)
    out = rl.main(runs_per_level=2, bfgs_rounds=1, lm_rounds=1, assert_gates=False,
                  archive=False, resume=False, device="cpu", results=tmp_path)
    assert out["wall"] > 0 and len(out["chunk_walls"]) == 1
    for k in ("exact", "contains", "exact_pre_restart", "exact_sr3", "exact_sr3d",
              "exact_oracle", "exact_weak", "exact_combo"):
        assert len(out[k]) == 5, k
        assert all(0.0 <= v <= 1.0 for v in out[k]), k
    assert np.all(np.isfinite(out["err"])) and len(out["err"]) == 10
    assert np.all(np.isfinite(out["aicc"]))
    assert set(out["probe"]["stage_ops"]) == {"adam", "bfgs", "lm", "recover"}
    assert all(v > 0 for v in out["probe"]["stage_ops"].values())
    assert 0 <= out["restart_lanes"] <= 10
    assert not list(tmp_path.glob("*.npz"))  # archive=False writes no group


def test_bfgs_lanes_do_not_wait_for_each_others_line_searches():
    # independent Rosenbrock valleys whose line searches take different
    # numbers of trials: each evaluation serves every lane at its own point,
    # so the batch is evaluated as often as the busiest lane needs, not once
    # per trial of the slowest search of every iteration
    rng = np.random.default_rng(7)
    x0 = torch.tensor(rng.uniform(-1.5, 1.5, size=(6, 2)))
    shift = torch.tensor(rng.uniform(0.5, 1.5, size=(6,)))
    calls = [0]

    def lanes(X):
        calls[0] += 1
        return (shift - X[:, 0]) ** 2 + 100 * (X[:, 1] - X[:, 0] ** 2) ** 2

    res = tude.bfgs_minimize_lanes(lanes, x0, maxiters=60, initial_stepnorm=0.01)
    assert calls[0] == int(res.num_evals.max())
    assert int(res.num_evals.min()) < calls[0]


def test_lane_inputs_of_both_sources():
    # the JAX draw: at r < 100 runs per level, the first r lanes of each level
    st = rl.build_stages(device="cpu")
    data, theta0, mag = st.lane_inputs(np.arange(4), 2, attempt=1)
    with np.load(rl.FIXTURE) as z:
        np.testing.assert_array_equal(data.numpy(), z["data"][[0, 1, 100, 101]])
        np.testing.assert_array_equal(theta0.numpy(), z["theta0"][1][[0, 1, 100, 101]])
    np.testing.assert_array_equal(mag.numpy(), np.float32([1e-3, 1e-3, 5e-3, 5e-3]))
    # the port's own draw: a lane is its index, and a restart keeps its data
    st = rl.build_stages(device="cpu", lanes="torch")
    d0, th0, mag = st.lane_inputs([0, 7], 5)
    d1, th1, _ = st.lane_inputs([0, 7], 5, attempt=1)
    d7, th7, _ = st.lane_inputs([7], 5)
    assert d0.dtype == th0.dtype == F32 and th0.shape == (2, st.n_params)
    assert torch.equal(d0, d1) and not torch.equal(th0, th1)
    assert torch.equal(d7[0], d0[1]) and torch.equal(th7[0], th0[1])
    z = (d0 - st.X) / (mag[:, None, None] * st.x_mean)
    assert 0.5 < float(z.std()) < 1.5 and float(z.abs().max()) < 6.0
