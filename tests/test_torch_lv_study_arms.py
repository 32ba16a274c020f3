"""PyTorch port: the noise study's training-free arms against the JAX package and its archive.

The port's ``weak_stage`` (``examples/run_loops.py``) on the study's lanes
selects the same supports as the JAX study's own ``weak_stage`` run on the
same ``jax.random`` keys (float32, x64 off), with coefficients within 1e-3
relative, and so does its ``recover_stage`` from weights the JAX study
trained (``examples/data/lv_study_recover.npz`` records JAX's selections on
all 25).  On the 25 lanes the JAX study trained for
``lane_theta_samples.npz`` (lanes 0-4 of each level, a set fixed before the
port), the oracle and weak
arms select, on at least 23 lanes each, the active sets that the JAX study
archived in ``loop_study.npz``.  The combo playoff picks the true structure
from whichever arm offers it, and the playoff with the truth injected as a
third candidate finds it (mirrors of ``tests/test_lv_pipeline.py``'s
``test_combo_playoff_picks_true_structure_from_either_arm``).
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_differential_equations_torch.examples import run_loops as rl

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "examples" / "lotka_volterra" / "results"
FIVE = np.array([0, 100, 200, 300, 400])  # lane 0 of each noise level


@pytest.fixture(scope="module")
def st():
    return rl.build_stages(device="cpu")


def test_weak_stage_matches_jax(st):
    sys.path.insert(0, str(RESULTS.parent))
    import run_loops as jrl

    with jax.enable_x64(False):
        jst = jrl.build_stages()
        keys = jax.random.split(jax.random.PRNGKey(42), 500)[jnp.asarray(FIVE)]
        mags = jnp.asarray(np.asarray(rl.NOISE_LEVELS, np.float32))
        j_ex, j_co, j_c1, j_c2 = (np.asarray(a) for a in jst.weak_stage(keys, mags))
    data, _, mags_t = st.lane_inputs(FIVE, 100)
    ex, co, c1, c2 = (a.numpy() for a in st.weak_stage(data, mags_t))
    for got, ref in ((c1, j_c1), (c2, j_c2)):
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0.0)
    np.testing.assert_array_equal(ex, j_ex)
    np.testing.assert_array_equal(co, j_co)


def test_recover_stage_matches_jax(st):
    # lanes whose selections differ: x·y, the constant term, and mixed supports
    lanes = np.array([102, 202, 301, 303, 401])
    spec = importlib.util.spec_from_file_location("lv_study_lanes", ROOT / "tools" /
                                                  "lv_study_lanes.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with jax.enable_x64(False):
        _, j_c1, j_c2 = tool.jax_recover(lanes)
    with np.load(RESULTS / "lane_theta_samples.npz") as z:
        rows = np.searchsorted(z["lane"], lanes)
        theta, loss = torch.as_tensor(z["theta"][rows]), torch.as_tensor(z["loss"][rows])
    data, _, mags = st.lane_inputs(lanes, 100)
    out = st.recover_stage(theta, data, loss, mags)
    for got, ref in ((out[3].numpy(), j_c1), (out[4].numpy(), j_c2)):
        np.testing.assert_array_equal(got != 0, ref != 0)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0.0)
    with np.load(rl.FIXTURE.with_name("lv_study_recover.npz")) as z:
        np.testing.assert_array_equal(z["coef1"][rows] != 0, j_c1 != 0)


@pytest.mark.parametrize("arm", ["oracle", "weak"])
def test_arm_agrees_with_the_jax_archive(st, arm):
    with np.load(RESULTS / "lane_theta_samples.npz") as z:
        lanes = z["lane"]
    with np.load(RESULTS / "loop_study.npz") as z:
        a1, a2 = z[f"coef1_{arm}"][lanes] != 0, z[f"coef2_{arm}"][lanes] != 0
    data, _, mags = st.lane_inputs(lanes, 100)
    stage = st.oracle_stage if arm == "oracle" else st.weak_stage
    _, _, c1, c2 = stage(data, mags)
    same = ((c1.numpy() != 0) == a1).all(1) & ((c2.numpy() != 0) == a2).all(1)
    assert same.sum() >= 23, f"{arm}: lanes {lanes[~same].tolist()} disagree with the archive"


def test_combo_playoff_picks_true_structure_from_either_arm(st):
    m = len(rl.BASIS)
    names = rl.BASIS.names

    def coef(name, value):
        c = torch.zeros(m)
        c[names.index(name)] = value
        return c

    true1, true2 = coef("u1*u2", -0.9), coef("u1*u2", 0.8)
    wrong1, wrong2 = coef("u1", -0.5), coef("u2^2", 0.1)
    n = 4
    data, _, mags = st.lane_inputs(np.arange(200, 200 + n), 100)  # noise 1e-2
    tile = lambda c: c[None].repeat(n, 1)  # noqa: E731
    # the true structure on the trained side, then on the weak side
    ex_a, co_a, _, _ = st.combo_stage(data, mags, tile(true1), tile(true2),
                                      tile(wrong1), tile(wrong2))
    ex_b, co_b, _, _ = st.combo_stage(data, mags, tile(wrong1), tile(wrong2),
                                      tile(true1), tile(true2))
    assert int(ex_a.sum()) >= 3 and int(ex_b.sum()) >= 3, (ex_a, ex_b)
    assert bool((co_a == ex_a).all()) and bool((co_b == ex_b).all())
    # both arms wrong, the truth offered as a third candidate: the judge finds it
    cands1 = torch.stack([wrong1, coef("u2", 0.3), true1])
    cands2 = torch.stack([wrong2, coef("u1^2", -0.2), true2])
    ex_o, _, _, _ = st.playoff_stage(data, mags, cands1[None].repeat(n, 1, 1),
                                     cands2[None].repeat(n, 1, 1))
    assert int(ex_o.sum()) >= 3, ex_o
