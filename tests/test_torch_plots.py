"""PyTorch port: every example's figures against the JAX scripts' figures.

* Names: each of the 13 port scripts' figure functions, at a small size,
  writes exactly the file names its JAX script's source names.
* Fisher-KPP: the JAX script's ``write_plots`` (loaded by file path, its
  ``viz.save`` capturing the figures) and the port's, from the same
  parameters, for ``fourier`` and ``mlp``: the learned field within 1e-4 and
  the reaction curve within 1e-5 (float32; the port's plain RHS on the CPU).
* The 500-lane study: ``run_loops --plot-only`` on a copy of the committed
  archive writes the 8 figures, whose content (lines, markers, bars, texts,
  limits) equals the JAX ``write_plots``' on the same arrays; the
  trajectories of ``loop_trajectories`` agree within 1e-4.
* The port's figures go to ``build/plots/<case>/``; nothing is written under
  ``examples/``.
"""
import importlib
import importlib.util
import re
import shutil
from pathlib import Path

import jax
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_torch.viz as tviz
import universal_differential_equations_tpu.viz as jviz
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_tpu.models import fisher_kpp as jfk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PKG = "universal_differential_equations_torch.examples."
STUDY = EXAMPLES / "lotka_volterra" / "results"
F32 = torch.float32


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_names(rel, variant="mlp"):
    """The figure file names the JAX script's source names."""
    text = (EXAMPLES / rel).read_text()
    names = re.findall(r"""["']([\w{}.\-]+\.(?:pdf|png|gif))["']""", text)
    return {n.replace("{variant}", variant) for n in names}


def content(fig):
    """What a figure draws: per axes its limits, labels, texts, lines,
    marker offsets, bars and images; the figure's suptitle."""
    axes = []
    for ax in fig.axes:
        axes.append(dict(
            visible=ax.get_visible(), xlim=ax.get_xlim(), ylim=ax.get_ylim(),
            title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            texts=[t.get_text() for t in ax.texts],
            ticks=[t.get_text() for t in ax.get_xticklabels()],
            lines=[np.asarray(line.get_xydata(), float) for line in ax.lines],
            offsets=[np.asarray(c.get_offsets(), float) for c in ax.collections],
            bars=[(p.get_x(), p.get_height()) for p in ax.patches],
            images=[np.asarray(im.get_array(), float) for im in ax.images]))
    return dict(axes=axes, suptitle=fig._suptitle.get_text() if fig._suptitle else None)


def _recorder(monkeypatch, viz_module, write=False):
    """Replace ``viz_module.save`` with one that records each figure's
    content by file name (and writes the file too with ``write``)."""
    got = {}
    save = viz_module.save

    def record(fig, path):
        got[Path(path).name] = content(fig)
        if write:
            return save(fig, path)
        plt.close(fig)
        return Path(path)

    monkeypatch.setattr(viz_module, "save", record)
    return got


def assert_same(a, b, tol=None, where=""):
    """Equal content; arrays within ``tol`` (absolute and relative) if given."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape, where
        if tol is None:
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, tol, f"{where}[{i}]")
    elif isinstance(a, float) and tol is not None:
        assert abs(a - b) <= tol * max(1.0, abs(a)), (where, a, b)
    else:
        assert a == b, (where, a, b)


# --- names: each script's figure function at a small size ---------------------

def _t(rng, *shape, lo=0.0, hi=1.0):
    return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=F32)


def _fisher_kpp(m, out, rng):
    ts, data = torch.arange(0.0, 5.01, 0.5), _t(rng, 11, tfk.NX)
    _, params = tfk.make_model(torch.Generator().manual_seed(0), "mlp")
    m.write_plots("mlp", ts, data, params, out)
    m.make_dashboard("mlp", out)(100, 0.5, params)


def _lv_scenario_1(m, out, rng):
    ts, ts_ex = torch.linspace(0.0, 3.0, 31), torch.linspace(0.0, 50.0, 101)
    m.write_plots(ts, _t(rng, 31, 2, lo=1, hi=5), _t(rng, 31, 2, lo=1, hi=5), _t(rng, 31, 2),
                  _t(rng, 40), ts_ex, _t(rng, 101, 2), _t(rng, 101, 2), 3.0, out)


def _lv_scenario_2(m, out, rng):
    m.write_plots(torch.arange(0.0, 6.01, 0.05), _t(rng, 121, 2), torch.linspace(0.0, 6.0, 61),
                  _t(rng, 61, 2), torch.tensor(1.7), out)


def _lv_scenario_3(m, out, rng):
    u = np.linspace(0.0, 1.0, 101)
    m.write_plots(_t(rng, 11, 26), _t(rng, 11, 26), (u, u * (1 - u) + 0.01, u * (1 - u)), out)


def _hudson_bay(m, out, rng):
    m.write_plots(torch.arange(0.0, 21.0), _t(rng, 21, 2), _t(rng, 41, 2), _t(rng, 201, 2), out)


def _seir_exposure(m, out, rng):
    m.write_plots(torch.arange(0.0, 22.0), _t(rng, 22), _t(rng, 22), torch.arange(0.0, 61.0),
                  _t(rng, 61, 7), _t(rng, 61, 7), out)


def _run_loops(m, out, rng):
    # one exact lane and one failed lane with a finite model: two solves
    ex = np.zeros((5, 4), bool)
    ex[0, 0] = True
    c1 = np.full((20, len(m.BASIS)), np.nan, np.float32)
    c2 = np.zeros_like(c1)
    c1[:2] = 0.0
    c1[:2, m.I_XY] = -0.9
    c1[1, 0] = 0.05
    c2[:, m.I_XY] = 0.8
    m.write_plots(ex, ex | (rng.random((5, 4)) < 0.5), c1, c2, np.asarray(m.NOISE_LEVELS),
                  final_loss=rng.random(20), err=rng.random(20), aicc=rng.random(20),
                  loss_hist=rng.random((20, 12)).astype(np.float16), exact_o=ex, contains_o=ex,
                  exact_w=ex, contains_w=ex, exact_j=ex, outdir=out, device="cpu")


def _hjb_100d(m, out, rng):
    m.write_plots(torch.as_tensor(rng.random(30)), 4.59, 4.60, 0.002, out)


def _fenep(m, out, rng):
    m.write_plots(torch.linspace(0.0, 10.0, 100), _t(rng, 100), rng.random(100),
                  rng.random(100), out)


def _climate_neural_pde(m, out, rng):
    _, params, net = m.cn.make_neural_rhs(torch.Generator().manual_seed(0))
    m.write_plots(m.flux_curves(net, params, _t(rng, 30, 30)), _t(rng, 30, 30), out)


def _climate_neural_pde_data(m, out, rng):
    m.write_plots(np.linspace(-0.5, 0.5, 64), 32, (0.0, 4.0), _t(rng, 41, 30), _t(rng, 41, 30),
                  out)


def _climate_training_rt(m, out, rng):
    m.write_plots(np.arange(9) * 0.1, np.linspace(-0.5, 0.5, 64), rng.random((9, 16)),
                  rng.random((9, 16)), 16, out)


def _climate_data_generation(m, out, rng):
    m.write_plots(np.arange(41) * 0.1, np.linspace(-0.5, 0.5, 64), rng.random((41, 64)), out)


SCRIPTS = {  # port script: (its JAX script, a call of its figure function at a small size)
    "fisher_kpp": ("fisher_kpp/fisher_kpp.py", _fisher_kpp),
    "lv_scenario_1": ("lotka_volterra/scenario_1.py", _lv_scenario_1),
    "lv_scenario_2": ("lotka_volterra/scenario_2.py", _lv_scenario_2),
    "lv_scenario_3": ("lotka_volterra/scenario_3.py", _lv_scenario_3),
    "hudson_bay": ("lotka_volterra/hudson_bay.py", _hudson_bay),
    "seir_exposure": ("seir_exposure/seir_exposure.py", _seir_exposure),
    "run_loops": ("lotka_volterra/run_loops.py", _run_loops),
    "hjb_100d": ("highdim_pde/hjb_100d.py", _hjb_100d),
    "fenep": ("non_newtonian/fenep.py", _fenep),
    "climate_neural_pde": ("climate/neural_pde.py", _climate_neural_pde),
    "climate_neural_pde_data": ("climate/neural_pde_data.py", _climate_neural_pde_data),
    "climate_training_rt": ("climate/training_rt.py", _climate_training_rt),
    "climate_data_generation": ("climate/data_generation.py", _climate_data_generation),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_figure_function_writes_the_jax_scripts_names(tmp_path, script):
    rel, call = SCRIPTS[script]
    m = importlib.import_module(PKG + script)
    # the default folder: build/plots/<the JAX example's directory>
    assert m.PLOTS == ROOT / "build" / "plots" / rel.split("/")[0]
    call(m, tmp_path, np.random.default_rng(len(script)))
    written = {p.name for p in tmp_path.iterdir()}
    assert written == jax_names(rel)
    assert all(p.stat().st_size > 0 for p in tmp_path.iterdir())


# --- Fisher-KPP: the learned field and the reaction curve --------------------------

@pytest.fixture(scope="module")
def fkpp_scripts():
    return _load("jax_fisher_kpp_plots", "examples/fisher_kpp/fisher_kpp.py"), \
        importlib.import_module(PKG + "fisher_kpp")


@pytest.mark.parametrize("variant", ["fourier", "mlp"])
def test_fisher_kpp_figures_match_jax(monkeypatch, tmp_path, fkpp_scripts, variant):
    jx, tx = fkpp_scripts
    ts_j, data_j = jfk.generate_data()
    _, p_j = jfk.make_model(jax.random.PRNGKey(5), variant)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F32)
    ts_t, data_t = torch.as_tensor(np.asarray(ts_j)), torch.as_tensor(np.asarray(data_j))
    got_j = _recorder(monkeypatch, jviz)
    got_t = _recorder(monkeypatch, tviz)
    jx.write_plots(variant, ts_j, data_j, p_j)
    tx.write_plots(variant, ts_t, data_t, p_t, tmp_path)
    assert set(got_t) == set(got_j) == jax_names("fisher_kpp/fisher_kpp.py", variant) - {
        "dashboard.png"}
    assert_same(got_t[f"{variant}_truth.pdf"], got_j[f"{variant}_truth.pdf"])
    for name, tol in (("learned", 1e-4), ("error", 1e-4), ("reaction", 1e-5)):
        assert_same(got_t[f"{variant}_{name}.pdf"], got_j[f"{variant}_{name}.pdf"], tol, name)


# --- the 500-lane study from its committed archive ---------------------------------

@pytest.fixture(scope="module")
def study_figures(tmp_path_factory):
    """``run_loops --plot-only`` on a copy of the committed archive: the
    files it writes and what its figures draw."""
    rl = importlib.import_module(PKG + "run_loops")
    results = tmp_path_factory.mktemp("results")
    for name in ("loop_study.npz", "attribution.npz"):
        shutil.copy(STUDY / name, results / name)
    plots = tmp_path_factory.mktemp("plots")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rl, "PLOTS", plots)
        got = _recorder(mp, tviz, write=True)
        rl.cli(["--plot-only", "--results", str(results), "--device", "cpu"])
    return plots, got


def test_run_loops_plot_only_writes_the_eight_figures(study_figures):
    plots, got = study_figures
    names = jax_names("lotka_volterra/run_loops.py")
    assert len(names) == 8
    assert {p.name for p in plots.iterdir()} == set(got) == names
    assert all(p.stat().st_size > 0 for p in plots.iterdir())


def test_study_figures_match_jax(monkeypatch, study_figures):
    _, got_t = study_figures
    jrl = _load("jax_run_loops_plots", "examples/lotka_volterra/run_loops.py")
    got_j = _recorder(monkeypatch, jviz)
    with np.load(STUDY / "attribution.npz") as za:
        exact_j = za["exact"]
    with np.load(STUDY / "loop_study.npz") as z:
        jrl.write_plots(z["exact"], z["contains"], z["coef1"], z["coef2"], z["noise"],
                        exact_j=exact_j, final_loss=z["final_loss"], err=z["err"],
                        aicc=z["aicc"], loss_hist=z["loss_hist"], exact_o=z["exact_oracle"],
                        contains_o=z["contains_oracle"], exact_w=z["exact_weak"],
                        contains_w=z["contains_weak"])
    assert set(got_j) == set(got_t)
    for name in sorted(got_j):
        tol = 1e-4 if name == "loop_trajectories.pdf" else None
        assert_same(got_t[name], got_j[name], tol, name)


def test_nothing_written_under_examples():
    import subprocess

    out = subprocess.run(["git", "status", "--porcelain", "--", "examples"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 or out.stdout == ""
