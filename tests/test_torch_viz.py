"""PyTorch port: ``viz.py`` against the JAX package's ``viz.py``.

Every drawing helper of the JAX module's ``__all__`` is fed the same numpy
arrays, made from a seed, in both packages, and must write the same bytes
(PDF and PNG; GIF for ``animate_profiles``); the port's helper must write
them again from CPU tensors.  ``TrainingDashboard`` rewrites its PNG on each
call and never asks ``fit`` to stop.  A host without matplotlib imports the
port and its examples, and an example's ``--plot`` stops there at once.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import universal_differential_equations_torch.viz as tv
import universal_differential_equations_tpu.viz as jv

ROOT = Path(__file__).resolve().parents[1]


def _arrays():
    rng = np.random.default_rng(12)
    ts = np.linspace(0.0, 5.0, 41)
    ys = np.stack([np.sin(ts) + 2.0, np.cos(0.7 * ts) + 2.0], -1)
    x = np.linspace(0.0, 1.0, 51)
    losses = np.exp(-np.linspace(0.0, 6.0, 50)) * (1.0 + 0.1 * rng.random(50))
    losses[7] = np.inf  # a non-finite entry becomes a gap
    return dict(ts=ts, ys=ys, noisy=ys + 0.05 * rng.standard_normal(ys.shape), x=x,
                learned=np.stack([x * (1 - x) + 0.01 * rng.standard_normal(51), -x], -1),
                true=np.stack([x * (1 - x), -x], -1), losses=losses,
                field=rng.standard_normal((26, 11)).cumsum(0),
                noise=np.array([1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2]),
                rates=np.array([0.97, 0.95, 0.9, 0.61, 0.2]))


def _tensors(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


def _styled_figure(v, a):
    fig, ax = v.new_figure(4.0, 3.0)
    v.style_axes(ax)
    ax.plot(np.asarray(a["x"]), np.asarray(a["true"])[:, 0], color=v.SERIES[2])
    return fig


HELPERS = {
    "plot_timeseries": lambda v, a: v.plot_timeseries(
        a["ts"], a["ys"], labels=["x", "y"], data_ts=a["ts"], data=a["noisy"], title="fit",
        ylabel="population", train_end=2.5),
    "plot_loss_history": lambda v, a: v.plot_loss_history(
        a["losses"], stages=[("ADAM", 30), ("BFGS", 20)]),
    "plot_field": lambda v, a: v.plot_field(a["field"], (0.0, 5.0, 0.0, 1.04),
                                            title="ρ(x, t)", cbar_label="ρ"),
    "plot_field_diverging": lambda v, a: v.plot_field(a["field"], (0.0, 5.0, 0.0, 1.04),
                                                      cbar_label="Δρ", diverging=True),
    "plot_function_comparison": lambda v, a: v.plot_function_comparison(
        a["x"], a["learned"], a["true"], labels=("NN", "true"), title="missing terms",
        ylabel="r"),
    "plot_success_rates": lambda v, a: v.plot_success_rates(a["noise"], a["rates"], counts=100),
    "new_figure_style_axes": _styled_figure,
}


def test_module_surface_equals_jax():
    assert tv.__all__ == jv.__all__
    assert tv.SERIES == jv.SERIES and tv._RC == jv._RC
    for name in ("SEQ_CMAP", "DIV_CMAP"):
        grid = np.linspace(0.0, 1.0, 33)
        np.testing.assert_array_equal(getattr(tv, name)(grid), getattr(jv, name)(grid))


@pytest.mark.parametrize("suffix", ["pdf", "png"])
@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_writes_the_jax_helpers_bytes(tmp_path, name, suffix):
    a = _arrays()
    jv.save(HELPERS[name](jv, a), tmp_path / f"jax.{suffix}")
    # the PDF case feeds the port CPU tensors, the PNG case numpy arrays
    tv.save(HELPERS[name](tv, _tensors(a) if suffix == "pdf" else a), tmp_path / f"port.{suffix}")
    ref = (tmp_path / f"jax.{suffix}").read_bytes()
    assert len(ref) > 1000
    assert (tmp_path / f"port.{suffix}").read_bytes() == ref


def test_animate_profiles_writes_the_jax_gif(tmp_path):
    rng = np.random.default_rng(3)
    z = np.linspace(-0.5, 0.5, 16)
    truth = np.tanh(8 * z)[None, :] * np.linspace(1.0, 0.4, 9)[:, None]
    pred = truth + 0.02 * rng.standard_normal(truth.shape)
    ts = np.linspace(0.0, 0.8, 9)
    kw = dict(xlabel="b̄", title="free rollout")
    jv.animate_profiles(tmp_path / "jax.gif", z, truth, pred=pred, ts=ts, **kw)
    tv.animate_profiles(tmp_path / "port.gif", z, truth, pred=pred, ts=ts, **kw)
    tv.animate_profiles(tmp_path / "tensors.gif", torch.as_tensor(z), torch.as_tensor(truth),
                        pred=torch.as_tensor(pred), ts=torch.as_tensor(ts), **kw)
    ref = (tmp_path / "jax.gif").read_bytes()
    assert ref[:6] == b"GIF89a"
    assert (tmp_path / "port.gif").read_bytes() == ref
    assert (tmp_path / "tensors.gif").read_bytes() == ref


def test_training_dashboard_rewrites_the_jax_png(tmp_path):
    def panel(ax, step, params):
        w = np.asarray(params["w"])
        ax.bar([0, 1, 2], w, color=jv.SERIES[0])
        ax.set_title(f"stencil (Σw = {w.sum():+.1e})", fontsize=8)

    def panel_t(ax, step, params):
        panel(ax, step, {"w": params["w"].detach().cpu().numpy()})

    dj = jv.TrainingDashboard(tmp_path / "jax.png", panel=panel, title="fisher-kpp mlp")
    dt = tv.TrainingDashboard(tmp_path / "port.png", panel=panel_t, title="fisher-kpp mlp")
    for step, loss in ((100, 0.52), (200, 0.031), (300, float("nan"))):
        w = np.array([1.1, -2.5, 1.0]) * (1.0 + step / 1000)
        assert dj(step, np.float32(loss), {"w": w}) is False
        # the port's fit passes the loss as a float and the live tensors
        assert dt(step, loss, {"w": torch.as_tensor(w)}) is False
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    assert dt.steps == [100, 200, 300] and dt.losses[:2] == [0.52, 0.031]


_NO_MATPLOTLIB = r"""
import importlib, json, pkgutil, sys
sys.modules["matplotlib"] = None  # any "import matplotlib" now raises ImportError
import universal_differential_equations_torch as pkg
import universal_differential_equations_torch.examples as ex
names = [m.name for m in pkgutil.walk_packages(ex.__path__, ex.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from universal_differential_equations_torch.examples import fenep
try:
    fenep.main(device="cpu", plot=True)
except ImportError as e:
    error = str(e)
print(json.dumps(dict(names=names, error=error)))
"""


def test_plot_fails_at_once_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["names"]) == 13
    assert "matplotlib" in res["error"]
    # it stopped before the truth solves, which print their first line
    assert "DAE data generation" not in out.stdout
