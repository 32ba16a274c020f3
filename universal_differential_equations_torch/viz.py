"""Figure helpers for the case-study examples of the port.

A copy of the JAX package's ``viz.py`` (the reference's Plots.jl/PyPlot
figures: trajectory fits, missing-term comparisons, loss histories, PDE
heatmaps, success-rate bars, profile animations and the live training
dashboard), with the same names, constants and styling.  The one change:
every helper also takes torch tensors, on any device, and copies them to the
host at its entry, so a figure drawn from the same values is the same file.

Design rules applied throughout (kept deliberately boring and consistent):

- one fixed, colorblind-validated categorical series order (never cycled,
  never re-assigned when a series is dropped);
- sequential (magnitude) data uses a single-hue light→dark ramp, never a
  rainbow; diverging data gets two hues around a neutral midpoint;
- one y-axis per plot; recessive grid; thin marks; direct labels where they
  fit, legend otherwise.

Matplotlib renders through the Agg backend on a headless host (no
``DISPLAY`` or ``MPLBACKEND``); every helper returns the ``Figure`` so
callers can compose, and ``save`` writes PDF/PNG.  ``animate_profiles``
needs Pillow.  The package's ``__init__`` does not import this module, so
only ``--plot`` needs matplotlib.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

import matplotlib
import torch

# headless hosts get Agg; an interactive session's chosen backend (GUI or
# notebook inline) is left untouched
if not os.environ.get("MPLBACKEND") and not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import LinearSegmentedColormap  # noqa: E402

__all__ = [
    "SERIES", "style_axes", "new_figure", "save",
    "plot_timeseries", "plot_loss_history", "plot_field",
    "plot_function_comparison", "plot_success_rates", "animate_profiles",
    "TrainingDashboard",
]

# Fixed categorical order — CVD-validated (worst adjacent-pair ΔE 9.1 on a
# light surface): blue, orange, aqua, yellow, magenta, green, violet, red.
SERIES = (
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100",
    "#e87ba4", "#008300", "#4a3aa7", "#e34948",
)
_INK = "#1a1a19"
_MUTED = "#6b6a62"
_GRID = "#e4e3dc"

# single-hue sequential ramp (light → dark blue) for magnitude fields
SEQ_CMAP = LinearSegmentedColormap.from_list(
    "ude_seq", ["#f4f7fc", "#a8c6ec", "#2a78d6", "#123c6b"]
)
# diverging: warm/cool poles around a neutral gray midpoint
DIV_CMAP = LinearSegmentedColormap.from_list(
    "ude_div", ["#1f5ba8", "#7ea7dd", "#f0efe9", "#f09d77", "#c24a20"]
)

# Applied per-figure via rc_context in the helpers — importing this module
# must not restyle a user's unrelated figures (process-global rcParams).
_RC = {
    "figure.dpi": 130,
    "font.size": 9,
    "axes.edgecolor": _MUTED,
    "axes.labelcolor": _INK,
    "text.color": _INK,
    "xtick.color": _MUTED,
    "ytick.color": _MUTED,
    "axes.titlesize": 10,
    "axes.titleweight": "semibold",
    "legend.frameon": False,
}


def _host(x):
    """A torch tensor (any device) as a numpy array; anything else unchanged."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _ctx():
    return plt.rc_context(_RC)


def _styled(fn):
    """Run the whole helper inside the rc_context: legends, titles and
    labels are created after ``new_figure`` returns, so styling only the
    figure-creation call would leave them on default rcParams."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _ctx():
            return fn(*args, **kwargs)

    return wrapper


def style_axes(ax):
    """Recessive grid, no top/right spines."""
    ax.grid(True, color=_GRID, linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_linewidth(0.8)
    return ax


def new_figure(width=5.2, height=3.2):
    with _ctx():
        fig, ax = plt.subplots(figsize=(width, height))
        style_axes(ax)
    return fig, ax


def save(fig, path):
    """Write the figure (directories created; format from the suffix)."""
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    # Strip run-dependent PDF/SVG metadata so re-running an example with
    # unchanged science output leaves the tracked figure byte-identical.
    # (The SVG backend's timestamp key is "Date"; passing "CreationDate"
    # there raises ValueError.)
    metadata = None
    if path.suffix.lower() == ".pdf":
        metadata = {"CreationDate": None}
    elif path.suffix.lower() == ".svg":
        metadata = {"Date": None}
    fig.savefig(path, bbox_inches="tight", metadata=metadata)
    plt.close(fig)
    return path


@_styled
def plot_timeseries(ts, ys, labels=None, data_ts=None, data=None,
                    data_label="measurements", title=None, xlabel="t",
                    ylabel=None, ax=None, train_end=None):
    """Solution curves (lines) with optional noisy observations (markers).

    The reference's recurring figure: `scenario_1.jl` "UDE Approximation" /
    "Training Data" overlays, `hudson_bay.jl` data fits, `seir_exposure.jl`
    extrapolations.  ``train_end`` draws the training-window boundary.
    """
    ts, ys, data_ts, data = map(_host, (ts, ys, data_ts, data))
    if ax is None:
        fig, ax = new_figure()
    else:
        fig = ax.figure
    ts = np.asarray(ts)
    ys = np.atleast_2d(np.asarray(ys).T).T  # (T,) -> (T, 1)
    for i in range(ys.shape[1]):
        lab = labels[i] if labels else None
        ax.plot(ts, ys[:, i], color=SERIES[i % len(SERIES)], linewidth=1.6,
                label=lab, zorder=3)
    if data is not None:
        data = np.atleast_2d(np.asarray(data).T).T
        dts = np.asarray(data_ts if data_ts is not None else ts)
        for i in range(data.shape[1]):
            ax.scatter(dts, data[:, i], s=9, color=SERIES[i % len(SERIES)],
                       alpha=0.55, edgecolors="none", zorder=2,
                       label=data_label if i == 0 else None)
    if train_end is not None:
        ax.axvline(train_end, color=_MUTED, linewidth=0.9, linestyle="--",
                   zorder=1)
        ax.annotate(" training window ends", (train_end, ax.get_ylim()[1]),
                    fontsize=7, color=_MUTED, va="top")
    ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    if labels or data is not None:
        ax.legend(fontsize=8, ncol=2)
    return fig


@_styled
def plot_loss_history(losses, stages=None, title="training loss", ax=None):
    """Log-scale loss trajectory; ``stages`` = [(name, n_steps), …] shades
    the optimizer stages (the reference's ADAM→BFGS chaining)."""
    if ax is None:
        fig, ax = new_figure()
    else:
        fig = ax.figure
    losses = np.array(_host(losses), dtype=float)
    # non-finite entries become gaps, keeping x = iteration index so the
    # stage spans below stay aligned
    losses[~np.isfinite(losses)] = np.nan
    ax.semilogy(np.arange(losses.size), losses, color=SERIES[0],
                linewidth=1.4, zorder=3)
    if stages:
        x0 = 0
        for si, (name, n) in enumerate(stages):
            if si % 2 == 1:
                ax.axvspan(x0, x0 + n, color=_GRID, alpha=0.45, zorder=0)
            ax.annotate(name, ((x0 + n / 2), ax.get_ylim()[1]), fontsize=7,
                        color=_MUTED, ha="center", va="top")
            x0 += n
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_title(title)
    return fig


@_styled
def plot_field(field, extent, title=None, xlabel="t", ylabel="x",
               cbar_label=None, diverging=False, ax=None):
    """Space-time heatmap u(x, t) for the PDE cases (`Fisher-KPP-CNN.jl`
    and `npde.jl` surface/contour figures).  Sequential single-hue ramp by
    default; set ``diverging=True`` for signed fields (neutral midpoint)."""
    if ax is None:
        with _ctx():
            fig, ax = plt.subplots(figsize=(5.0, 3.0))
    else:
        fig = ax.figure
    field = np.asarray(_host(field))
    cmap = DIV_CMAP if diverging else SEQ_CMAP
    kw = {}
    if diverging:
        m = np.max(np.abs(field))
        kw = dict(vmin=-m, vmax=m)
    im = ax.imshow(field, aspect="auto", origin="lower", extent=extent,
                   cmap=cmap, interpolation="nearest", **kw)
    cb = fig.colorbar(im, ax=ax, fraction=0.046, pad=0.03)
    if cbar_label:
        cb.set_label(cbar_label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return fig


@_styled
def plot_function_comparison(x, learned, true_vals, labels=("learned", "true"),
                             title=None, xlabel="u", ylabel=None, ax=None):
    """Learned missing term vs ground-truth term (the reference's
    "Missing term" panels, `scenario_1.jl` / `scenario_3.jl` reaction
    comparisons).  Handles (N,) or (N, k) columns."""
    if ax is None:
        fig, ax = new_figure()
    else:
        fig = ax.figure
    x, learned, true_vals = map(_host, (x, learned, true_vals))
    x = np.asarray(x)
    learned = np.atleast_2d(np.asarray(learned).T).T
    true_vals = np.atleast_2d(np.asarray(true_vals).T).T
    for i in range(learned.shape[1]):
        suffix = f" [{i+1}]" if learned.shape[1] > 1 else ""
        ax.plot(x, true_vals[:, i], color=SERIES[i % len(SERIES)],
                linewidth=2.4, alpha=0.35, label=labels[1] + suffix, zorder=2)
        ax.plot(x, learned[:, i], color=SERIES[i % len(SERIES)],
                linewidth=1.3, linestyle="--", label=labels[0] + suffix,
                zorder=3)
    ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend(fontsize=8)
    return fig


class TrainingDashboard:
    """Live training dashboard as a ``fit`` callback (the reference's
    in-loop matplotlib dashboard, `Fisher-KPP-CNN.jl:163-233`): every
    invocation rewrites ``<path>`` with the loss history plus an optional
    user panel (e.g. current prediction vs data, stencil weights).

    ``panel(ax, step, params)`` draws the right-hand panel from the live
    parameters as ``fit`` passes them (on the card: copy what it draws to the
    host); headless-safe (file-based "live" view — tail it with any image
    viewer).

    >>> dash = TrainingDashboard("plots/dashboard.png", panel=draw_fit)
    >>> fit(loss, p0, lambda leaves: torch.optim.Adam(leaves, lr=1e-3), 1000,
    ...     callback=dash, callback_every=50)
    """

    def __init__(self, path, panel=None, title="training"):
        self.path = Path(path)
        self.panel = panel
        self.title = title
        self.steps = []
        self.losses = []

    def __call__(self, step, loss, params):
        step, loss = int(step), float(loss)
        self.steps.append(step)
        self.losses.append(loss)
        with _ctx():
            ncols = 2 if self.panel is not None else 1
            fig, axes = plt.subplots(1, ncols, figsize=(4.2 * ncols, 3.0))
            axes = np.atleast_1d(axes)
            style_axes(axes[0])
            ls = np.array(self.losses, dtype=float)
            ls[~np.isfinite(ls)] = np.nan
            axes[0].semilogy(self.steps, ls, color=SERIES[0], linewidth=1.4)
            axes[0].set_xlabel("step")
            axes[0].set_ylabel("loss")
            axes[0].set_title(f"{self.title} — step {step}, "
                              f"loss {loss:.3e}", fontsize=9)
            if self.panel is not None:
                style_axes(axes[1])
                self.panel(axes[1], step, params)
            save(fig, self.path)
        return False  # never requests an early stop


def animate_profiles(path, coord, truth, pred=None, ts=None, fps=12,
                     xlabel="value", ylabel="z", title=None, max_frames=120):
    """Animated profile evolution (the reference's MP4 rollout animations,
    `neural_pde_rayleigh_taylor_instability.jl:186-202`), written as GIF via
    the Pillow writer (no ffmpeg dependency).

    ``truth``/``pred``: (T, N) frames over the 1-D ``coord`` (N,).
    """
    from matplotlib.animation import FuncAnimation, PillowWriter

    coord, truth, pred, ts = map(_host, (coord, truth, pred, ts))
    truth = np.asarray(truth)
    stride = max(1, truth.shape[0] // max_frames)
    idx = np.arange(0, truth.shape[0], stride)
    with _ctx():
        fig, ax = plt.subplots(figsize=(3.6, 3.6))
        style_axes(ax)
    lo = min(truth.min(), np.asarray(pred).min() if pred is not None else np.inf)
    hi = max(truth.max(), np.asarray(pred).max() if pred is not None else -np.inf)
    pad = 0.05 * (hi - lo + 1e-12)
    ax.set_xlim(lo - pad, hi + pad)
    ax.set_ylim(float(np.min(coord)), float(np.max(coord)))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    (l_truth,) = ax.plot([], [], color=SERIES[0], linewidth=2.2, alpha=0.45,
                         label="data")
    l_pred = None
    if pred is not None:
        (l_pred,) = ax.plot([], [], color=SERIES[0], linewidth=1.3,
                            linestyle="--", label="model")
        ax.legend(fontsize=8, loc="upper right")
    ttl = ax.set_title(title or "")

    def update(k):
        i = idx[k]
        l_truth.set_data(truth[i], coord)
        arts = [l_truth, ttl]
        if l_pred is not None:
            l_pred.set_data(np.asarray(pred)[i], coord)
            arts.append(l_pred)
        stamp = f"t = {float(ts[i]):.2f}" if ts is not None else f"frame {i}"
        ttl.set_text(f"{title + '   ' if title else ''}{stamp}")
        return arts

    anim = FuncAnimation(fig, update, frames=len(idx), blit=False)
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


@_styled
def plot_success_rates(noise_levels, rates, counts=None,
                       title="exact structural recovery rate", ax=None):
    """Per-noise-level success-rate bars (`loop_evaluation.jl:120-126`,
    `plots/Found_Equations_Loop.pdf` analogue)."""
    if ax is None:
        fig, ax = new_figure(4.6, 3.0)
    else:
        fig = ax.figure
    noise_levels, rates = _host(noise_levels), _host(rates)
    x = np.arange(len(noise_levels))
    rates = np.asarray(rates, dtype=float)
    ax.bar(x, 100.0 * rates, width=0.62, color=SERIES[0], zorder=3)
    for xi, r in zip(x, rates):
        ax.annotate(f"{100 * r:.0f}%", (xi, 100 * r), ha="center",
                    va="bottom", fontsize=8, color=_INK)
    ax.set_xticks(x)
    ax.set_xticklabels([f"{nl:g}" for nl in noise_levels])
    ax.set_xlabel("noise magnitude")
    ax.set_ylabel("success rate [%]")
    ax.set_ylim(0, 105)
    if counts is not None:
        ax.set_title(f"{title} (n = {counts} per level)")
    else:
        ax.set_title(title)
    return fig
