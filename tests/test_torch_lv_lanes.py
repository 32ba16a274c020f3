"""PyTorch port: the LV study's lane loss and gradient (``ops/lv_lanes.py``) on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``); here its
plain PyTorch twin, which does the kernel's arithmetic (forward solve, the
states kept, the reverse sweep written out), is held to the JAX package's
``jax.vmap(jax.value_and_grad)`` of the study's lane loss, to autograd
through ``integrate_fixed`` and the ``make_ude`` RHS, to the study's own
``loss_and_grad`` on the CPU within the benchmark's limits, and the wrapper
to its checks.

The card test holds the kernel to JAX's float64 loss and gradient of 25
study lanes, stored in ``tests/data/lv_lanes_jax.npz`` (the card's machine
has no JAX); ``test_card_reference_is_jax`` recomputes them here.  Rewrite
the file with ``PYTHONPATH=. python3 tests/test_torch_lv_lanes.py``.
"""
import statistics
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.core.integrate import integrate_fixed
from universal_differential_equations_torch.examples import run_loops as rl
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.models import lotka_volterra as lv
from universal_differential_equations_torch.nn.layers import MLP, Chain, Dense
from universal_differential_equations_torch.ops import lv_lanes
from universal_differential_equations_torch.solvers import Tsit5
from universal_differential_equations_tpu.core.integrate import integrate_fixed as j_integrate_fixed
from universal_differential_equations_tpu.models import lotka_volterra as jlv

LOSS_GAP, GRAD_GAP = 1e-5, 8e-6  # the benchmark's limits (perfbench/checks/lv_study.adam.json)
# float32 against float32, each lane on its own: the loss relative to the
# lane's, each gradient element relative to the norm of the lane's gradient
# (this twin against JAX at these lanes: 4.1e-6 and 1.9e-6)
LANE_LOSS_TOL, LANE_GRAD_TOL = 2e-5, 1e-5
ALPHA, DELTA = float(lv.P_TRUE[0]), float(lv.P_TRUE[3])
CARD_REF = Path(__file__).resolve().parent / "data" / "lv_lanes_jax.npz"
CARD_LANES = np.linspace(0, 499, 25).astype(int)


@pytest.fixture(scope="module")
def study():
    return rl.build_stages(device="cpu")


def _lanes(study, n):
    """``n`` of the study's lanes, spread over the noise levels."""
    return study.lane_inputs(np.linspace(0, 499, n).astype(int), 100)[:2]


def _per_lane_gaps(prog, ref):
    """The worst lane's loss gap relative to its loss, and the worst gradient
    element's gap relative to its lane's gradient norm."""
    (lp, gp), (lr, gr) = ((np.asarray(x, np.float64) for x in pair) for pair in (prog, ref))
    return (float((np.abs(lp - lr) / np.abs(lr)).max()),
            float((np.abs(gp - gr).max(1) / np.linalg.norm(gr, axis=1)).max()))


def jax_value_and_grad(theta, data, t_end, dtype):
    """Each lane's loss and gradient by the JAX package: ``jax.vmap`` of
    ``jax.value_and_grad`` of the JAX study's lane loss (fixed-step Tsit5 by
    ``integrate_fixed``, the ``make_ude`` RHS) in ``dtype``; numpy arrays."""
    rhs, params0, _ = jlv.make_ude(jax.random.PRNGKey(7), dtype=dtype)
    unravel = jax.flatten_util.ravel_pytree(params0)[1]
    n_step = (data.shape[1] - 1) * rl.SUB

    def mean_loss(th, d):
        _, ys = j_integrate_fixed(rhs, d[0], 0.0, t_end, unravel(th), jude.Tsit5(), n_step)
        return jnp.mean((ys[::rl.SUB] - d) ** 2)

    out = jax.jit(jax.vmap(jax.value_and_grad(mean_loss)))(
        jnp.asarray(np.asarray(theta), dtype), jnp.asarray(np.asarray(data), dtype))
    return tuple(np.asarray(x) for x in out)


def _wrapper(study):
    _, _, net = lv.make_ude(torch.Generator().manual_seed(7))
    return lv_lanes.LaneLossGrad(net, ALPHA, DELTA, 0.0, float(study.ts[-1]), rl.SUB)


def _twin(study):
    """The twin as the study's ``loss_and_grad`` is called: float32 lanes."""
    coef = lv_lanes.tsit5_coefficients(0.0, float(study.ts[-1]), 30 * rl.SUB)
    return lambda theta, data: lv_lanes.lanes_torch(theta, data, ALPHA, DELTA, rl.SUB, coef)


def _loss_gap(prog, ref):
    """The benchmark's ``loss_gap``: the losses summed over lanes, relative."""
    p, r = float(prog.double().sum()), float(ref.double().sum())
    return abs(p - r) / abs(r)


def _grad_gap(prog, ref):
    """The benchmark's ``grad_gap``: per leaf (all lanes) ``|‖p‖ − ‖r‖|`` over
    the larger of ``‖r‖`` and the median leaf's, the worst leaf."""
    n_p, n_r = ([t.norm().item() for w, b in lv_lanes._layers(x) for t in (b, w)]
                for x in (prog, ref))
    med = statistics.median(n_r)
    return max(abs(p - r) / max(r, med) for p, r in zip(n_p, n_r))


def _autograd_f64(theta, data, t_end):
    """Each lane's loss and gradient by autograd through ``torch.func.vmap``
    of ``integrate_fixed`` with the ``make_ude`` RHS, in float64."""
    rhs, params0, _ = lv.make_ude(torch.Generator().manual_seed(7), dtype=torch.float64)
    _, unravel = ravel_pytree(params0)
    t0, t1 = torch.zeros((), dtype=torch.float64), torch.tensor(t_end, dtype=torch.float64)
    n_step = (data.shape[1] - 1) * rl.SUB

    def resid(th, d):
        _, ys = integrate_fixed(rhs, d[0], t0, t1, unravel(th), Tsit5(), n_step)
        return (ys[::rl.SUB] - d).reshape(-1)

    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        r = torch.func.vmap(resid)(th, data)
        loss = (r * r).mean(-1)
        (g,) = torch.autograd.grad(loss.sum(), th)
    return loss.detach(), g


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_twin_is_jax_value_and_grad(study, dtype):
    """Float64: to 1e-10 on every lane and element.  Float32: each lane
    within ``LANE_*_TOL`` and the benchmark's gaps within its limits."""
    data, theta = _lanes(study, 25)
    t_end = float(study.ts[-1])
    tdt = getattr(torch, dtype)
    coef = lv_lanes.tsit5_coefficients(0.0, t_end, 30 * rl.SUB, tdt)
    prog = lv_lanes.lanes_torch(theta.to(tdt), data.to(tdt), ALPHA, DELTA, rl.SUB, coef)
    ref = jax_value_and_grad(theta, data, t_end, getattr(jnp, dtype))
    loss_gap, grad_gap = _per_lane_gaps(prog, ref)
    if dtype == "float64":
        assert loss_gap <= 1e-10 and grad_gap <= 1e-10, (loss_gap, grad_gap)
    else:
        assert loss_gap <= LANE_LOSS_TOL and grad_gap <= LANE_GRAD_TOL, (loss_gap, grad_gap)
        ref = tuple(torch.tensor(x) for x in ref)
        assert _loss_gap(prog[0], ref[0]) <= LOSS_GAP
        assert _grad_gap(prog[1], ref[1]) <= GRAD_GAP


def test_card_reference_is_jax(study):
    """``tests/data/lv_lanes_jax.npz``, which the card test holds the kernel
    to, is JAX's float64 loss and gradient of those lanes."""
    with np.load(CARD_REF) as z:
        lanes, loss, grad = z["lanes"], z["loss"], z["grad"]
    np.testing.assert_array_equal(lanes, CARD_LANES)
    data, theta, _ = study.lane_inputs(lanes, 100)
    ref_loss, ref_grad = jax_value_and_grad(theta, data, float(study.ts[-1]), jnp.float64)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-12, atol=0)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n", [1, 7, 25])
def test_twin_is_autograd_through_the_solve_in_float64(study, n):
    data, theta = (x.double() for x in _lanes(study, n))
    t_end = float(study.ts[-1])
    coef = lv_lanes.tsit5_coefficients(0.0, t_end, (data.shape[1] - 1) * rl.SUB, torch.float64)
    loss, grad = lv_lanes.lanes_torch(theta, data, ALPHA, DELTA, rl.SUB, coef)
    loss_a, grad_a = _autograd_f64(theta, data, t_end)
    assert ((loss - loss_a).abs() / loss_a.abs()).max() <= 1e-10
    assert ((grad - grad_a).norm(dim=1) / grad_a.norm(dim=1)).max() <= 1e-10


@pytest.mark.parametrize("n", [1, 7, 25])
def test_twin_matches_the_study_loss_and_grad_in_float32(study, n):
    data, theta = _lanes(study, n)
    loss, grad = _twin(study)(theta, data)
    loss_p, grad_p = study.loss_and_grad(theta, data)
    assert loss.dtype == grad.dtype == torch.float32
    assert grad.shape == theta.shape and loss.shape == (n,)
    assert _loss_gap(loss, loss_p) <= LOSS_GAP
    assert _grad_gap(grad, grad_p) <= GRAD_GAP
    loss_gap, grad_gap = _per_lane_gaps((loss, grad), (loss_p, grad_p))
    assert loss_gap <= LANE_LOSS_TOL and grad_gap <= LANE_GRAD_TOL, (loss_gap, grad_gap)


@pytest.mark.parametrize("case", ["nan_lane", "subset"])
def test_each_lane_is_its_own(study, case):
    """A NaN lane stays NaN and leaves the others as they are; a lane's
    result does not depend on which lanes are beside it."""
    data, theta = _lanes(study, 25)
    fg = _twin(study)
    loss, grad = fg(theta, data)
    if case == "nan_lane":
        data = data.clone()
        data[3, 5, 0] = float("nan")
        loss_n, grad_n = fg(theta, data)
        assert torch.isnan(loss_n[3]) and torch.isnan(grad_n[3]).any()
        keep = torch.arange(25) != 3
        assert torch.equal(loss_n[keep], loss[keep]) and torch.equal(grad_n[keep], grad[keep])
    else:
        pick = torch.tensor([0, 4, 11, 24])
        loss_s, grad_s = fg(theta[pick].contiguous(), data[pick].contiguous())
        torch.testing.assert_close(loss_s, loss[pick], rtol=1e-6, atol=0)
        torch.testing.assert_close(grad_s, grad[pick], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["widths", "depth", "activation", "no_bias", "theta_width",
                                 "float64", "lanes", "not_contiguous", "cpu"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(study, bad):
    """The shape, dtype and layout checks come before the device's, so each
    raises on CPU tensors as it would on the card; sound CPU tensors raise
    too: the kernel runs on CUDA only and nothing falls back."""
    data, theta = _lanes(study, 7)
    t_end = float(study.ts[-1])
    nets = {"widths": MLP([2, 6, 5, 5, 2]), "depth": MLP([2, 5, 5, 2]),
            "activation": MLP([2, 5, 5, 5, 2], activation="tanh"),
            "no_bias": Chain(tuple(Dense(i, o, a, use_bias=False) for i, o, a in
                                   [(2, 5, "rbf"), (5, 5, "rbf"), (5, 5, "rbf"),
                                    (5, 2, "identity")]))}
    if bad in nets:
        with pytest.raises(ValueError):
            lv_lanes.LaneLossGrad(nets[bad], ALPHA, DELTA, 0.0, t_end, rl.SUB)
        return
    fg = _wrapper(study)
    args = {"theta_width": (theta[:, :86].contiguous(), data),
            "float64": (theta.double(), data.double()),
            "lanes": (theta, data[:6].contiguous()),
            "not_contiguous": (theta.t().contiguous().t(), data),
            "cpu": (theta, data)}[bad]
    before = lv_lanes.launches
    with pytest.raises(TypeError if bad == "float64" else ValueError):
        fg(*args)
    assert lv_lanes.launches == before


def test_the_cpu_path_of_build_stages_is_the_plain_one(study):
    """On the CPU ``loss_and_grad`` is autograd through ``mean_loss``, as it
    was; only a CUDA device takes the kernel."""
    assert not isinstance(study.loss_and_grad, lv_lanes.LaneLossGrad)
    assert "mean_loss" in study.loss_and_grad.__code__.co_freevars


if __name__ == "__main__":
    # rewrite the card test's JAX reference (CARD_REF) on the CPU
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    st = rl.build_stages(device="cpu")
    d, th, _ = st.lane_inputs(CARD_LANES, 100)
    loss_ref, grad_ref = jax_value_and_grad(th, d, float(st.ts[-1]), jnp.float64)
    CARD_REF.parent.mkdir(exist_ok=True)
    np.savez_compressed(CARD_REF, lanes=CARD_LANES, loss=loss_ref, grad=grad_ref)
    print(f"wrote {CARD_REF}: {len(CARD_LANES)} lanes")
