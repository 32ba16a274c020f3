"""The plain references agree with the port on the CPU at tiny sizes: 4 LV
lanes (loss, gradient, one ADAM step; the driver's three steps followed)
and 8 deep-BSDE paths (loss and gradient; the trainer's three iterations
followed)."""
import json
from pathlib import Path

import torch

from perfbench import compare
from perfbench.drivers import bsde_adam, lv_stage
from perfbench.reference import adam as ref_adam
from perfbench.reference import bsde as ref_bsde
from perfbench.reference import lv as ref_lv
from perfbench.trace import Tracer

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LV = json.loads((CONFIGS / "lv_ude_s1.json").read_text())
HJB = json.loads((CONFIGS / "hjb100d_deepbsde.json").read_text())
CPU = torch.device("cpu")
TIGHT = 2e-5  # float32 on both sides, different order of operations


def lv_lanes(seed=11, runs_per_level=1):
    traffic = {"stage": "adam_stage", "lr": 0.1}
    return lv_stage.lane_inputs(dict(LV, runs_per_level=runs_per_level), traffic, seed, CPU)


def test_lane_layout_is_the_ports_flat_vector():
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import lotka_volterra as lv

    _, params, _ = lv.make_ude(torch.Generator().manual_seed(0))
    flat, _ = ravel_pytree(params)
    assert flat.numel() == ref_lv.n_params(LV["nn_widths"]) == LV["nn_params"]
    leaves = ref_lv.leaves(flat[None], LV["nn_widths"])
    for k, layer in enumerate(params):
        for name in ("w", "b"):
            assert torch.equal(leaves[f"{k}.{name}"][0], layer[name].reshape(-1))


def test_truth_matches_the_ports_generator():
    from universal_differential_equations_torch.models import lotka_volterra as lv

    _, X, _ = lv.generate_data(noise=torch.Generator().manual_seed(0))
    assert torch.allclose(torch.as_tensor(ref_lv.truth(LV)), X, rtol=1e-9, atol=1e-9)


def test_lv_loss_gradient_and_adam_step_on_4_lanes():
    from universal_differential_equations_torch.examples import run_loops

    ns = run_loops.build_stages(device="cpu", lanes="torch")
    data, theta0 = lv_lanes()
    data, theta0 = data[:4], theta0[:4]
    loss_p, g_p = ns.loss_and_grad(theta0, data)
    loss_r, g_r = ref_lv.loss_and_grad(theta0, data, LV)
    assert torch.allclose(loss_p, loss_r, rtol=TIGHT, atol=0)
    assert (g_p - g_r).abs().max() <= TIGHT * g_r.abs().max()
    theta_p, _ = ns.adam_stage(theta0, data, steps=1, lr=0.1)

    def fg(t):
        loss, g = ref_lv.loss_and_grad(t["x"], data, LV)
        return float(loss.sum()), {"x": g}

    _, _, points = ref_adam.run(fg, {"x": theta0}, 1, 0.1)
    assert (theta_p - points[-1]["x"]).abs().max() <= 1e-6


def test_lv_driver_records_agree_with_the_reference():
    drv = lv_stage.Driver(dict(LV, runs_per_level=1), {"stage": "adam_stage", "lr": 0.1},
                          3, CPU, Tracer(False))
    drv.setup()
    drv.collect()
    readings = drv.readings()
    assert set(readings) >= {"loss_gap", "grad_gap", "change_gap"}
    for k, v in readings.items():
        assert v <= TIGHT, k


def test_bsde_loss_and_gradient_on_8_paths():
    drv = bsde_adam.Driver(HJB, {"trajectories": 8}, 5, CPU, Tracer(False))
    drv.setup()
    ref = drv.reference()
    assert len(ref["change"]) == len(drv.first["change"]) == bsde_adam.STEPS
    for k, v in compare.training_readings(drv.first, ref).items():
        assert v <= TIGHT, k
    # the reference's loss by itself, from the draws and the weights
    loss, grads = ref_bsde.loss_and_grad(ref_bsde.leaves(drv.params0), drv.normals(0, 0), HJB,
                                         block=3)
    assert abs(float(loss) - drv.first["loss"][0]) <= TIGHT * abs(float(loss))
    assert set(grads) == set(drv.first["change"][0]) == set(ref["grad"])
