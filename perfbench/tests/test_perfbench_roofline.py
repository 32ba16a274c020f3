"""The benchmark's operation and byte counts against counts made by hand."""
import json
from pathlib import Path

from perfbench import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LV = json.loads((CONFIGS / "lv_ude_s1.json").read_text())
HJB = json.loads((CONFIGS / "hjb100d_deepbsde.json").read_text())


def test_grad_net_forward_is_46310_macs_per_path_step():
    # 101·110 + 110·110 + 110·110 + 110·100
    assert roofline.mlp_macs(HJB["grad_net_widths"]) == 11110 + 12100 + 12100 + 11000 == 46310


def test_grad_net_forward_and_backward_per_path_step():
    # forward 46310, weight gradients 46310, input gradients of layers 2-4 only
    # (the paths' states carry no gradient): 12100 + 12100 + 11000
    macs = 46310 + 46310 + 35200
    assert roofline.bsde_flop_per_path_step(HJB) == 2 * macs == 255640


def test_bsde_gemm_per_iteration():
    m = 131072
    flop, byts = roofline.bsde_gemm_per_iter(HJB, m)
    assert flop == 255640 * 50 * m
    # bytes of layer 1 (no input gradient): forward X, W, Y; dW reads dY, X, writes W
    l1 = (m * 101 + 101 * 110 + m * 110) + (m * 110 + m * 101 + 101 * 110)
    # a later layer (in, out) adds dX: reads dY and W, writes dX
    later = [(110, 110), (110, 110), (110, 100)]
    rest = sum(3 * (m * i + i * o + m * o) for i, o in later)
    assert byts == 4 * 50 * (l1 + rest)


def test_lv_net_flop_per_lane_step():
    # 2→5→5→5→2: 10 + 25 + 25 + 10 = 70 MACs per evaluation, forward;
    # forward + weight + input gradients = 3 × 70; 6 fresh stages per step
    assert roofline.mlp_macs(LV["nn_widths"]) == 70
    assert roofline.lv_flop_per_lane_step(LV) == 2 * 3 * 70 * 6 == 2520


def test_lv_flop_per_iteration():
    # 120 steps of 6 fresh evaluations plus the first point (721), over 500 lanes
    assert roofline.lv_flop_per_iter(LV, 500) == 2 * 3 * 70 * 721 * 500


def test_roofline_share_takes_the_larger_bound():
    share, by = roofline.roofline_share(67e12, 0, 2.0)
    assert (share, by) == (50.0, "operations")
    share, by = roofline.roofline_share(0, 3.35e12, 4.0)
    assert (share, by) == (25.0, "bytes")
