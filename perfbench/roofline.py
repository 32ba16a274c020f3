"""Peaks of the card and the work of one training iteration, from shapes.

Frozen with the benchmark: the program may change, the yardstick may not.
Every count is a function of a configuration's published shapes and of the
cell's batch, never of what the program reports.

Operations count multiply-adds (MACs) of the dense products, two FLOP each;
elementwise work (activations, stage sums) is left out of every count, so a
share against the peak is a share of the products' work.  Bytes count each
input of a product read once and its output written once, in float32.
"""
from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense rates): float32 outside the tensor
# cores (the port pins TF32 off) and HBM3 bandwidth.  They assume the full
# 700 W power limit; the harness records the card's limit beside each share.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32_BYTES = 4


def dense_layers(widths):
    """``[(in, out), ...]`` of a chain of dense layers ``widths[0] → … → widths[-1]``."""
    return list(zip(widths[:-1], widths[1:]))


def mlp_macs(widths):
    """Multiply-adds of one forward pass of one row through the chain."""
    return sum(i * o for i, o in dense_layers(widths))


def mlp_train_macs(widths, input_grad=True):
    """Multiply-adds of one row's forward and backward pass: the forward
    product, the weight gradient, and the input gradient of every layer (of
    every layer but the first where the chain's input needs no gradient)."""
    layers = dense_layers(widths)
    fwd = sum(i * o for i, o in layers)
    dx = sum(i * o for k, (i, o) in enumerate(layers) if input_grad or k > 0)
    return fwd + fwd + dx


def mlp_train_gemm(widths, rows, input_grad=True):
    """``(flop, bytes)`` of the dense products of one forward and backward
    pass over ``rows`` rows, each product counted as one (rows × in) by
    (in × out) product: forward ``Y = X Wᵀ``, ``dW = dYᵀ X``, ``dX = dY W``."""
    flop = byts = 0
    for k, (i, o) in enumerate(dense_layers(widths)):
        flop += 2 * 2 * rows * i * o
        byts += (rows * i + i * o + rows * o) + (rows * o + rows * i + i * o)
        if input_grad or k > 0:
            flop += 2 * rows * i * o
            byts += rows * o + i * o + rows * i
    return flop, byts * F32_BYTES


def lv_flop_per_lane_step(cfg):
    """FLOP of the net's products per lane and solver step, forward and
    backward (the state carries a gradient, so every layer's input does)."""
    per_eval = 2 * mlp_train_macs(cfg["nn_widths"], input_grad=True)
    return per_eval * (cfg["tsit5_stages"] - 1)


def lv_flop_per_iter(cfg, lanes):
    """FLOP of the products of one loss-and-gradient evaluation over every
    lane (the only evaluation of an ADAM step): the solve's steps and its
    first point."""
    n_steps = (cfg["samples"] - 1) * cfg["substeps"]
    first = 2 * mlp_train_macs(cfg["nn_widths"], input_grad=True)
    return (lv_flop_per_lane_step(cfg) * n_steps + first) * lanes


def bsde_flop_per_path_step(cfg):
    """FLOP of the grad net's products per path and time step, forward and
    backward.  The paths' states carry no gradient (the drift is zero and
    the diffusion constant), so the first layer needs no input gradient."""
    return 2 * mlp_train_macs(cfg["grad_net_widths"], input_grad=False)


def bsde_gemm_per_iter(cfg, trajectories):
    """``(flop, bytes)`` of the grad net's products in one deep-BSDE
    iteration: ``n_steps`` products per layer over the (m, ·) batch, forward
    and backward."""
    flop, byts = mlp_train_gemm(cfg["grad_net_widths"], trajectories, input_grad=False)
    return flop * cfg["n_steps"], byts * cfg["n_steps"]


def bsde_flop_per_iter(cfg, trajectories):
    """FLOP of every product of one iteration: the grad net over the batch
    and the u0 net on the one starting point."""
    gemm, _ = bsde_gemm_per_iter(cfg, trajectories)
    return gemm + 2 * mlp_train_macs(cfg["u0_net_widths"], input_grad=False)


def roofline_share(flop, byts, seconds):
    """Percent of the card's bound that ``flop`` and ``byts`` done in
    ``seconds`` reach, and which bound it is."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, byts / PEAK_HBM_BYTES
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return 100.0 * bound / seconds, by
