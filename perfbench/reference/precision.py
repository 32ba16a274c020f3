"""The reference's products, in float32 or, for the control, in TF32.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits.  The control
rounds both operands of every product to TF32 (to nearest, ties to even)
and accumulates in float32, as the tensor cores do; it does so itself
rather than through ``torch.backends.cuda.matmul.allow_tf32``, because
cuBLAS keeps its float32 path for small batched products (the lanes' 5-wide
layers) even where TF32 is allowed.
"""
from __future__ import annotations

import torch


def round_tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value; the gradient passes
    through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def product(a, b, tf32=False):
    """``a @ b`` with TF32 matmuls off, or with both operands in TF32."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
