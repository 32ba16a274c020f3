"""Neural layers for embedding in differential-equation right-hand sides.

Port of ``universal_differential_equations_tpu/nn/layers.py``.  Layers are
static configuration objects; parameters are plain dicts and lists of tensors
created by ``init(generator, dtype, device)`` and passed explicitly to
``apply``.  That keeps one flat parameter vector (``flatten_util``) that
``torch.func.jacfwd`` can differentiate, and keeps the JAX package's names
and layouts (``Dense`` stores ``w`` as (out, in)), so ``convert.params_from_jax``
maps parameters one to one.

Initial weights are drawn on the CPU from an explicit ``torch.Generator`` and
then moved to ``device``, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["rbf", "Dense", "Chain", "MLP", "FourierBasis", "TensorLayer"]


def rbf(x):
    """Gaussian radial basis activation ``exp(-x^2)`` (``scenario_1.jl:59``)."""
    return torch.exp(-(x * x))


_ACTIVATIONS = {
    "rbf": rbf,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "swish": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


def _resolve(act):
    if callable(act):
        return act
    return _ACTIVATIONS[act]


def _place(x, dtype, device):
    return x.to(dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine layer ``W x + b`` with optional activation; Glorot-uniform init."""

    in_size: int
    out_size: int
    activation: object = "identity"
    use_bias: bool = True

    def init(self, generator, dtype=torch.float32, device=None):
        lim = math.sqrt(6.0 / (self.in_size + self.out_size))
        u = torch.rand((self.out_size, self.in_size), generator=generator,
                       dtype=torch.float64)
        params = {"w": _place((2.0 * u - 1.0) * lim, dtype, device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.out_size,), dtype=dtype, device=device)
        return params

    def apply(self, params, x):
        y = params["w"] @ x if x.ndim == 1 else x @ params["w"].T
        if self.use_bias:
            y = y + params["b"]
        return _resolve(self.activation)(y)


@dataclasses.dataclass(frozen=True)
class Chain:
    """Sequential composition of layers (``Lux.Chain``)."""

    layers: Tuple

    def init(self, generator, dtype=torch.float32, device=None):
        return [layer.init(generator, dtype, device) for layer in self.layers]

    def apply(self, params, x):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def __call__(self, params, x):
        return self.apply(params, x)

    def as_matmul_params(self, params):
        """Dense-chain params as a ``[(w, b), ...]`` list of (h_in, h_out)
        matmul weights — the layout the fused RHS kernel takes
        (:func:`..ops.stencil.fused_updet_rhs`, which hard-codes the tanh
        hidden activation this chain must be using)."""
        out = []
        for layer, p in zip(self.layers, params):
            if not isinstance(layer, Dense):
                raise TypeError("the matmul view needs a chain of Dense layers")
            b = p.get("b")
            if b is None:
                b = torch.zeros((layer.out_size,), dtype=p["w"].dtype,
                                device=p["w"].device)
            out.append((p["w"].T, b))
        return out


def MLP(sizes: Sequence[int], activation="rbf", final_activation="identity"):
    """Multi-layer perceptron, e.g. ``MLP([1, 10, 20, 10, 1], "tanh")`` is the
    Fisher-KPP paper's reaction net (``Fisher-KPP-CNN.jl:92-96``)."""
    layers = []
    for i in range(len(sizes) - 1):
        act = activation if i < len(sizes) - 2 else final_activation
        layers.append(Dense(sizes[i], sizes[i + 1], act))
    return Chain(tuple(layers))


@dataclasses.dataclass(frozen=True)
class FourierBasis:
    """Fourier feature basis (``DiffEqFlux.FourierBasis``).

    ``n`` basis functions: sin(k·x) for k=1..⌈n/2⌉ and cos(k·x) for the rest
    (``Fisher-KPP-CNN-Fourier.jl:89-92``); with ``include_constant=True`` the
    first function is 1.
    """

    n: int
    include_constant: bool = False

    def __call__(self, x):
        n_trig = self.n - int(self.include_constant)
        ks = torch.arange(1, n_trig // 2 + n_trig % 2 + 1, dtype=x.dtype, device=x.device)
        sins = torch.sin(ks * x[..., None])
        kc = torch.arange(1, n_trig // 2 + 1, dtype=x.dtype, device=x.device)
        coss = torch.cos(kc * x[..., None])
        parts = [sins, coss]
        if self.include_constant:
            parts.insert(0, torch.ones_like(x[..., None]))
        return torch.cat(parts, dim=-1)


@dataclasses.dataclass(frozen=True)
class TensorLayer:
    """Linear combination of a tensor product of basis functions
    (``TensorLayer([FourierBasis(n)], 1)``, ``Fisher-KPP-CNN-Fourier.jl:91-92``)."""

    bases: Tuple
    out_size: int = 1

    @property
    def num_features(self):
        n = 1
        for b in self.bases:
            n *= b.n
        return n

    def init(self, generator, dtype=torch.float32, device=None):
        w = torch.randn((self.out_size, self.num_features), generator=generator,
                        dtype=torch.float64) * 0.1
        return {"w": _place(w, dtype, device)}

    def apply(self, params, x):
        # x: (len(bases),) scalar inputs per basis; tensor-product features
        feats = None
        for i, b in enumerate(self.bases):
            fi = b(x[i]) if x.ndim else b(x)
            feats = fi if feats is None else torch.outer(feats, fi).reshape(-1)
        return params["w"] @ feats

    def __call__(self, params, x):
        return self.apply(params, x)
