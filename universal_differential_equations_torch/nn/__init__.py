from .layers import MLP, Chain, Dense, FourierBasis, StencilConv1D, TensorLayer, rbf

__all__ = ["Chain", "Dense", "MLP", "FourierBasis", "StencilConv1D", "TensorLayer", "rbf"]
