from .layers import (MLP, Chain, Dense, FourierBasis, StencilConv1D, TensorLayer, gaussian_rbf,
                     rbf)

__all__ = ["Chain", "Dense", "MLP", "FourierBasis", "StencilConv1D", "TensorLayer", "rbf",
           "gaussian_rbf"]
