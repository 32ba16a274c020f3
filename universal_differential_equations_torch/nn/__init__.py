from .layers import MLP, Chain, Dense, FourierBasis, TensorLayer, rbf

__all__ = ["Chain", "Dense", "MLP", "FourierBasis", "TensorLayer", "rbf"]
