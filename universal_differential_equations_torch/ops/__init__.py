from .stencil import FusedUpdetRHS, fused_updet_rhs, make_pointwise_mlp_params, updet_rhs_torch

__all__ = ["FusedUpdetRHS", "fused_updet_rhs", "make_pointwise_mlp_params", "updet_rhs_torch"]
