"""Discrete Laplacian operators as stencils of tensors."""

from .stencil import BGridVectorStencil, CGridVectorOperator, ScalarStencil5, north_neighbor
from .laplacians import build_operator, build_scalar_stencil, build_vector_operator

__all__ = [
    "BGridVectorStencil",
    "CGridVectorOperator",
    "ScalarStencil5",
    "north_neighbor",
    "build_operator",
    "build_scalar_stencil",
    "build_vector_operator",
]
