"""Discrete Laplacian operators as stencils of tensors."""

from .stencil import ScalarStencil5, north_neighbor
from .laplacians import build_operator, build_scalar_stencil

__all__ = [
    "ScalarStencil5",
    "north_neighbor",
    "build_operator",
    "build_scalar_stencil",
]
