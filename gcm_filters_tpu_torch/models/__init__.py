"""Grid models: the supported grid discretizations and their metadata."""

from .grids import (
    GridType,
    GRID_VAR_NAMES,
    required_grid_vars,
    is_vector_grid,
    is_dimensional,
    is_area_weighted,
)

__all__ = [
    "GridType",
    "GRID_VAR_NAMES",
    "required_grid_vars",
    "is_vector_grid",
    "is_dimensional",
    "is_area_weighted",
]
