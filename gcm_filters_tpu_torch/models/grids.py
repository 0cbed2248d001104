"""Grid-type registry: names, required grid variables, and classification.

PyTorch-port counterpart of ``gcm_filters_tpu/models/grids.py``, kept as a
copy so that the port never imports the JAX package. The names, the order of
the grid variables and the per-grid flags must stay equal to the JAX
package's; ``tests/test_torch_host_math.py`` holds the two together.
"""
from __future__ import annotations

import enum
from typing import Dict, List


class GridType(enum.Enum):
    """Supported grid discretizations."""

    REGULAR = enum.auto()
    REGULAR_AREA_WEIGHTED = enum.auto()
    REGULAR_WITH_LAND = enum.auto()
    REGULAR_WITH_LAND_AREA_WEIGHTED = enum.auto()
    IRREGULAR_WITH_LAND = enum.auto()
    MOM5U = enum.auto()
    MOM5T = enum.auto()
    TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED = enum.auto()
    TRIPOLAR_POP_WITH_LAND = enum.auto()
    VECTOR_C_GRID = enum.auto()
    VECTOR_B_GRID = enum.auto()


# Required grid variables per grid type, in the (significant!) order of the
# positional-argument protocol.
GRID_VAR_NAMES: Dict[GridType, List[str]] = {
    GridType.REGULAR: [],
    GridType.REGULAR_AREA_WEIGHTED: ["area"],
    GridType.REGULAR_WITH_LAND: ["wet_mask"],
    GridType.REGULAR_WITH_LAND_AREA_WEIGHTED: ["area", "wet_mask"],
    GridType.IRREGULAR_WITH_LAND: [
        "wet_mask",
        "dxw",
        "dyw",
        "dxs",
        "dys",
        "area",
        "kappa_w",
        "kappa_s",
    ],
    GridType.MOM5U: ["wet_mask", "dxt", "dyt", "dxu", "dyu", "area_u"],
    GridType.MOM5T: ["wet_mask", "dxt", "dyt", "dxu", "dyu", "area_t"],
    GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED: ["area", "wet_mask"],
    GridType.TRIPOLAR_POP_WITH_LAND: ["wet_mask", "dxe", "dye", "dxn", "dyn", "tarea"],
    GridType.VECTOR_C_GRID: [
        "wet_mask_t",
        "wet_mask_q",
        "dxT",
        "dyT",
        "dxCu",
        "dyCu",
        "dxCv",
        "dyCv",
        "dxBu",
        "dyBu",
        "area_u",
        "area_v",
        "kappa_iso",
        "kappa_aniso",
    ],
    GridType.VECTOR_B_GRID: [
        "DXU",
        "DYU",
        "HUS",
        "HUW",
        "HTE",
        "HTN",
        "UAREA",
        "TAREA",
    ],
}

# Vector (two-component, viscosity-style) Laplacians.
_VECTOR_GRIDS = frozenset({GridType.VECTOR_C_GRID, GridType.VECTOR_B_GRID})

# Dimensional Laplacians carry physical units and are nondimensionalized by
# 2/s_max in the Chebyshev recurrence; nondimensional ones additionally divide
# by dx_min^2.
_DIMENSIONAL_GRIDS = frozenset(
    {
        GridType.IRREGULAR_WITH_LAND,
        GridType.MOM5U,
        GridType.MOM5T,
        GridType.TRIPOLAR_POP_WITH_LAND,
        GridType.VECTOR_C_GRID,
        GridType.VECTOR_B_GRID,
    }
)

# "Simple fixed factor" grids: the field is area-weighted before filtering on
# a unit-spacing Cartesian grid and de-weighted after; requires dx_min == 1.
_AREA_WEIGHTED_GRIDS = frozenset(
    {
        GridType.REGULAR_AREA_WEIGHTED,
        GridType.REGULAR_WITH_LAND_AREA_WEIGHTED,
        GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
    }
)

# Grids whose north boundary is a tripolar fold seam rather than periodic wrap.
TRIPOLAR_GRIDS = frozenset(
    {
        GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
        GridType.TRIPOLAR_POP_WITH_LAND,
    }
)


def required_grid_vars(grid_type: GridType) -> List[str]:
    """Names of the grid variables needed by ``grid_type``."""
    return list(GRID_VAR_NAMES[grid_type])


def is_vector_grid(grid_type: GridType) -> bool:
    return grid_type in _VECTOR_GRIDS


def is_dimensional(grid_type: GridType) -> bool:
    return grid_type in _DIMENSIONAL_GRIDS


def is_area_weighted(grid_type: GridType) -> bool:
    return grid_type in _AREA_WEIGHTED_GRIDS
