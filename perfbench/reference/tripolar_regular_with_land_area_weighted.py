"""GCM-Filters' TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED Laplacian, plainly.

Fixed-factor filtering on the unit-spacing grid: the field is multiplied by
``area`` before the filter and divided by it after. The Laplacian is the
masked 5-point one with no flux through land: NaNs read as 0, land cells
give and take nothing, and a wet cell's centre weight is its number of wet
neighbours, the top row's neighbours across the tripolar fold included.
"""
from __future__ import annotations

import torch

from .common import Operator, east, north, south, west


def operator(grid_vars: dict, dtype: torch.dtype) -> Operator:
    wet64 = grid_vars["wet_mask"].double()
    if bool(wet64[0].any()):
        raise ValueError("the southernmost row must be land")
    n_wet = (north(wet64, fold=True) + south(wet64) + east(wet64) + west(wet64)).to(dtype)
    wet = wet64.to(dtype)
    area = grid_vars["area"].double().to(dtype)

    def laplacian(f):
        g = wet * torch.nan_to_num(f)
        return (wet * (north(g, fold=True) + south(g) + east(g) + west(g) - n_wet * g),)

    return Operator(laplacian=laplacian, dimensional=False,
                    prepare=lambda f: (f * area,), finalize=lambda f: (f / area,))
