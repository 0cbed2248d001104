"""GCM-Filters' VECTOR_B_GRID Laplacian (POP's B-grid friction), plainly.

POP's del2 on the velocity points from its eight metric arrays: the 5-point
diffusion coefficients DUN, DUS, DUE, DUW from the face lengths over UAREA,
the metric terms KXU, KYU and DXKX, DYKX, DXKY, DYKY, and the u-v mixing
coefficients DMC, DMN, DME (DMS = -DMN, DMW = -DME). Both components see the
same diffusion stencil, and each takes the mixing stencil of the other.
Doubly periodic, no land mask; NaNs read as 0. The coefficients are worked
out in float64 and then cast to the filter's dtype.
"""
from __future__ import annotations

import torch

from .common import Operator, east, north, south, west


def _roll(a, shift, dim):
    return torch.roll(a, shift, dims=dim)


def operator(grid_vars: dict, dtype: torch.dtype) -> Operator:
    g = {k: v.double() for k, v in grid_vars.items()}
    DXU, DYU, HUS, HUW = g["DXU"], g["DYU"], g["HUS"], g["HUW"]
    HTE, HTN, UAREA, TAREA = g["HTE"], g["HTN"], g["UAREA"], g["TAREA"]
    uarea_r, tarea_r = 1.0 / UAREA, 1.0 / TAREA
    dxur, dyur = 1.0 / DXU, 1.0 / DYU

    work = HUS / HTE
    dus = work * uarea_r
    dun = _roll(work, 1, -1) * uarea_r
    work = HUW / HTN
    duw = work * uarea_r
    due = _roll(work, 1, -2) * uarea_r

    kxu = (_roll(HUW, 1, -2) - HUW) * uarea_r
    kyu = (_roll(HUS, 1, -1) - HUS) * uarea_r
    kxt = (HTE - _roll(HTE, -1, -2)) * tarea_r
    kyt = (HTN - _roll(HTN, -1, -1)) * tarea_r
    mid = 0.5 * (kxt + _roll(kxt, 1, -1))
    dxkx = (_roll(mid, 1, -2) - mid) * dxur
    mid = 0.5 * (kxt + _roll(kxt, 1, -2))
    dykx = (_roll(mid, 1, -1) - mid) * dyur
    mid = 0.5 * (kyt + _roll(kyt, 1, -2))
    dyky = (_roll(mid, 1, -1) - mid) * dyur
    mid = 0.5 * (kyt + _roll(kyt, 1, -1))
    dxky = (_roll(mid, 1, -2) - mid) * dxur

    dum = -(dxkx + dyky + 2.0 * (kxu * kxu + kyu * kyu))
    dmc = dxky - dykx
    dme = 2.0 * kyu / (HTN + _roll(HTN, 1, -2))
    dmn = -2.0 * kxu / (HTE + _roll(HTE, 1, -1))
    cc = -(dun + dus + due + duw) + dum
    cc, dun, dus, due, duw, dmc, dmn, dme = (
        a.to(dtype) for a in (cc, dun, dus, due, duw, dmc, dmn, dme))

    def diffusion(f):
        return cc * f + dun * north(f) + dus * south(f) + due * east(f) + duw * west(f)

    def mixing(f):
        return dmc * f + dmn * (north(f) - south(f)) + dme * (east(f) - west(f))

    def laplacian(u, v):
        u, v = torch.nan_to_num(u), torch.nan_to_num(v)
        return diffusion(u) + mixing(v), diffusion(v) + mixing(u)

    return Operator(laplacian=laplacian, dimensional=True)
