"""GCM-Filters' VECTOR_C_GRID Laplacian (MOM6's viscosity, after Griffies &
Hallberg 2000), plainly, in its two stages.

Stage 1, the strains: the horizontal tension at T points,
d(u/dyCu)/dx * dyT/dxT - d(v/dxCv)/dy * dxT/dyT, and the shear strain at q
points, d(v/dyCv)/dx * dyBu/dxBu + d(u/dxCu)/dy * dxBu/dyBu, each aspect
ratio times the wet mask of its point, the tension times
-(kappa_iso + kappa_aniso / 2) and the shear times -kappa_iso. Stage 2, the
divergence of the stress back to the velocity points: u from the tension
times dyT**2 across its east and west T cells and the shear times dxBu**2
across its north and south q points, over area_u; v likewise over area_v.
Points are MOM6's non-symmetric ones: u(j, i) on T(j, i)'s east face, v(j,
i) on its north face, q(j, i) at its north-east corner. Doubly periodic;
NaNs read as 0; a point of zero area gets nothing. The metric factors are
worked out in float64 and then cast to the filter's dtype.
"""
from __future__ import annotations

import torch

from .common import Operator, east, north, south, west


def operator(grid_vars: dict, dtype: torch.dtype) -> Operator:
    g = {k: v.double() for k, v in grid_vars.items()}
    wet_t, wet_q = g["wet_mask_t"], g["wet_mask_q"]
    dxT, dyT, dxBu, dyBu = g["dxT"], g["dyT"], g["dxBu"], g["dyBu"]

    def over_area(area):
        return torch.where(area > 0, 1.0 / torch.where(area > 0, area, 1.0), 0.0)

    m = {
        # the strains' masked aspect ratios and viscosities
        "t_x": wet_t * dyT / dxT, "t_y": wet_t * dxT / dyT,
        "q_x": wet_q * dyBu / dxBu, "q_y": wet_q * dxBu / dyBu,
        "k_t": -(g["kappa_iso"] + 0.5 * g["kappa_aniso"]), "k_q": -g["kappa_iso"],
        # the lengths that the velocities are divided by
        "dyCu": g["dyCu"], "dxCu": g["dxCu"], "dyCv": g["dyCv"], "dxCv": g["dxCv"],
        # the divergence's squared lengths and inverse areas
        "dxT2": dxT * dxT, "dyT2": dyT * dyT, "dxBu2": dxBu * dxBu, "dyBu2": dyBu * dyBu,
        "inv_u": over_area(g["area_u"]), "inv_v": over_area(g["area_v"]),
    }
    m = {k: a.to(dtype) for k, a in m.items()}

    def laplacian(u, v):
        u, v = torch.nan_to_num(u), torch.nan_to_num(v)
        # stage 1: tension at T (u's west face difference, v's south one)
        # and shear at q (v's east difference, u's north one)
        u_y, v_x = u / m["dyCu"], v / m["dxCv"]
        tension = m["k_t"] * (m["t_x"] * (u_y - west(u_y)) - m["t_y"] * (v_x - south(v_x)))
        v_y, u_x = v / m["dyCv"], u / m["dxCu"]
        shear = m["k_q"] * (m["q_x"] * (east(v_y) - v_y) + m["q_y"] * (north(u_x) - u_x))
        # stage 2: the stress's divergence at u (T east of it, q south of it)
        # and at v (q west of it, T north of it)
        tu, sq_u = m["dyT2"] * tension, m["dxBu2"] * shear
        lu = ((tu - east(tu)) / m["dyCu"] + (south(sq_u) - sq_u) / m["dxCu"]) * m["inv_u"]
        sq_v, tv = m["dyBu2"] * shear, m["dxT2"] * tension
        lv = ((west(sq_v) - sq_v) / m["dyCv"] - (tv - north(tv)) / m["dxCv"]) * m["inv_v"]
        return lu, lv

    return Operator(laplacian=laplacian, dimensional=True)
