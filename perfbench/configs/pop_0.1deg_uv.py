"""Inputs of ``pop_0.1deg_uv.json``, made from the seed on the device.

The metrics are those of a Mercator grid with a 0.1 degree longitude step:
row j's T points at Mercator ordinate y0 + (j + 1/2) dlon, its U points at
y0 + (j + 1) dlon, so cells are square. Constant in x.
"""
from __future__ import annotations

import math

import torch


def _lat(y: torch.Tensor) -> torch.Tensor:
    """Latitude (radians) at Mercator ordinate ``y``."""
    return 2.0 * torch.atan(torch.exp(y)) - 0.5 * math.pi


def grid_vars(cfg: dict, shape, gen: torch.Generator, device) -> dict:
    ny, nx = shape
    r = cfg["earth_radius_m"]
    dlon = math.radians(cfg["lon_step_deg"])
    phi0 = math.radians(cfg["lat_south_deg"])
    y0 = math.log(math.tan(0.25 * math.pi + 0.5 * phi0))
    j = torch.arange(-1, ny + 1, dtype=torch.float64, device=device)
    lat_t = _lat(y0 + (j + 0.5) * dlon)  # T rows -1 .. ny
    lat_u = _lat(y0 + (j + 1.0) * dlon)  # U rows -1 .. ny
    t, u = slice(1, ny + 1), slice(1, ny + 1)

    def plane(col):
        return col[:, None].expand(ny, nx).contiguous()

    dxt = r * torch.cos(lat_t[t]) * dlon
    dyt = r * (lat_u[1:ny + 1] - lat_u[0:ny])  # T cell: between the U rows around it
    dxu = r * torch.cos(lat_u[u]) * dlon
    dyu = r * (lat_t[2:ny + 2] - lat_t[1:ny + 1])  # U cell: between the T rows around it
    gv = {
        "DXU": dxu, "DYU": dyu,
        "HTN": dxu,  # the T cell's north face lies on the U row
        "HTE": dyt,  # the T cell's east face
        "HUS": dxt,  # the U cell's south face lies on the T row
        "HUW": dyu,  # the U cell's west face
        "UAREA": dxu * dyu, "TAREA": dxt * dyt,
    }
    return {k: plane(v) for k, v in gv.items()}


def scales(cfg: dict, grid_vars: dict) -> dict:
    dx_min = min(float(grid_vars[k].min()) for k in ("DXU", "DYU", "HUS", "HUW", "HTE", "HTN"))
    return {"filter_scale": cfg["filter_factor"] * dx_min, "dx_min": dx_min}


def snapshots(cfg: dict, shape, n: int, gen: torch.Generator, device, grid_vars: dict):
    """``n`` (u, v) pairs: two (n, ny, nx) tensors."""
    u = 2.0 * torch.rand((n, *shape), generator=gen, dtype=torch.float32, device=device) - 1.0
    v = 2.0 * torch.rand((n, *shape), generator=gen, dtype=torch.float32, device=device) - 1.0
    return (u, v)
