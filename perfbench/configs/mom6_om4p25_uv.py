"""Inputs of ``mom6_om4p25_uv.json``, made from the seed on the device.

The metrics are those of an isotropic Mercator grid from ``lat_south_deg``
with no tripolar cap, laid out as GCM-Filters indexes MOM6's non-symmetric
arrays: T(j, i) a cell's centre, u(j, i) its east face, v(j, i) its north
face, q(j, i) its north-east corner. The longitude step is 360 / nx degrees
(0.25 at 1440 columns), so a smaller grid in the tests stays global; T and u
rows stand at Mercator ordinate y0 + (j + 1/2) dlon, v and q rows at
y0 + (j + 1) dlon, so cells are square. Constant in x.

Land is fixed: Antarctica south of ``antarctica_deg``, the boxes of
``continents`` (longitudes from 0 to 360, the first crossing the x wrap), a
one-cell channel through two of them (``channels``) and a lattice of
one-cell islands (``islands``). ``wet_mask_q`` is the product of the four T
masks around q, as MOM6 defines ``mask2dBu``.
"""
from __future__ import annotations

import math

import torch


def _lat(y: torch.Tensor) -> torch.Tensor:
    """Latitude (radians) at Mercator ordinate ``y``."""
    return 2.0 * torch.atan(torch.exp(y)) - 0.5 * math.pi


def _east(a: torch.Tensor) -> torch.Tensor:  # a[j, i + 1]
    return torch.roll(a, -1, -1)


def _north(a: torch.Tensor) -> torch.Tensor:  # a[j + 1, i]
    return torch.roll(a, -1, -2)


def _rows(cfg: dict, ny: int, dlon: float, device):
    """Latitudes (radians, float64) of the T rows and of the q rows, -1 .. ny."""
    phi0 = math.radians(cfg["lat_south_deg"])
    y0 = math.log(math.tan(0.25 * math.pi + 0.5 * phi0))
    j = torch.arange(-1, ny + 1, dtype=torch.float64, device=device)
    return _lat(y0 + (j + 0.5) * dlon), _lat(y0 + (j + 1.0) * dlon)


def wet_mask_t(cfg: dict, shape, device) -> torch.Tensor:
    """The T cells' wet mask, 1 for ocean and 0 for land (float64)."""
    ny, nx = shape
    dlon = 2.0 * math.pi / nx
    lat_t = torch.rad2deg(_rows(cfg, ny, dlon, device)[0][1:ny + 1])[:, None]
    lon_t = ((torch.arange(nx, dtype=torch.float64, device=device) + 0.5) * (360.0 / nx))[None, :]
    land = (lat_t < cfg["antarctica_deg"]).expand(ny, nx).clone()
    for lon_w, lon_e, lat_s, lat_n in cfg["continents"]:
        in_lon = (lon_t >= lon_w) & (lon_t < lon_e) if lon_w < lon_e else (
            (lon_t >= lon_w) | (lon_t < lon_e))  # across the x wrap
        land |= in_lon & (lat_t >= lat_s) & (lat_t < lat_n)
    for kind, at, lo, hi in cfg["channels"]:
        # one column ("ns", at a longitude) or one row ("ew", at a latitude),
        # wet between lo and hi of the other coordinate
        if kind == "ns":
            i = int((lon_t - at).abs().argmin())
            cut = (lat_t[:, 0] >= lo) & (lat_t[:, 0] < hi)
            land[cut, i] = False
        else:
            j = int((lat_t - at).abs().argmin())
            lon = lon_t[0]
            cut = (lon >= lo) | (lon < hi) if lo > hi else (lon >= lo) & (lon < hi)
            land[j, cut] = False
    lon_w, lon_e, lat_s, lat_n = cfg["islands"]["box"]
    step = max(cfg["islands"]["step_min"], nx // cfg["islands"]["per_circle"])
    jj = torch.arange(ny, device=device)[:, None]
    ii = torch.arange(nx, device=device)[None, :]
    box = (lon_t >= lon_w) & (lon_t < lon_e) & (lat_t >= lat_s) & (lat_t < lat_n)
    land |= box & (jj % step == step // 2) & (ii % step == step // 2)
    return (~land).to(torch.float64)


def grid_vars(cfg: dict, shape, gen: torch.Generator, device) -> dict:
    ny, nx = shape
    r = cfg["earth_radius_m"]
    dlon = 2.0 * math.pi / nx
    lat_t, lat_q = _rows(cfg, ny, dlon, device)  # rows -1 .. ny
    rows = slice(1, ny + 1)

    def plane(col):
        return col[:, None].expand(ny, nx).contiguous()

    dx_t = r * torch.cos(lat_t[rows]) * dlon  # along a T (and u) row
    dy_t = r * (lat_q[1:ny + 1] - lat_q[0:ny])  # between the q rows around it
    dx_q = r * torch.cos(lat_q[rows]) * dlon  # along a q (and v) row
    dy_q = r * (lat_t[2:ny + 2] - lat_t[1:ny + 1])  # between the T rows around it
    wet_t = wet_mask_t(cfg, shape, device)
    wet_q = wet_t * _east(wet_t) * _north(wet_t) * _north(_east(wet_t))
    gv = {
        "wet_mask_t": wet_t, "wet_mask_q": wet_q,
        "dxT": plane(dx_t), "dyT": plane(dy_t),
        "dxCu": plane(dx_t), "dyCu": plane(dy_t),  # u on the T row, its face between q rows
        "dxCv": plane(dx_q), "dyCv": plane(dy_q),  # v on the q row, between T rows
        "dxBu": plane(dx_q), "dyBu": plane(dy_q),
        "area_u": plane(dx_t * dy_t), "area_v": plane(dx_q * dy_q),
        "kappa_iso": torch.full(shape, cfg["kappa_iso"], dtype=torch.float64, device=device),
        "kappa_aniso": torch.full(shape, cfg["kappa_aniso"], dtype=torch.float64, device=device),
    }
    return {k: gv[k] for k in cfg["grid_vars"]}


LENGTHS = ("dxT", "dyT", "dxCu", "dyCu", "dxCv", "dyCv", "dxBu", "dyBu")


def scales(cfg: dict, grid_vars: dict) -> dict:
    """``dx_min``, the least length, and ``filter_scale``, ``filter_factor``
    times it. GCM-Filters counts ceil(1.1 * filter_scale / dx_min) steps, and
    for a factor of 10 that quotient rounds above 11 for about half of all
    dx_min: the scale is lowered by units in its last place until it gives
    the configuration's ``n_steps``."""
    dx_min = min(float(grid_vars[k].min()) for k in LENGTHS)
    filter_scale = cfg["filter_factor"] * dx_min
    while math.ceil(1.1 * filter_scale / dx_min) > cfg["n_steps"]:
        filter_scale = math.nextafter(filter_scale, 0.0)
    return {"filter_scale": filter_scale, "dx_min": dx_min}


def velocity_masks(grid_vars: dict):
    """``(wet_u, wet_v)``: a u point is wet where both T cells beside it are,
    a v point where the T cells south and north of it are."""
    wet_t = grid_vars["wet_mask_t"]
    return wet_t * _east(wet_t), wet_t * _north(wet_t)


def snapshots(cfg: dict, shape, n: int, gen: torch.Generator, device, grid_vars: dict):
    """``n`` (u, v) pairs: two (n, ny, nx) tensors, uniform in [-1, 1) m/s,
    NaN at the land velocity points (as xarray reads MOM6 output)."""
    u = 2.0 * torch.rand((n, *shape), generator=gen, dtype=torch.float32, device=device) - 1.0
    v = 2.0 * torch.rand((n, *shape), generator=gen, dtype=torch.float32, device=device) - 1.0
    wet_u, wet_v = velocity_masks(grid_vars)
    u[:, wet_u == 0] = float("nan")
    v[:, wet_v == 0] = float("nan")
    return (u, v)
