"""Inputs of ``pop_0.1deg_sst.json``, made from the seed on the device."""
from __future__ import annotations

import torch


def grid_vars(cfg: dict, shape, gen: torch.Generator, device) -> dict:
    ny, nx = shape
    wet = torch.ones(shape, dtype=torch.float64, device=device)
    wet[0, :] = 0  # Antarctica
    wet[: ny // 6, : nx // 5] = 0  # a continent
    area = 0.9 + 0.2 * torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    return {"area": area, "wet_mask": wet}


def scales(cfg: dict, grid_vars: dict) -> dict:
    return {"filter_scale": cfg["filter_scale"], "dx_min": cfg["dx_min"]}


def snapshots(cfg: dict, shape, n: int, gen: torch.Generator, device, grid_vars: dict):
    """``n`` SST snapshots, one (n, ny, nx) tensor, NaN on land."""
    x = torch.rand((n, *shape), generator=gen, dtype=torch.float32, device=device)
    x[:, grid_vars["wet_mask"] == 0] = float("nan")
    return (x,)
