"""Inputs of ``pop_0.1deg_sst_f64.json``: the grid and snapshots of
``pop_0.1deg_sst`` (its module, loaded by path), so that both configurations
draw the same values from a seed, the snapshots cast once to float64 on the
device (exactly): each call then takes a resident float64 field, with no
cast inside the timed window."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "perfbench_pop_0_1deg_sst", Path(__file__).with_name("pop_0.1deg_sst.py"))
_sst = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sst)

grid_vars = _sst.grid_vars
scales = _sst.scales


def snapshots(cfg: dict, shape, n: int, gen: torch.Generator, device, grid_vars: dict):
    """``pop_0.1deg_sst``'s ``n`` snapshots, one (n, ny, nx) float64 tensor."""
    (x,) = _sst.snapshots(cfg, shape, n, gen, device, grid_vars)
    return (x.to(torch.float64),)
