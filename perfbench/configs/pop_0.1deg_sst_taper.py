"""Inputs of ``pop_0.1deg_sst_taper.json``: the grid and snapshots of
``pop_0.1deg_sst`` (its module, loaded by path), so that both configurations
draw the same inputs from a seed, and the Taper's transition width."""
from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "perfbench_pop_0_1deg_sst", Path(__file__).with_name("pop_0.1deg_sst.py"))
_sst = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sst)

grid_vars = _sst.grid_vars
snapshots = _sst.snapshots


def scales(cfg: dict, grid_vars: dict) -> dict:
    return {**_sst.scales(cfg, grid_vars), "transition_width": cfg["transition_width"]}
