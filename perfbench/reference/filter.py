"""The whole filter in the reference: the configuration's Laplacian (a module
of this folder named after its grid type), the fit of its filter shape and
the recurrence, in any dtype."""
from __future__ import annotations

import importlib
from typing import Sequence, Tuple

import torch

from .chebyshev import TRANSITION_WIDTH, chebyshev_filter, filter_coefficients, n_steps_default


def reference_filter(cfg: dict, grid_vars: dict, scales: dict,
                     fields: Sequence[torch.Tensor], dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Filter ``fields`` (one (n, ny, nx) tensor a component) as the
    configuration ``cfg`` states, computing in ``dtype``. ``scales`` holds
    the ``filter_scale`` and ``dx_min`` that the benchmark hands the program
    too, and the ``transition_width`` where the configuration sets one."""
    shape = cfg["filter_shape"]
    width = scales.get("transition_width", TRANSITION_WIDTH)
    n_steps = n_steps_default(shape, scales["filter_scale"], scales["dx_min"], width)
    if n_steps != cfg["n_steps"]:
        raise ValueError(f"the configuration states {cfg['n_steps']} steps, its scales give {n_steps}")
    grid = importlib.import_module(f"{__package__}.{cfg['grid_type'].lower()}")
    op = grid.operator(grid_vars, dtype)
    p, s_max = filter_coefficients(shape, scales["filter_scale"], scales["dx_min"], n_steps, width)
    scale = 2.0 / s_max if op.dimensional else 2.0 / (s_max * scales["dx_min"] ** 2)
    prepared = op.prepare(*(f.to(dtype) for f in fields))
    return op.finalize(*chebyshev_filter(op.laplacian, prepared, p, scale))
