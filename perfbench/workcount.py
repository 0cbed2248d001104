"""The work one call must do, counted from the configuration's inputs, and
the least time one H100 could take for it.

Frozen here so that the yardstick does not move with the program: the
published H100 SXM peaks, the floating-point operations the filter needs per
cell and step, and the bytes a call must move. Bytes count each input plane
read once and each output plane written once: the snapshot's state in and
out (two planes a component) and every grid variable of the configuration
once, at the item size of the configuration's dtype. Nothing here looks at
how the program lays out or derives its operands, so the count is the same
whatever implements the filter.
"""
from __future__ import annotations

from typing import Tuple

# Published H100 SXM peaks (NVIDIA data sheet, at the full 700 W power
# limit): HBM3 rate, and the FP32 / FP64 rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}

# Floating-point operations per cell and step. Scalar: 5 multiplies and 4
# adds for the 5-point contraction, 1 post multiply, 3 for the recurrence, 2
# for the sum. B-grid pair: four 5-point contractions (9 each) and 2 adds,
# and 5 for the recurrence and the sum of each component. C-grid pair: two
# 9-tap contractions (17 each) and the same 10.
FLOPS_PER_CELL_STEP = {"scalar": 15, "VECTOR_B_GRID": 48, "VECTOR_C_GRID": 44}


def bound_ms(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """``(ms, bound_by)``: the larger of the times to move ``nbytes`` and to
    do ``flops`` at the published peaks, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def components(cfg: dict) -> int:
    """Planes a snapshot has: 1 for a scalar field, 2 for a (u, v) pair."""
    return 2 if cfg["kind"] == "vector" else 1


def call_work(cfg: dict, snapshots: int) -> Tuple[float, float]:
    """``(bytes, flops)`` that filtering ``snapshots`` snapshots in one call
    needs: the grid variables are read once a call, whatever the batch."""
    cells = cfg["ny"] * cfg["nx"]
    planes = 2 * components(cfg) * snapshots + len(cfg["grid_vars"])
    per_cell_step = FLOPS_PER_CELL_STEP[cfg["grid_type"] if cfg["kind"] == "vector" else "scalar"]
    return (planes * cells * ITEMSIZE[cfg["dtype"]],
            per_cell_step * cells * cfg["n_steps"] * snapshots)


def call_bound_ms(cfg: dict, snapshots: int) -> float:
    nbytes, flops = call_work(cfg, snapshots)
    return bound_ms(nbytes, flops, cfg["dtype"])[0]
