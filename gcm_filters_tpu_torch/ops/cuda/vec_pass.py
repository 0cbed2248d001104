"""One coupled vector Chebyshev step: the CUDA kernel's wrapper and its plain version.

PyTorch-port counterpart of the pass semantics of
``gcm_filters_tpu/ops/pallas/vec_pass.py`` (``_build_coupled_pass`` with the
B-grid body ``_bgrid_lap`` or the C-grid tap body ``_ctap_lap``). The kernels
are in ``gcm_filters_tpu_torch/csrc/vec_pass.cu``; its head comment states
what one launch computes for each :data:`FIRST`, :data:`MIDDLE` and
:data:`LAST` step. :func:`vec_pass_reference` computes the same step with
torch ops.

The state is the stacked pair, ``(batch, 2, ny, nx)`` with u at index 0 and v
at index 1 of the second axis. Coefficients are one contiguous
``(n_coef, ny, nx)`` tensor, pre-scaled by ``-2*lap_scale``, in
``BGRID_FIELDS`` order (B-grid, 10 planes: diffusion then mixing) or
``CTAPS`` order (C-grid taps, 18 planes).

:func:`vec_pass` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; for a CUDA tensor it launches or raises.

The fused pass runs S <= 16 coupled steps per launch on shared-memory tiles,
as the TPU kernel does in VMEM (``csrc/vec_tile.cuh``; entries
``vec_fused_pass_f32/f64`` in ``csrc/vec_pass.cu``): :func:`vec_fused_pass`
is its wrapper, :func:`vec_fused_pass_reference` its plain version (the same
steps as a chain of :func:`vec_pass_reference`, so its result equals the
plain step chain exactly), :func:`vec_fused_pass_tiled_reference` the
kernel's tile decomposition in torch (periodic windows with their corners,
shrinking steps), and :func:`plan_vec_fused_passes` the counterpart of the
JAX ``plan_vec_passes`` / ``plan_ctap_passes``: tile, halo, the balanced
split of the steps into passes, the steps each pass runs (a float32 pass of
the periodic field in registers, ``vec_reg_kernel``, where the cost model
finds them cheaper; else in shared memory) and the static predicate that
says whether the fused route applies.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..ctaps import CTAP_NAMES, apply_taps
from ..stencil import BGRID_FIELDS, BGridVectorStencil
from .cheb_pass import (
    FIRST, FUSED_THREADS, LAST, MAX_FUSE, MIDDLE, SHARED_BYTES, SM_SHARED_BYTES, FusedPlan,
    _kinds, _pass_args, check_shared, from_tiles, search_plan, tile_windows, to_tiles,
)
from .launch import STEP_ROWS, Kernel, check_grid, pointer, route

Tensor = torch.Tensor

BGRID, CTAP = 0, 1  # the contraction a launch runs (the kernel's `op`)
N_COEF = {BGRID: len(BGRID_FIELDS), CTAP: len(CTAP_NAMES)}


@dataclasses.dataclass(frozen=True)
class VecPassOperands:
    """What every step of one vector filter reads besides the carries.

    ``coef`` is the ``(n_coef, ny, nx)`` coefficient tensor on one device in
    one dtype, pre-scaled by ``-2*lap_scale``; ``op`` is :data:`BGRID` or
    :data:`CTAP`; ``zap`` scrubs NaNs from the contraction's input.
    """

    op: int
    coef: Tensor
    zap: bool


def _lap(ops: VecPassOperands, t: Tensor) -> Tensor:
    """lap'(t) on the stacked state, periodic in x and y, with the
    contraction order of the JAX kernel bodies."""
    if ops.op == CTAP:
        g = torch.nan_to_num(t) if ops.zap else t
        lu, lv = apply_taps(dict(zip(CTAP_NAMES, ops.coef)), g[:, 0], g[:, 1])
    elif ops.op == BGRID:
        lu, lv = BGridVectorStencil(*ops.coef, zap_nans=ops.zap).laplacian(t[:, 0], t[:, 1])
    else:
        raise ValueError(f"unknown vector contraction {ops.op}")
    return torch.stack([lu, lv], dim=1)


def reference_step(
    kind: int, p_a: float, p_b: float, laplacian, *,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """One coupled step with torch ops around ``laplacian``, which maps a
    stacked state to ``lap'`` of it: the periodic contraction for the
    unsharded step, the same contraction fed from halo rows for a shard of
    the ring step (ops/cuda/ring_pass.py)."""
    if kind == FIRST:
        t1 = -w + 0.5 * laplacian(w)
        a = p_a * w + p_b * t1
        t_next.copy_(t1)
        acc.copy_(a)
        return
    if kind not in (MIDDLE, LAST):
        raise ValueError(f"unknown step kind {kind}")
    nxt = -2.0 * t + laplacian(t) - t_prev
    a = acc + p_a * nxt
    if kind == MIDDLE:
        t_next.copy_(nxt)
    acc.copy_(a)


def vec_pass_reference(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    Writes its outputs into the given buffers, as the kernel does: FIRST
    reads ``w`` and writes ``t_next`` (T1) and ``acc``; MIDDLE writes
    ``t_next`` (which may be ``t_prev``) and ``acc``; LAST writes the result
    into ``acc``.
    """
    reference_step(kind, p_a, p_b, lambda x: _lap(ops, x), w=w, t=t, t_prev=t_prev,
                   t_next=t_next, acc=acc)


_KERNEL = Kernel("vec_pass", "vec_pass", (
    [ctypes.c_int] * 5            # op, kind, batch, ny, nx
    + [ctypes.c_void_p] * 6       # w, t, t_prev, t_next, acc, coef
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))
_FUSED_KERNEL = Kernel("vec_pass", "vec_fused_pass", (
    [ctypes.c_int] * 9            # op, batch, ny, nx, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 8       # w, t, t_prev, acc_in, t_out, t_prev_out, acc_out, coef
    + [ctypes.c_int] * 2          # zap, regs
    + [ctypes.c_void_p]           # stream
))

_REQUIRED = {
    FIRST: ("w", "t_next", "acc"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    if ops.op not in N_COEF:
        raise ValueError(f"unknown vector contraction {ops.op}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 4 or acc.shape[1] != 2:
        raise ValueError(f"vec_pass kernel takes (batch, 2, ny, nx) carries, got {tuple(acc.shape)}")
    batch, _, ny, nx = acc.shape
    check_grid(batch, ny, STEP_ROWS, "shape", acc.shape)
    ptr = {}
    for name in ("w", "t", "t_prev", "t_next", "acc"):
        if name not in _REQUIRED[kind]:
            ptr[name] = None
        elif bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
        else:
            ptr[name] = pointer(name, bufs[name], acc.shape, device, dtype)
    coef = pointer("coef", ops.coef, (N_COEF[ops.op], ny, nx), device, dtype)
    _KERNEL(device, dtype, ops.op, kind, batch, ny, nx, ptr["w"], ptr["t"], ptr["t_prev"],
            ptr["t_next"], ptr["acc"], coef, float(p_a), float(p_b), int(ops.zap),
            detail=ops.op)


def vec_pass(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """One coupled Chebyshev step, as :func:`vec_pass_reference` documents it.

    CUDA tensors launch the kernel (counted per contraction under
    ``("vec_pass", BGRID)`` and ``("vec_pass", CTAP)`` in
    :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; CPU tensors run the plain version. Anything else raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_next=t_next, acc=acc)
    with route("vec_pass", acc.device) as card:
        if card:
            _launch(ops, kind, p_a, p_b, bufs)
        else:
            vec_pass_reference(ops, kind, p_a, p_b, **bufs)


# -- the fused pass: S coupled steps per launch on shared-memory tiles -------

# Tile shapes (by, bx) the planner chooses from, bx a multiple of the warp
# width, per contraction, each with the ratio of its measured time to the
# cost model's, relative to the best tile: the float32 tile sweep that
# chip_smoke.py phase 7b runs and prints on one H100 (every tile at every
# split of the 11-step headline, 2400x3600, and of the 44-step Taper). It
# covers what the model does not see (strip quantization, how a tile's rows
# fall on the warps).
VEC_TILES = {
    BGRID: {(32, 64): 1.114, (16, 96): 1.0, (24, 64): 1.088, (48, 32): 1.195,
            (40, 32): 1.156, (16, 128): 1.03, (32, 32): 1.173, (16, 64): 1.106,
            (24, 32): 1.203, (16, 48): 1.146, (16, 32): 1.243},
    CTAP: {(16, 64): 1.0, (40, 32): 1.154, (32, 32): 1.112, (24, 64): 1.094,
           (16, 96): 1.04, (24, 32): 1.121, (16, 32): 1.099, (8, 64): 1.032},
}
# float64 keeps the tiles and ratios of the float32 sweep of the tile's
# first design, and that design's cost model below: a model fitted to the
# 2400x3600 float64 sweep alone has no cost per launch, and took three
# launches where two were faster at 128x256 (PERF.md §6).
VEC_TILES_F64 = {
    BGRID: {(32, 64): 1.0, (16, 96): 0.873, (48, 32): 1.194, (40, 32): 1.164,
            (24, 64): 1.018, (16, 64): 1.047, (16, 128): 0.847, (32, 32): 1.208,
            (24, 32): 1.192, (16, 32): 1.192},
    CTAP: {(16, 64): 1.0, (32, 32): 1.205, (40, 32): 1.282, (24, 32): 1.225,
           (24, 64): 1.097, (16, 96): 1.047, (16, 32): 1.188, (8, 64): 1.045},
}
# The cost model, in window-cell loads of one plane: a pass costs its
# window's load, every plane, plus its cell-steps at _VEC_STEP[(op, itemsize)]
# each, times _VEC_ONE_BLOCK[itemsize] where a block takes more than half an
# SM's shared memory. Fitted (least squares, with the tile ratios above) to
# the float32 sweep, where the steps are most of the time; float64 steps
# weigh more (two shared wavefronts a value, half the FMA rate).
_VEC_STEP = {(BGRID, 4): 2.40, (CTAP, 4): 2.92, (BGRID, 8): 1.32, (CTAP, 8): 2.97}
_VEC_ONE_BLOCK = {4: 1.0, 8: 1.25}


def vec_tiles(op: int, itemsize: int) -> dict:
    """The tiles the planner weighs for ``op`` in this item size, with their
    measured ratios (:data:`VEC_TILES`, :data:`VEC_TILES_F64`)."""
    return (VEC_TILES_F64 if itemsize == 8 else VEC_TILES)[op]


def vec_fused_shared_bytes(tile, halo: int, n_coef: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (``vec_fused_shared_bytes`` of
    vec_tile.cuh): two state pairs and ``n_coef`` coefficient planes of the
    window, and acc of the own tile for u and v."""
    by, bx = tile
    return ((4 + n_coef) * (by + 2 * halo) * (bx + 2 * halo) + 2 * by * bx) * itemsize


def _vec_pass_cost(op: int, tile, steps, itemsize: int) -> float:
    """Modelled cost per own cell of a plan: per pass the window's load (every
    plane) and every step's shrinking window, scaled by the tile's measured
    ratio (:func:`vec_tiles`). Comparable within one dtype only."""
    by, bx = tile
    return sum(_vec_shared_cost(op, tuple(tile), s, itemsize) for s in steps) / (by * bx)


def _vec_shared_cost(op: int, tile, halo: int, itemsize: int) -> float:
    """Modelled cost of one pass of ``halo`` steps in shared memory
    (``vec_step_window``), the tile's measured ratio included."""
    by, bx = tile
    n_coef = N_COEF[op]
    wy, wx = by + 2 * halo, bx + 2 * halo
    cells = sum((wy - 2 * j) * (wx - 2 * j) for j in range(1, halo + 1))
    two = 2 * (vec_fused_shared_bytes(tile, halo, n_coef, itemsize) + 1024) <= SM_SHARED_BYTES
    step = _VEC_STEP[(op, itemsize)] * (1.0 if two else _VEC_ONE_BLOCK[itemsize])
    return ((4 + n_coef) * wy * wx + step * cells) * vec_tiles(op, itemsize).get(tuple(tile), 1.0)


# -- the register steps (vec_reg_kernel of csrc/vec_tile.cuh) ----------------

# Rows of a thread's run in the register steps, by (contraction, itemsize)
# (``VecRegRows`` of vec_tile.cuh); a pair not named keeps the shared-memory
# steps (float64: its runs would take twice the registers).
VEC_REG_ROWS = {(BGRID, 4): 8, (CTAP, 4): 6}
# The register steps' cost model, in the units of the shared-memory model
# (window-cell loads of one plane, at the same milliseconds a unit): a pass
# costs _VEC_REG_PASS a tile (its barriers, the latencies of its load and
# lift), _VEC_REG_LOAD a window cell of a plane, and _VEC_REG_STEP[op] a lane
# slot that a step issues (every lane of a warp on every live row of its
# runs: the columns outside the shrunk window are stepped too), times the
# tile's ratio in VEC_REG_TILES. Fitted (least squares, 7% rms) to a float32
# sweep on one H100 of every tile at every split of the 11-step headline
# (2400x3600 on both grids, 1080x1440 on the C-grid) and of the Taper (the
# same sweep that chip_smoke.py phase 7b prints, on both steps; PERF.md §6).
_VEC_REG_PASS, _VEC_REG_LOAD = 13977.7, 0.7491
_VEC_REG_STEP = {BGRID: 1.4092, CTAP: 1.7256}
VEC_REG_TILES = {
    BGRID: {(16, 32): 1.089, (16, 48): 1.01, (16, 64): 0.951, (16, 96): 0.911,
            (16, 128): 0.959, (24, 32): 1.042, (24, 64): 0.949, (32, 32): 1.019,
            (32, 64): 1.01, (40, 32): 1.013, (48, 32): 1.04},
    CTAP: {(8, 64): 0.923, (16, 32): 0.988, (16, 64): 0.96, (16, 96): 1.1, (24, 32): 1.006,
           (24, 64): 1.1, (32, 32): 1.047, (40, 32): 1.108},
}


def vec_reg_pitch(wy: int, rows: int) -> int:
    """Cells a column of an exchange plane holds (``vec_reg_pitch`` of
    vec_tile.cuh): the window's run rows, made odd."""
    return -(-wy // rows) * rows | 1


def vec_reg_shared_bytes(tile, halo: int, n_coef: int, itemsize: int, rows: int) -> int:
    """Dynamic shared memory of one block on the register steps
    (``vec_reg_shared_bytes`` of vec_tile.cuh): the window's coefficients,
    then the larger of its state and acc (:func:`vec_fused_shared_bytes`'s
    other planes) and the two exchange planes of (u, v) pairs."""
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    window = 4 * wy * wx + 2 * by * bx
    planes = 4 * (wx + 2) * vec_reg_pitch(wy, rows)
    return (n_coef * wy * wx + max(window, planes)) * itemsize


@functools.lru_cache(maxsize=None)
def vec_reg_fits(op: int, itemsize: int, tile, halo: int) -> bool:
    """Whether a pass of ``halo`` steps on ``tile`` can take the register
    steps (``launch_vec_reg`` of vec_tile.cuh refuses it otherwise): the
    contraction and item size have a run length R, the block's threads cover
    the window's ``ceil(wy / R) * wx`` runs, and its planes fit in a block's
    shared memory."""
    rows = VEC_REG_ROWS.get((op, itemsize), 0)
    if rows == 0:
        return False
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    return (-(-wy // rows) * wx <= FUSED_THREADS
            and vec_reg_shared_bytes(tile, halo, N_COEF[op], itemsize, rows) <= SHARED_BYTES)


def vec_reg_runs(tile, halo: int, rows: int):
    """The runs of a window on the register steps, in thread order: ``(q,
    r0)``, column and first row of thread t's run (``vec_reg_steps``)."""
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    return [(t % wx, t // wx * rows) for t in range(-(-wy // rows) * wx)]


def vec_reg_live(r0: int, rows: int, wy: int, j: int) -> range:
    """The slots of a run that step j of a window ``wy`` rows high steps: the
    rows of the window shrunk by j (``vec_reg_step``'s ``lo`` and ``hi``)."""
    return range(max(0, j - r0), min(rows, wy - j - r0))


@functools.lru_cache(maxsize=None)
def vec_reg_slots(tile, halo: int, rows: int) -> int:
    """Lane slots that a pass's steps issue on the register steps: for every
    step and warp, 32 a slot that any of its lanes steps."""
    by, bx = tile
    wy = by + 2 * halo
    runs = vec_reg_runs(tile, halo, rows)
    total = 0
    for j in range(1, halo + 1):
        for w0 in range(0, len(runs), 32):
            live = set()
            for _, r0 in runs[w0:w0 + 32]:
                live.update(vec_reg_live(r0, rows, wy, j))
            total += 32 * len(live)
    return total


@functools.lru_cache(maxsize=None)
def vec_pass_costs(op: int, tile, halo: int, itemsize: int):
    """Modelled cost of one pass of ``halo`` steps on ``tile``: ``(shared,
    registers)``, the steps in shared memory (:func:`_vec_shared_cost`) and in
    registers (None where the pass cannot take them: :func:`vec_reg_fits`)."""
    shared = _vec_shared_cost(op, tile, halo, itemsize)
    if not vec_reg_fits(op, itemsize, tile, halo):
        return shared, None
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    regs = ((_VEC_REG_PASS + _VEC_REG_LOAD * (4 + N_COEF[op]) * wy * wx
             + _VEC_REG_STEP[op] * vec_reg_slots(tile, halo, VEC_REG_ROWS[op, itemsize]))
            * VEC_REG_TILES[op].get(tuple(tile), 1.0))
    return shared, regs


def vec_pass_path(op: int, tile, halo: int, itemsize: int) -> str:
    """Which steps a pass takes: "registers" where it can take them and the
    model (:func:`vec_pass_costs`) finds them cheaper, else "shared"."""
    shared, regs = vec_pass_costs(op, tuple(tile), halo, itemsize)
    return "registers" if regs is not None and regs < shared else "shared"


@functools.lru_cache(maxsize=None)
def _vec_plan(n_steps: int, ny: int, nx: int, itemsize: int, op: int, max_fuse: int,
              tile: Optional[Tuple[int, int]], ring: bool) -> FusedPlan:
    def fits(tl, halo):
        if ring and nx < tl[1] + 2 * halo:
            return False
        return vec_fused_shared_bytes(tl, halo, N_COEF[op], itemsize) <= SHARED_BYTES

    def cost(tl, steps):
        if ring:
            return _vec_pass_cost(op, tl, steps, itemsize)
        return sum(min(c for c in vec_pass_costs(op, tuple(tl), s, itemsize) if c is not None)
                   for s in steps) / (tl[0] * tl[1])

    plan = search_plan(
        n_steps, ny, nx, max_fuse, (tile,) if tile else vec_tiles(op, itemsize), fits, cost,
        predicate=(lambda tl, halo: ny >= halo) if ring else None)
    paths = tuple("shared" if ring else vec_pass_path(op, plan.tile, s, itemsize)
                  for s in plan.steps)
    return dataclasses.replace(plan, paths=paths)


def plan_vec_fused_passes(n_steps: int, ny: int, nx: int, dtype: torch.dtype, op: int,
                          max_fuse: int = MAX_FUSE,
                          tile: Optional[Tuple[int, int]] = None,
                          ring: bool = False) -> FusedPlan:
    """The fused plan of an ``n_steps`` vector filter with contraction ``op``
    on ``(ny, nx)`` fields: the counterpart of the JAX ``plan_vec_passes`` /
    ``plan_ctap_passes``.

    Every balanced split of the steps into ``ceil(n_steps / cap)`` passes
    (``cap <= max_fuse``) and every tile of ``vec_tiles(op, itemsize)`` (or only
    ``tile``) whose window fits in a block's shared memory is scored by a
    cost model fitted to measured times, each pass on the cheaper of its
    steps (:func:`vec_pass_costs`); the cheapest wins, and the plan's
    ``paths`` say which steps each pass takes (:func:`vec_pass_path`), for
    :func:`vec_fused_pass` to launch. ``fused`` is False where the field is
    smaller than a tile plus its halo in either dimension: the step chain runs
    there. With ``ring`` the ``(ny, nx)`` field is a y-shard of the ring
    (parallel/ring.py), whose window rows past its edges come from the
    neighbours: only tiles whose window fits in ``nx`` are weighed, the plan
    is fused where ``ny >= halo``, and every pass steps in shared memory (the
    ring's kernel has no register steps). The result depends on the shape,
    the dtype and ``op`` only.
    """
    if op not in N_COEF:
        raise ValueError(f"unknown vector contraction {op}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _vec_plan(int(n_steps), int(ny), int(nx), itemsize, int(op), int(max_fuse),
                     tuple(tile) if tile else None, bool(ring))


def vec_fused_pass_reference(
    ops: VecPassOperands, p, start: int, n_ops: int, *, tile=None, path=None,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """The plain PyTorch version of one fused launch, on any device: steps
    ``start+1 .. start+n_ops`` of the filter as a chain of
    :func:`vec_pass_reference`, so the result equals the plain step chain
    exactly (``tile`` and ``path`` are not used).

    A first pass (``start == 0``) reads the stacked input ``w``; any other
    reads ``t``, ``t_prev`` and ``acc``. A pass that ends the filter leaves
    the result in ``acc``; any other writes ``t_out``, ``t_prev_out`` and
    ``acc``. The inputs are not written.
    """
    first, last = _kinds(p, start, n_ops)
    if first:
        cur, prev = torch.empty_like(acc), w.clone()
        vec_pass_reference(ops, FIRST, p[0], p[1], w=w, t_next=cur, acc=acc)
        done = 1
    else:
        cur, prev = t.clone(), t_prev.clone()
        done = start
    for k in range(done + 1, start + n_ops + 1):
        if k == len(p) - 1:
            vec_pass_reference(ops, LAST, p[k], t=cur, t_prev=prev, acc=acc)
        else:
            vec_pass_reference(ops, MIDDLE, p[k], t=cur, t_prev=prev, t_next=prev, acc=acc)
            cur, prev = prev, cur
    if not last:
        t_out.copy_(cur)
        t_prev_out.copy_(prev)


def vec_fused_pass_tiled_reference(
    ops: VecPassOperands, p, start: int, n_ops: int, *, tile, path=None,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """One fused launch computed as the kernel decomposes it, in torch.

    For each ``tile = (by, bx)`` of output cells: gather a window of
    ``(by+2H) x (bx+2H)`` cells (``H = n_ops``), periodic in both axes and
    with its corners, of the state of both components and of every
    coefficient plane; run the steps on the window shrunk by j at step j; keep
    the own cells (:func:`vec_tiled_pass`). Same arguments and outputs as
    :func:`vec_fused_pass_reference`, and the same torch arithmetic per cell,
    so the two are equal bit for bit wherever the decomposition is right
    (``path`` is not used: both steps compute the same cells).
    """
    _, last = _kinds(p, start, n_ops)
    ny = acc.shape[-2]
    outs = vec_tiled_pass(ops, p, start, n_ops, tile, lambda r: r % ny, w=w, t=t,
                          t_prev=t_prev, acc=acc)
    acc.copy_(outs["acc"])
    if not last:
        t_out.copy_(outs["t"])
        t_prev_out.copy_(outs["t_prev"])


def vec_tiled_pass(ops: VecPassOperands, p, start: int, n_ops: int, tile, rows, *,
                   w: Optional[Tensor], t: Optional[Tensor], t_prev: Optional[Tensor],
                   acc: Tensor) -> dict:
    """The kernel's tile decomposition of one fused vector pass, in torch, for
    any geometry without a fold: the own domain is ``acc``'s ``(batch, 2, ny,
    nx)``; ``rows(r)`` maps the window rows ``r`` (own coordinates, may lie
    outside) to the rows of the "in" planes (``ops.coef``, ``w``, ``t``,
    ``t_prev``) that hold them; x is periodic. Every tile's window is cut at
    once, a dimension of its own beside the batch, and the steps run on all
    of them together. The contraction is the plain step's own (:func:`_lap`
    on the windows, whose wrap at a window's edge reaches only cells outside
    the shrunk window; every op is elementwise or a shift inside a window).
    The own cells of the ragged last tiles past the field are computed and
    dropped. Returns the own-shaped ``acc`` and, unless the pass ends the
    filter, ``t`` and ``t_prev``."""
    first, last = _kinds(p, start, n_ops)
    by, bx = tile
    H = n_ops
    ny, nx = acc.shape[-2:]
    dev = acc.device
    n_ty, n_tx = -(-ny // by), -(-nx // bx)
    wy, wx = by + 2 * H, bx + 2 * H
    src_r = rows(torch.arange(-H, by + H, device=dev) + by * torch.arange(n_ty, device=dev)[:, None])
    cols = (torch.arange(-H, bx + H, device=dev) + bx * torch.arange(n_tx, device=dev)[:, None]) % nx
    idx = tile_windows(n_ty, n_tx, src_r, cols, nx)
    flat = lambda x: x.reshape(x.shape[:-2] + (-1,))  # noqa: E731

    # the windows: (n_coef, tiles, wy, wx) and (batch, 2, tiles, wy, wx)
    wops = VecPassOperands(ops.op, flat(ops.coef)[:, idx], ops.zap)
    if first:
        cur = flat(w)[..., idx]
        prev = torch.empty_like(cur)
    else:
        cur, prev = flat(t)[..., idx], flat(t_prev)[..., idx]
    a = None if first else to_tiles(acc, tile)
    for i in range(H):
        j = i + 1
        kind = FIRST if first and i == 0 else LAST if last and i == H - 1 else MIDDLE
        sl = (Ellipsis, slice(j, wy - j), slice(j, wx - j))
        lap = _lap(wops, cur)[sl]
        # own cells inside this step's window
        o = (Ellipsis, slice(H - j, H - j + by), slice(H - j, H - j + bx))
        if kind == FIRST:
            h0 = cur[sl]
            t1 = -h0 + 0.5 * lap
            prev[sl] = t1
            a = p[0] * h0[o] + p[1] * t1[o]
            cur, prev = prev, cur
            continue
        nxt = -2.0 * cur[sl] + lap - prev[sl]
        a = a + p[start + i + 1] * nxt[o]
        if kind == MIDDLE:
            prev[sl] = nxt
            cur, prev = prev, cur
    outs = {"acc": from_tiles(a, (ny, nx))}
    if not last:
        own = (Ellipsis, slice(H, H + by), slice(H, H + bx))
        outs["t"], outs["t_prev"] = from_tiles(cur[own], (ny, nx)), from_tiles(prev[own], (ny, nx))
    return outs


def _fused_launch(ops, p, start, n_ops, tile, bufs, path="shared") -> None:
    first, last = _kinds(p, start, n_ops)
    if n_ops > MAX_FUSE:
        raise ValueError(f"a fused pass runs at most {MAX_FUSE} steps, got {n_ops}")
    if ops.op not in N_COEF:
        raise ValueError(f"unknown vector contraction {ops.op}")
    if path not in ("registers", "shared"):
        raise ValueError(f"unknown steps {path!r}: 'registers' or 'shared'")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 4 or acc.shape[1] != 2:
        raise ValueError(
            f"vec_fused_pass takes (batch, 2, ny, nx) carries, got {tuple(acc.shape)}")
    batch, _, ny, nx = acc.shape
    by, bx = tile
    check_grid(batch, ny, by, "shape", acc.shape)
    check_shared(vec_fused_shared_bytes(tile, n_ops, N_COEF[ops.op], acc.element_size()), tile,
                 n_ops)
    if path == "registers" and not vec_reg_fits(ops.op, acc.element_size(), tile, n_ops):
        raise ValueError(f"a pass of {n_ops} steps on tile {tile} in {dtype} cannot take the "
                         "register steps")
    required = ("acc",) + (("w",) if first else ("t", "t_prev")) + (
        () if last else ("t_out", "t_prev_out"))
    pa, p_b = _pass_args(p, start, n_ops, first, bufs, required)
    if not last and any(bufs[o].data_ptr() == bufs[i].data_ptr()
                        for o in ("t_out", "t_prev_out") for i in ("w", "t", "t_prev")
                        if i in required):
        raise ValueError("t_out and t_prev_out must not alias w, t or t_prev")
    ptr = {k: pointer(k, bufs[k], acc.shape, device, dtype) if k in required else None
           for k in ("w", "t", "t_prev", "t_out", "t_prev_out", "acc")}
    coef = pointer("coef", ops.coef, (N_COEF[ops.op], ny, nx), device, dtype)
    _FUSED_KERNEL(device, dtype, ops.op, batch, ny, nx, by, bx, n_ops, int(first), int(last),
                  pa, p_b, ptr["w"], ptr["t"], ptr["t_prev"], ptr["acc"], ptr["t_out"],
                  ptr["t_prev_out"], ptr["acc"], coef, int(ops.zap), int(path == "registers"),
                  detail=(ops.op, path))


def vec_fused_pass(
    ops: VecPassOperands, p, start: int, n_ops: int, *, tile, path: str = "shared",
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """Steps ``start+1 .. start+n_ops`` of the vector filter in one launch,
    on tiles of ``tile = (by, bx)`` cells, as :func:`vec_fused_pass_reference`
    documents them.

    CUDA tensors launch the kernel on the current stream, without
    synchronizing: ``path`` "registers" runs the register steps (a pass the
    plan gave them, :func:`plan_vec_fused_passes`; raises where the pass
    cannot take them, :func:`vec_reg_fits`), "shared" the shared-memory
    steps. The launch is counted per contraction and path under
    ``("vec_fused_pass", (op, path))`` in :func:`~.launch.launch_counts`
    and carries ``path=`` on its ``gft.launch`` span. CPU tensors run the
    plain version, whose cells are the same on either path. Anything else
    raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_out=t_out, t_prev_out=t_prev_out, acc=acc)
    with route("vec_fused_pass", acc.device, path if acc.is_cuda else None) as card:
        if card:
            _fused_launch(ops, p, start, n_ops, tuple(tile), bufs, path)
        else:
            vec_fused_pass_reference(ops, p, start, n_ops, **bufs)
