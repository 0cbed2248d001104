"""One Chebyshev step: the CUDA kernel's wrapper and its plain PyTorch version.

PyTorch-port counterpart of the pass semantics of
``gcm_filters_tpu/ops/pallas/cheb_pass.py`` (the fused, end-fused scalar
pass). The kernel is ``gcm_filters_tpu_torch/csrc/cheb_pass.cu``; its head
comment states what one launch computes for each :data:`FIRST`,
:data:`MIDDLE` and :data:`LAST` step. :func:`cheb_pass_reference` computes
the same step with torch ops.

:func:`cheb_pass` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; for a CUDA tensor it launches or raises.

The fused pass runs S <= 16 steps per launch on shared-memory tiles, as the
TPU kernel does in VMEM (``csrc/cheb_tile.cuh``; entries
``cheb_fused_pass_f32/f64`` in ``csrc/cheb_pass.cu``): :func:`cheb_fused_pass`
is its wrapper, :func:`cheb_fused_pass_reference` its plain version (the same
steps as a chain of :func:`reference_step`, so its result equals the plain
step chain exactly), :func:`cheb_fused_pass_tiled_reference` the kernel's tile
decomposition in torch (windows, shrinking steps, mirror cells at the fold),
and :func:`plan_fused_passes` the counterpart of the JAX ``plan_passes``: tile,
halo, the balanced split of the steps into passes, and the static predicate
that says whether the fused route applies.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..stencil import COEF_FIELDS, ScalarStencil5
from .launch import STEP_ROWS, Kernel, check_grid, pointer, route

FIRST, MIDDLE, LAST = 0, 1, 2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PassOperands:
    """What every step of one filter reads besides the carries.

    ``stencil`` is the hot stencil on one device in one dtype, with ``c, n,
    s, e, w`` pre-scaled by ``-2*lap_scale`` (``pre``, ``post`` and ``area``
    are not scaled). ``drop_pre`` turns on the h-space mask elimination,
    with ``post`` as the 0/1 wet mask and ``land_gain = chebval(-1, p)``
    (see dispatch.py).
    """

    stencil: ScalarStencil5
    drop_pre: bool
    land_gain: float


def reference_step(
    ops: PassOperands, kind: int, p_a: float, p_b: float, laplacian, *,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """One step with torch ops around ``laplacian``, which maps a state to
    ``lap'`` of it: the whole-field stencil for the unsharded step, the same
    contraction fed from halo rows for a shard of the ring step
    (ops/cuda/ring_pass.py)."""
    st = ops.stencil
    if kind == FIRST:
        fbar = st.prepare(field)
        h0 = st.post * torch.nan_to_num(fbar) if ops.drop_pre else fbar
        t1 = -h0 + 0.5 * laplacian(h0)
        a = p_a * h0 + p_b * t1
        h.copy_(h0)
        t_next.copy_(t1)
        acc.copy_(a)
        return
    nxt = -2.0 * t + laplacian(t) - t_prev
    a = acc + p_a * nxt
    if kind == MIDDLE:
        t_next.copy_(nxt)
        acc.copy_(a)
        return
    if kind != LAST:
        raise ValueError(f"unknown step kind {kind}")
    fbar = st.prepare(field)
    if ops.drop_pre:
        # 0*fbar poisons a wet-cell NaN back into the result
        a = torch.where(st.post == 0, ops.land_gain * fbar, a + fbar * 0.0)
    acc.copy_(st.finalize(a))


def cheb_pass_reference(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    Writes its outputs into the given buffers, as the kernel does: FIRST
    writes ``h``, ``t_next`` and ``acc``; MIDDLE writes ``t_next`` (which
    may be ``t_prev``) and ``acc``; LAST writes the result into ``acc``.
    """
    reference_step(ops, kind, p_a, p_b, ops.stencil.laplacian, field=field, t=t,
                   t_prev=t_prev, t_next=t_next, acc=acc, h=h)


_KERNEL = Kernel("cheb_pass", "cheb_pass", (
    [ctypes.c_int] * 4            # kind, batch, ny, nx
    + [ctypes.c_void_p] * 11      # field, t, t_prev, t_next, acc, h, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 3          # zap, fold, drop_pre
    + [ctypes.c_void_p]           # stream
))


def coefficient_args(st, shape, device, dtype):
    """``(pointers, immediates, masks)`` of a stencil for a kernel call:
    array coefficients as pointers (immediate 0), constants as immediates
    (null pointer), then the pointers of pre, post and area, each plane
    checked to be a ``shape`` of ``dtype`` on ``device``."""
    ptrs, vals = [], []
    for k in COEF_FIELDS:
        v = getattr(st, k)
        if isinstance(v, Tensor):
            ptrs.append(pointer(k, v, shape, device, dtype))
            vals.append(0.0)
        else:
            ptrs.append(None)
            vals.append(float(v))
    masks = [pointer(k, getattr(st, k), shape, device, dtype) for k in ("pre", "post", "area")]
    return ptrs, vals, masks


_REQUIRED = {
    FIRST: ("field", "t_next", "acc", "h"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("field", "t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 3:
        raise ValueError(f"cheb_pass kernel takes (batch, ny, nx) carries, got {tuple(acc.shape)}")
    batch, ny, nx = acc.shape
    check_grid(batch, ny, STEP_ROWS, "shape", acc.shape)
    for name in _REQUIRED[kind]:
        if bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
    ptr = {k: pointer(k, bufs[k], acc.shape, device, dtype) if k in _REQUIRED[kind] else None
           for k in ("field", "t", "t_prev", "t_next", "acc", "h")}
    st = ops.stencil
    coef_ptr, coef_val, masks = coefficient_args(st, (ny, nx), device, dtype)
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")
    _KERNEL(device, dtype, kind, batch, ny, nx,
            ptr["field"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], ptr["h"],
            *coef_ptr, *coef_val, *masks, float(p_a), float(p_b), float(ops.land_gain),
            int(st.zap_nans), int(st.fold_north), int(ops.drop_pre))


def cheb_pass(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """One Chebyshev step, as :func:`cheb_pass_reference` documents it.

    CUDA tensors launch the kernel (counted under ``("cheb_pass", None)`` in
    :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; CPU tensors run the plain version. Anything else raises.
    """
    bufs = dict(field=field, t=t, t_prev=t_prev, t_next=t_next, acc=acc, h=h)
    with route("cheb_pass", acc.device) as card:
        if card:
            _launch(ops, kind, p_a, p_b, bufs)
        else:
            cheb_pass_reference(ops, kind, p_a, p_b, **bufs)


# -- the fused pass: S steps per launch on shared-memory tiles ---------------

MAX_FUSE = 16              # steps per pass at most (csrc/cheb_tile.cuh)
SHARED_BYTES = 232448      # shared memory one block may take on sm_90
SM_SHARED_BYTES = 233472   # shared memory of one SM (1 KB of it reserved per block)
FUSED_THREADS = 512        # threads of a block (csrc/cheb_tile.cuh)
STRIP = 4                  # rows of a step's work item (csrc/cheb_tile.cuh)
# The stencil shapes the tile is compiled for (``fused_mode`` of cheb_tile.cuh)
GENERIC, HSPACE, FLUX = 0, 1, 2
# Rows of a thread's run in the register steps, by (mode, itemsize)
# (``RegRows`` of cheb_tile.cuh); a mode not named steps in shared memory.
REG_ROWS = {(HSPACE, 4): 13}
# Tile shapes (by, bx) the planner chooses from, each with the ratio of its
# measured time to the cost model's at the 2400x3600 float32 headline,
# relative to 32x96 (the tile sweep that chip_smoke.py phase 4b runs and
# prints on one H100, PERF.md §6): what the model does not see (the load's
# access pattern, bank conflicts where a warp's items cross a strip's end).
# The items are per column, so bx need not be a multiple of the warp width.
TILES = {(32, 96): 1.0, (16, 128): 0.932, (48, 64): 1.017, (32, 64): 0.98,
         (16, 64): 1.04, (32, 32): 1.119, (16, 32): 1.041, (56, 56): 1.047,
         (40, 80): 0.99, (64, 48): 1.025}
# The cost model, in lane slots of the f32 kernel's steps (step_slots): a
# step issues its (strip, column) items in whole rounds of FUSED_THREADS;
# loading one window cell of one plane costs about _LOAD slots (a burst of
# cp.async copies, which the steps do not overlap: PERF.md §6), and steps
# cost _ONE_BLOCK times more where an SM holds one block, not two. Two fit
# where two windows fit in an SM's shared memory and the kernel is the f32
# kernel of four planes (the h-space mode, 56 registers a thread); the other
# modes and float64 take more than 64 registers, one block an SM. Fitted to
# the same sweeps: _LOAD to the headline's tiles and splits, _ONE_BLOCK to
# the Taper's (13, 13, 13) against its (10, 10, 10, 9).
_LOAD, _ONE_BLOCK = 1.78, 1.55
# The register steps (``reg_steps`` of cheb_tile.cuh, a kernel of their own
# that holds one block an SM) in the same units: a pass costs _REG_PASS a
# tile (its barriers and the latencies of its load and lift), _REG_LOAD a
# window cell of a plane, and each step _REG_STEP a slot of every warp that
# holds a run (every slot of a run is stepped, in the shrunk window or not).
# Fitted to a sweep on one H100 of every tile at one pass and at two and
# three passes of the headline, and the Taper's splits, on both steps
# (PERF.md §6; 7% rms).
_REG_PASS, _REG_LOAD, _REG_STEP = 30381.0, 1.410, 0.3890
# Each tile's ratio of the register steps' measured time to that model, the
# geometric mean over its plans of the same sweep (the tile's load pattern
# and its runs' lanes across run rows).
REG_TILES = {(32, 96): 0.995, (16, 128): 0.922, (48, 64): 1.016, (32, 64): 1.012,
             (16, 64): 0.96, (32, 32): 1.055, (16, 32): 1.021, (56, 56): 1.05,
             (40, 80): 1.006, (64, 48): 1.031}


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How a filter of ``sum(steps)`` steps runs as fused passes: tiles of
    ``tile = (by, bx)`` output cells, a halo of ``halo = max(steps)`` cells,
    one launch per entry of ``steps``. ``fused`` is the static predicate: where
    it is False (a field smaller than a tile plus its halo in either
    dimension) the step chain runs instead. ``paths``, where the planner gives
    them, say which steps each pass's launch runs ("registers" or "shared",
    the vector planner's :func:`~.vec_pass.vec_pass_path`); empty, the
    wrapper's own choice (the scalar tile's :func:`fused_path`) or shared
    memory."""

    tile: Tuple[int, int]
    halo: int
    steps: Tuple[int, ...]
    fused: bool
    paths: Tuple[str, ...] = ()


def fused_planes(ops: PassOperands) -> int:
    """Shared planes of a window: the two carries, every coefficient that is
    an array, ``post`` and ``pre``."""
    st = ops.stencil
    return 2 + sum(isinstance(getattr(st, k), Tensor) for k in COEF_FIELDS + ("post", "pre"))


def _mode(arrays: Tuple[bool, ...], zap: bool) -> int:
    """The compiled mode of a stencil whose c, n, s, e, w, pre, post are
    arrays where ``arrays`` says so."""
    coefs, (pre, post) = arrays[:5], arrays[5:]
    if not zap and not pre and post and coefs == (True, False, False, False, False):
        return HSPACE
    if zap and not pre and not post and all(coefs):
        return FLUX
    return GENERIC


def _arrays(st: ScalarStencil5) -> Tuple[bool, ...]:
    return (isinstance(st.c, Tensor), isinstance(st.n, Tensor), isinstance(st.s, Tensor),
            isinstance(st.e, Tensor), isinstance(st.w, Tensor), isinstance(st.pre, Tensor),
            isinstance(st.post, Tensor))


def fused_mode(st: ScalarStencil5) -> int:
    """The compiled mode that a hot stencil's launches take (``fused_mode`` of
    cheb_tile.cuh): HSPACE without zap and pre, with post and c the only
    array coefficient; FLUX with zap and all five, without pre and post;
    GENERIC otherwise."""
    return _mode(_arrays(st), bool(st.zap_nans))


def reg_pitch(wy: int, rows: int) -> int:
    """Rows a column of an exchange plane holds (``reg_pitch`` of
    cheb_tile.cuh): the window's run rows, made odd."""
    return -(-wy // rows) * rows | 1


def reg_fits(mode: int, itemsize: int, tile, halo: int, n_planes: int) -> bool:
    """Whether a pass of ``halo`` steps on ``tile`` takes the register steps
    (``reg_fits`` of cheb_tile.cuh): the mode has a run length R, the block's
    threads cover the window's ``ceil(wy / R) * wx`` runs, and the two
    exchange planes (``wx + 2`` columns of :func:`reg_pitch` rows) fit in the
    window's shared memory."""
    rows = REG_ROWS.get((mode, itemsize), 0)
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    words = fused_shared_bytes(tile, halo, n_planes, itemsize) // itemsize
    return (rows > 0 and -(-wy // rows) * wx <= FUSED_THREADS
            and 3 * (wx + 2) * reg_pitch(wy, rows) <= words)


@functools.lru_cache(maxsize=None)
def _path(arrays: Tuple[bool, ...], zap: bool, tile, n_ops: int, itemsize: int) -> str:
    shared, regs = pass_costs(tile, n_ops, 2 + sum(arrays), itemsize, _mode(arrays, zap))
    return "registers" if regs is not None and regs < shared else "shared"


def fused_path(st: ScalarStencil5, tile, n_ops: int, itemsize: int) -> str:
    """Which steps a launch of the scalar tile runs: "registers" where the
    pass can take them and the model (:func:`pass_costs`) finds them
    cheaper, else "shared" (``step_window``)."""
    return _path(_arrays(st), bool(st.zap_nans), tuple(tile), n_ops, itemsize)


def fused_shared_bytes(tile, halo: int, n_planes: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (``fused_shared_bytes`` of
    cheb_tile.cuh): ``n_planes`` window planes and acc of the own tile."""
    by, bx = tile
    return (n_planes * (by + 2 * halo) * (bx + 2 * halo) + by * bx) * itemsize


def _balanced(n_steps: int, cap: int) -> Tuple[int, ...]:
    """``ceil(n_steps / cap)`` near-equal passes (``plan_passes:426-430``)."""
    n_pass = -(-n_steps // cap)
    base, extra = divmod(n_steps, n_pass)
    return tuple(base + (1 if i < extra else 0) for i in range(n_pass))


def step_slots(wy: int, wx: int, j: int) -> int:
    """Lane slots that step j issues on a wy x wx window: its (strip,
    column) items, rows ``[j, wy-j)`` in strips of :data:`STRIP`, columns
    ``[j, wx-j)``, in whole rounds of the block's threads."""
    items = -(-(wy - 2 * j) // STRIP) * (wx - 2 * j)
    return -(-items // FUSED_THREADS) * FUSED_THREADS * STRIP


def reg_step_slots(wy: int, wx: int, rows: int) -> int:
    """Slots a step of the register steps issues on a wy x wx window: every
    slot of every warp that holds a run."""
    return -(-(-(-wy // rows) * wx) // 32) * 32 * rows


@functools.lru_cache(maxsize=None)
def pass_costs(tile, halo: int, n_planes: int, itemsize: int, mode: int):
    """Modelled cost of one pass of ``halo`` steps on ``tile`` in f32 lane
    slots: ``(shared, registers)``, the steps in shared memory (the window's
    load and every step's lane slots, scaled by the tile's measured factor,
    :data:`TILES`) and in registers (None where the pass cannot take them:
    :func:`reg_fits`)."""
    by, bx = tile
    wy, wx = by + 2 * halo, bx + 2 * halo
    slots = sum(step_slots(wy, wx, j) for j in range(1, halo + 1))
    two = (2 * (fused_shared_bytes(tile, halo, n_planes, itemsize) + 1024) <= SM_SHARED_BYTES
           and itemsize == 4 and n_planes == 4)
    shared = ((_LOAD * n_planes * wy * wx + slots * (1.0 if two else _ONE_BLOCK)) * itemsize / 4
              * TILES.get(tuple(tile), 1.0))
    if not reg_fits(mode, itemsize, tile, halo, n_planes):
        return shared, None
    rows = REG_ROWS[mode, itemsize]
    regs = ((_REG_PASS + _REG_LOAD * n_planes * wy * wx
             + _REG_STEP * halo * reg_step_slots(wy, wx, rows)) * REG_TILES.get(tuple(tile), 1.0))
    return shared, regs


def _pass_cost(tile, steps, n_planes: int, itemsize: int, registers: bool = True) -> float:
    """Modelled cost per own cell of a plan, in f32 lane slots: each pass on
    the cheaper of its steps (:func:`pass_costs`; with ``registers`` a
    stencil of four planes is taken for the h-space mode, whose f32 passes
    may take the register steps)."""
    by, bx = tile
    mode = HSPACE if n_planes == 4 and registers else GENERIC
    return sum(min(c for c in pass_costs(tuple(tile), s, n_planes, itemsize, mode)
                   if c is not None) for s in steps) / (by * bx)


def search_plan(n_steps: int, ny: int, nx: int, max_fuse: int, tiles, fits, cost,
                one_pass: bool = False, predicate=None) -> FusedPlan:
    """The cheapest plan: every balanced split of the steps into
    ``ceil(n_steps / cap)`` passes (``cap <= max_fuse``) on every tile of
    ``tiles`` for which ``fits(tile, halo)``, scored by ``cost(tile, steps)``;
    with ``one_pass`` only the split into one pass. Where nothing fits (one
    pass of more than :data:`MAX_FUSE` steps) the plan is not fused. The
    plan found is fused where ``predicate(tile, halo)`` holds, by default
    where an ``(ny, nx)`` field holds a tile plus its halo."""
    best = None
    for cap in range(1, min(max_fuse, MAX_FUSE, n_steps) + 1):
        steps = _balanced(n_steps, cap)
        halo = max(steps)
        if halo != cap or (one_pass and len(steps) > 1):
            continue  # the same split as a smaller cap, or more than one pass
        for tl in tiles:
            if not fits(tl, halo):
                continue
            c = cost(tl, steps)
            if best is None or c < best[0]:
                best = (c, tl, halo, steps)
    if best is None:
        return FusedPlan(tuple(next(iter(tiles))), n_steps, (n_steps,), False)
    _, tl, halo, steps = best
    if predicate is None:
        fused = ny >= tl[0] + 2 * halo and nx >= tl[1] + 2 * halo
    else:
        fused = predicate(tl, halo)
    return FusedPlan(tuple(tl), halo, steps, fused)


@functools.lru_cache(maxsize=None)
def _plan(n_steps: int, ny: int, nx: int, itemsize: int, n_planes: int, max_fuse: int,
          tile: Optional[Tuple[int, int]], one_pass: bool, ring: bool,
          registers: bool) -> FusedPlan:
    def fits(tl, halo):
        if ring and nx < tl[1] + 2 * halo:
            return False
        return fused_shared_bytes(tl, halo, n_planes, itemsize) <= SHARED_BYTES

    return search_plan(
        n_steps, ny, nx, max_fuse, (tile,) if tile else TILES, fits,
        lambda tl, steps: _pass_cost(tl, steps, n_planes, itemsize, registers), one_pass,
        (lambda tl, halo: ny >= halo) if ring else None)


def plan_fused_passes(n_steps: int, ny: int, nx: int, dtype: torch.dtype, n_planes: int,
                      max_fuse: int = MAX_FUSE, tile: Optional[Tuple[int, int]] = None,
                      one_pass: bool = False, ring: bool = False,
                      registers: bool = True) -> FusedPlan:
    """The fused plan of an ``n_steps`` filter on ``(ny, nx)`` fields: the
    counterpart of the JAX ``plan_passes``.

    Every split of the steps into ``ceil(n_steps / cap)`` balanced passes
    (``cap <= max_fuse``) and every tile of :data:`TILES` (or only ``tile``)
    whose window fits in a block's shared memory is scored by a cost model
    fitted to measured times (:func:`_pass_cost`); the cheapest wins. With
    ``one_pass`` (a round of the sharded engine) only the split into one pass
    is considered, and more than :data:`MAX_FUSE` steps plan no fused route.
    With ``ring`` the ``(ny, nx)`` field is a y-shard of the ring
    (parallel/ring.py), whose window rows past its edges come from the
    neighbours: only tiles whose window fits in ``nx`` are weighed, and the
    plan is fused where ``ny >= halo``. ``registers`` says whether the
    kernel that runs the plan has register steps, which the model then
    weighs: only K1 has them (the strip round's and the ring's runs would
    spill). The result depends on the
    shape, the dtype and ``n_planes`` (:func:`fused_planes`) only.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _plan(int(n_steps), int(ny), int(nx), itemsize, int(n_planes), int(max_fuse),
                 tuple(tile) if tile else None, bool(one_pass), bool(ring), bool(registers))


def _kinds(p, start: int, n_ops: int):
    """``(first, last)`` of the pass that runs steps ``start+1 .. start+n_ops``
    of a filter whose polynomial is ``p`` (``len(p) - 1`` steps)."""
    n_steps = len(p) - 1
    if n_steps < 2 or start < 0 or n_ops < 1 or start + n_ops > n_steps:
        raise ValueError(f"steps {start + 1}..{start + n_ops} of a {n_steps}-step filter")
    return start == 0, start + n_ops == n_steps


def cheb_fused_pass_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, tile=None,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """The plain PyTorch version of one fused launch, on any device: steps
    ``start+1 .. start+n_ops`` of the filter as a chain of
    :func:`cheb_pass_reference`, so the result equals the plain step chain
    exactly (``tile`` is not used).

    A first pass (``start == 0``) reads the raw ``field``; any other reads
    ``t``, ``t_prev`` and ``acc``. A pass that ends the filter reads ``field``
    and leaves the result in ``acc``; any other writes ``t_out``,
    ``t_prev_out`` and ``acc``. The inputs ``t`` and ``t_prev`` are not
    written.
    """
    first, last = _kinds(p, start, n_ops)
    if first:
        prev, cur = torch.empty_like(acc), torch.empty_like(acc)
        cheb_pass_reference(ops, FIRST, p[0], p[1], field=field, t_next=cur, acc=acc, h=prev)
        done = 1
    else:
        cur, prev = t.clone(), t_prev.clone()
        done = start
    for k in range(done + 1, start + n_ops + 1):
        if k == len(p) - 1:
            cheb_pass_reference(ops, LAST, p[k], field=field, t=cur, t_prev=prev, acc=acc)
        else:
            cheb_pass_reference(ops, MIDDLE, p[k], t=cur, t_prev=prev, t_next=prev, acc=acc)
            cur, prev = prev, cur
    if not last:
        t_out.copy_(cur)
        t_prev_out.copy_(prev)


def cheb_fused_pass_tiled_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, tile,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """One fused launch computed as the kernel decomposes it, in torch.

    For each ``tile = (by, bx)`` of output cells: gather a window of
    ``(by+2H) x (bx+2H)`` cells (``H = n_ops``; x periodic, y periodic or
    folded, the rows above the top row being mirror cells), run the steps on
    the window shrunk by j at step j, stepping a mirror cell as the real cell
    it mirrors (its own coefficients, its window neighbours in swapped roles:
    the real north is the window's south, the real east the window's west),
    and keep the own cells. Same arguments and outputs as
    :func:`cheb_fused_pass_reference`, and the same torch arithmetic per cell,
    so the two are equal bit for bit wherever the decomposition is right.
    """
    _, last = _kinds(p, start, n_ops)
    ny = acc.shape[-2]

    def rows(r):
        mirror = (r >= ny) if ops.stencil.fold_north else torch.zeros_like(r, dtype=torch.bool)
        return torch.where(mirror, 2 * ny - 1 - r, r) % ny, mirror

    outs = tiled_pass(ops, p, start, n_ops, tile, rows, field=field, field_own=field, t=t,
                      t_prev=t_prev, acc=acc)
    acc.copy_(outs["acc"])
    if not last:
        t_out.copy_(outs["t"])
        t_prev_out.copy_(outs["t_prev"])


def tile_windows(n_ty: int, n_tx: int, rows_r: Tensor, cols: Tensor, nx: int,
                 mirror: Optional[Tensor] = None) -> Tensor:
    """Every tile's window at once: ``(n_ty*n_tx, wy, wx)`` flat indices into
    an "in" plane of ``nx`` columns, from the in-plane rows of each tile row's
    window ``rows_r`` ``(n_ty, wy)`` and the columns of each tile column's
    window ``cols`` ``(n_tx, wx)``; a window row that is a mirror cell
    (``mirror``, like ``rows_r``) reads its columns reversed."""
    r = rows_r[:, None, :, None].expand(-1, n_tx, -1, 1)
    c = cols[None, :, None, :].expand(n_ty, -1, 1, -1)
    if mirror is not None:
        c = torch.where(mirror[:, None, :, None], nx - 1 - c, c)
    return (r * nx + c).reshape(n_ty * n_tx, rows_r.shape[-1], cols.shape[-1])


def to_tiles(x: Tensor, tile) -> Tensor:
    """``(..., ny, nx)`` -> ``(..., tiles, by, bx)``, tile rows first, zero
    past the field."""
    (by, bx), (ny, nx) = tile, x.shape[-2:]
    n_ty, n_tx = -(-ny // by), -(-nx // bx)
    xp = x.new_zeros(x.shape[:-2] + (n_ty * by, n_tx * bx))
    xp[..., :ny, :nx] = x
    xp = xp.reshape(x.shape[:-2] + (n_ty, by, n_tx, bx)).transpose(-3, -2)
    return xp.reshape(x.shape[:-2] + (n_ty * n_tx, by, bx))


def from_tiles(x: Tensor, shape) -> Tensor:
    """The inverse of :func:`to_tiles`: ``(..., tiles, by, bx)`` -> ``(...,
    ny, nx)``, the cells past the field dropped."""
    (by, bx), (ny, nx) = x.shape[-2:], shape
    n_ty, n_tx = -(-ny // by), -(-nx // bx)
    x = x.reshape(x.shape[:-3] + (n_ty, n_tx, by, bx)).transpose(-3, -2)
    return x.reshape(x.shape[:-4] + (n_ty * by, n_tx * bx))[..., :ny, :nx]


def tiled_pass(ops: PassOperands, p, start: int, n_ops: int, tile, rows, *,
               field: Optional[Tensor], field_own: Optional[Tensor], t: Optional[Tensor],
               t_prev: Optional[Tensor], acc: Tensor, cols=None, width: Optional[int] = None
               ) -> dict:
    """The kernel's tile decomposition of one fused pass, in torch, for any
    geometry: the own domain is ``acc``'s ``(batch, ny, nx)``; ``rows(r)``
    maps the window rows ``r`` (own coordinates, may lie outside) to the rows
    of the "in" planes (the stencil's planes, ``field``, ``t``, ``t_prev``)
    that hold them and says which are mirror cells; ``cols(q)`` maps the
    window columns to the columns of the "in" planes, ``width`` wide (by
    default x is periodic and the "in" planes are ``nx`` wide).
    ``field_own`` is the own-shaped raw field of a last pass. A state plane
    (``field``, ``t``, ``t_prev``) may also be a function of the windows'
    flat indices into an "in" plane that returns their values (a strip
    round's, which has no extended plane). Every tile's
    window is cut at once, a dimension of its own beside the batch, and the
    steps run on all of them together (every op is elementwise or a shift
    inside a window); the own cells of the ragged last tiles past the field
    are computed and dropped. Returns the own-shaped ``acc`` and, unless the
    pass ends the filter, ``t`` and ``t_prev``."""
    first, last = _kinds(p, start, n_ops)
    st = ops.stencil
    by, bx = tile
    H = n_ops
    ny, nx = acc.shape[-2:]
    dev = acc.device
    n_ty, n_tx = -(-ny // by), -(-nx // bx)
    wy, wx = by + 2 * H, bx + 2 * H
    src_r, mirror = rows(torch.arange(-H, by + H, device=dev)
                         + by * torch.arange(n_ty, device=dev)[:, None])
    q = torch.arange(-H, bx + H, device=dev) + bx * torch.arange(n_tx, device=dev)[:, None]
    idx = tile_windows(n_ty, n_tx, src_r, q % nx if cols is None else cols(q),
                       nx if width is None else width, mirror)
    # (tiles, wy): which window rows are mirror cells
    mirror = mirror[:, None, :].expand(-1, n_tx, -1).reshape(n_ty * n_tx, wy)
    flat = lambda x: x.reshape(x.shape[:-2] + (-1,))  # noqa: E731
    take = lambda x: (x(idx) if callable(x)  # noqa: E731
                      else flat(x)[..., idx] if isinstance(x, Tensor) else x)
    coef = {k: take(getattr(st, k)) for k in COEF_FIELDS}
    post, pre, area = take(st.post), take(st.pre), take(st.area)
    if first:
        # the kernel's window: the raw field in plane 0 and area in plane 1,
        # then T_0 in place from both and post; FIRST writes T_1 over plane 1
        cur = take(field)
        prev = area.expand_as(cur).clone() if area is not None else torch.empty_like(cur)
        if area is not None:
            cur = cur * prev
        if ops.drop_pre:
            cur = post * torch.nan_to_num(cur)
    else:
        cur, prev = take(t), take(t_prev)
    own = (Ellipsis, slice(H, H + by), slice(H, H + bx))
    a = None if first else to_tiles(acc, tile)
    for i in range(H):
        j = i + 1
        kind = FIRST if first and i == 0 else LAST if last and i == H - 1 else MIDDLE
        g = torch.nan_to_num(cur) if st.zap_nans else cur
        if pre is not None:
            g = pre * g
        win = lambda x, dy=0, dx=0: (  # noqa: E731
            x[..., j + dy:wy - j + dy, j + dx:wx - j + dx] if isinstance(x, Tensor) else x)
        mir = mirror[:, j:wy - j, None]
        north, south, east, west = win(g, 1), win(g, -1), win(g, 0, 1), win(g, 0, -1)
        lap = (win(coef["c"]) * win(g) + win(coef["n"]) * torch.where(mir, south, north)
               + win(coef["s"]) * torch.where(mir, north, south)
               + win(coef["e"]) * torch.where(mir, west, east)
               + win(coef["w"]) * torch.where(mir, east, west))
        if post is not None:
            lap = win(post) * lap
        sl = (Ellipsis, slice(j, wy - j), slice(j, wx - j))
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
            continue
        fb = to_tiles(field_own, tile)
        if area is not None:
            fb = fb * area[own]
        if ops.drop_pre:
            a = torch.where(post[own] == 0, ops.land_gain * fb, a + fb * 0.0)
        if area is not None:
            a = a / area[own]
    outs = {"acc": from_tiles(a, (ny, nx))}
    if not last:
        outs["t"], outs["t_prev"] = from_tiles(cur[own], (ny, nx)), from_tiles(prev[own], (ny, nx))
    return outs


_FUSED_KERNEL = Kernel("cheb_pass", "cheb_fused_pass", (
    [ctypes.c_int] * 8            # batch, ny, nx, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 12      # field, t, t_prev, acc_in, t_out, t_prev_out, acc_out, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double]           # land_gain
    + [ctypes.c_int] * 4          # zap, fold, drop_pre, regs
    + [ctypes.c_void_p]           # stream
))


def _pass_args(p, start, n_ops, first, bufs, required):
    """The host array of p_a for the pass's steps, p_b, and a check that the
    pass got the buffers it needs."""
    for name in required:
        if bufs[name] is None:
            raise ValueError(f"this fused pass needs {name}")
    pa = [p[0] if first and i == 0 else p[start + i + 1] for i in range(n_ops)]
    return (ctypes.c_double * MAX_FUSE)(*pa), float(p[1]) if first else 0.0


def check_shared(bytes_: int, tile, n_ops: int) -> None:
    """Raise unless a block's window of ``bytes_`` fits in its shared memory."""
    if bytes_ > SHARED_BYTES:
        raise ValueError(f"tile {tile} with a halo of {n_ops} does not fit in shared memory")


def _fused_launch(ops, p, start, n_ops, tile, bufs, path) -> None:
    first, last = _kinds(p, start, n_ops)
    if n_ops > MAX_FUSE:
        raise ValueError(f"a fused pass runs at most {MAX_FUSE} steps, got {n_ops}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 3:
        raise ValueError(f"cheb_fused_pass takes (batch, ny, nx) carries, got {tuple(acc.shape)}")
    batch, ny, nx = acc.shape
    by, bx = tile
    check_grid(batch, ny, by, "shape", acc.shape)
    st = ops.stencil
    check_shared(fused_shared_bytes(tile, n_ops, fused_planes(ops), acc.element_size()), tile,
                 n_ops)
    required = ("acc",) + (("field",) if first or last else ()) + (
        () if first else ("t", "t_prev")) + (() if last else ("t_out", "t_prev_out"))
    pa, p_b = _pass_args(p, start, n_ops, first, bufs, required)
    if not last and any(bufs[o] is not None and bufs[o].data_ptr() == bufs[i].data_ptr()
                        for o in ("t_out", "t_prev_out") for i in ("t", "t_prev")
                        if bufs[i] is not None):
        raise ValueError("t_out and t_prev_out must not alias t or t_prev")
    ptr = {k: pointer(k, bufs[k], acc.shape, device, dtype) if k in required else None
           for k in ("field", "t", "t_prev", "t_out", "t_prev_out", "acc")}
    coef_ptr, coef_val, masks = coefficient_args(st, (ny, nx), device, dtype)
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")
    _FUSED_KERNEL(device, dtype, batch, ny, nx, by, bx, n_ops, int(first), int(last), pa, p_b,
                  ptr["field"], ptr["t"], ptr["t_prev"], ptr["acc"], ptr["t_out"],
                  ptr["t_prev_out"], ptr["acc"], *coef_ptr, *coef_val, *masks,
                  float(ops.land_gain), int(st.zap_nans), int(st.fold_north),
                  int(ops.drop_pre), int(path == "registers"), detail=path)


def cheb_fused_pass(
    ops: PassOperands, p, start: int, n_ops: int, *, tile,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """Steps ``start+1 .. start+n_ops`` of the filter in one launch, on tiles
    of ``tile = (by, bx)`` cells, as :func:`cheb_fused_pass_reference`
    documents them.

    CUDA tensors launch the kernel on the current stream, without
    synchronizing; the launch runs the steps that :func:`fused_path` picks,
    is counted under ``("cheb_fused_pass", path)`` in
    :func:`~.launch.launch_counts` and carries ``path=`` on its
    ``gft.launch`` span. CPU tensors run the plain version. On both, the
    span carries ``steps=n_ops``. Anything else raises.
    """
    bufs = dict(field=field, t=t, t_prev=t_prev, t_out=t_out, t_prev_out=t_prev_out, acc=acc)
    path = fused_path(ops.stencil, tile, n_ops, acc.element_size()) if acc.is_cuda else None
    with route("cheb_fused_pass", acc.device, path, n_ops) as card:
        if card:
            _fused_launch(ops, p, start, n_ops, tuple(tile), bufs, path)
        else:
            cheb_fused_pass_reference(ops, p, start, n_ops, **bufs)
