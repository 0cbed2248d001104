#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and check them on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and nvcc.
It imports only ``gcm_filters_tpu_torch`` (never JAX or ``gcm_filters_tpu``)
and runs these phases; any failed check raises and the script exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compiles ``gcm_filters_tpu_torch/csrc/*.cu`` (one nvcc per source,
   all at once), prints every kernel's ``ptxas -v`` lines and holds them to
   the record of this tree, ``gcm_filters_tpu_torch/csrc/ptxas_lines.json``
   (where the same nvcc release built it): the scalar tile's kernels apart,
   every other kernel with the lines it had before the tile was redesigned;
3. small grids: all 9 scalar grids at 128x256 in float32 and float64, with
   the Gaussian and the Taper filter (several fused passes), plus
   ``exact_nan``, a 97x300 shape, a batch, NaN fields, a spike on the fold
   row at a tile seam, and a shape below the fused plan's predicate, each
   through ``Filter(device="cuda").apply``: against the same dispatch driven
   by the plain versions (``cheb_fused_pass_reference``,
   ``cheb_pass_reference``) on the card, against the chain of step-kernel
   launches bit for bit (NaNs in the same cells), and against the tiled
   plain version of the fused pass; each apply must launch the fused kernel
   once per planned pass (or, below the predicate, the step kernel n_steps
   times) and no other kernel; then, on a ragged 396x601 fold grid with a
   batch of two, a first pass and a middle pass into NaN-filled t_out,
   t_prev_out and acc (an own cell that a launch skipped would keep the
   sentinel), each bitwise equal to the step-kernel chain;
4. scalar headline (the scalar path): the ``bench.py`` workload, 2400x3600
   float32 TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED, Gaussian factor 10
   (11 steps), through ``Filter.apply`` on the card, checked against the
   eager engine in float64 and against the step-kernel chain bit for bit,
   and timed with CUDA events beside the step chain; the fused launch
   counter must equal passes x applies, every other counter 0, and no
   fallback may be recorded; then the fused plan's tile sweep (each tile
   with its best split, timed, in float32 and float64) and two more
   headlines on the same footing: the Taper filter (factor 10, several
   passes) on the same grid, swept at 3, 4 and 5 passes (the TPU planner's
   (13, 13, 13) among them), and IRREGULAR_WITH_LAND (five coefficient
   planes), swept at every tile;
5. each step kind of the scalar step kernel, and the fused pass, against its
   plain version at the headline shape;
6. small vector grids: VECTOR_B_GRID and VECTOR_C_GRID at 128x256 through
   ``Filter(device="cuda").apply_to_vector``: unit-scale metrics in float32
   and float64 (C-grid at kappa_aniso 1 and 0) with the Gaussian and (not
   on the amplifying kappa_aniso 1) the Taper filter (several fused
   passes), the spherical metrics in float64, 97x300, a batch, NaN fields with a NaN at a tile corner,
   spikes at a tile corner (which the C-grid's diagonal taps reach) and
   across the periodic seams, a C-grid operator with ``zap_nans=False`` and
   a shape below the fused plan's predicate: each against the same dispatch
   driven by the plain versions (``vec_fused_pass_reference``,
   ``vec_pass_reference``) on the card, against the chain of step-kernel
   launches bit for bit (NaNs in the same cells), and against the tiled
   plain version of the fused pass;
   each apply must launch the fused kernel once per planned pass (or, below
   the predicate, the step kernel n_steps times) and no other kernel; then a
   first pass into NaN-filled outputs on a batch of two 397x601 fields, on
   the planned tile, bitwise equal to the step-kernel chain;
7. vector headlines (the vector path): both grids at 2400x3600 float32,
   Gaussian factor 10 (11 steps), unit-scale metrics (C-grid at
   kappa_aniso 0), each checked against the float64 eager engine and against
   the step-kernel chain bit for bit, and timed beside the step chain, with
   launches = passes x applies, every other counter 0 and no fallback; then
   each grid's tile sweep (every tile at every split, timed, bitwise equal;
   the same for the 44-step Taper in float32), on the C-grid the Taper
   filter (several passes), and the
   route: the fused plan beside the step chain, bitwise equal, timed on the
   float64 headline and at 128x256 in float32 and float64;
8. each step kind of both vector step kernels, and the fused passes in
   float32 and float64, against their plain versions at the headline shape;
9. sharded small grids: a one-rank NCCL process group and a 1x1
   ``DeviceMesh``; all 9 scalar grids at 128x256 in float32 and float64, plus
   ``exact_nan``, 97x300, a batch, NaN fields, ``halo_steps`` 1, 3 and None
   and a block below the fused predicate, each through
   ``Filter(mesh=..., spatial_axes=("y", "x")).apply`` against the same
   sharded apply driven by the plain versions (``local_strip_pass_reference``,
   ``local_pass_reference``) on the card, against the chain of local
   step-kernel launches bit for bit, and against the unsharded
   ``Filter.apply``; each apply must launch the round on strips
   (``local_strip_pass``) once per round (below the predicate: the local
   step kernel n_steps times) and no other kernel; then a middle round on
   the ragged 396x601 fold grid, batch two, on strips (the cores read in
   place from extended carries), into NaN-filled t_out and t_prev_out,
   bitwise equal to the local step-kernel chain on the same inputs;
10. sharded headline (the sharded path): the phase-4 workload through the
    mesh path, checked against the float64 eager engine and against the
    local step chain bit for bit, and timed beside it, with one strip
    launch per round x applies and no fallback; its parts timed alone
    (``utils/round_split.py``: the strips, the rounds with their strips
    frozen, the parent's halo exchange), the round on strips alone against
    its plain version, and the chain of 11 local steps alone; then (10b)
    the Taper (39 steps, several rounds whose later strips come from the
    carries' cores) through the mesh, bit for bit equal to the local step
    chain, its launches counted, timed with its parts;
11. each step kind of the local step kernel against its plain version at the
    headline's extended shape;
12. sharded small vector grids, on the same 1x1 mesh: both vector grids at
    128x256 in float32 and float64 (C-grid at kappa_aniso 1 and 0), the
    spherical metrics in float64, 97x300, a batch, NaN fields with a NaN at
    core corners, spikes at the four core corners (which the C-grid's
    diagonal taps reach through the halo corners), a C-grid operator with
    ``zap_nans=False``, ``halo_steps`` 1, 3 and None, the Taper filter and a
    block below the fused predicate, each through ``Filter(mesh=...,
    spatial_axes=("y", "x")).apply_to_vector`` against the same sharded apply
    driven by the plain versions (``vec_local_fused_pass_reference``,
    ``vec_local_pass_reference``) on the card, against the chain of local
    step-kernel launches bit for bit (NaNs in the same cells), against the
    tiled plain version of the fused round, and against the unsharded
    ``apply_to_vector``; each apply must launch the strip entry of its grid
    once per round (the round's first launch, on u and v or the carries'
    cores and their halo strips) and the extended-block entry once per later
    launch of its rounds (below the predicate: the windowed local step
    kernel n_steps times) and no other kernel;
13. sharded vector headlines (the sharded vector path): the phase-7 B-grid
    and C-grid workloads through the mesh path, checked against the float64
    eager engine, bit for bit against the fused unsharded result and against
    the local step-kernel chain, and timed beside both, with one strip
    launch and the round's other planned launches x applies, every other
    counter (the windowed local step's too) 0 and no fallback; the apply's
    parts timed alone (``utils/round_split.py``: the strips, the rounds with
    their strips frozen, and the parent's stack and halo exchange), the
    round on strips bit for bit equal to the parent's round on the extended
    block (also timed), its first launch alone against its plain version and
    beside the parent's first launch, and the chain of 11 local steps alone;
    then the round sweep on strips: every tile at one launch per round
    (split (a)) and at balanced splits into several launches (split (b)), in
    float32 and float64, each bitwise equal to the planned round and timed;
    then (13c) the C-grid Taper (44 steps, three rounds whose later strips
    come from the carries' cores) through the mesh, bit for bit equal to the
    unsharded Taper, its launches counted, timed with its parts;
14. each step kind of both windowed local vector kernels, and the fused round
    in float32 and float64 (the planned round and one launch of 11 steps,
    every launch's outputs first filled with NaN), on the extended block and
    on strips, against its plain version at the headlines' extended shape,
    the round on strips bit for bit equal to the one on the extended block;
15. ring small grids: the cases of tests/test_ring.py in float32 (REGULAR,
    also with 37 steps; IRREGULAR_WITH_LAND; both tripolar grids; ``exact_nan``
    with a wet NaN; ``nx = 250``; one-row shards; B-grid; C-grid at
    kappa_aniso 0 and 1 and with 37 steps, the vector fields with a NaN and
    spikes at shard-edge tile corners; both vector grids at ``nx = 250``;
    one-row vector shards) through
    ``Filter(mesh=ResidentMesh(p_y, "cuda"), spatial_axes=("y", None))`` at
    ``p_y`` 2, 4 and 8: several y-shards resident on the one card, whose
    kernels exchange the halo rows themselves. Each result must equal the
    unsharded kernel path and the step ring (``fused_fn=None``) bit for bit,
    and agree with the same ring apply driven by the plain versions on the
    card; each apply must launch its fused ring kernel (``ring_fused_pass``,
    ``vec_ring_fused_pass``) once per planned pass (the step ring kernel
    n_steps times where the plan is not fused: one-row shards), and no other
    kernel; then the fused scalar ring on the ragged 396x601 fold grid at
    ``p_y`` 4, a first, a middle and a last pass with acc and each pass's
    carry pair out NaN-filled first, the own rows after the first two and the
    result bitwise equal to the step-kernel chain;
16. ring headlines (the ring path): the phase-4 workload at ``p_y`` 4, 2 and
    8, the Taper filter and ``IRREGULAR_WITH_LAND`` at ``p_y`` 4, each through
    the fused ring, bitwise equal to the fused K1 and to the step ring of this
    run and timed beside both, and split (``utils/ring_split.py``: its passes
    alone and the copies around them, beside K1's launches alone); at each
    ``p_y`` 24 applies alternating two inputs, each bitwise equal to the
    fused K1 of its own input; then 200 more fused scalar applies, each
    bitwise equal to the first; the phase-7 workloads through the fused
    vector ring (B-grid at ``p_y`` 4, 2 and 8, C-grid and its Taper at 4),
    each bitwise equal to the fused K3 / K4 and to the vector step ring of
    this run and timed beside both, then 50 more B-grid applies, each bitwise
    equal to the first; all checked against the float64 eager engine, with
    launches = the plan's passes x applies, every other counter 0 and no
    fallback; each vector ring headline also timed as its fused launches
    alone and the copies around them alone, beside the fused K3 / K4
    launches alone (the split of ``utils/ring_split.py``); then, at ``p_y``
    4 on both grids, 24 applies alternating two inputs, each bitwise equal to
    the fused K3 / K4 of its own input (a halo row read stale would show);
17. each step kind of the three ring step kernels, and each pass kind of the
    fused scalar and vector rings (first only, middle, last, first and last;
    the vector ring's first pass into NaN-filled outputs) against its plain
    and tiled plain versions, at the headline shape, in float32 and float64;
    then the fused vector ring's blocks where tiles are shorter than the
    halo: one 5-step pass on 4x16 tiles of a 48x250 field, at ``p_y`` 2
    (two interior tile rows a shard, by block index, and two edge rows a
    side, by ticket) and 4 (every tile an edge tile), bitwise equal to the
    step ring and against the tiled plain version;
18. the user-facing paths (``user_paths``), at full width, 2400x3600
    float32 from numpy seeds, each with every launch counter and the
    fallback counters at 0 just before it and read just after:
    (a) ``Filter.apply_streamed`` of 32 snapshots of the phase-4 headline
    (land NaN and a wet NaN) in chunks of 16, and of a (2, 4) lead in chunks
    of 3, of the first 5 as float64 in chunks of 3 and from a memory-mapped
    file in chunks of 2: each snapshot bitwise equal to ``Filter.apply`` of
    it alone, the first call's result read after the second call, one fused
    launch per chunk per planned pass, every chunk's copies through
    page-locked memory (``pinned=`` equal to ``bytes=`` on its spans); ms per
    snapshot end to end and, for one chunk moved as the loop moves it, the
    host's staging copy by the host clock and host->device, kernels and
    device->host by CUDA events;
    (b) ``apply_to_vector_streamed`` of 16 (u, v) pairs in chunks of 8 on
    the phase-7 B-grid and C-grid headlines, the same checks and numbers;
    (c) a batch of 8 ``IRREGULAR_WITH_LAND`` fields (the flux form, on the
    satellite example's lat/lon metrics) in one call, bitwise equal entry by
    entry to the batch-1 applies, timed both ways; (d) ``Filter.apply`` of a
    dict of ``(array, dims)`` pairs with a non-spatial entry; (e) the
    headline's ``ScalarStencil5`` as ``custom_operator`` (the fused kernel,
    bitwise equal to the grid path) and a free-form protocol operator (plain
    torch on the card, no kernel launched, against the float64 eager engine);
    (f) ``utils/profiling.trace`` around one headline apply, whose
    ``trace.json`` must name ``fused_pass_kernel``; (g) every
    ``examples/torch_*.py`` through ``main(device="cuda")`` at its own size,
    with the checks it prints held (variance drops, land NaN and ocean
    finite, the ring and the sharded paths equal to the single-device
    filter), and the kernels each launched; then a ``{"user_paths": ...}``
    line of these numbers;
19. a ``{"kernels": [...]}`` line (twenty entries: the step kernels, timed
    as step chains, the fused passes and rounds, the scalar round on strips
    timed per apply, and the two strip entries of the sharded vector round,
    timed as one launch), then ``{"ok": true, "device": ...}`` last.

Without a CUDA device it prints no result and exits 2. With
``--write-ptxas-record PATH`` it stops after phase 2 and writes the build's
``ptxas -v`` lines there as the record that phase 2 holds later builds to.
"""
import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# The bounds (``bound_ms``) use the published H100 SXM peaks kept in
# gcm_filters_tpu_torch/utils/profiling.py.
# Floating-point operations one step does per cell: 5 multiplies and 4 adds
# for the contraction, 1 post multiply, 3 for the recurrence, 2 for the sum.
FLOPS_PER_CELL_STEP = 15

# Per cell and step of a vector kernel: B-grid, four 5-point contractions (9
# each) and 2 adds; C-grid, two 9-tap contractions (17 each); both, 5 for the
# recurrence and the sum of each component.
VEC_FLOPS_PER_CELL_STEP = {"bgrid": 48, "ctap": 44}

TOL = {"float64": dict(rtol=1e-12, atol=1e-14), "float32": dict(rtol=2e-5, atol=2e-6)}


def log(*a):
    print(*a, flush=True)


def mask_data(shape):
    m = np.ones(shape)
    ny, nx = shape
    m[0, :] = 0  # "Antarctica" land row, required by the tripolar grids
    m[: ny // 2, : nx // 2] = 0  # quarter-domain island
    return m


def irregular(shape, seed):
    return 0.9 + 0.2 * np.random.Generator(np.random.PCG64(seed)).random(shape)


def scalar_grid_data(grid_type, names, shape):
    """Grid variables made from numpy seeds, as tests/conftest.py makes them."""
    data = np.random.Generator(np.random.PCG64(100)).random(shape)
    gv = {}
    seed = 0
    for seed, name in enumerate(names):
        if name == "wet_mask":
            gv[name] = mask_data(shape)
        elif "kappa" in name:
            gv[name] = np.ones(shape)
        else:
            gv[name] = irregular(shape, seed)
    if grid_type.name == "TRIPOLAR_POP_WITH_LAND":
        nx = shape[1]
        for name in names:
            if name in ("dxn", "dyn"):
                seed += 1
                g = irregular(shape, seed)
                g[-1, nx // 2:] = g[-1, : nx // 2][::-1]
                gv[name] = g
    return data, gv


def compare(label, got, want, dtype_name):
    import torch

    tol = TOL[dtype_name]
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{label}: NaN positions differ")
    torch.testing.assert_close(got, want, equal_nan=True, **tol, msg=lambda m: f"{label}: {m}")
    ok = ~torch.isnan(want)
    diff = (got[ok] - want[ok]).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / want[ok].abs().clamp_min(1e-300)).max()) if diff.numel() else 0.0
    return abs_err, rel_err


def step_bytes(kind, ops, batch, ny, nx, itemsize):
    """Bytes one launch must move: each input read once, each output written once."""
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, MIDDLE

    st = ops.stencil
    plane = ny * nx * itemsize
    coefs = sum(1 for k in ("c", "n", "s", "e", "w") if not isinstance(getattr(st, k), float))
    masks = {k: getattr(st, k) is not None for k in ("pre", "post", "area")}
    static = coefs + masks["pre"] + masks["post"]
    if kind == FIRST:  # field, area in; h, T1, acc out
        return (static + masks["area"]) * plane + 4 * batch * plane
    if kind == MIDDLE:  # t, t_prev, acc in; t_next, acc out
        return static * plane + 5 * batch * plane
    return (static + masks["area"]) * plane + 5 * batch * plane  # t, t_prev, acc, field in; acc out


def local_step_bytes(kind, ops, batch, ly, lx, cells, shrink, itemsize):
    """Bytes one launch of the local step must move on its shrinking windows:
    each input read once where the step reads it, each output written once.
    ``win(s)`` is the extended block shrunk by s cells; the core is win(cells)."""
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, MIDDLE

    st = ops.stencil
    win = lambda s: (ly + 2 * (cells - s)) * (lx + 2 * (cells - s))  # noqa: E731
    core = ly * lx
    coefs = sum(1 for k in ("c", "n", "s", "e", "w") if not isinstance(getattr(st, k), float))
    has = {k: getattr(st, k) is not None for k in ("pre", "post", "area")}
    if kind == FIRST:
        # field, area, pre and post on the whole block; h out on the whole
        # block, T1 on win(1), acc on the core
        static = (has["area"] + has["pre"] + has["post"]) * win(0) + coefs * win(1)
        carries = 2 * win(0) + win(1) + core
    elif kind == MIDDLE:
        # t on win(shrink-1), t_prev on win(shrink), acc on the core in;
        # t_next on win(shrink), acc on the core out
        static = (coefs + has["post"]) * win(shrink) + has["pre"] * win(shrink - 1)
        carries = win(shrink - 1) + 2 * win(shrink) + 2 * core
    else:
        # t on win(cells-1); t_prev, acc and (h-space) the raw field on the
        # core in; the result on the core out
        static = (coefs + has["post"] + has["area"]) * core + has["pre"] * win(cells - 1)
        carries = win(cells - 1) + (3 + ops.drop_pre) * core
    return (static + batch * carries) * itemsize


def plan_cost(ops, plan, batch, ny, nx, itemsize):
    """``(bytes, flops)`` of one apply as a fused plan runs it: each pass reads
    its inputs once and writes its outputs once (the first pass the field, a
    later one t, t_prev and acc, the last one the field again; the array
    coefficients, pre and post on every pass, area on the first and the
    last), and computes every cell of its shrinking windows, the trapezoid's
    redundant cells included."""
    import torch

    st = ops.stencil
    plane = ny * nx * itemsize
    static = sum(1 for k in ("c", "n", "s", "e", "w", "pre", "post")
                 if isinstance(getattr(st, k), torch.Tensor))
    area = int(st.area is not None)
    by, bx = plan.tile
    tiles = math.ceil(ny / by) * math.ceil(nx / bx)
    nbytes = cells = 0
    for i, s in enumerate(plan.steps):
        first, last = i == 0, i == len(plan.steps) - 1
        carries = (1 if first else 3) + (1 if last and not first else 0) + (1 if last else 3)
        nbytes += (static + area * (first or last) + batch * carries) * plane
        cells += tiles * sum((by + 2 * s - 2 * j) * (bx + 2 * s - 2 * j) for j in range(1, s + 1))
    return nbytes, FLOPS_PER_CELL_STEP * batch * cells


def ring_plan_cost(ops, plan, p_y, ny, nx, itemsize):
    """``(bytes, flops)`` of one fused ring apply: each shard's passes as
    :func:`plan_cost` counts them on its ``ny/p_y`` rows, plus every pass's
    2 p_y sends, each of H rows of the live fields (the field on the first
    pass, t and t_prev after) read once and written once."""
    nbytes, flops = plan_cost(ops, plan, 1, ny // p_y, nx, itemsize)
    sends = sum(2 * p_y * (1 if i == 0 else 2) * s * nx * itemsize * 2
                for i, s in enumerate(plan.steps))
    return p_y * nbytes + sends, p_y * flops


def vec_ring_plan_cost(n_coef, plan, p_y, ny, nx, itemsize, key):
    """``(bytes, flops)`` of one fused vector ring apply: each shard's passes
    as :func:`vec_plan_cost` counts them on its ``ny/p_y`` rows, plus every
    pass's 2 p_y sends, each of H rows of both components of the live fields
    (w on the first pass, t and t_prev after) read once and written once."""
    nbytes, flops = vec_plan_cost(n_coef, plan, 1, ny // p_y, nx, itemsize, key)
    sends = sum(2 * p_y * 2 * (1 if i == 0 else 2) * s * nx * itemsize * 2
                for i, s in enumerate(plan.steps))
    return p_y * nbytes + sends, p_y * flops


def spherical_vector_grid_vars(names, shape):
    """The spherical lat/lon construction of tests/conftest.py
    (make_vector_grid_data), rebuilt here: that file imports JAX."""
    ny, nx = shape
    lat_cu = np.linspace(-70 + 0.5 * 140 / ny, 70 - 0.5 * 140 / ny, ny)
    lat_cv = np.linspace(-70 + 140 / ny, 70, ny)
    _, geolat_cu = np.meshgrid(np.linspace(60 / nx, 60, nx), lat_cu)
    _, geolat_cv = np.meshgrid(np.linspace(0.5 * 60 / nx, 60 - 0.5 * 60 / nx, nx), lat_cv)
    r = 6378000.0
    gv, dy = {}, None
    for name in names:
        if name in ("dxCu", "dxT", "HUS", "HTE"):
            gv[name] = r * np.cos(geolat_cu / 360 * 2 * np.pi)
            dy = np.max(gv[name]) * np.ones((ny, nx))
        if name in ("dxCv", "dxBu", "DXU", "HUW", "HTN"):
            gv[name] = r * np.cos(geolat_cv / 360 * 2 * np.pi)
    for name in names:
        if name in ("dyCu", "dyCv", "dyBu", "dyT", "DYU"):
            gv[name] = dy
    areas = {"area_u": ("dxCu", "dyCu"), "area_v": ("dxCv", "dyCv"),
             "UAREA": ("DXU", "DYU"), "TAREA": ("HTE", "DYU")}
    for name in names:
        if name in areas:
            gv[name] = gv[areas[name][0]] * gv[areas[name][1]]
        elif name in ("kappa_iso", "kappa_aniso"):
            gv[name] = np.ones((ny, nx))
    mask = np.ones((ny, nx))
    mask[: ny // 2, : nx // 2] = 0
    for name in ("wet_mask_t", "wet_mask_q"):
        if name in names:
            gv[name] = mask
    return gv


def vec_step_bytes(kind, n_coef, batch, ny, nx, itemsize):
    """Bytes one vector launch must move: the coefficient planes, and 2
    planes (u and v) per batch entry for each carry read or written."""
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, MIDDLE

    carries = 6 if kind == FIRST else 10 if kind == MIDDLE else 8
    return (n_coef + carries * batch) * ny * nx * itemsize


def vec_local_step_bytes(kind, n_coef, batch, ly, lx, cells, shrink, itemsize):
    """Bytes one launch of the windowed local vector step must move on its
    shrinking windows: the coefficient planes on the step's window, and 2
    planes (u and v) per batch entry for each carry where the step reads or
    writes it. ``win(s)`` is the extended block shrunk by s cells; the core is
    win(cells)."""
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, MIDDLE

    win = lambda s: (ly + 2 * (cells - s)) * (lx + 2 * (cells - s))  # noqa: E731
    core = ly * lx
    if kind == FIRST:
        # the extended input on the whole block in; T1 on win(1), acc on the core out
        static, carries = n_coef * win(1), win(0) + win(1) + core
    elif kind == MIDDLE:
        # t on win(shrink-1), t_prev on win(shrink), acc on the core in;
        # t_next on win(shrink), acc on the core out
        static, carries = n_coef * win(shrink), win(shrink - 1) + 2 * win(shrink) + 2 * core
    else:
        # t on win(cells-1), t_prev and acc on the core in; the result on the core out
        static, carries = n_coef * core, win(cells - 1) + 3 * core
    return (static + 2 * batch * carries) * itemsize


def vec_plan_cost(n_coef, plan, batch, ny, nx, itemsize, key):
    """``(bytes, flops)`` of one apply as a fused vector plan runs it: each
    pass reads the coefficient planes and its state once (the first pass w,
    a later one t, t_prev and acc, 2 planes each) and writes its state once
    (t, t_prev and acc; the last pass acc only), and computes every cell of
    its shrinking windows, the trapezoid's redundant cells included."""
    by, bx = plan.tile
    tiles = math.ceil(ny / by) * math.ceil(nx / bx)
    nbytes = cells = 0
    for i, s in enumerate(plan.steps):
        state = (1 if i == 0 else 3) + (1 if i == len(plan.steps) - 1 else 3)
        nbytes += (n_coef + 2 * batch * state) * ny * nx * itemsize
        cells += tiles * sum((by + 2 * s - 2 * j) * (bx + 2 * s - 2 * j) for j in range(1, s + 1))
    return nbytes, VEC_FLOPS_PER_CELL_STEP[key] * batch * cells


def vec_launch_cost(n_coef, tile, n, s, first, last, batch, ly, lx, cells, itemsize, key):
    """``(bytes, flops)`` of one fused launch of the sharded vector engine
    that runs ``n`` steps and ends on the block shrunk by ``s``: it reads the
    coefficient planes and its state (the filter's first launch u and v, any
    other t and t_prev, 2 planes each, and acc on the core) where its
    windows reach, on the block shrunk by s - n, and writes its state once
    (t and t_prev on the block shrunk by s and acc; the filter's last launch
    acc only), and computes every cell of its tiles' shrinking windows, the
    redundant cells included. Where the state comes from (an extended block
    or the core and its strips) moves no byte."""
    win = lambda s_: (ly + 2 * (cells - s_)) * (lx + 2 * (cells - s_))  # noqa: E731
    by, bx = tile
    state_in = 2 * win(s - n) if first else 4 * win(s - n) + 2 * ly * lx
    state_out = 2 * ly * lx if last else 4 * win(s) + 2 * ly * lx
    nbytes = (n_coef * win(s - n) + batch * (state_in + state_out)) * itemsize
    tiles = math.ceil((ly + 2 * (cells - s)) / by) * math.ceil((lx + 2 * (cells - s)) / bx)
    ncells = tiles * sum((by + 2 * n - 2 * j) * (bx + 2 * n - 2 * j) for j in range(1, n + 1))
    return nbytes, VEC_FLOPS_PER_CELL_STEP[key] * batch * ncells


def vec_rounds_cost(n_coef, plans, batch, ly, lx, cells, itemsize, key):
    """``(bytes, flops)`` of a filter as the sharded vector engine's rounds
    run it, one fused plan a round: the sum of :func:`vec_launch_cost` over
    every launch of every round."""
    n_steps = sum(sum(pl.steps) for pl in plans)
    nbytes = flops = done = 0
    for pl in plans:
        left = sum(pl.steps)
        for n in pl.steps:
            left -= n
            b, f = vec_launch_cost(n_coef, pl.tile, n, cells - left, done == 0,
                                   done + n == n_steps, batch, ly, lx, cells, itemsize, key)
            nbytes, flops, done = nbytes + b, flops + f, done + n
    return nbytes, flops


# Each kernel's ``ptxas -v`` lines as this tree builds them, with the nvcc
# release that printed them (write_ptxas_record); the kernels of the scalar
# tile (csrc/cheb_tile.cuh: the fused K1 and K2 kernels, the K2 strip round
# and the fused scalar ring) are named apart.
PTXAS_RECORD = Path(__file__).resolve().parent / "gcm_filters_tpu_torch/csrc/ptxas_lines.json"
SCALAR_TILE_KERNEL = re.compile(r"(?:used_pass_kernel|(?<!vec_)ring_fused_kernel|local_strip_kernel)I")


def ptxas_lines(logs):
    """``{"source:kernel": [lines]}`` from nvcc's build logs: each kernel's
    stack and spill line and its register line, the kernel named without the
    per-build hash of its anonymous namespace."""
    out, fn = {}, None
    for src, text in logs.items():
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = src + ":" + re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+",
                                        r"_ANON_\1", m.group(1))
                out[fn] = []
            elif fn and ("spill" in line or "registers" in line):
                out[fn].append(re.sub(r"^.*?(\d+ bytes stack|Used)", r"\1", line.strip()))
    return out


def nvcc_release(build):
    """The release of the nvcc that builds the kernels, as ``nvcc --version``
    names it (e.g. ``12.8.93``)."""
    version = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    release = re.search(r"release [\d.]+, V([\d.]+)", version)
    return release.group(1) if release else version.strip()[-60:]


def write_ptxas_record(build, path=PTXAS_RECORD):
    """Write this build's ``ptxas -v`` lines and its nvcc release as the
    record that :func:`check_ptxas_lines` holds later builds to. A change that
    means to move a kernel's registers rewrites it from a build on the card,
    ``python3 chip_smoke.py --write-ptxas-record PATH``, and says so."""
    record = {"kernels": ptxas_lines(build.build_logs), "nvcc": nvcc_release(build)}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    log(f"ptxas -v lines of {len(record['kernels'])} kernels (nvcc {record['nvcc']}) written "
        f"to {path}")


def check_ptxas_lines(build):
    """Every kernel's ``ptxas -v`` lines against the record of this tree
    (:data:`PTXAS_RECORD`), where nvcc is the release that wrote it and this
    run built the source; raises on a kernel whose lines differ. Returns the
    counts compared, apart for the scalar tile's kernels."""
    release = nvcc_release(build)
    with open(PTXAS_RECORD) as fh:
        record = json.load(fh)
    if record["nvcc"] != release:
        log(f"ptxas -v lines not compared: nvcc {release}, the record's {record['nvcc']}")
        return {"compared": False, "nvcc": release}
    got = ptxas_lines(build.build_logs)
    built = set(build.build_logs)
    names = sorted(k for k in set(record["kernels"]) | set(got) if k.split(":")[0] in built)
    tile = {k for k in names if SCALAR_TILE_KERNEL.search(k)}
    differ = [k for k in names if record["kernels"].get(k) != got.get(k)]
    other = [k for k in names if k not in tile]
    counts = {"compared": True, "nvcc": release,
              "other_kernels": len(other),
              "other_as_recorded": sum(k not in differ for k in other),
              "scalar_tile_kernels": len(tile),
              "scalar_tile_as_recorded": sum(k not in differ for k in tile)}
    log(f"ptxas -v (nvcc {release}): {counts['other_as_recorded']} of {counts['other_kernels']} "
        f"kernels outside the scalar tile and {counts['scalar_tile_as_recorded']} of "
        f"{counts['scalar_tile_kernels']} scalar tile kernels as recorded in {PTXAS_RECORD}")
    for k in differ:
        log(f"  differs: {k}: {record['kernels'].get(k)} -> {got.get(k)}")
    if differ:
        raise AssertionError(f"{len(differ)} kernel(s) have other ptxas -v lines than "
                             f"{PTXAS_RECORD} records")
    return counts


def event_ms(fn, n, host=False):
    """Device ms per call over ``n`` calls, from CUDA events. With ``host``
    also the host's ms per call to enqueue them (no synchronize inside): where
    that is not well below the device time, the host holds the card back."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    return (ms, host_ms) if host else ms


# The examples phase 18 runs on the card, each through main(device="cuda").
EXAMPLES = ("torch_filter_types.py", "torch_tripole_grid.py", "torch_satellite_observations.py",
            "torch_viscosity_filter.py", "torch_sharded_filtering.py", "torch_gpu_filtering.py")
EXAMPLE_DIR = Path(__file__).resolve().parent / "examples"


def user_paths(dev, counters, reset_counters, bitwise):
    """Phase 18: the entry points a user calls around the kernels, at full
    width (2400x3600 float32, data made on the host from numpy seeds), each
    driven with every launch counter and the fallback counters set to 0 just
    before it and read just after. Returns what it measured, by path."""
    import os
    import runpy

    import torch

    from gcm_filters_tpu_torch import BaseScalarOperator, Filter, GridType
    from gcm_filters_tpu_torch.engine import scalar_filter_apply
    from gcm_filters_tpu_torch.utils.profiling import trace
    from gcm_filters_tpu_torch.utils.ring_split import unit_vector_grid_vars
    from gcm_filters_tpu_torch.utils.telemetry import (
        fallback_counts, recording, reset_fallback_counts, reset_spans, spans,
    )

    ny, nx = 2400, 3600
    out = {}

    def start():
        torch.cuda.synchronize()
        reset_counters()
        reset_fallback_counts()

    def launched(label, want):
        """Raise unless the launches since ``start()`` are ``want`` (kernel ->
        count; every other kernel 0) and no fallback was recorded."""
        torch.cuda.synchronize()
        got = counters()
        expected = {k: want.get(k, 0) for k in got}
        if got != expected:
            raise AssertionError(f"{label}: kernel launches {got}, expected {expected}")
        if fallback_counts():
            raise AssertionError(f"{label}: fallbacks recorded {fallback_counts()}")

    def split_ms(fn, *chunks):
        """One chunk through ``fn`` as the streamed loop moves it: the host's
        copy into page-locked staging (host clock), then host->device from
        it, the filter's kernels and device->host into a page-locked result,
        each timed by CUDA events."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = [torch.empty(c.shape, dtype=torch.float32, pin_memory=True).copy_(
            torch.as_tensor(c)) for c in chunks]
        stage_ms = 1e3 * (time.perf_counter() - t0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        xs = [c.to(dev, non_blocking=True) for c in staged]
        ev[1].record()
        res = fn(*xs)
        ev[2].record()
        for r, c in zip(res if isinstance(res, tuple) else (res,), staged):
            c.copy_(r, non_blocking=True)
        ev[3].record()
        torch.cuda.synchronize()
        nbytes = sum(c.numel() * c.element_size() for c in staged)
        split = {"stage_ms": stage_ms, "h2d_ms": ev[0].elapsed_time(ev[1]),
                 "kernel_ms": ev[1].elapsed_time(ev[2]), "d2h_ms": ev[2].elapsed_time(ev[3])}
        for k in ("stage", "h2d", "d2h"):
            split[f"{k}_gb_per_s"] = nbytes / split[f"{k}_ms"] / 1e6
        return split

    def pinned_spans(label, n_chunks):
        """Raise unless the recorded spans hold ``n_chunks`` chunks whose
        uploads and downloads all went through page-locked memory."""
        moves = [s for s in spans() if s.name in ("gft.stream.upload", "gft.stream.download")]
        if len(moves) != 2 * n_chunks or any(
                s.counts.get("pinned") != s.counts["bytes"] for s in moves):
            raise AssertionError(f"{label}: copies not all page-locked: {moves}")

    def bitwise_host(label, got, want, what):
        bitwise(label, torch.as_tensor(np.ascontiguousarray(got), device=dev), want, what)

    # the phase-4 headline grid and field (the same seed and draws)
    rng = np.random.default_rng(42)
    wet = np.ones((ny, nx))
    wet[0, :] = 0
    wet[: ny // 6, : nx // 5] = 0
    area = 0.9 + 0.2 * rng.random((ny, nx))
    field = torch.as_tensor(rng.random((ny, nx)).astype(np.float32), device=dev)
    head = Filter(filter_scale=10.0, dx_min=1.0,
                  grid_type=GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                  grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32, device=dev)
    fn = head._scalar_fn()
    passes = len(fn.plan(ny, nx, torch.float32).steps)
    ref = head.apply(field)

    # 18a. Filter.apply_streamed: 32 snapshots of the headline, land NaN and
    # one wet NaN, in chunks of 16; then a (2, 4) lead in chunks of 3
    n_snap, chunk = 32, 16
    snaps = np.random.default_rng(18).random((n_snap, ny, nx), dtype=np.float32)
    snaps[:, wet == 0] = np.nan
    snaps[5, ny // 2, nx // 2] = np.nan
    start()
    reset_spans()
    t0 = time.perf_counter()
    with recording():
        streamed = head.apply_streamed(snaps, chunk=chunk)
    e2e = [1e3 * (time.perf_counter() - t0) / n_snap]
    launched("apply_streamed", {"cheb_fused_pass": passes * -(-n_snap // chunk)})
    pinned_spans("apply_streamed", -(-n_snap // chunk))
    t0 = time.perf_counter()
    head.apply_streamed(snaps, chunk=chunk)
    e2e.append(1e3 * (time.perf_counter() - t0) / n_snap)
    if streamed.shape != snaps.shape or streamed.dtype != np.float32:
        raise AssertionError(f"apply_streamed gave {streamed.dtype} {streamed.shape}")
    for i in range(n_snap):  # the first call's result, read after the second call
        bitwise_host(f"streamed snapshot {i}", streamed[i], head.apply(snaps[i]),
                     "Filter.apply of the snapshot alone")
    flat = torch.as_tensor(streamed[:8], device=dev)
    lead = snaps[:8].reshape(2, 4, ny, nx)
    start()
    streamed4 = head.apply_streamed(lead, chunk=3)
    launched("apply_streamed (2, 4) lead", {"cheb_fused_pass": passes * 3})
    if streamed4.shape != lead.shape:
        raise AssertionError(f"apply_streamed of a (2, 4) lead gave {streamed4.shape}")
    bitwise_host("streamed (2, 4) lead", streamed4.reshape(8, ny, nx), flat,
                 "the flat streamed snapshots")
    start()
    reset_spans()
    with recording():
        streamed64 = head.apply_streamed(snaps[:5].astype(np.float64), chunk=3)
    launched("apply_streamed float64", {"cheb_fused_pass": passes * 2})
    pinned_spans("apply_streamed float64", 2)
    bitwise_host("streamed float64 cast to float32", streamed64, flat[:5],
                 "the flat streamed snapshots")
    with tempfile.TemporaryDirectory() as d:
        mm = np.memmap(os.path.join(d, "snaps.f32"), dtype=np.float32, mode="w+",
                       shape=(5, ny, nx))
        mm[:] = snaps[:5]
        mm.flush()
        start()
        streamed_mm = head.apply_streamed(mm, chunk=2)
        launched("apply_streamed memmap", {"cheb_fused_pass": passes * 3})
        del mm
    bitwise_host("streamed memmap", streamed_mm, flat[:5], "the flat streamed snapshots")
    out["apply_streamed"] = dict(
        snapshots=n_snap, chunk=chunk, launches_per_chunk=passes,
        ms_per_snapshot=e2e, chunk_split=split_ms(fn, snaps[:chunk]),
        chunk_kernel_alone_ms=event_ms(
            lambda x=torch.as_tensor(snaps[:chunk], device=dev): fn(x), 5))
    log(f"18a apply_streamed {n_snap}x{ny}x{nx} float32, chunk {chunk}: {e2e[0]:.3f}, "
        f"{e2e[1]:.3f} ms per snapshot end to end; one chunk {out['apply_streamed']['chunk_split']}"
        f" (kernels alone {out['apply_streamed']['chunk_kernel_alone_ms']:.4f} ms); "
        f"{passes} launch(es) a chunk; every snapshot, the (2, 4) lead, the float64 input and "
        f"the memory-mapped one bitwise equal to Filter.apply of it alone, every copy "
        f"page-locked")
    del snaps, streamed, streamed4, streamed64, streamed_mm, lead, flat

    # 18b. apply_to_vector_streamed on the phase-7 headlines: 16 (u, v)
    # pairs in chunks of 8
    n_pair, vchunk = 16, 8
    vrng = np.random.default_rng(7)
    us = vrng.random((n_pair, ny, nx), dtype=np.float32)
    vs = vrng.random((n_pair, ny, nx), dtype=np.float32)
    out["apply_to_vector_streamed"] = {}
    for gname, key in (("VECTOR_B_GRID", "bgrid"), ("VECTOR_C_GRID", "ctap")):
        vf = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                    grid_vars=unit_vector_grid_vars(gname, (ny, nx), vrng, 0.0),
                    dtype=torch.float32, device=dev)
        vfn = vf._vector_fn()
        vpasses = len(vfn.plan(ny, nx, torch.float32).steps)
        vf.apply_to_vector(us[0], vs[0])  # the operands (the C-grid taps) on the card
        start()
        reset_spans()
        t0 = time.perf_counter()
        with recording():
            su, sv = vf.apply_to_vector_streamed(us, vs, chunk=vchunk)
        e2e = [1e3 * (time.perf_counter() - t0) / n_pair]
        launched(f"{gname} apply_to_vector_streamed",
                 {f"vec_fused_pass_{key}": vpasses * -(-n_pair // vchunk)})
        pinned_spans(f"{gname} apply_to_vector_streamed", -(-n_pair // vchunk))
        t0 = time.perf_counter()
        vf.apply_to_vector_streamed(us, vs, chunk=vchunk)
        e2e.append(1e3 * (time.perf_counter() - t0) / n_pair)
        for i in range(n_pair):
            fu, fv = vf.apply_to_vector(us[i], vs[i])
            bitwise_host(f"{gname} streamed pair {i} u", su[i], fu, "apply_to_vector of it alone")
            bitwise_host(f"{gname} streamed pair {i} v", sv[i], fv, "apply_to_vector of it alone")
        res = dict(pairs=n_pair, chunk=vchunk, launches_per_chunk=vpasses, ms_per_pair=e2e,
                   chunk_split=split_ms(vfn, us[:vchunk], vs[:vchunk]),
                   chunk_kernel_alone_ms=event_ms(
                       lambda u=torch.as_tensor(us[:vchunk], device=dev),
                       v=torch.as_tensor(vs[:vchunk], device=dev): vfn(u, v), 5))
        out["apply_to_vector_streamed"][gname] = res
        log(f"18b {gname} apply_to_vector_streamed {n_pair} pairs, chunk {vchunk}: "
            f"{e2e[0]:.3f}, {e2e[1]:.3f} ms per pair end to end; one chunk "
            f"{res['chunk_split']} (kernels alone {res['chunk_kernel_alone_ms']:.4f} ms); "
            f"{vpasses} launches a chunk; every pair bitwise equal to apply_to_vector of it alone, "
            f"every copy page-locked")
        del vf, vfn, su, sv
    del us, vs

    # 18c. a batch in one call: IRREGULAR_WITH_LAND (the flux form) on the
    # satellite example's lat/lon metrics and fields at full width, 8 snapshots
    sat = runpy.run_path(str(EXAMPLE_DIR / "torch_satellite_observations.py"))
    nb = 8
    lat, lon, u, _, swet = sat["synthesize_observations"](ny, nx, nb, np.random.default_rng(42))
    dx, dy, sarea = sat["metrics_from_latlon"](lat, lon)
    irr = Filter(filter_scale=10 * float(dx.min()), dx_min=float(dx.min()),
                 grid_type=GridType.IRREGULAR_WITH_LAND,
                 grid_vars=sat["grid_vars"](swet, dx, dy, sarea), dtype=torch.float32, device=dev)
    xb = torch.as_tensor((np.nan_to_num(u) * swet).astype(np.float32), device=dev)
    del u
    ifn = irr._scalar_fn()
    ipasses = len(ifn.plan(ny, nx, torch.float32).steps)
    ist = ifn.operands(torch.float32, dev)[0].stencil
    if not (ist.zap_nans and ist.pre is None and ist.post is None
            and all(isinstance(getattr(ist, k), torch.Tensor) for k in "cnsew")):
        raise AssertionError("IRREGULAR_WITH_LAND does not take the flux form")
    start()
    ob = irr.apply(xb)
    launched("IRREGULAR_WITH_LAND batch", {"cheb_fused_pass": ipasses})
    if ob.shape != (nb, ny, nx) or not bool(torch.isfinite(ob).all()):
        raise AssertionError("the batch result is not a finite (8, ny, nx) tensor")
    for i in range(nb):
        bitwise(f"batch entry {i}", ob[i], irr.apply(xb[i]), "the batch-1 apply")
    w64 = scalar_filter_apply(irr.operator, irr.filter_spec, xb[0].double())
    torch.testing.assert_close(ob[0].double(), w64, rtol=1e-4, atol=1e-5)
    ms_b = event_ms(lambda: irr.apply(xb), 10)
    ms_1 = event_ms(lambda: [irr.apply(xb[i]) for i in range(nb)], 10)
    out["batch"] = dict(grid="IRREGULAR_WITH_LAND", batch=nb, n_steps=irr.n_steps,
                        launches_per_apply=ipasses, ms_per_field_batched=ms_b / nb,
                        ms_per_field_one_by_one=ms_1 / nb,
                        vs_f64_engine_max_abs=float((ob[0].double() - w64).abs().max()))
    log(f"18c IRREGULAR_WITH_LAND ({nb}, {ny}, {nx}) float32, n_steps {irr.n_steps}, "
        f"{ipasses} launch(es) an apply: {ms_b / nb:.4f} ms per field batched, "
        f"{ms_1 / nb:.4f} one by one; every entry bitwise equal to its batch-1 apply")
    del irr, ifn, ist, xb, ob, w64, sat, lat, lon, swet, dx, dy, sarea

    # 18d. the dict path: (array, dims) pairs and a non-spatial entry
    f0 = field.cpu().numpy()
    g0 = np.stack([f0, f0[::-1].copy()])
    mask = wet[:, 0].copy()
    start()
    res = head.apply({"sst": (f0, ("y", "x")), "ssh": (g0, ("time", "y", "x")),
                      "mask": (mask, ("y",))}, dims=("y", "x"))
    launched("dict", {"cheb_fused_pass": 2 * passes})
    if res["sst"][1] != ("y", "x") or res["ssh"][1] != ("time", "y", "x"):
        raise AssertionError("the dict path lost the entries' dims")
    if res["mask"][0] is not mask or res["mask"][1] != ("y",):
        raise AssertionError("the non-spatial entry did not pass through unchanged")
    bitwise("dict sst", res["sst"][0], ref, "Filter.apply of it")
    bitwise("dict ssh", res["ssh"][0], head.apply(g0), "Filter.apply of it")
    log("18d dict: sst and ssh bitwise equal to Filter.apply of each, mask passed through")

    # 18e. custom_operator: the headline's own stencil runs the fused kernel;
    # a free-form protocol operator runs plain torch on the card
    cust = Filter(filter_scale=10.0, dx_min=1.0, custom_operator=head.operator,
                  dtype=torch.float32, device=dev)
    start()
    oc = cust.apply(field)
    launched("custom_operator stencil", {"cheb_fused_pass": passes})
    bitwise("custom_operator stencil", oc, ref, "the grid path")
    st32 = head.operator.to(torch.float32, dev)

    class FivePoint(BaseScalarOperator):
        is_dimensional = st32.is_dimensional

        def prepare(self, f):
            return st32.prepare(f)

        def finalize(self, f):
            return st32.finalize(f)

        def __call__(self, f):
            return st32.laplacian(f)

    proto = Filter(filter_scale=10.0, dx_min=1.0, custom_operator=FivePoint(),
                   dtype=torch.float32, device=dev)
    start()
    op_ = proto.apply(field)
    launched("protocol custom_operator", {})
    w64 = scalar_filter_apply(head.operator, head.filter_spec, field.double())
    if op_.device != field.device or op_.dtype != torch.float32:
        raise AssertionError(f"the protocol operator gave {op_.dtype} on {op_.device}")
    torch.testing.assert_close(op_.double(), w64, rtol=1e-4, atol=1e-5)
    out["custom_operator"] = dict(
        protocol_vs_f64_engine_max_abs=float((op_.double() - w64).abs().max()),
        protocol_ms=event_ms(lambda: proto.apply(field), 5))
    log(f"18e custom_operator: the headline stencil bitwise equal to the grid path in "
        f"{passes} fused launch(es); the protocol operator on the card, no kernel, vs eager "
        f"engine in float64 max abs {out['custom_operator']['protocol_vs_f64_engine_max_abs']:.3e}"
        f", {out['custom_operator']['protocol_ms']:.4f} ms/apply")
    del cust, oc, proto, op_, w64, st32

    # 18f. utils/profiling.trace around one headline apply
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            head.apply(field)
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    kern = [e for e in events if "fused_pass_kernel" in str(e.get("name", ""))]
    if not kern:
        raise AssertionError(f"trace.json ({len(events)} events) names no fused_pass_kernel")
    out["trace"] = dict(events=len(events), fused_pass_kernel_events=len(kern),
                        fused_pass_kernel_us=[e.get("dur") for e in kern
                                              if e.get("cat") == "kernel"])
    log(f"18f trace.json: {len(events)} events, {len(kern)} name fused_pass_kernel, device "
        f"time {out['trace']['fused_pass_kernel_us']} us")

    # 18g. every example, on the card at its own default size
    out["examples"] = {}
    for name in EXAMPLES:
        log(f"18g {name}:")
        start()
        t0 = time.perf_counter()
        r = runpy.run_path(str(EXAMPLE_DIR / name))["main"](device="cuda")
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k: n for k, n in counters().items() if n}
        if name == "torch_filter_types.py":
            for k, v in r["results"].items():
                if not (np.isfinite(v["out"]).all() and v["var_out"] < v["var_in"]):
                    raise AssertionError(f"{name} {k}: not finite or variance did not drop")
            checked = {k: [v["var_in"], v["var_out"]] for k, v in r["results"].items()}
        elif name == "torch_tripole_grid.py":
            if not (r["simple"]["across"] > 0 and r["pop"]["across"] > 0
                    and max(r["simple"]["mass_err"], r["pop"]["mass_err"]) < 1e-12
                    and r["sharded"]["max_err"] == 0.0):
                raise AssertionError(f"{name}: {r['sharded']['max_err']=}")
            checked = {"ring_vs_unsharded_max_abs": r["sharded"]["max_err"]}
        elif name == "torch_satellite_observations.py":
            ocean = r["wet"] == 1
            if not (np.isfinite(r["u_bar"][:, ocean]).all() and r["means"]["eke"] > 0
                    and r["means"]["mke"] < r["means"]["ke"]):
                raise AssertionError(f"{name}: {r['means']}")
            checked = r["means"]
        elif name == "torch_viscosity_filter.py":
            if not (max(r["solid_body_dev"]) < 1e-12
                    and all(b > a for b, a in r["var"].values())):
                raise AssertionError(f"{name}: {r['solid_body_dev']}, {r['var']}")
            checked = {"solid_body_dev": r["solid_body_dev"], "var": r["var"]}
        elif name == "torch_sharded_filtering.py":
            if not (r["mesh"]["max_err"] < 1e-12 and r["ring"]["max_err"] == 0.0):
                raise AssertionError(f"{name}: {r['mesh']['max_err']}, {r['ring']['max_err']}")
            checked = {"mesh_vs_single_max_abs": r["mesh"]["max_err"],
                       "ring_vs_unsharded_max_abs": r["ring"]["max_err"]}
        else:
            if not (r["land_nan"] and r["ocean_finite"]):
                raise AssertionError(f"{name}: land NaN {r['land_nan']}, ocean finite "
                                     f"{r['ocean_finite']}")
            checked = {"ms_per_filter": r["ms"], "card": r["card"]}
        if not launches or fallback_counts():
            raise AssertionError(f"{name}: launches {launches}, fallbacks {fallback_counts()}")
        out["examples"][name] = dict(seconds=secs, launches=launches, **checked)
    return out


def main():
    parser = argparse.ArgumentParser(description="Build, check and time the port on one card.")
    parser.add_argument("--write-ptxas-record", metavar="PATH", dest="record_to",
                        help="write the build's ptxas -v lines to PATH and stop")
    record_to = parser.parse_args().record_to
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was checked", file=sys.stderr)
        return 2

    from gcm_filters_tpu_torch import Filter, FilterShape, GridType, required_grid_vars
    from gcm_filters_tpu_torch.engine import scalar_filter_apply, vector_filter_apply
    from gcm_filters_tpu_torch.models.grids import is_vector_grid
    from gcm_filters_tpu_torch.ops.cuda import build
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import (
        FIRST, LAST, MAX_FUSE, MIDDLE, SHARED_BYTES, TILES, FusedPlan, _balanced, _pass_cost,
        cheb_fused_pass, cheb_fused_pass_reference, cheb_fused_pass_tiled_reference, cheb_pass,
        cheb_pass_reference, fused_planes, plan_fused_passes,
    )
    from gcm_filters_tpu_torch.ops.cuda.dispatch import (
        _fused_chain, _vec_step_chain, make_cuda_scalar_apply, make_cuda_vector_apply,
    )
    from gcm_filters_tpu_torch.ops.cuda import (
        cheb_pass as cp_mod, local_pass as lp_mod, ring_pass as rp_mod, vec_local_pass as vlp_mod,
        vec_pass as vp_mod,
    )
    from gcm_filters_tpu_torch.ops.cuda.launch import Kernel, launch_counts
    from gcm_filters_tpu_torch.ops.cuda.local_pass import local_pass, local_strip_pass
    from gcm_filters_tpu_torch.ops.cuda.ring_pass import (
        RingItems, ring_fused_pass, ring_pass, vec_ring_fused_pass, vec_ring_pass,
    )
    from gcm_filters_tpu_torch.ops.cuda.vec_local_pass import vec_local_fused_pass, vec_local_pass
    from gcm_filters_tpu_torch.ops.cuda.vec_pass import (
        BGRID, CTAP, N_COEF, VEC_TILES, _vec_pass_cost, plan_vec_fused_passes, vec_fused_pass,
        vec_fused_pass_reference, vec_fused_pass_tiled_reference, vec_fused_shared_bytes,
        vec_pass, vec_pass_costs, vec_pass_reference, vec_reg_fits, vec_tiles,
    )
    from gcm_filters_tpu_torch.utils.profiling import bound_ms
    from gcm_filters_tpu_torch.utils.ring_split import (
        ring_parts, unit_vector_grid_vars, unsharded_launches,
    )
    from gcm_filters_tpu_torch.utils.telemetry import fallback_counts, reset_fallback_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"device: {card} (count {torch.cuda.device_count()})")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    paths = build.build()
    log(f"build: {len(paths)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"  {name}: {line.strip()}")
    if record_to:
        write_ptxas_record(build, record_to)
        return 0
    ptxas_check = check_ptxas_lines(build)

    def vec_tile_ptxas(source, kernel, op, geo=""):
        """This build's ``ptxas -v`` lines of a vector tile kernel for one
        contraction, by dtype and zap."""
        lap = "BGridLap" if op == BGRID else "CTapLap"
        out = {}
        for name, lines in ptxas_lines(build.build_logs).items():
            m = re.search(kernel + r"I([fd])NS_\d+" + lap + r"ELi(\d)E(?:NS_\d+(\w+?Geo)E)?",
                          name)
            if name.startswith(source + ":") and m and (m.group(3) or "") == geo:
                label = f"{'f64' if m.group(1) == 'd' else 'f32'} {'zap' if m.group(2) == '1' else 'no zap'}"
                out[label] = "; ".join(lines)
        return out or None
    def scalar_tile_ptxas(source, kernel):
        """This build's ``ptxas -v`` lines of the scalar tile kernels of one
        source (``kernel`` the regular expression of the name before its
        dtype), by dtype, compiled mode and steps (the register steps' kernels
        named apart)."""
        modes = {"0": "GENERIC", "1": "HSPACE", "2": "FLUX"}
        out = {}
        for name, lines in ptxas_lines(build.build_logs).items():
            m = re.search(kernel + r"I([fd])(?:NS_\d+\w+?GeoE)?Li(\d)E(?:Lb(\d)E)?", name)
            if name.startswith(source + ":") and m and SCALAR_TILE_KERNEL.search(name):
                out[f"{'f64' if m.group(1) == 'd' else 'f32'} {modes[m.group(2)]}"
                    + (" registers" if m.group(3) == "1" else "")] = "; ".join(lines)
        return out or None
    dev = torch.device("cuda")

    op_names = {BGRID: "bgrid", CTAP: "ctap"}

    def kernel_name(entry, detail):
        """An entry's name in :func:`counters`: a vector entry's with its
        contraction (``vec_pass_bgrid``; the fused periodic entry's detail is
        its contraction and its steps, summed here), a scalar one's alone."""
        if not entry.startswith("vec_"):
            return entry
        return f"{entry}_{op_names[detail[0] if isinstance(detail, tuple) else detail]}"

    def vec_paths(op):
        """The fused periodic vector launches of contraction ``op`` in the
        launch table, by steps."""
        return {path: launch_counts().get(("vec_fused_pass", (op, path)), 0)
                for path in ("registers", "shared")}

    kernel_names = sorted({kernel_name(k.entry, op) for m in (cp_mod, lp_mod, vp_mod, vlp_mod, rp_mod)
                           for k in vars(m).values() if isinstance(k, Kernel) for op in op_names})

    def counters():
        """Every kernel's launches since the launch table was last reset, by
        :func:`kernel_name` (a scalar tile's steps summed), 0 for a kernel
        that did not launch."""
        out = dict.fromkeys(kernel_names, 0)
        for (entry, detail), n in launch_counts().items():
            out[kernel_name(entry, detail)] += n
        return out

    def reset_counters():
        launch_counts(reset=True)

    def launched_since(before, label, want):
        """The launches since ``before``; raises unless they are ``want``
        (kernel -> count) and 0 for every other kernel."""
        got = {k: n - before[k] for k, n in counters().items()}
        expected = {k: want.get(k, 0) for k in got}
        if got != expected:
            raise AssertionError(f"{label}: kernel launches {got}, expected {expected}")
        return got

    def bitwise(label, got, want, what="the unsharded kernel path"):
        """Max abs difference, after requiring equality bit for bit (NaNs in
        the same cells)."""
        if got.shape != want.shape or got.dtype != want.dtype or got.device.type != "cuda":
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} on {got.device}")
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{label}: NaN positions differ from {what}")
        ok = ~torch.isnan(want)
        diff = float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0
        if diff != 0.0 or not torch.equal(got[ok], want[ok]):
            raise AssertionError(f"{label}: differs from {what}, max abs {diff:.3e}")
        return diff

    def step_snaps(ops_, p_, x_, ks):
        """The step-kernel chain on ``x_``: ``{k: (T_k, T_{k-1}, acc)}`` after
        each step k of ``ks`` (middle steps only)."""
        h, cur, acc_ = (torch.empty_like(x_) for _ in range(3))
        cheb_pass(ops_, FIRST, p_[0], p_[1], field=x_, t_next=cur, acc=acc_, h=h)
        prev, snaps = h, {}
        for k in range(2, max(ks) + 1):
            cheb_pass(ops_, MIDDLE, p_[k], t=cur, t_prev=prev, t_next=prev, acc=acc_)
            cur, prev = prev, cur
            if k in ks:
                snaps[k] = (cur.clone(), prev.clone(), acc_.clone())
        return snaps

    # the ragged fold-grid shape of the sentinel cases (phases 3, 9 and 15)
    # and the passes they run: a first pass of SENT[0] steps, a middle one of
    # SENT[1]
    sshape_s, SENT = (396, 601), (4, 5)

    # 3. small grids: the fused dispatch vs the plain versions, the step-kernel
    # chain (bit for bit) and the tiled plain version of the fused pass
    worst = {"float32": [0.0, 0.0], "float64": [0.0, 0.0]}
    fworst = {"vs_plain": 0.0, "vs_tiled": 0.0, "vs_steps": 0.0, "cases": 0}
    step_path = {"launches": 0}  # cheb_pass launched by Filter.apply below the predicate

    def check_filter(label, filt, x, dtype_name, want_fused=True):
        kw = dict(exact_nan=filt.exact_nan)
        plain = make_cuda_scalar_apply(filt.operator, filt.filter_spec, pass_fn=cheb_pass_reference,
                                       fused_fn=cheb_fused_pass_reference, **kw)
        steps = make_cuda_scalar_apply(filt.operator, filt.filter_spec, fused_fn=None, **kw)
        xs = filt._coerce(x)
        plan = filt._scalar_fn().plan(*xs.shape[-2:], xs.dtype if xs.is_floating_point()
                                      else torch.float64)
        if plan.fused != want_fused:
            raise AssertionError(f"{label}: fused route {plan.fused}, expected {want_fused}")
        before = counters()
        got = filt.apply(x)
        torch.cuda.synchronize()
        want_l = ({"cheb_fused_pass": len(plan.steps)} if plan.fused
                  else {"cheb_pass": filt.n_steps})
        launched = launched_since(before, label, want_l)
        step_path["launches"] += launched["cheb_pass"]
        want = plain(xs)
        if got.shape != want.shape or got.device.type != "cuda":
            raise AssertionError(f"{label}: result {tuple(got.shape)} on {got.device}")
        a, r = compare(label, got, want, dtype_name)
        worst[dtype_name] = [max(worst[dtype_name][0], a), max(worst[dtype_name][1], r)]
        chain_err = bitwise(label, got, steps(xs), "the step-kernel chain")
        tiled = ""
        if plan.fused:
            tiled_fn = make_cuda_scalar_apply(filt.operator, filt.filter_spec,
                                              fused_fn=cheb_fused_pass_tiled_reference, **kw)
            t_err = compare(f"{label} vs tiled", got, tiled_fn(xs), dtype_name)[0]
            fworst["vs_tiled"] = max(fworst["vs_tiled"], t_err)
            fworst["vs_plain"] = max(fworst["vs_plain"], a)
            fworst["cases"] += 1
            tiled = f", vs tiled plain {t_err:.3e}"
        log(f"  {label}: plan {plan.tile} {plan.steps} {'fused' if plan.fused else 'step chain'}: "
            f"vs plain max abs {a:.3e} max rel {r:.3e}{tiled}; vs step chain {chain_err:.1e} "
            f"({sum(launched.values())} launches)")
        return got

    scalar = [g for g in GridType if not is_vector_grid(g)]
    shape = (128, 256)
    log(f"small grids at {shape}:")
    for g in scalar:
        data, gv = scalar_grid_data(g, required_grid_vars(g), shape)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            for fshape in ("GAUSSIAN", "TAPER"):
                filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=gv,
                              filter_shape=FilterShape[fshape], dtype=dt, device=dev)
                check_filter(f"{g.name} {fshape} n_steps {filt.n_steps} {name}", filt, data, name)

    tri = GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED
    data, gv = scalar_grid_data(tri, required_grid_vars(tri), shape)
    for g in (tri, GridType.REGULAR_WITH_LAND):
        d, v = scalar_grid_data(g, required_grid_vars(g), shape)
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=v,
                      exact_nan=True, device=dev)
        nan_d = d.copy()
        nan_d[0, 5] = np.nan       # land
        nan_d[100, 200] = np.nan   # wet
        check_filter(f"{g.name} exact_nan float64", filt, nan_d, "float64")

    odd = (97, 300)
    d, v = scalar_grid_data(tri, required_grid_vars(tri), odd)
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=tri, grid_vars=v,
                      dtype=dt, device=dev)
        check_filter(f"{tri.name} {odd} {name}", filt, d, name)

    filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=tri, grid_vars=gv, device=dev)
    check_filter(f"{tri.name} batch (2, 128, 256) float64", filt,
                 np.stack([data, data[::-1].copy()]), "float64")
    nan_d = data.copy()
    nan_d[0, 7] = np.nan       # land
    nan_d[90, 150] = np.nan    # wet
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        f_nan = Filter(filter_scale=6.0, dx_min=1.0, grid_type=tri, grid_vars=gv,
                       dtype=dt, device=dev)
        out = check_filter(f"{tri.name} NaN land+wet {name}", f_nan, nan_d, name)
        if not (bool(torch.isnan(out[0, 7])) and bool(torch.isnan(out[90, 150]))):
            raise AssertionError("NaN cells must stay NaN")
        # spikes on the fold row at a tile seam and at its mirror column
        bx = f_nan._scalar_fn().plan(*shape, dt).tile[1]
        spike = data.copy()
        spike[-1, bx - 1], spike[-1, bx], spike[-1, shape[1] - bx] = 50.0, -40.0, 30.0
        check_filter(f"{tri.name} fold-row spikes at the tile seam {bx} {name}", f_nan, spike,
                     name)
    # below the predicate the step chain runs, by a static test
    for g in (tri, GridType.IRREGULAR_WITH_LAND):
        d, v = scalar_grid_data(g, required_grid_vars(g), (40, 100))
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=v, device=dev)
        check_filter(f"{g.name} (40, 100) below the fused predicate float64", filt, d, "float64",
                     want_fused=False)
    # sentinel outputs (WrapGeo): every output of a pass starts as NaN (acc
    # before the first pass; t_out and t_prev_out before each pass), so an own
    # cell that the launch skipped would keep it; a first pass, then a middle
    # one, each bitwise equal to the step-kernel chain, batch 2, on the fold
    n0, n1 = SENT
    sd, sv = scalar_grid_data(tri, required_grid_vars(tri), sshape_s)
    sfilt = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri, grid_vars=sv, device=dev)
    sfn_ = make_cuda_scalar_apply(sfilt.operator, sfilt.filter_spec)
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        ops_, p_ = sfn_.operands(dt, dev)
        if len(p_) - 1 <= n0 + n1:
            raise AssertionError(f"the sentinel case needs more than {n0 + n1} steps")
        x_ = torch.as_tensor(np.random.default_rng(7).random((2,) + sshape_s), dtype=dt,
                             device=dev)
        tl = sfn_.plan(*sshape_s, dt).tile
        snaps = step_snaps(ops_, p_, x_, (n0, n0 + n1))
        nan = lambda: torch.full_like(x_, float("nan"))  # noqa: E731
        a0, a1, acc_k = nan(), nan(), nan()
        cheb_fused_pass(ops_, p_, 0, n0, tile=tl, field=x_, t_out=a0, t_prev_out=a1, acc=acc_k)
        for nm, g, w in zip(("t", "t_prev", "acc"), (a0, a1, acc_k), snaps[n0]):
            bitwise(f"K1 sentinel first pass {name} {tl} {nm}", g, w, "the step-kernel chain")
        b0, b1 = nan(), nan()
        cheb_fused_pass(ops_, p_, n0, n1, tile=tl, t=a0, t_prev=a1, t_out=b0, t_prev_out=b1,
                        acc=acc_k)
        for nm, g, w in zip(("t", "t_prev", "acc"), (b0, b1, acc_k), snaps[n0 + n1]):
            bitwise(f"K1 sentinel middle pass {name} {tl} {nm}", g, w, "the step-kernel chain")
        log(f"  {tri.name} {sshape_s} batch 2 {name}: a first pass of {n0} and a middle pass "
            f"of {n1} steps on {tl} tiles into NaN-filled t_out, t_prev_out and acc: bit for "
            f"bit equal to the step-kernel chain")
    del sfilt, sfn_, ops_, x_, snaps, a0, a1, b0, b1, acc_k
    log(f"fused route on {fworst['cases']} small cases: vs the step-kernel chain max abs 0 "
        f"(bit for bit, NaNs in the same cells); vs plain max abs {fworst['vs_plain']:.3e}; "
        f"vs the tiled plain version max abs {fworst['vs_tiled']:.3e}")

    # 4. headline: the main path, at full size
    ny, nx = 2400, 3600
    rng = np.random.default_rng(42)
    wet = np.ones((ny, nx))
    wet[0, :] = 0  # Antarctica
    wet[: ny // 6, : nx // 5] = 0  # an idealized continent
    area = 0.9 + 0.2 * rng.random((ny, nx))
    field = rng.random((ny, nx)).astype(np.float32)
    head = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                  grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32, device=dev)
    n_steps = head.n_steps
    warm, chain = 3, 50
    item = 4
    torch.cuda.synchronize()
    fn = head._scalar_fn()
    fn_scalar_operands = fn.operands
    plan = fn.plan(ny, nx, torch.float32)

    reset_fallback_counts()
    reset_counters()
    out = head.apply(field)
    y = out
    for _ in range(warm):
        y = head.apply(y)
    ms_apply, host_apply = event_ms(lambda: head.apply(out), chain, host=True)
    counts = counters()
    launches = counts.pop("cheb_fused_pass")
    fallbacks = fallback_counts()
    applies = 1 + warm + chain
    log(f"headline {ny}x{nx} float32 {tri.name}, n_steps {n_steps}, fused plan tile {plan.tile} "
        f"passes {plan.steps}: {launches} cheb_fused_pass launches over {applies} applies, "
        f"other kernels {counts}, fallbacks {fallbacks}")
    if launches != len(plan.steps) * applies:
        raise AssertionError(f"expected {len(plan.steps) * applies} launches, saw {launches}")
    if any(counts.values()):
        raise AssertionError(f"the scalar path launched another kernel: {counts}")
    if fallbacks:
        raise AssertionError(f"fallbacks recorded on the kernel path: {fallbacks}")

    x_dev = torch.as_tensor(field, device=dev)
    x3 = x_dev.reshape(1, ny, nx)
    want64 = scalar_filter_apply(head.operator, head.filter_spec, x_dev.double())
    if out.shape != (ny, nx) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError("headline result is not a finite float32 (ny, nx) tensor")
    torch.testing.assert_close(out.double(), want64, rtol=1e-4, atol=1e-5)
    head_err = float((out.double() - want64).abs().max())
    log(f"headline vs eager engine in float64: max abs {head_err:.3e}")
    del want64

    # the chain of step-kernel launches: the same bits, timed in the same run
    steps_head = make_cuda_scalar_apply(head.operator, head.filter_spec, fused_fn=None)
    head_vs_steps = bitwise("headline", out, steps_head(x_dev), "the step-kernel chain")
    before = counters()["cheb_pass"]
    ms_steps, host_steps = event_ms(lambda: steps_head(x_dev), chain, host=True)
    step_chain_launches = (counters()["cheb_pass"] - before) // chain

    plain_head = make_cuda_scalar_apply(head.operator, head.filter_spec,
                                        pass_fn=cheb_pass_reference,
                                        fused_fn=cheb_fused_pass_reference)
    plain_head(x_dev)
    ms_plain = event_ms(lambda: plain_head(x_dev), 10)

    # bounds for one apply: per step launch (what the step chain moves), the
    # fused plan's (its passes' bytes and its redundant cell-steps), and the
    # whole filter's (one read of field and operands, one write)
    ops, p = fn.operands(torch.float32, dev)
    kinds = [FIRST] + [MIDDLE] * (n_steps - 2) + [LAST]
    apply_bytes = sum(step_bytes(k, ops, 1, ny, nx, item) for k in kinds)
    apply_flops = FLOPS_PER_CELL_STEP * ny * nx * n_steps
    b_ms, b_by = bound_ms(apply_bytes, apply_flops, "float32")
    st = ops.stencil
    n_operands = sum(1 for k in ("c", "n", "s", "e", "w", "pre", "post", "area")
                     if isinstance(getattr(st, k), torch.Tensor))
    filter_bytes = (2 + n_operands) * ny * nx * item
    fb_ms, fb_by = bound_ms(filter_bytes, apply_flops, "float32")
    p_bytes, p_flops = plan_cost(ops, plan, 1, ny, nx, item)
    pb_ms, pb_by = bound_ms(p_bytes, p_flops, "float32")
    gps = ny * nx * n_steps / (ms_apply * 1e-3)
    log(f"headline: {ms_apply:.4f} ms/apply fused (host enqueue {host_apply:.4f} ms/apply) = "
        f"{gps:.4e} grid-point-steps/s on {smi}; bit for bit equal to the step-kernel chain, "
        f"{ms_steps:.4f} ms/apply in {step_chain_launches} launches (host enqueue "
        f"{host_steps:.4f})")
    log(f"  plan bound {pb_ms:.4f} ms ({p_bytes / 1e9:.3f} GB, {p_flops / 1e9:.2f} GFLOP with "
        f"the trapezoid's redundant cells, {pb_by}); whole-filter bound {fb_ms:.4f} ms "
        f"({filter_bytes / 1e6:.1f} MB); step chain's per-launch bound {b_ms:.4f} ms "
        f"({apply_bytes / 1e9:.3f} GB); plain PyTorch {ms_plain:.4f} ms/apply")

    # 4b. the fused plan's tiles: each with the planner's best split for it,
    # and the chosen tile with fewer steps per pass, each bitwise equal
    def tile_sweep(label, sops, sp, xs, want, cands, n=20):
        """Each candidate plan of a headline, bitwise equal to its result,
        timed: ``{"BYxBX s1+s2": ms per apply}``."""
        n_pl, isz = fused_planes(sops), xs.element_size()
        out_ = {}
        for pl in cands:
            run = lambda: _fused_chain(cheb_fused_pass, sops, sp, pl, xs)  # noqa: E731
            bitwise(f"{label} tile sweep {pl.tile} {pl.steps}", run()[0], want,
                    f"the fused {label} headline")
            ms = event_ms(run, n)
            key = f"{pl.tile[0]}x{pl.tile[1]} {'+'.join(map(str, pl.steps))}"
            out_[key] = ms
            log(f"  {label} tile {key}: {ms:.4f} ms/apply; model cost "
                f"{_pass_cost(pl.tile, pl.steps, n_pl, isz):.2f} per cell")
        return out_

    n_planes = fused_planes(ops)
    cands = [plan_fused_passes(n_steps, ny, nx, torch.float32, n_planes, tile=tl) for tl in TILES]
    cands += [plan_fused_passes(n_steps, ny, nx, torch.float32, n_planes, max_fuse=cap,
                                tile=plan.tile) for cap in (6, 4)]
    sweep = tile_sweep("headline", ops, p, x3, out, cands)
    # the float64 headline (the same field and grid): every tile with its
    # best split, and one pass and 6+5 at the planned tile
    ops64, p64 = fn.operands(torch.float64, dev)
    x64 = x3.double()
    plan64 = fn.plan(ny, nx, torch.float64)
    out64 = _fused_chain(cheb_fused_pass, ops64, p64, plan64, x64)[0]
    bitwise("float64 headline", out64, steps_head(x_dev.double()), "the step-kernel chain")
    cands = [plan_fused_passes(n_steps, ny, nx, torch.float64, n_planes, tile=tl) for tl in TILES]
    for steps_ in ((n_steps,), (6, 5)):
        c = dataclasses.replace(plan64, steps=steps_, halo=max(steps_))
        if c not in cands:
            cands.append(c)
    sweep64 = tile_sweep("float64 headline", ops64, p64, x64, out64, cands, n=10)
    del ops64, x64, out64

    # 4c. two more headlines on the same footing: the Taper filter (several
    # passes), with the TPU's split (13, 13, 13) beside the planner's, and a
    # grid with five coefficient planes, at every tile
    def fused_headline(label, filt, sweep_cands=None):
        x = torch.as_tensor(field, device=dev)
        pl = filt._scalar_fn().plan(ny, nx, torch.float32)
        reset_counters()
        o = filt.apply(x)
        torch.cuda.synchronize()
        launched_since({k: 0 for k in counters()}, label, {"cheb_fused_pass": len(pl.steps)})
        ms_f, host_f = event_ms(lambda: filt.apply(x), 20, host=True)
        steps_fn = make_cuda_scalar_apply(filt.operator, filt.filter_spec, fused_fn=None)
        vs = bitwise(label, o, steps_fn(x), "the step-kernel chain")
        ms_s = event_ms(lambda: steps_fn(x), 10)
        w64 = scalar_filter_apply(filt.operator, filt.filter_spec, x.double())
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{label} is not finite")
        torch.testing.assert_close(o.double(), w64, rtol=1e-4, atol=1e-5)
        err = float((o.double() - w64).abs().max())
        del w64
        fops, fp = filt._scalar_fn().operands(torch.float32, dev)
        fst = fops.stencil
        n_op = sum(1 for k in ("c", "n", "s", "e", "w", "pre", "post", "area")
                   if isinstance(getattr(fst, k), torch.Tensor))
        flops = FLOPS_PER_CELL_STEP * ny * nx * filt.n_steps
        fbm, _ = bound_ms((2 + n_op) * ny * nx * item, flops, "float32")
        pbm, pbb = bound_ms(*plan_cost(fops, pl, 1, ny, nx, item), "float32")
        log(f"headline {label} {ny}x{nx} float32, n_steps {filt.n_steps}, plan {pl.tile} "
            f"{pl.steps}: {ms_f:.4f} ms/apply fused (host enqueue {host_f:.4f}), step chain "
            f"{ms_s:.4f} ms/apply, bit for bit equal; vs eager engine in float64 max abs "
            f"{err:.3e}; plan bound {pbm:.4f} ms ({pbb}), whole-filter bound {fbm:.4f} ms")
        res = {"ms": ms_f, "host_enqueue_ms": host_f, "step_chain_ms": ms_s,
               "n_steps": filt.n_steps, "passes": list(pl.steps), "tile": list(pl.tile),
               "plan_bound_ms": pbm, "filter_bound_ms": fbm, "vs_step_chain_max_abs": vs,
               "vs_f64_engine_max_abs": err}
        if sweep_cands is not None:
            res["tile_sweep_ms"] = tile_sweep(label, fops, fp, x.reshape(1, ny, nx), o,
                                              sweep_cands(pl, fused_planes(fops)), n=10)
        return res

    def taper_cands(pl, n_pl):
        """The planner's plan and the splits into 3, 4 and 5 passes (the TPU
        planner's (13, 13, 13) among them), at 32x96 and at the planned tile."""
        out_ = [pl]
        for tl in dict.fromkeys([(32, 96), pl.tile]):
            for steps_ in ((13, 13, 13), (10, 10, 10, 9), (8, 8, 8, 8, 7)):
                c = dataclasses.replace(pl, tile=tl, steps=steps_, halo=max(steps_))
                if c not in out_:
                    out_.append(c)
        return out_

    def every_tile(pl, n_pl):
        """Every tile of the planner with its best split."""
        return [plan_fused_passes(sum(pl.steps), ny, nx, torch.float32, n_pl,
                                  tile=tl) for tl in TILES]

    more_heads = {"taper": fused_headline("TAPER " + tri.name, Filter(
        filter_scale=10.0, dx_min=1.0, filter_shape=FilterShape.TAPER, grid_type=tri,
        grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32, device=dev),
        taper_cands)}
    m = 0.9 + 0.2 * rng.random((ny, nx))
    ones = np.ones((ny, nx))
    more_heads["irregular_with_land"] = fused_headline("IRREGULAR_WITH_LAND", Filter(
        filter_scale=10.0, dx_min=1.0, grid_type=GridType.IRREGULAR_WITH_LAND,
        grid_vars=dict(wet_mask=wet, dxw=m, dyw=m, dxs=m, dys=m, area=m * m, kappa_w=ones,
                       kappa_s=ones), dtype=torch.float32, device=dev), every_tile)
    del m, ones

    # 5. each step kind of the kernel against its plain version, headline shape
    x3 = x_dev.reshape(1, ny, nx)
    bufs = {tag: [torch.empty_like(x3) for _ in range(3)] for tag in ("k", "r")}
    step_err = 0.0
    for tag, f in (("k", cheb_pass), ("r", cheb_pass_reference)):
        h, t1, acc = bufs[tag]
        f(ops, FIRST, p[0], p[1], field=x3, t_next=t1, acc=acc, h=h)
    torch.cuda.synchronize()
    for i in range(3):
        step_err = max(step_err, compare(f"FIRST step out {i}", bufs["k"][i], bufs["r"][i], "float32")[0])
    # same inputs for both from here on: copy the kernel's carries over
    for i in range(3):
        bufs["r"][i].copy_(bufs["k"][i])
    for tag, f in (("k", cheb_pass), ("r", cheb_pass_reference)):
        h, t1, acc = bufs[tag]
        f(ops, MIDDLE, p[2], t=t1, t_prev=h, t_next=h, acc=acc)
    torch.cuda.synchronize()
    for i in range(3):
        step_err = max(step_err, compare(f"MIDDLE step out {i}", bufs["k"][i], bufs["r"][i], "float32")[0])
    for i in range(3):
        bufs["r"][i].copy_(bufs["k"][i])
    for tag, f in (("k", cheb_pass), ("r", cheb_pass_reference)):
        h, t1, acc = bufs[tag]
        f(ops, LAST, p[3], field=x3, t=h, t_prev=t1, acc=acc)
    torch.cuda.synchronize()
    step_err = max(step_err, compare("LAST step", bufs["k"][2], bufs["r"][2], "float32")[0])
    h, t1, acc = bufs["k"]
    ms_mid = event_ms(lambda: cheb_pass(ops, MIDDLE, p[2], t=t1, t_prev=h, t_next=h, acc=acc), 100)
    mid_ms, _ = bound_ms(step_bytes(MIDDLE, ops, 1, ny, nx, item),
                         FLOPS_PER_CELL_STEP * ny * nx, "float32")
    log(f"step kinds vs plain at {ny}x{nx}: max abs {step_err:.3e}; "
        f"middle step {ms_mid:.4f} ms vs bound {mid_ms:.4f} ms")
    # the fused pass: the planned single pass, and two passes (middle carries)
    fused_err = 0.0
    for steps_ in (plan.steps, (6, 5)):
        pl = dataclasses.replace(plan, steps=steps_, halo=max(steps_))
        got_k = _fused_chain(cheb_fused_pass, ops, p, pl, x3)
        got_r = _fused_chain(cheb_fused_pass_reference, ops, p, pl, x3)
        fused_err = max(fused_err, compare(f"fused passes {steps_}", got_k, got_r, "float32")[0])
    log(f"fused passes vs plain at {ny}x{nx}: max abs {fused_err:.3e}")
    del got_k, got_r

    # 6. small vector grids: the fused dispatch vs the plain versions, the
    # step-kernel chain (bit for bit) and the tiled plain version of the fused pass
    vec_ops = {"VECTOR_B_GRID": BGRID, "VECTOR_C_GRID": CTAP}
    vkey = {BGRID: "bgrid", CTAP: "ctap"}
    vworst = {op: {"float32": [0.0, 0.0], "float64": [0.0, 0.0]} for op in (BGRID, CTAP)}
    vfworst = {op: {"vs_tiled": 0.0, "cases": 0} for op in (BGRID, CTAP)}
    vstep_path = {BGRID: 0, CTAP: 0}  # vec_pass launched by apply_to_vector below the predicate

    def check_vector(label, filt, u, v, dtype_name, want_fused=True, operator=None):
        operator = operator or filt.operator
        op = vec_ops[filt.grid_type.name]
        plain = make_cuda_vector_apply(operator, filt.filter_spec, pass_fn=vec_pass_reference,
                                       fused_fn=vec_fused_pass_reference)
        steps = make_cuda_vector_apply(operator, filt.filter_spec, fused_fn=None)
        fn = make_cuda_vector_apply(operator, filt.filter_spec)
        uc, vc = filt._coerce(u), filt._coerce(v)
        dt = uc.dtype if uc.is_floating_point() else torch.float64
        plan = fn.plan(*uc.shape[-2:], dt)
        if plan.fused != want_fused:
            raise AssertionError(f"{label}: fused route {plan.fused}, expected {want_fused}")
        before = counters()
        got = fn(uc, vc) if operator is not filt.operator else filt.apply_to_vector(u, v)
        torch.cuda.synchronize()
        want_l = ({f"vec_fused_pass_{vkey[op]}": len(plan.steps)} if plan.fused
                  else {f"vec_pass_{vkey[op]}": filt.n_steps})
        launched = launched_since(before, label, want_l)
        vstep_path[op] += launched[f"vec_pass_{vkey[op]}"]
        want = plain(uc, vc)
        errs = []
        for comp, g, w in zip("uv", got, want):
            if g.shape != w.shape or g.device.type != "cuda":
                raise AssertionError(f"{label} {comp}: result {tuple(g.shape)} on {g.device}")
            errs.append(compare(f"{label} {comp}", g, w, dtype_name))
        a, r = max(e[0] for e in errs), max(e[1] for e in errs)
        w8 = vworst[op][dtype_name]
        vworst[op][dtype_name] = [max(w8[0], a), max(w8[1], r)]
        chain_err = max(bitwise(f"{label} {comp}", g, w, "the step-kernel chain")
                        for comp, g, w in zip("uv", got, steps(uc, vc)))
        tiled = ""
        if plan.fused:
            tiled_fn = make_cuda_vector_apply(operator, filt.filter_spec,
                                              fused_fn=vec_fused_pass_tiled_reference)
            t_err = max(compare(f"{label} {comp} vs tiled", g, w, dtype_name)[0]
                        for comp, g, w in zip("uv", got, tiled_fn(uc, vc)))
            vfworst[op]["vs_tiled"] = max(vfworst[op]["vs_tiled"], t_err)
            vfworst[op]["cases"] += 1
            tiled = f", vs tiled plain {t_err:.3e}"
        log(f"  {label}: plan {plan.tile} {plan.steps} {'fused' if plan.fused else 'step chain'}: "
            f"vs plain max abs {a:.3e} max rel {r:.3e}{tiled}; vs step chain {chain_err:.1e} "
            f"({sum(launched.values())} launches)")
        return got

    vshape = (128, 256)
    log(f"small vector grids at {vshape}:")
    vrng = np.random.default_rng(7)
    u_s, v_s = vrng.random(vshape), vrng.random(vshape)
    cases = [("VECTOR_B_GRID", 1.0), ("VECTOR_C_GRID", 1.0), ("VECTOR_C_GRID", 0.0)]
    for gname, ka in cases:
        gv = unit_vector_grid_vars(gname, vshape, np.random.default_rng(42), ka)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            # The Taper with dx_min = 0.9, the metrics' least spacing: with 1
            # the operator's spectrum runs past s_max, where the Taper
            # polynomial amplifies, and rounding noise grows past any
            # tolerance. The C-grid at kappa_aniso 1 amplifies either way.
            shapes = [("GAUSSIAN", 1.0)]
            if not (gname == "VECTOR_C_GRID" and ka == 1.0):
                shapes.append(("TAPER", 0.9))
            for fshape, dx_min in shapes:
                filt = Filter(filter_scale=6.0, dx_min=dx_min, grid_type=GridType[gname],
                              grid_vars=gv, dtype=dt, device=dev,
                              filter_shape=FilterShape[fshape])
                tag = f" kappa_aniso={ka:g}" if gname == "VECTOR_C_GRID" else ""
                check_vector(f"{gname} unit metrics{tag} {fshape} n_steps {filt.n_steps} {name}",
                             filt, u_s, v_s, name)
    for gname in vec_ops:
        gv = spherical_vector_grid_vars(required_grid_vars(GridType[gname]), vshape)
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                      grid_vars=gv, device=dev)
        check_vector(f"{gname} spherical float64", filt, u_s, v_s, "float64")
        odd = (97, 300)
        gv = unit_vector_grid_vars(gname, odd, np.random.default_rng(42), 0.0)
        u_o, v_o = vrng.random(odd), vrng.random(odd)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                          grid_vars=gv, dtype=dt, device=dev)
            check_vector(f"{gname} {odd} {name}", filt, u_o, v_o, name)
        gv = unit_vector_grid_vars(gname, vshape, np.random.default_rng(42), 0.0)
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                      grid_vars=gv, device=dev)
        check_vector(f"{gname} batch (2, 128, 256) float64", filt,
                     np.stack([u_s, v_s]), np.stack([v_s[::-1].copy(), u_s]), "float64")
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                          grid_vars=gv, dtype=dt, device=dev)
            by, bx = filt._vector_fn().plan(*vshape, dt).tile
            u_n, v_n = u_s.copy(), v_s.copy()
            u_n[10, 20] = np.nan
            v_n[50, 7] = np.nan
            u_n[by, bx] = np.nan  # a tile corner
            fu, fv = check_vector(f"{gname} NaN in u and v, one at the tile corner {(by, bx)} "
                                  f"{name}", filt, u_n, v_n, name)
            if not (bool(torch.isnan(fu[10, 20])) and bool(torch.isnan(fv[50, 7]))
                    and bool(torch.isnan(fu[by, bx]))):
                raise AssertionError("NaN cells must stay NaN")
            # spikes at a tile corner, which the C-grid's diagonal taps reach
            # from the first step on, and across the periodic seams
            u_k, v_k = u_s.copy(), v_s.copy()
            u_k[by - 1, bx], v_k[by, bx - 1], u_k[-1, -1], v_k[0, 0] = 50.0, -40.0, 30.0, -20.0
            check_vector(f"{gname} spikes at the tile corner {(by, bx)} and the seams {name}",
                         filt, u_k, v_k, name)
        # below the predicate the step chain runs, by a static test
        small = (20, 40)
        gv_small = unit_vector_grid_vars(gname, small, np.random.default_rng(42), 0.0)
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                      grid_vars=gv_small, device=dev)
        check_vector(f"{gname} {small} below the fused predicate float64", filt,
                     vrng.random(small), vrng.random(small), "float64", want_fused=False)
    # a C-grid operator that does not scrub NaNs: the NaN spreads through the
    # fused passes exactly as through the step chain
    gv = unit_vector_grid_vars("VECTOR_C_GRID", vshape, np.random.default_rng(42), 0.0)
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType.VECTOR_C_GRID,
                      grid_vars=gv, dtype=dt, device=dev)
        fu, fv = check_vector(f"VECTOR_C_GRID zap_nans=False {name}", filt, u_n, v_n, name,
                              operator=dataclasses.replace(filt.operator, zap_nans=False))
        spread = int(torch.isnan(fu).sum()), int(torch.isnan(fv).sum())
        if min(spread) <= 1:
            raise AssertionError(f"an unscrubbed NaN must spread, saw {spread} NaN cells")
    # the sentinel: a first pass of 5 steps whose t_out, t_prev_out and acc
    # start as NaN, on a batch of two ragged fields, on the planned tile:
    # every own cell of every tile is written, bitwise equal to 5 step-kernel
    # launches (a tile that the launch skipped would keep the sentinel)
    sshape, n1 = (397, 601), 5
    for gname, op in vec_ops.items():
        gv = unit_vector_grid_vars(gname, sshape, np.random.default_rng(42), 0.0)
        sfilt = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname], grid_vars=gv,
                       device=dev)
        sfn = make_cuda_vector_apply(sfilt.operator, sfilt.filter_spec)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            ops_, p_ = sfn.operands(dt, dev)
            w_ = torch.as_tensor(np.random.default_rng(11).random((2, 2) + sshape), dtype=dt,
                                 device=dev)
            cur, prev, acc_ = torch.empty_like(w_), w_.clone(), torch.empty_like(w_)
            vec_pass(ops_, FIRST, p_[0], p_[1], w=w_, t_next=cur, acc=acc_)
            for k in range(2, n1 + 1):
                vec_pass(ops_, MIDDLE, p_[k], t=cur, t_prev=prev, t_next=prev, acc=acc_)
                cur, prev = prev, cur
            spl = sfn.plan(*sshape, dt)
            tl, path = spl.tile, spl.paths[0]  # float32: the register steps
            outs = [torch.full_like(w_, float("nan")) for _ in range(3)]
            vec_fused_pass(ops_, p_, 0, n1, tile=tl, path=path, w=w_, t_out=outs[0],
                           t_prev_out=outs[1], acc=outs[2])
            for nm, g, want in zip(("t", "t_prev", "acc"), outs, (cur, prev, acc_)):
                bitwise(f"{gname} sentinel {name} {tl} {nm}", g, want, "the step-kernel chain")
            log(f"  {gname} {sshape} batch 2 {name}: a first pass of {n1} steps on {tl} tiles "
                f"({path} steps) into NaN-filled t_out, t_prev_out and acc: bit for bit equal "
                f"to {n1} step-kernel launches")
        del sfilt, sfn, ops_, w_, cur, prev, acc_, outs
    for op, k in vkey.items():
        log(f"fused {k} route on {vfworst[op]['cases']} small cases: vs the step-kernel chain max "
            f"abs 0 (bit for bit, NaNs in the same cells); vs plain max abs "
            f"{max(vworst[op]['float32'][0], vworst[op]['float64'][0]):.3e}; vs the tiled plain "
            f"version max abs {vfworst[op]['vs_tiled']:.3e}")

    # 7. vector headlines (the vector path), at full size
    vrng = np.random.default_rng(42)
    u_h = vrng.random((ny, nx)).astype(np.float32)
    v_h = vrng.random((ny, nx)).astype(np.float32)
    u_dev = torch.as_tensor(u_h, device=dev)
    v_dev = torch.as_tensor(v_h, device=dev)
    w3 = torch.stack([u_dev, v_dev]).unsqueeze(0)
    vec_results, vec_fused_results = {}, {}
    vec_kept = {}  # per grid: metrics, unsharded results and float64 answers, for phase 13
    for gname, op in vec_ops.items():
        key = vkey[op]
        # kappa_aniso=0: with 1, kappa_tension = 1.5 lifts the C-grid operator's
        # spectrum above s_max on unit metrics and the filter amplifies
        vhead_gv = unit_vector_grid_vars(gname, (ny, nx), vrng, 0.0)
        vhead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                       grid_vars=vhead_gv, dtype=torch.float32, device=dev)
        vn = vhead.n_steps
        fn = vhead._vector_fn()
        vplan = fn.plan(ny, nx, torch.float32)
        torch.cuda.synchronize()
        reset_fallback_counts()
        reset_counters()
        t0 = time.perf_counter()
        fu, fv = vhead.apply_to_vector(u_h, v_h)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(warm):
            vhead.apply_to_vector(u_dev, v_dev)
        ms_v, host_v = event_ms(lambda: vhead.apply_to_vector(u_dev, v_dev), chain, host=True)
        v_other = counters()
        v_launches = v_other.pop(f"vec_fused_pass_{key}")
        v_paths = vec_paths(op)
        v_fallbacks = fallback_counts()
        log(f"headline {ny}x{nx} float32 {gname}, n_steps {vn}, fused plan tile {vplan.tile} "
            f"passes {vplan.steps} on {vplan.paths}: {v_launches} vec_fused_pass launches over "
            f"{applies} applies ({v_paths}; first apply with operand set-up {first_s:.2f} s), "
            f"other kernels {v_other}, fallbacks {v_fallbacks}")
        if v_launches != len(vplan.steps) * applies:
            raise AssertionError(f"expected {len(vplan.steps) * applies} launches, saw {v_launches}")
        if v_paths != {"registers": v_launches, "shared": 0}:
            raise AssertionError(f"the float32 headline's passes must all run the register "
                                 f"steps: {v_paths}")
        if any(v_other.values()):
            raise AssertionError(f"the vector path launched another kernel: {v_other}")
        if v_fallbacks:
            raise AssertionError(f"fallbacks recorded on the kernel path: {v_fallbacks}")

        want_u, want_v = vector_filter_apply(vhead.operator, vhead.filter_spec,
                                             u_dev.double(), v_dev.double())
        v_err = 0.0
        for comp, g, w in (("u", fu, want_u), ("v", fv, want_v)):
            if g.shape != (ny, nx) or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{gname} headline {comp} is not a finite float32 (ny, nx) tensor")
            torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
            v_err = max(v_err, float((g.double() - w).abs().max()))
        log(f"{gname} headline vs eager engine in float64: max abs {v_err:.3e}; variance "
            f"u {float(u_dev.double().var()):.4e} -> {float(fu.double().var()):.4e}")
        vec_kept[op] = dict(gv=vhead_gv, out=(fu, fv), want=(want_u, want_v))
        del want_u, want_v

        # the chain of step-kernel launches: the same bits, timed in the same run
        steps_v = make_cuda_vector_apply(vhead.operator, vhead.filter_spec, fused_fn=None)
        v_vs_steps = max(bitwise(f"{gname} headline {comp}", g, w, "the step-kernel chain")
                         for comp, g, w in zip("uv", (fu, fv), steps_v(u_dev, v_dev)))
        before = counters()[f"vec_pass_{key}"]
        ms_vsteps, host_vsteps = event_ms(lambda: steps_v(u_dev, v_dev), chain, host=True)
        vstep_launches = (counters()[f"vec_pass_{key}"] - before) // chain

        plain_v = make_cuda_vector_apply(vhead.operator, vhead.filter_spec,
                                         pass_fn=vec_pass_reference,
                                         fused_fn=vec_fused_pass_reference)
        plain_v(u_dev, v_dev)
        ms_v_plain = event_ms(lambda: plain_v(u_dev, v_dev), 5)

        # bounds for one apply: per step launch (what the step chain moves), the
        # fused plan's (its passes' bytes and its redundant cell-steps), and the
        # whole filter's (one read of u, v and the coefficients, one write)
        vops, vp_ = fn.operands(torch.float32, dev)
        n_coef = vops.coef.shape[0]
        vkinds = [FIRST] + [MIDDLE] * (vn - 2) + [LAST]
        v_bytes = sum(vec_step_bytes(k, n_coef, 1, ny, nx, item) for k in vkinds)
        v_flops = VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * vn
        vb_ms, vb_by = bound_ms(v_bytes, v_flops, "float32")
        v_filter_bytes = (n_coef + 4) * ny * nx * item  # u, v, coefficients in; u, v out
        vfb_ms, vfb_by = bound_ms(v_filter_bytes, v_flops, "float32")
        vp_bytes, vp_flops = vec_plan_cost(n_coef, vplan, 1, ny, nx, item, key)
        vpb_ms, vpb_by = bound_ms(vp_bytes, vp_flops, "float32")
        log(f"{gname} headline: {ms_v:.4f} ms/apply fused (host enqueue {host_v:.4f} ms/apply) = "
            f"{ny * nx * vn / (ms_v * 1e-3):.4e} grid-point-steps/s on {smi}; bit for bit equal "
            f"to the step-kernel chain, {ms_vsteps:.4f} ms/apply in {vstep_launches} launches "
            f"(host enqueue {host_vsteps:.4f})")
        log(f"  plan bound {vpb_ms:.4f} ms ({vp_bytes / 1e9:.3f} GB, {vp_flops / 1e9:.2f} GFLOP "
            f"with the trapezoid's redundant cells, {vpb_by}); whole-filter bound {vfb_ms:.4f} ms "
            f"({v_filter_bytes / 1e6:.1f} MB); step chain's per-launch bound {vb_ms:.4f} ms "
            f"({v_bytes / 1e9:.3f} GB, {vb_by}); plain PyTorch {ms_v_plain:.4f} ms/apply")

        # 7b. the tile sweep the planner's cost models are fitted to: every
        # tile of its table at every split into 1 to 4 passes that fits, in
        # float32 on both steps (shared memory, and registers where every pass
        # can take them) and in float64, each bitwise equal to the planned
        # passes of its dtype
        vsweep = {}
        for dt_, tag, reps in ((torch.float32, "float32", 10), (torch.float64, "float64", 5)):
            ops_, p_ = fn.operands(dt_, dev)
            x_ = w3.to(dt_)
            ref_ = _fused_chain(vec_fused_pass, ops_, p_, fn.plan(ny, nx, dt_), x_, name="w")
            isz = x_.element_size()
            for tl in vec_tiles(op, isz):
                for cap in (11, 6, 4, 3):
                    st_ = _balanced(vn, cap)
                    if vec_fused_shared_bytes(tl, max(st_), n_coef, isz) > SHARED_BYTES:
                        continue
                    for path in ("shared", "registers"):
                        if path == "registers" and not all(vec_reg_fits(op, isz, tl, s)
                                                           for s in st_):
                            continue
                        pl = FusedPlan(tl, max(st_), st_, True, (path,) * len(st_))
                        k_ = (f"{tag} {tl[0]}x{tl[1]} {'+'.join(map(str, st_))}"
                              + (" registers" if path == "registers" else ""))
                        run = lambda: _fused_chain(vec_fused_pass, ops_, p_, pl, x_, name="w")  # noqa: E731
                        bitwise(f"{gname} tile sweep {k_}", run(), ref_, "the planned passes")
                        vsweep[k_] = event_ms(run, reps)
                        model = sum(vec_pass_costs(op, tl, s, isz)[path == "registers"]
                                    for s in st_) / (tl[0] * tl[1])
                        log(f"  tile {k_}: {vsweep[k_]:.4f} ms/apply; model cost "
                            f"{model:.2f} per cell")
            del ops_, x_, ref_
        # the 44-step Taper (dx_min = 0.9, as 7c) at every tile and every
        # split into passes of 4 to 16 steps, float32: the long filters' half
        # of the sweep, each bitwise equal to the planned passes
        tfilt = Filter(filter_scale=10.0, dx_min=0.9, filter_shape=FilterShape.TAPER,
                       grid_type=GridType[gname], grid_vars=vhead_gv, dtype=torch.float32,
                       device=dev)
        tfn = tfilt._vector_fn()
        tops, tp_ = tfn.operands(torch.float32, dev)
        tref = _fused_chain(vec_fused_pass, tops, tp_, tfn.plan(ny, nx, torch.float32), w3,
                            name="w")
        tsweep = {}
        for tl in VEC_TILES[op]:
            for cap in range(4, MAX_FUSE + 1):
                st_ = _balanced(tfilt.n_steps, cap)
                if max(st_) != cap or vec_fused_shared_bytes(tl, cap, n_coef, item) > SHARED_BYTES:
                    continue
                for path in ("shared", "registers"):
                    if path == "registers" and not all(vec_reg_fits(op, item, tl, s) for s in st_):
                        continue
                    pl = FusedPlan(tl, cap, st_, True, (path,) * len(st_))
                    k_ = (f"float32 {tl[0]}x{tl[1]} {'+'.join(map(str, st_))}"
                          + (" registers" if path == "registers" else ""))
                    run = lambda: _fused_chain(vec_fused_pass, tops, tp_, pl, w3, name="w")  # noqa: E731
                    bitwise(f"{gname} Taper sweep {k_}", run(), tref, "the planned passes")
                    tsweep[k_] = event_ms(run, 3)
        fastest = min(tsweep, key=tsweep.get)
        log(f"  Taper ({tfilt.n_steps} steps) sweep: {len(tsweep)} plans, the planned "
            f"{tfn.plan(ny, nx, torch.float32).steps} on {tfn.plan(ny, nx, torch.float32).tile}; "
            f"fastest {fastest}: {tsweep[fastest]:.4f} ms/apply")
        del tops, tref

        # 7c. the Taper filter on the C-grid headline: several passes, carries between them
        taper = None
        if op == CTAP:
            # dx_min = 0.9, the metrics' least spacing: with 1 the Taper
            # amplifies the top of the operator's spectrum (see phase 6)
            tplan = tfilt._vector_fn().plan(ny, nx, torch.float32)
            reset_counters()
            tu, tv = tfilt.apply_to_vector(u_dev, v_dev)
            torch.cuda.synchronize()
            launched_since({k: 0 for k in counters()}, "TAPER " + gname,
                           {f"vec_fused_pass_{key}": len(tplan.steps)})
            ms_t, host_t = event_ms(lambda: tfilt.apply_to_vector(u_dev, v_dev), 20, host=True)
            tsteps = make_cuda_vector_apply(tfilt.operator, tfilt.filter_spec, fused_fn=None)
            t_vs = max(bitwise(f"TAPER {gname} {comp}", g, w, "the step-kernel chain")
                       for comp, g, w in zip("uv", (tu, tv), tsteps(u_dev, v_dev)))
            ms_ts = event_ms(lambda: tsteps(u_dev, v_dev), 10)
            t_err = 0.0
            for g, w in zip((tu, tv), vector_filter_apply(tfilt.operator, tfilt.filter_spec,
                                                          u_dev.double(), v_dev.double())):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"TAPER {gname} headline is not finite")
                torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
                t_err = max(t_err, float((g.double() - w).abs().max()))
            t_flops = VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * tfilt.n_steps
            tfb_ms, _ = bound_ms(v_filter_bytes, t_flops, "float32")
            tpb_ms, tpb_by = bound_ms(*vec_plan_cost(n_coef, tplan, 1, ny, nx, item, key),
                                      "float32")
            log(f"headline TAPER {gname} {ny}x{nx} float32, n_steps {tfilt.n_steps}, plan "
                f"{tplan.tile} {tplan.steps}: {ms_t:.4f} ms/apply fused (host enqueue "
                f"{host_t:.4f}), step chain {ms_ts:.4f} ms/apply, bit for bit equal; vs eager "
                f"engine in float64 max abs {t_err:.3e}; plan bound {tpb_ms:.4f} ms ({tpb_by}), "
                f"whole-filter bound {tfb_ms:.4f} ms")
            taper = {"ms": ms_t, "host_enqueue_ms": host_t, "step_chain_ms": ms_ts,
                     "n_steps": tfilt.n_steps, "passes": list(tplan.steps),
                     "tile": list(tplan.tile), "plan_bound_ms": tpb_ms,
                     "filter_bound_ms": tfb_ms, "vs_step_chain_max_abs": t_vs,
                     "vs_f64_engine_max_abs": t_err}
            del tsteps, tu, tv

        # 7d. the route: where the planner sends a field to the fused passes,
        # they must beat the step chain. The float64 headline and a mid-size
        # field, 128x256 in float32 and float64, each bitwise equal and timed
        route = {}
        mid_gv = unit_vector_grid_vars(gname, (128, 256), np.random.default_rng(7), 0.0)
        mid = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname], grid_vars=mid_gv,
                     dtype=torch.float32, device=dev)
        u_m = torch.as_tensor(np.random.default_rng(8).random((2, 128, 256)), device=dev)
        for f_, tag, dt_, xu, xv, reps in (
                (vhead, f"{ny}x{nx} float64", torch.float64, u_dev, v_dev, 10),
                (mid, "128x256 float32", torch.float32, u_m[0], u_m[1], 100),
                (mid, "128x256 float64", torch.float64, u_m[0], u_m[1], 100)):
            xu, xv = xu.to(dt_), xv.to(dt_)
            rf = make_cuda_vector_apply(f_.operator, f_.filter_spec)
            rs = make_cuda_vector_apply(f_.operator, f_.filter_spec, fused_fn=None)
            rpl = rf.plan(*xu.shape, dt_)
            if not rpl.fused:
                raise AssertionError(f"{gname} {tag}: the planner sent the field to the steps")
            for comp, g, w in zip("uv", rf(xu, xv), rs(xu, xv)):
                bitwise(f"{gname} route {tag} {comp}", g, w, "the step-kernel chain")
            rf(xu, xv)
            route[tag] = {"fused_ms": event_ms(lambda: rf(xu, xv), reps),
                          "step_chain_ms": event_ms(lambda: rs(xu, xv), reps),
                          "tile": list(rpl.tile), "passes": list(rpl.steps)}
            log(f"{gname} route {tag}: fused {route[tag]['fused_ms']:.4f} ms/apply "
                f"({rpl.tile} {rpl.steps}), step chain {route[tag]['step_chain_ms']:.4f} "
                f"ms/apply, bit for bit equal")
        del mid, u_m, rf, rs

        # 8. each step kind against its plain version, headline shape
        vbufs = {tag: [w3.clone(), torch.empty_like(w3), torch.empty_like(w3)]
                 for tag in ("k", "r")}
        s_err = 0.0
        for tag, f in (("k", vec_pass), ("r", vec_pass_reference)):
            w0, t1, acc = vbufs[tag]
            f(vops, FIRST, vp_[0], vp_[1], w=w0, t_next=t1, acc=acc)
        torch.cuda.synchronize()
        for i in (1, 2):
            s_err = max(s_err, compare(f"{gname} FIRST step out {i}", vbufs["k"][i],
                                       vbufs["r"][i], "float32")[0])
        for i in range(3):
            vbufs["r"][i].copy_(vbufs["k"][i])
        for tag, f in (("k", vec_pass), ("r", vec_pass_reference)):
            w0, t1, acc = vbufs[tag]
            f(vops, MIDDLE, vp_[2], t=t1, t_prev=w0, t_next=w0, acc=acc)
        torch.cuda.synchronize()
        for i in (0, 2):
            s_err = max(s_err, compare(f"{gname} MIDDLE step out {i}", vbufs["k"][i],
                                       vbufs["r"][i], "float32")[0])
        for i in range(3):
            vbufs["r"][i].copy_(vbufs["k"][i])
        for tag, f in (("k", vec_pass), ("r", vec_pass_reference)):
            w0, t1, acc = vbufs[tag]
            f(vops, LAST, vp_[3], t=w0, t_prev=t1, acc=acc)
        torch.cuda.synchronize()
        s_err = max(s_err, compare(f"{gname} LAST step", vbufs["k"][2], vbufs["r"][2],
                                   "float32")[0])
        w0, t1, acc = vbufs["k"]
        ms_vmid = event_ms(lambda: vec_pass(vops, MIDDLE, vp_[2], t=t1, t_prev=w0,
                                            t_next=w0, acc=acc), 100)
        vmid_ms, _ = bound_ms(vec_step_bytes(MIDDLE, n_coef, 1, ny, nx, item),
                              VEC_FLOPS_PER_CELL_STEP[key] * ny * nx, "float32")
        log(f"{gname} step kinds vs plain at {ny}x{nx}: max abs {s_err:.3e}; "
            f"middle step {ms_vmid:.4f} ms vs bound {vmid_ms:.4f} ms")
        del vbufs
        # the fused pass against its plain version: the planned passes and a
        # split into more passes in float32, the float64 plan in float64
        vf_err = {"float32": 0.0, "float64": 0.0}
        vops64, vp64 = fn.operands(torch.float64, dev)
        for tag, ops_, p_, pl, x_ in (
                ("float32", vops, vp_, vplan, w3),
                ("float32", vops, vp_, plan_vec_fused_passes(vn, ny, nx, torch.float32, op,
                                                             max_fuse=4, tile=vplan.tile), w3),
                ("float64", vops64, vp64, fn.plan(ny, nx, torch.float64), w3.double())):
            got_k = _fused_chain(vec_fused_pass, ops_, p_, pl, x_, name="w")
            got_r = _fused_chain(vec_fused_pass_reference, ops_, p_, pl, x_, name="w")
            vf_err[tag] = max(vf_err[tag], compare(f"{gname} fused passes {pl.tile} {pl.steps} "
                                                   f"{tag}", got_k, got_r, tag)[0])
        del vops64, got_k, got_r
        log(f"{gname} fused passes vs plain at {ny}x{nx}: max abs {vf_err['float32']:.3e} "
            f"(float32), {vf_err['float64']:.3e} (float64)")

        worst_v = vworst[op]
        replaces = "gcm_filters_tpu/ops/pallas/vec_pass.py:" + ("567" if op == BGRID else "575")
        vec_results[op] = {
            "name": f"vec_pass_{key}",
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": replaces,
            "launches": vstep_path[op],
            "launches_from": "Filter.apply_to_vector of fields below the fused plan's predicate "
                             "(phase 6)",
            "max_abs_err": max(s_err, worst_v["float32"][0], worst_v["float64"][0]),
            "max_rel_err_f64": worst_v["float64"][1],
            "ms": ms_vsteps,
            "plain_ms": ms_v_plain,
            "bound_ms": vb_ms,
            "bound_by": vb_by,
            "library_ms": None,
            "unit": f"one headline apply as the step chain = {vstep_launches} launches, "
                    f"{ny}x{nx} float32 {gname}",
            "filter_bound_ms": vfb_ms,
            "launches_per_apply": vstep_launches,
            "bytes_moved": v_bytes,
            "plan_bound_ms": vb_ms,
            "middle_step_ms": ms_vmid,
            "middle_step_bound_ms": vmid_ms,
            "host_enqueue_ms": host_vsteps,
        }
        vec_fused_results[op] = {
            "name": f"vec_fused_pass_{key}",
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": replaces,
            "launches": v_launches,
            "launches_per_apply": len(vplan.steps),
            "max_abs_err": max(vf_err["float32"], vf_err["float64"], worst_v["float32"][0],
                               worst_v["float64"][0], vfworst[op]["vs_tiled"]),
            "vs_step_chain_max_abs": v_vs_steps,
            "headline_vs_f64_engine_max_abs": v_err,
            "ms": ms_v,
            "plain_ms": ms_v_plain,
            "bound_ms": vfb_ms,
            "bound_by": vfb_by,
            "library_ms": None,
            "unit": f"one headline apply = {len(vplan.steps)} launch(es) of {vplan.steps} steps "
                    f"on {vplan.tile[0]}x{vplan.tile[1]} tiles, {ny}x{nx} float32 {gname}",
            "bytes_moved": vp_bytes,
            "plan_bound_ms": vpb_ms,
            "filter_bound_ms": vfb_ms,
            "step_chain_ms": ms_vsteps,
            "host_enqueue_ms": host_v,
            "tile_sweep_ms": vsweep,
            "taper_sweep_ms": tsweep,
            "ptxas": vec_tile_ptxas("vec_pass", "vec_fused_kernel", op, "WrapGeo"),
            "ptxas_registers": vec_tile_ptxas("vec_pass", "vec_reg_kernel", op),
            "ptxas_as_recorded": ptxas_check,
            "paths": list(vplan.paths),
            "launches_by_path": v_paths,
            "headline_shared_ms": vsweep[f"float32 {vplan.tile[0]}x{vplan.tile[1]} "
                                         f"{'+'.join(map(str, vplan.steps))}"],
            "route_ms": route,
        }
        if taper:
            vec_fused_results[op]["taper"] = taper
        del plain_v, steps_v, fu, fv, vhead, fn, vops, tfilt, tfn

    # 9. sharded small grids: a one-rank process group and a 1x1 mesh
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from gcm_filters_tpu_torch.ops.cuda.local_pass import (
        local_pass_reference, local_strip_pass_reference,
    )
    from gcm_filters_tpu_torch.parallel import halo
    from gcm_filters_tpu_torch.parallel.sharded import make_sharded_scalar_apply
    from gcm_filters_tpu_torch.utils.round_split import scalar_round_parts

    torch.cuda.set_device(0)
    store_dir = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{store_dir.name}/store",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("y", "x"))
    axes = ("y", "x")
    sworst = {"float32": [0.0, 0.0], "float64": [0.0, 0.0]}
    # sharded against unsharded: the bar of the JAX package's sharded tests in
    # float64 (the same arithmetic, another summation order at block edges)
    tol_unsharded = {"float64": dict(rtol=1e-10, atol=1e-12), "float32": TOL["float32"]}

    local_step_path = {"launches": 0}  # local_pass launched by Filter.apply below the predicate
    local_axis = (None, 1)

    def check_sharded(label, x, dtype_name, want_fused=True, **kw):
        filt = Filter(device=dev, mesh=mesh, spatial_axes=axes, **kw)
        mk = lambda **k: make_sharded_scalar_apply(  # noqa: E731
            filt.operator, filt.filter_spec, mesh, axes, halo_steps=filt.halo_steps,
            exact_nan=filt.exact_nan, **k)
        plain = mk(pass_fn=local_pass_reference, fused_fn=local_strip_pass_reference)
        steps = mk(fused_fn=None)
        xs = filt._coerce(x)
        lops, cells, rounds, lp_all = filt._scalar_fn().operands(*xs.shape[-2:], xs.dtype)
        lplan = plan_fused_passes(cells, *xs.shape[-2:], xs.dtype, fused_planes(lops),
                                  one_pass=True)
        if lplan.fused != want_fused:
            raise AssertionError(f"{label}: fused rounds {lplan.fused}, expected {want_fused}")
        before = counters()
        got = filt.apply(x)
        torch.cuda.synchronize()
        launched = launched_since(before, label, {"local_strip_pass": len(rounds)} if lplan.fused
                                  else {"local_pass": filt.n_steps})
        local_step_path["launches"] += launched["local_pass"]
        if not isinstance(got, DTensor):
            raise AssertionError(f"{label}: the mesh path returned {type(got).__name__}")
        got = got.full_tensor()
        want = plain(xs).full_tensor()
        if got.shape != want.shape or got.device.type != "cuda":
            raise AssertionError(f"{label}: result {tuple(got.shape)} on {got.device}")
        a, r = compare(label, got, want, dtype_name)
        sworst[dtype_name] = [max(sworst[dtype_name][0], a), max(sworst[dtype_name][1], r)]
        bitwise(label, got, steps(xs).full_tensor(), "the local step-kernel chain")
        kw.pop("halo_steps", None)
        unsharded = Filter(device=dev, **kw).apply(x)
        if not torch.equal(torch.isnan(got), torch.isnan(unsharded)):
            raise AssertionError(f"{label}: NaN positions differ from the unsharded filter")
        torch.testing.assert_close(got, unsharded, equal_nan=True, **tol_unsharded[dtype_name],
                                   msg=lambda m: f"{label} vs unsharded: {m}")
        ok = ~torch.isnan(unsharded)
        u = float((got[ok] - unsharded[ok]).abs().max())
        log(f"  {label}: {'fused rounds' if lplan.fused else 'step chain'} {rounds} tile "
            f"{lplan.tile}: vs plain max abs {a:.3e} max rel {r:.3e}; vs the local step chain "
            f"0 (bit for bit); vs unsharded max abs {u:.3e} ({sum(launched.values())} launches)")
        return got

    both = ((torch.float32, "float32"), (torch.float64, "float64"))
    log(f"sharded small grids on a 1x1 mesh at {shape}:")
    for g in scalar:
        d, v = scalar_grid_data(g, required_grid_vars(g), shape)
        for dt, name in both:
            check_sharded(f"sharded {g.name} {name}", d, name, filter_scale=6.0, dx_min=1.0,
                          grid_type=g, grid_vars=v, dtype=dt)
    for g in (tri, GridType.REGULAR_WITH_LAND):
        d, v = scalar_grid_data(g, required_grid_vars(g), shape)
        nan_d = d.copy()
        nan_d[0, 5] = np.nan       # land
        nan_d[100, 200] = np.nan   # wet
        check_sharded(f"sharded {g.name} exact_nan float64", nan_d, "float64",
                      filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=v, exact_nan=True)
    d, v = scalar_grid_data(tri, required_grid_vars(tri), odd)
    for dt, name in both:
        check_sharded(f"sharded {tri.name} {odd} {name}", d, name, filter_scale=6.0,
                      dx_min=1.0, grid_type=tri, grid_vars=v, dtype=dt)
    data, gv = scalar_grid_data(tri, required_grid_vars(tri), shape)
    check_sharded(f"sharded {tri.name} batch (2, 128, 256) float64",
                  np.stack([data, data[::-1].copy()]), "float64", filter_scale=6.0,
                  dx_min=1.0, grid_type=tri, grid_vars=gv)
    for dt, name in both:
        out_nan = check_sharded(f"sharded {tri.name} NaN land+wet {name}", nan_d, name,
                                filter_scale=6.0, dx_min=1.0, grid_type=tri, grid_vars=gv,
                                dtype=dt)
        if not (bool(torch.isnan(out_nan[0, 5])) and bool(torch.isnan(out_nan[100, 200]))):
            raise AssertionError("NaN cells must stay NaN")
        for hs in (1, 3, None):
            check_sharded(f"sharded {tri.name} halo_steps={hs} {name}", data, name,
                          filter_scale=6.0, dx_min=1.0, grid_type=tri, grid_vars=gv,
                          dtype=dt, halo_steps=hs)
    d, v = scalar_grid_data(tri, required_grid_vars(tri), (40, 100))
    check_sharded(f"sharded {tri.name} (40, 100) below the fused predicate float64", d,
                  "float64", want_fused=False, filter_scale=6.0, dx_min=1.0, grid_type=tri,
                  grid_vars=v)

    # sentinel outputs (BlockStripGeo): a middle round on a ragged fold grid,
    # batch 2, from finite random extended carries and acc, its cores read in
    # place and its strips cut from them, its t_out and t_prev_out NaN-filled:
    # each and acc bitwise equal to the chain of local step-kernel launches
    # on the same inputs
    n0, n1 = SENT
    sd, sv = scalar_grid_data(tri, required_grid_vars(tri), sshape_s)
    sfilt = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri, grid_vars=sv, device=dev,
                   mesh=mesh, spatial_axes=axes)
    ly_, lx_ = sshape_s
    for dt, name in both:
        lops_, cells_, _, lp = sfilt._scalar_fn().operands(ly_, lx_, dt)
        if cells_ < n1 or len(lp) - 1 <= n0 + n1:
            raise AssertionError(f"the sentinel round needs {n1} cells and {n0 + n1} steps")
        tl = plan_fused_passes(cells_, ly_, lx_, dt, fused_planes(lops_), one_pass=True).tile
        rng_ = np.random.default_rng(8)
        ext = (2, ly_ + 2 * cells_, lx_ + 2 * cells_)
        t_, tp_ = (torch.as_tensor(rng_.random(ext), dtype=dt, device=dev) for _ in "ab")
        acc0 = torch.as_tensor(rng_.random((2,) + sshape_s), dtype=dt, device=dev)
        cur, prev, acc_s = t_.clone(), tp_.clone(), acc0.clone()
        for j in range(1, n1 + 1):
            local_pass(lops_, MIDDLE, lp[n0 + j], cells=cells_, shrink=j, t=cur, t_prev=prev,
                       t_next=prev, acc=acc_s)
            cur, prev = prev, cur
        core = (Ellipsis, slice(cells_, cells_ + ly_), slice(cells_, cells_ + lx_))
        # the cores read in place from the extended carries (their row pitch
        # and batch stride), the strips cut from them
        c_, e_ = cells_, cells_ + ly_
        sstr = halo.Strips(*(torch.stack([a[..., r_, q_] for a in (t_, tp_)]) for r_, q_ in (
            (slice(0, c_), slice(None)), (slice(e_, None), slice(None)),
            (slice(c_, e_), slice(0, c_)), (slice(c_, e_), slice(c_ + lx_, None)))))
        so0, so1 = (torch.full((2,) + sshape_s, float("nan"), dtype=dt, device=dev) for _ in "ab")
        acc_st = acc0.clone()
        local_strip_pass(lops_, lp, n0, n1, cells=cells_, tile=tl, t=t_[core], t_prev=tp_[core],
                         t_out=so0, t_prev_out=so1, acc=acc_st, strips=sstr)
        for nm, g, w in (("strips t", so0, cur[core]), ("strips t_prev", so1, prev[core]),
                         ("strips acc", acc_st, acc_s)):
            bitwise(f"K2 sentinel middle round {name} {tl} {nm}", g, w,
                    "the local step-kernel chain")
        log(f"  sharded {tri.name} {sshape_s} batch 2 {name}: a middle round of {n1} steps "
            f"(block of {cells_} cells) on {tl} tiles on strips (cores read in place from the "
            f"extended carries), into NaN-filled t_out and t_prev_out: bit for bit equal to "
            f"the local step-kernel chain")
    del sfilt, lops_, t_, tp_, acc0, cur, prev, acc_s, sstr, so0, so1, acc_st

    # 10. sharded headline: the phase-4 workload through the mesh path
    shead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                   grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32,
                   device=dev, mesh=mesh, spatial_axes=axes)
    torch.cuda.synchronize()
    sfn = shead._scalar_fn()
    reset_fallback_counts()
    reset_counters()
    s_out = shead.apply(field)
    y = s_out
    for _ in range(warm):
        y = shead.apply(y)
    ms_sharded, host_sharded = event_ms(lambda: shead.apply(x_dev), chain, host=True)
    s_other = counters()
    s_launches = s_other.pop("local_strip_pass")
    s_fallbacks = fallback_counts()
    lops, cells, rounds, lp_ = sfn.operands(ny, nx, torch.float32)
    log(f"sharded headline {ny}x{nx} float32 {tri.name} on a 1x1 mesh, n_steps {n_steps}, "
        f"rounds {rounds}: {s_launches} local_strip_pass launches over {applies} applies, "
        f"other kernels {s_other}, fallbacks {s_fallbacks}")
    if s_launches != len(rounds) * applies:
        raise AssertionError(f"expected {len(rounds) * applies} launches, saw {s_launches}")
    if any(s_other.values()):
        raise AssertionError(f"the sharded path launched another kernel: {s_other}")
    if s_fallbacks:
        raise AssertionError(f"fallbacks recorded on the kernel path: {s_fallbacks}")
    if not isinstance(s_out, DTensor):
        raise AssertionError(f"the mesh path returned {type(s_out).__name__}")
    s_full = s_out.full_tensor()
    want64 = scalar_filter_apply(shead.operator, shead.filter_spec, x_dev.double())
    if (s_full.shape != (ny, nx) or s_full.dtype != torch.float32
            or not bool(torch.isfinite(s_full).all())):
        raise AssertionError("sharded headline result is not a finite float32 (ny, nx) tensor")
    torch.testing.assert_close(s_full.double(), want64, rtol=1e-4, atol=1e-5)
    s_head_err = float((s_full.double() - want64).abs().max())
    s_vs_k1 = float((s_full - out).abs().max())
    log(f"sharded headline vs eager engine in float64: max abs {s_head_err:.3e}; "
        f"vs the unsharded kernel path: max abs {s_vs_k1:.3e}")
    del want64

    if rounds != (n_steps,):
        raise AssertionError(f"expected one round of {n_steps} steps, planned {rounds}")
    lplan = plan_fused_passes(cells, ny, nx, torch.float32, fused_planes(lops), one_pass=True)
    plain_shead = make_sharded_scalar_apply(shead.operator, shead.filter_spec, mesh, axes,
                                            pass_fn=local_pass_reference,
                                            fused_fn=local_strip_pass_reference)
    plain_shead(x_dev)
    ms_s_plain = event_ms(lambda: plain_shead(x_dev), 10)
    # the chain of local step-kernel launches: the same bits, timed in the same run
    steps_shead = make_sharded_scalar_apply(shead.operator, shead.filter_spec, mesh, axes,
                                            fused_fn=None)
    s_vs_steps = bitwise("sharded headline", s_full, steps_shead(x_dev).full_tensor(),
                         "the local step-kernel chain")
    before = counters()["local_pass"]
    ms_s_steps, host_s_steps = event_ms(lambda: steps_shead(x_dev), chain, host=True)
    s_step_chain_launches = (counters()["local_pass"] - before) // chain

    # the apply's parts alone (utils/round_split.py): the parent's halo
    # exchange (exchange_2d, the extended block), the strips the round reads
    # now, and the round with its strips frozen; then the round on strips
    # alone, and the chain of local steps alone on the extended block
    hparts, hinfo = scalar_round_parts(shead, x_dev)
    if not hinfo["rounds_alone_equal_apply"]:
        raise AssertionError(f"sharded headline parts: {hinfo}")
    ms_exchange = event_ms(hparts["exchange"], chain)
    ms_strips = event_ms(hparts["strips"], chain)
    ms_rounds_alone = event_ms(hparts["rounds_alone"], chain)
    xe = halo.exchange_2d(x3, cells, local_axis, local_axis, True)
    xs_strips = halo.exchange_strips(x3, cells, local_axis, local_axis, True)
    kbuf = [torch.zeros_like(xe), torch.zeros_like(xe), torch.zeros_like(x3)]

    def local_chain():
        h_, t_, acc_ = kbuf
        local_pass(lops, FIRST, lp_[0], lp_[1], cells=cells, shrink=1,
                   field=xe, t_next=t_, acc=acc_, h=h_)
        t_prev_ = h_
        for k in range(2, n_steps):
            local_pass(lops, MIDDLE, lp_[k], cells=cells, shrink=k,
                       t=t_, t_prev=t_prev_, t_next=t_prev_, acc=acc_)
            t_, t_prev_ = t_prev_, t_
        local_pass(lops, LAST, lp_[n_steps], cells=cells, field=x3, t=t_, t_prev=t_prev_,
                   acc=acc_)

    local_chain()
    ms_chain = event_ms(local_chain, chain)
    chain_err = bitwise("the local step chain alone", kbuf[2][0], s_full, "the sharded apply")
    facc = torch.empty_like(x3)
    fused_round = lambda: local_strip_pass(  # noqa: E731
        lops, lp_, 0, n_steps, cells=cells, tile=lplan.tile, field=x3, field_own=x3, acc=facc,
        strips=xs_strips)
    fused_round()
    ms_round = event_ms(fused_round, chain)
    bitwise("the round on strips alone", facc[0], s_full, "the sharded apply")
    # the round on strips against its plain version, at the headline's block
    racc = torch.empty_like(x3)
    local_strip_pass_reference(lops, lp_, 0, n_steps, cells=cells, field=x3, field_own=x3,
                               acc=racc, strips=xs_strips)
    ms_round_plain = event_ms(lambda: local_strip_pass_reference(
        lops, lp_, 0, n_steps, cells=cells, field=x3, field_own=x3, acc=racc,
        strips=xs_strips), 3)
    lfused_err = compare("round on strips vs plain", facc, racc, "float32")[0]
    del racc
    slp_bytes, slp_flops = plan_cost(lops, dataclasses.replace(lplan, steps=rounds), 1, ny, nx,
                                     item)
    slb_ms, slb_by = bound_ms(slp_bytes, slp_flops, "float32")

    skinds = [(FIRST, 1)] + [(MIDDLE, k) for k in range(2, n_steps)] + [(LAST, cells)]
    s_bytes = sum(local_step_bytes(k, lops, 1, ny, nx, cells, sh, item) for k, sh in skinds)
    s_cells = sum((ny + 2 * (cells - sh)) * (nx + 2 * (cells - sh)) for _, sh in skinds)
    s_flops = FLOPS_PER_CELL_STEP * s_cells
    sb_ms, sb_by = bound_ms(s_bytes, s_flops, "float32")
    sfb_ms, sfb_by = bound_ms(filter_bytes, s_flops, "float32")
    log(f"sharded headline: {ms_sharded:.4f} ms/apply fused (host enqueue {host_sharded:.4f} "
        f"ms/apply) = {ny * nx * n_steps / (ms_sharded * 1e-3):.4e} grid-point-steps/s on {smi}; "
        f"bit for bit equal to the local step chain, {ms_s_steps:.4f} ms/apply in "
        f"{s_step_chain_launches} launches")
    log(f"  {s_launches // applies} strip launch(es) an apply; strips alone ({cells} cells) "
        f"{ms_strips:.4f} ms, the parent's halo exchange alone (block {tuple(xe.shape[-2:])}) "
        f"{ms_exchange:.4f} ms; the rounds with their strips frozen {ms_rounds_alone:.4f} ms; "
        f"the round on strips alone (tile {lplan.tile}) {ms_round:.4f} ms, the {n_steps} local "
        f"steps alone "
        f"{ms_chain:.4f} ms (all bit for bit equal to the apply); unsharded fused path "
        f"{ms_apply:.4f} ms/apply; round on strips vs plain max abs {lfused_err:.3e} (plain "
        f"{ms_round_plain:.4f} ms)")
    log(f"  plan bound {slb_ms:.4f} ms ({slb_by}); whole-filter bound {sfb_ms:.4f} ms "
        f"({filter_bytes / 1e6:.1f} MB); step chain's per-launch bound {sb_ms:.4f} ms "
        f"({s_bytes / 1e9:.3f} GB, {sb_by}); plain PyTorch {ms_s_plain:.4f} ms/apply")

    # 10b. the sharded scalar Taper: 39 steps in several rounds, whose later
    # strips come from the previous round's core-shaped carries
    staper = Filter(filter_scale=10.0, dx_min=1.0, filter_shape=FilterShape.TAPER,
                    grid_type=tri, grid_vars={"area": area, "wet_mask": wet},
                    dtype=torch.float32, device=dev, mesh=mesh, spatial_axes=axes)
    t_ops, t_cells, t_rounds, _ = staper._scalar_fn().operands(ny, nx, torch.float32)
    torch.cuda.synchronize()
    reset_fallback_counts()
    reset_counters()
    t_first = staper.apply(x_dev)
    for _ in range(warm):
        staper.apply(x_dev)
    ms_staper, host_staper = event_ms(lambda: staper.apply(x_dev), 20, host=True)
    t_counts = counters()
    t_launches = t_counts.pop("local_strip_pass")
    t_applies = 1 + warm + 20
    if len(t_rounds) < 2 or t_launches != len(t_rounds) * t_applies or any(t_counts.values()):
        raise AssertionError(f"sharded Taper: rounds {t_rounds}, {t_launches} strip launches "
                             f"over {t_applies} applies, other kernels {t_counts}")
    if fallback_counts():
        raise AssertionError(f"fallbacks recorded on the kernel path: {fallback_counts()}")
    t_full = t_first.full_tensor()
    t64 = scalar_filter_apply(staper.operator, staper.filter_spec, x_dev.double())
    if not bool(torch.isfinite(t_full).all()):
        raise AssertionError("the sharded Taper result is not finite")
    torch.testing.assert_close(t_full.double(), t64, rtol=1e-4, atol=1e-5)
    t_err = float((t_full.double() - t64).abs().max())
    del t64
    t_steps = make_sharded_scalar_apply(staper.operator, staper.filter_spec, mesh, axes,
                                        fused_fn=None)
    bitwise("sharded Taper", t_full, t_steps(x_dev).full_tensor(), "the local step-kernel chain")
    tparts, tinfo = scalar_round_parts(staper, x_dev)
    if not tinfo["rounds_alone_equal_apply"]:
        raise AssertionError(f"sharded Taper parts: {tinfo}")
    bitwise("sharded Taper", t_full, tinfo.pop("out"), "its apply again")
    k1_taper = Filter(filter_scale=10.0, dx_min=1.0, filter_shape=FilterShape.TAPER,
                      grid_type=tri, grid_vars={"area": area, "wet_mask": wet},
                      dtype=torch.float32, device=dev)
    t_vs_k1 = float((t_full - k1_taper.apply(x_dev)).abs().max())
    t_split = {k: event_ms(fn_, 20) for k, fn_ in tparts.items() if k != "apply"}
    t_split["unsharded"] = event_ms(lambda: k1_taper.apply(x_dev), 20)
    tplan = plan_fused_passes(t_cells, ny, nx, torch.float32, fused_planes(t_ops), one_pass=True)
    tb_bytes, tb_flops = plan_cost(t_ops, dataclasses.replace(tplan, steps=t_rounds), 1, ny, nx,
                                   item)
    tb_ms, tb_by = bound_ms(tb_bytes, tb_flops, "float32")
    del k1_taper, t_steps
    sh_taper = {"ms": ms_staper, "host_enqueue_ms": host_staper, "n_steps": staper.n_steps,
                "rounds": list(t_rounds), "cells": t_cells, "tile": list(tplan.tile),
                "launches": t_launches, "launches_per_apply": len(t_rounds),
                "plan_bound_ms": tb_ms, "plan_bound_by": tb_by, "vs_f64_engine_max_abs": t_err,
                "vs_unsharded_k1_max_abs": t_vs_k1, "split_ms": t_split}
    log(f"sharded Taper {ny}x{nx} float32 on a 1x1 mesh, {staper.n_steps} steps in rounds "
        f"{t_rounds} (cells {t_cells}, tile {tplan.tile}): {ms_staper:.4f} ms/apply (host "
        f"enqueue {host_staper:.4f}), {t_launches} local_strip_pass launches over {t_applies} "
        f"applies; bit for bit equal to the local step chain; vs eager float64 max abs {t_err:.3e}, vs unsharded K1 max abs "
        f"{t_vs_k1:.3e}; parts alone " + ", ".join(f"{k} {v:.4f}" for k, v in t_split.items())
        + f" ms; plan bound {tb_ms:.4f} ms ({tb_by}) on {smi}")
    del staper, t_first, t_full

    # 11. each step kind of the local step against its plain version, at the
    # headline's extended shape (buffers start at zero: a step leaves the
    # cells outside its window untouched, in both versions)
    rbuf = [torch.zeros_like(b) for b in kbuf]
    for b in kbuf:
        b.zero_()
    ls_err = 0.0
    for bufs_, f in ((kbuf, local_pass), (rbuf, local_pass_reference)):
        h_, t_, acc_ = bufs_
        f(lops, FIRST, lp_[0], lp_[1], cells=cells, shrink=1, field=xe, t_next=t_, acc=acc_, h=h_)
    torch.cuda.synchronize()
    for i in range(3):
        ls_err = max(ls_err, compare(f"local FIRST step out {i}", kbuf[i], rbuf[i], "float32")[0])
    for i in range(3):
        rbuf[i].copy_(kbuf[i])
    for bufs_, f in ((kbuf, local_pass), (rbuf, local_pass_reference)):
        h_, t_, acc_ = bufs_
        f(lops, MIDDLE, lp_[2], cells=cells, shrink=2, t=t_, t_prev=h_, t_next=h_, acc=acc_)
    torch.cuda.synchronize()
    for i in range(3):
        ls_err = max(ls_err, compare(f"local MIDDLE step out {i}", kbuf[i], rbuf[i], "float32")[0])
    for i in range(3):
        rbuf[i].copy_(kbuf[i])
    for bufs_, f in ((kbuf, local_pass), (rbuf, local_pass_reference)):
        h_, t_, acc_ = bufs_
        f(lops, LAST, lp_[3], cells=cells, field=x3, t=h_, t_prev=t_, acc=acc_)
    torch.cuda.synchronize()
    ls_err = max(ls_err, compare("local LAST step", kbuf[2], rbuf[2], "float32")[0])
    h_, t_, acc_ = kbuf
    ms_lmid = event_ms(lambda: local_pass(lops, MIDDLE, lp_[2], cells=cells, shrink=2,
                                          t=t_, t_prev=h_, t_next=h_, acc=acc_), 100)
    lmid_ms, _ = bound_ms(local_step_bytes(MIDDLE, lops, 1, ny, nx, cells, 2, item),
                          FLOPS_PER_CELL_STEP * (ny + 2 * (cells - 2)) * (nx + 2 * (cells - 2)),
                          "float32")
    log(f"local step kinds vs plain at block {tuple(xe.shape[-2:])}: max abs {ls_err:.3e}; "
        f"middle step {ms_lmid:.4f} ms vs bound {lmid_ms:.4f} ms")
    # 12. sharded small vector grids on the same 1x1 mesh: the fused rounds vs
    # the plain versions, the local step-kernel chain (bit for bit), the tiled
    # plain version of the fused round and the unsharded filter
    from gcm_filters_tpu_torch.ops.cuda.vec_local_pass import (
        vec_local_fused_pass_reference, vec_local_fused_pass_tiled_reference,
        vec_local_pass_reference,
    )
    from gcm_filters_tpu_torch.ops.cuda.ring_pass import (
        RingState, ring_fused_pass_reference, ring_pass_reference, vec_ring_fused_pass_reference,
        vec_ring_pass_reference,
    )
    from gcm_filters_tpu_torch.parallel.sharded import make_sharded_vector_apply

    svworst = {op: {"float32": [0.0, 0.0], "float64": [0.0, 0.0]} for op in (BGRID, CTAP)}
    svfworst = {op: {"vs_tiled": 0.0, "cases": 0} for op in (BGRID, CTAP)}
    vlocal_step_path = {BGRID: 0, CTAP: 0}  # vec_local_pass launched below the predicate

    def check_sharded_vector(label, op, u, v, dtype_name, want_fused=True, **kw):
        filt = Filter(device=dev, mesh=mesh, spatial_axes=axes, **kw)
        mk = lambda **k: make_sharded_vector_apply(  # noqa: E731
            filt.operator, filt.filter_spec, mesh, axes, halo_steps=filt.halo_steps, **k)
        key = vkey[op]
        uc, vc = filt._coerce(u), filt._coerce(v)
        before = counters()
        got = filt.apply_to_vector(u, v)
        torch.cuda.synchronize()
        plans = filt._vector_fn().plan(*uc.shape[-2:], got[0].dtype)
        fused = all(pl.fused for pl in plans)
        if fused != want_fused:
            raise AssertionError(f"{label}: fused rounds {fused}, expected {want_fused}")
        # a round's first launch reads strips, its later ones the extended carries
        launched = launched_since(
            before, label, {f"vec_local_strip_pass_{key}": len(plans),
                            f"vec_local_fused_pass_{key}": sum(len(pl.steps) - 1 for pl in plans)}
            if fused else {f"vec_local_pass_{key}": filt.n_steps})
        vlocal_step_path[op] += launched[f"vec_local_pass_{key}"]
        if not all(isinstance(g, DTensor) for g in got):
            raise AssertionError(f"{label}: the mesh path returned {[type(g).__name__ for g in got]}")
        got = [g.full_tensor() for g in got]
        want = [w.full_tensor() for w in mk(pass_fn=vec_local_pass_reference,
                                            fused_fn=vec_local_fused_pass_reference)(uc, vc)]
        chain = [w.full_tensor() for w in mk(fused_fn=None)(uc, vc)]
        tiled = None
        if fused:
            tiled = [w.full_tensor()
                     for w in mk(fused_fn=vec_local_fused_pass_tiled_reference)(uc, vc)]
        kw.pop("halo_steps", None)
        unsharded = Filter(device=dev, **kw).apply_to_vector(u, v)
        errs, uerr, t_err = [], 0.0, 0.0
        for m, (comp, g, w, un) in enumerate(zip("uv", got, want, unsharded)):
            if g.shape != w.shape or g.device.type != "cuda":
                raise AssertionError(f"{label} {comp}: result {tuple(g.shape)} on {g.device}")
            errs.append(compare(f"{label} {comp}", g, w, dtype_name))
            bitwise(f"{label} {comp}", g, chain[m], "the local step-kernel chain")
            if tiled is not None:
                t_err = max(t_err, compare(f"{label} {comp} vs tiled", g, tiled[m],
                                           dtype_name)[0])
            if not torch.equal(torch.isnan(g), torch.isnan(un)):
                raise AssertionError(f"{label} {comp}: NaN positions differ from the unsharded filter")
            torch.testing.assert_close(g, un, equal_nan=True, **tol_unsharded[dtype_name],
                                       msg=lambda m: f"{label} {comp} vs unsharded: {m}")
            ok = ~torch.isnan(un)
            uerr = max(uerr, float((g[ok] - un[ok]).abs().max()))
        a, r = max(e[0] for e in errs), max(e[1] for e in errs)
        w8 = svworst[op][dtype_name]
        svworst[op][dtype_name] = [max(w8[0], a), max(w8[1], r)]
        if tiled is not None:
            svfworst[op]["vs_tiled"] = max(svfworst[op]["vs_tiled"], t_err)
            svfworst[op]["cases"] += 1
        route = (f"fused rounds {[(pl.tile, pl.steps) for pl in plans]}" if fused
                 else "step chain")
        log(f"  {label}: {route}: vs plain max abs {a:.3e} max rel {r:.3e}"
            f"{f', vs tiled plain {t_err:.3e}' if tiled is not None else ''}; vs the local "
            f"step chain 0 (bit for bit); vs unsharded max abs {uerr:.3e} "
            f"({sum(launched.values())} launches)")
        return got

    log(f"sharded small vector grids on a 1x1 mesh at {vshape}:")
    for gname, ka in cases:
        op = vec_ops[gname]
        gv = unit_vector_grid_vars(gname, vshape, np.random.default_rng(42), ka)
        tag = f" kappa_aniso={ka:g}" if gname == "VECTOR_C_GRID" else ""
        for dt, name in both:
            check_sharded_vector(f"sharded {gname} unit metrics{tag} {name}", op, u_s, v_s, name,
                                 filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                                 grid_vars=gv, dtype=dt)
    u_c, v_c = u_n.copy(), v_n.copy()
    u_c[0, 0] = np.nan              # core corners: their halo copies sit on the
    v_c[vshape[0] - 1, 0] = np.nan  # opposite corners of the extended block
    u_k, v_k = u_s.copy(), v_s.copy()
    u_k[0, 0], v_k[0, -1], u_k[-1, 0], v_k[-1, -1] = 50.0, -40.0, 30.0, -20.0
    for gname, op in vec_ops.items():
        g = GridType[gname]
        gv = spherical_vector_grid_vars(required_grid_vars(g), vshape)
        check_sharded_vector(f"sharded {gname} spherical float64", op, u_s, v_s, "float64",
                             filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=gv)
        gv = unit_vector_grid_vars(gname, odd, np.random.default_rng(42), 0.0)
        for dt, name in both:
            check_sharded_vector(f"sharded {gname} {odd} {name}", op, u_o, v_o, name,
                                 filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=gv,
                                 dtype=dt)
        gv = unit_vector_grid_vars(gname, vshape, np.random.default_rng(42), 0.0)
        check_sharded_vector(f"sharded {gname} batch (2, 128, 256) float64", op,
                             np.stack([u_s, v_s]), np.stack([v_s[::-1].copy(), u_s]), "float64",
                             filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=gv)
        for dt, name in both:
            fu, fv = check_sharded_vector(f"sharded {gname} NaN in u and v, at core corners "
                                          f"{name}", op, u_c, v_c, name, filter_scale=6.0,
                                          dx_min=1.0, grid_type=g, grid_vars=gv, dtype=dt)
            if not (bool(torch.isnan(fu[10, 20])) and bool(torch.isnan(fv[50, 7]))
                    and bool(torch.isnan(fu[0, 0])) and bool(torch.isnan(fv[-1, 0]))):
                raise AssertionError("NaN cells must stay NaN")
            check_sharded_vector(f"sharded {gname} spikes at the core corners {name}", op, u_k,
                                 v_k, name, filter_scale=6.0, dx_min=1.0, grid_type=g,
                                 grid_vars=gv, dtype=dt)
            for hs in (1, 3, None):
                check_sharded_vector(f"sharded {gname} halo_steps={hs} {name}", op, u_s, v_s,
                                     name, filter_scale=6.0, dx_min=1.0, grid_type=g,
                                     grid_vars=gv, dtype=dt, halo_steps=hs)
        # the Taper (dx_min = 0.9, see phase 6): several rounds of up to 16 steps
        check_sharded_vector(f"sharded {gname} TAPER float64", op, u_s, v_s, "float64",
                             filter_scale=6.0, dx_min=0.9, filter_shape=FilterShape.TAPER,
                             grid_type=g, grid_vars=gv)
        # below the predicate the local step chain runs, by a static test
        small = (12, 30)
        check_sharded_vector(f"sharded {gname} {small} below the fused predicate float64", op,
                             vrng.random(small), vrng.random(small), "float64",
                             want_fused=False, filter_scale=6.0, dx_min=1.0, grid_type=g,
                             grid_vars=unit_vector_grid_vars(gname, small,
                                                             np.random.default_rng(42), 0.0))
    # a C-grid operator that does not scrub NaNs: the NaN spreads through the
    # sharded rounds exactly as through the unsharded kernel path
    c_gv = unit_vector_grid_vars("VECTOR_C_GRID", vshape, np.random.default_rng(42), 0.0)
    c_op = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType.VECTOR_C_GRID,
                  grid_vars=c_gv, device=dev).operator
    for hs in (3, None):
        fu, fv = check_sharded_vector(f"sharded VECTOR_C_GRID zap_nans=False halo_steps={hs} "
                                      "float64", CTAP, u_n, v_n, "float64", filter_scale=6.0,
                                      dx_min=1.0, halo_steps=hs,
                                      custom_operator=dataclasses.replace(c_op, zap_nans=False))
        spread = int(torch.isnan(fu).sum()), int(torch.isnan(fv).sum())
        log(f"  zap_nans=False: NaN cells in (u, v) after the filter {spread}")
        if min(spread) <= 1:
            raise AssertionError(f"an unscrubbed NaN must spread, saw {spread} NaN cells")
    for op, k in vkey.items():
        log(f"fused local {k} rounds on {svfworst[op]['cases']} small cases: vs the local "
            f"step-kernel chain max abs 0 (bit for bit, NaNs in the same cells); vs plain max "
            f"abs {max(svworst[op]['float32'][0], svworst[op]['float64'][0]):.3e}; vs the tiled "
            f"plain version max abs {svfworst[op]['vs_tiled']:.3e}")

    # 13. sharded vector headlines: the phase-7 workloads through the mesh path
    from gcm_filters_tpu_torch.utils.round_split import round_parts

    w_dev = torch.stack([u_dev, v_dev]).unsqueeze(0)  # (1, 2, ny, nx), the parent's stack
    uv = (u_dev[None], v_dev[None])  # what the rounds read now, in place
    svec_results, svfused_results, svstrip_results = {}, {}, {}
    for gname, op in vec_ops.items():
        key = "bgrid" if op == BGRID else "ctap"
        mine, step_mine = f"vec_local_fused_pass_{key}", f"vec_local_pass_{key}"
        strip_mine = f"vec_local_strip_pass_{key}"
        kept = vec_kept[op]
        svhead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                        grid_vars=kept["gv"], dtype=torch.float32, device=dev,
                        mesh=mesh, spatial_axes=axes)
        vn = svhead.n_steps
        svfn = svhead._vector_fn()
        (splan,) = svfn.plan(ny, nx, torch.float32)
        torch.cuda.synchronize()
        reset_fallback_counts()
        reset_counters()
        t0 = time.perf_counter()
        su, sv = svhead.apply_to_vector(u_h, v_h)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(warm):
            svhead.apply_to_vector(u_dev, v_dev)
        ms_sv, host_sv = event_ms(lambda: svhead.apply_to_vector(u_dev, v_dev), chain,
                                  host=True)
        counts = counters()
        sv_launches, sv_strip_launches = counts.pop(mine), counts.pop(strip_mine)
        sv_fallbacks = fallback_counts()
        log(f"sharded headline {ny}x{nx} float32 {gname} on a 1x1 mesh, n_steps {vn}, round "
            f"plan tile {splan.tile} launches {splan.steps}: {sv_strip_launches} {strip_mine} "
            f"and {sv_launches} {mine} launches over {applies} applies (first apply with "
            f"operand set-up {first_s:.2f} s), other kernels {counts}, fallbacks {sv_fallbacks}")
        # the round's first launch reads the strips, its later ones the extended carries
        if (not splan.fused or sv_strip_launches != applies
                or sv_launches != (len(splan.steps) - 1) * applies):
            raise AssertionError(
                f"expected {applies} strip and {(len(splan.steps) - 1) * applies} extended-block "
                f"launches, saw {sv_strip_launches} and {sv_launches}")
        if any(counts.values()):
            raise AssertionError(f"the sharded vector path launched another kernel: {counts}")
        if sv_fallbacks:
            raise AssertionError(f"fallbacks recorded on the kernel path: {sv_fallbacks}")
        if not (isinstance(su, DTensor) and isinstance(sv, DTensor)):
            raise AssertionError(f"the mesh path returned {type(su).__name__}")
        su, sv = su.full_tensor(), sv.full_tensor()
        sv_err = sv_vs_k = 0.0
        for comp, g, w, un in zip("uv", (su, sv), kept["want"], kept["out"]):
            if g.shape != (ny, nx) or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
                raise AssertionError(
                    f"sharded {gname} headline {comp} is not a finite float32 (ny, nx) tensor")
            torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
            sv_err = max(sv_err, float((g.double() - w).abs().max()))
            sv_vs_k = max(sv_vs_k, bitwise(f"sharded {gname} headline {comp}", g, un,
                                           "the fused unsharded path"))
        log(f"sharded {gname} headline vs eager engine in float64: max abs {sv_err:.3e}; "
            f"vs the unsharded (fused) kernel path: max abs {sv_vs_k:.3e} (bit for bit)")

        lvops, cells, vrounds, lvp = svfn.operands(ny, nx, torch.float32)
        if vrounds != (vn,):
            raise AssertionError(f"expected one round of {vn} steps, planned {vrounds}")
        n_coef = lvops.coef.shape[0]
        # the chain of local step-kernel launches: the same bits, timed in the same run
        steps_sv = make_sharded_vector_apply(svhead.operator, svhead.filter_spec, mesh, axes,
                                             fused_fn=None)
        sv_vs_steps = max(bitwise(f"sharded {gname} headline {comp}", g, w.full_tensor(),
                                  "the local step-kernel chain")
                          for comp, g, w in zip("uv", (su, sv), steps_sv(u_dev, v_dev)))
        before = counters()[f"vec_local_pass_{key}"]
        ms_sv_steps, host_sv_steps = event_ms(lambda: steps_sv(u_dev, v_dev), chain, host=True)
        svstep_launches = (counters()[f"vec_local_pass_{key}"] - before) // chain
        plain_sv = make_sharded_vector_apply(svhead.operator, svhead.filter_spec, mesh, axes,
                                             pass_fn=vec_local_pass_reference,
                                             fused_fn=vec_local_fused_pass_reference)
        plain_sv(u_dev, v_dev)
        ms_sv_plain = event_ms(lambda: plain_sv(u_dev, v_dev), 5)

        # the apply's parts alone (utils/round_split.py): the stack and the
        # extended block that the parent's rounds built, the strips that the
        # rounds exchange now, and the rounds with their strips frozen; then
        # the parent's round on the extended block alone, and the chain of
        # local steps alone on it
        sparts, sinfo = round_parts(svhead, u_dev, v_dev)
        if not sinfo["rounds_alone_equal_apply"]:
            raise AssertionError(f"{gname}: the rounds alone differ from the apply")
        ms_vstack = event_ms(sparts["stack"], chain)
        ms_vex = event_ms(sparts["exchange"], chain)
        ms_vstrips = event_ms(sparts["strips"], chain)
        ms_vround = event_ms(sparts["rounds_alone"], chain)
        we = halo.exchange_2d(w_dev, cells, local_axis, local_axis)
        sstrips = halo.exchange_strips(uv, cells, local_axis, local_axis, stack_dim=1)

        def run_round(pl, ops_, p_, we_, acc_, fn=vec_local_fused_pass, fill=None,
                      strips_=None):
            """The round's launches of ``fn`` as the plan ``pl`` splits it, as
            the rounds run them: the result in ``acc_``. The first launch
            reads ``strips_ = ((u, v), strips)`` where given (the apply's
            route), else the exchanged input ``we_`` (the parent's). With
            ``fill`` every launch's t_out and t_prev_out start filled with
            it."""
            t_ = tp_ = None
            start, left = 0, vn
            for n_ops in pl.steps:
                left -= n_ops
                new_ = torch.empty_like if fill is None else (
                    lambda x: torch.full_like(x, fill))
                outs = (None, None) if left == 0 else (new_(we_), new_(we_))
                src = {}
                if start == 0:
                    src = dict(w=strips_[0], strips=strips_[1]) if strips_ else dict(w=we_)
                fn(ops_, p_, start, n_ops, cells=cells, shrink=cells - left, tile=pl.tile,
                   t=t_, t_prev=tp_, t_out=outs[0], t_prev_out=outs[1], acc=acc_, **src)
                t_, tp_ = outs
                start += n_ops
            return acc_

        racc, sacc = torch.empty_like(w_dev), torch.empty_like(w_dev)
        ext_round = lambda: run_round(splan, lvops, lvp, we, racc)  # noqa: E731
        ext_round()
        ms_ext_round = event_ms(ext_round, chain)
        run_round(splan, lvops, lvp, we, sacc, strips_=(uv, sstrips))
        for m, (comp, g) in enumerate((("u", su), ("v", sv))):
            bitwise(f"{gname} the parent's round alone {comp}", racc[0, m], g,
                    "the sharded apply")
            bitwise(f"{gname} the round on strips {comp}", sacc[0, m], racc[0, m],
                    "the parent's round on the extended block")

        # the strip launch alone (the round's first): its carries and acc bit
        # for bit equal to the parent's first launch on the extended block,
        # its acc against its plain version (the carries out start as NaN:
        # every version writes only the block shrunk by the launch's shrink)
        n0, left0 = splan.steps[0], vn - splan.steps[0]

        def launch_outs():
            return ([None, None] if left0 == 0
                    else [torch.full_like(we, float("nan")) for _ in range(2)],
                    torch.empty_like(w_dev))

        (s_out, s_acc), (e_out, e_acc), (p_out, p_acc) = (launch_outs() for _ in range(3))

        def first_launch(fn=vec_local_fused_pass, strips_=True, outs_=s_out, acc_=s_acc):
            src = dict(w=uv, strips=sstrips) if strips_ else dict(w=we)
            fn(lvops, lvp, 0, n0, cells=cells, shrink=cells - left0, tile=splan.tile,
               t_out=outs_[0], t_prev_out=outs_[1], acc=acc_, **src)

        ext_first = lambda: first_launch(strips_=False, outs_=e_out, acc_=e_acc)  # noqa: E731
        first_launch()
        ext_first()
        ms_strip = event_ms(first_launch, chain)
        ms_ext_first = event_ms(ext_first, chain)
        for name_, g_, w_ in zip(("t_out", "t_prev_out", "acc"), s_out + [s_acc],
                                 e_out + [e_acc]):
            if g_ is not None:
                bitwise(f"{gname} strip launch {name_}", g_, w_,
                        "the parent's first launch on the extended block")
        first_launch(vec_local_fused_pass_reference, outs_=p_out, acc_=p_acc)
        ms_strip_plain = event_ms(
            lambda: first_launch(vec_local_fused_pass_reference, outs_=p_out, acc_=p_acc), 3)
        strip_err = compare(f"{gname} strip launch acc", s_acc, p_acc, "float32")[0]
        st_bytes, st_flops = vec_launch_cost(n_coef, splan.tile, n0, cells - left0, True,
                                             left0 == 0, 1, ny, nx, cells, item, key)
        stb_ms, stb_by = bound_ms(st_bytes, st_flops, "float32")
        del s_out, s_acc, e_out, e_acc, p_out, p_acc

        vc = [torch.zeros_like(we), torch.zeros_like(we), torch.zeros_like(w_dev)]

        def vec_local_chain():
            # as the rounds run it, but T_2 goes to a third buffer so that the
            # input `we` survives for the next repeat (same bytes moved)
            a_, b_, acc_ = vc
            vec_local_pass(lvops, FIRST, lvp[0], lvp[1], cells=cells, w=we, t_next=a_, acc=acc_)
            vec_local_pass(lvops, MIDDLE, lvp[2], cells=cells, shrink=2,
                           t=a_, t_prev=we, t_next=b_, acc=acc_)
            t_, t_prev_ = b_, a_
            for k in range(3, vn):
                vec_local_pass(lvops, MIDDLE, lvp[k], cells=cells, shrink=k,
                               t=t_, t_prev=t_prev_, t_next=t_prev_, acc=acc_)
                t_, t_prev_ = t_prev_, t_
            vec_local_pass(lvops, LAST, lvp[vn], cells=cells, t=t_, t_prev=t_prev_, acc=acc_)

        vec_local_chain()
        ms_vchain = event_ms(vec_local_chain, chain)
        for m, (comp, g) in enumerate((("u", su), ("v", sv))):
            bitwise(f"{gname} the local steps alone {comp}", vc[2][0, m], g, "the sharded apply")
        del vc

        svkinds = [(FIRST, 1)] + [(MIDDLE, k) for k in range(2, vn)] + [(LAST, cells)]
        sv_bytes = sum(vec_local_step_bytes(k, n_coef, 1, ny, nx, cells, sh, item)
                       for k, sh in svkinds)
        sv_cells = sum((ny + 2 * (cells - sh)) * (nx + 2 * (cells - sh)) for _, sh in svkinds)
        sv_flops = VEC_FLOPS_PER_CELL_STEP[key] * sv_cells
        svb_ms, svb_by = bound_ms(sv_bytes, sv_flops, "float32")
        svfb_ms, svfb_by = bound_ms((n_coef + 4) * ny * nx * item,
                                    VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * vn, "float32")
        sr_bytes, sr_flops = vec_rounds_cost(n_coef, [splan], 1, ny, nx, cells, item, key)
        srb_ms, srb_by = bound_ms(sr_bytes, sr_flops, "float32")
        log(f"sharded {gname} headline: {ms_sv:.4f} ms/apply fused (host enqueue {host_sv:.4f} "
            f"ms/apply) = {ny * nx * vn / (ms_sv * 1e-3):.4e} grid-point-steps/s on {smi}; bit "
            f"for bit equal to the local step chain, {ms_sv_steps:.4f} ms/apply in "
            f"{svstep_launches} launches (host enqueue {host_sv_steps:.4f})")
        log(f"  strips alone ({cells} cells) {ms_vstrips:.4f} ms; the fused round alone on "
            f"strips ({splan.tile} {splan.steps}) {ms_vround:.4f} ms, its first launch "
            f"{ms_strip:.4f} ms (on the extended block {ms_ext_first:.4f}, plain "
            f"{ms_strip_plain:.4f}, max abs {strip_err:.3e}, bound {stb_ms:.4f} ms, {stb_by}); "
            f"the parent's parts: stack {ms_vstack:.4f} ms, halo exchange (block "
            f"{tuple(we.shape[-2:])}) {ms_vex:.4f} ms, round on the extended block "
            f"{ms_ext_round:.4f} ms (bit for bit equal to the round on strips); the {vn} local "
            f"steps alone {ms_vchain:.4f} ms; unsharded fused path "
            f"{vec_fused_results[op]['ms']:.4f} ms/apply")
        log(f"  plan bound {srb_ms:.4f} ms ({sr_bytes / 1e9:.3f} GB, {sr_flops / 1e9:.2f} GFLOP "
            f"with the trapezoid's redundant cells, {srb_by}); whole-filter bound {svfb_ms:.4f} "
            f"ms; step chain's per-launch bound {svb_ms:.4f} ms ({sv_bytes / 1e9:.3f} GB, "
            f"{svb_by}); plain PyTorch {ms_sv_plain:.4f} ms/apply")

        # 13b. the round sweep: every tile at one launch per round (a) and at
        # balanced splits into several launches (b), in float32 and float64,
        # each bitwise equal to the planned round of its dtype
        rsweep = {}
        for dt_, tag, reps in ((torch.float32, "float32", 10), (torch.float64, "float64", 5)):
            ops_, _, _, p_ = svfn.operands(ny, nx, dt_)
            we_ = we.to(dt_)
            uv_ = tuple(x.to(dt_) for x in uv)
            st_ = (uv_, halo.exchange_strips(uv_, cells, local_axis, local_axis, stack_dim=1))
            acc_ = torch.empty_like(w_dev, dtype=dt_)
            (pl_ref,) = svfn.plan(ny, nx, dt_)
            ref_ = run_round(pl_ref, ops_, p_, we_, acc_, strips_=st_).clone()
            isz = we_.element_size()
            for tl in vec_tiles(op, isz):
                for cap in (11, 6, 4):
                    split_ = _balanced(vn, cap)
                    if vec_fused_shared_bytes(tl, max(split_), n_coef, isz) > SHARED_BYTES:
                        continue
                    pl = FusedPlan(tl, max(split_), split_, True)
                    k_ = f"{tag} {tl[0]}x{tl[1]} {'+'.join(map(str, split_))}"
                    run = lambda: run_round(pl, ops_, p_, we_, acc_, strips_=st_)  # noqa: E731
                    bitwise(f"{gname} round sweep {k_}", run(), ref_, "the planned round")
                    rsweep[k_] = event_ms(run, reps)
                    log(f"  round {k_}: {rsweep[k_]:.4f} ms; model cost "
                        f"{_vec_pass_cost(op, tl, split_, isz):.2f} per cell")
            del ops_, we_, uv_, st_, acc_, ref_

        # 14. each step kind of the windowed local kernel against its plain
        # version, at the headline's extended shape (buffers start at zero: a
        # step leaves the cells outside its window untouched, in both versions)
        vk, vr = ([we.clone(), torch.zeros_like(we), torch.zeros_like(w_dev)] for _ in "kr")
        lv_err = 0.0
        for bufs_, f in ((vk, vec_local_pass), (vr, vec_local_pass_reference)):
            w0_, t_, acc_ = bufs_
            f(lvops, FIRST, lvp[0], lvp[1], cells=cells, shrink=1, w=w0_, t_next=t_, acc=acc_)
        torch.cuda.synchronize()
        for i in (1, 2):
            lv_err = max(lv_err, compare(f"{gname} local FIRST step out {i}", vk[i], vr[i],
                                         "float32")[0])
        for i in range(3):
            vr[i].copy_(vk[i])
        for bufs_, f in ((vk, vec_local_pass), (vr, vec_local_pass_reference)):
            w0_, t_, acc_ = bufs_
            f(lvops, MIDDLE, lvp[2], cells=cells, shrink=2, t=t_, t_prev=w0_, t_next=w0_, acc=acc_)
        torch.cuda.synchronize()
        for i in (0, 2):
            lv_err = max(lv_err, compare(f"{gname} local MIDDLE step out {i}", vk[i], vr[i],
                                         "float32")[0])
        for i in range(3):
            vr[i].copy_(vk[i])
        for bufs_, f in ((vk, vec_local_pass), (vr, vec_local_pass_reference)):
            w0_, t_, acc_ = bufs_
            f(lvops, LAST, lvp[3], cells=cells, t=w0_, t_prev=t_, acc=acc_)
        torch.cuda.synchronize()
        lv_err = max(lv_err, compare(f"{gname} local LAST step", vk[2], vr[2], "float32")[0])
        w0_, t_, acc_ = vk
        ms_lvmid = event_ms(lambda: vec_local_pass(lvops, MIDDLE, lvp[2], cells=cells, shrink=2,
                                                   t=t_, t_prev=w0_, t_next=w0_, acc=acc_), 100)
        lvmid_ms, _ = bound_ms(
            vec_local_step_bytes(MIDDLE, n_coef, 1, ny, nx, cells, 2, item),
            VEC_FLOPS_PER_CELL_STEP[key] * (ny + 2 * (cells - 2)) * (nx + 2 * (cells - 2)),
            "float32")
        log(f"{gname} local step kinds vs plain at block {tuple(we.shape[-2:])}: max abs "
            f"{lv_err:.3e}; middle step {ms_lvmid:.4f} ms vs bound {lvmid_ms:.4f} ms")
        del vk, vr
        # the fused round against its plain version: the planned round and one
        # launch of all 11 steps (split (a), where a tile holds it) in float32,
        # the float64 plan in float64; acc and every launch's carries out start
        # as NaN (a tile that a launch skipped would keep it)
        # the round on strips too, against its plain version and bit for bit
        # against the parent's round on the extended block
        lf_err = {"float32": 0.0, "float64": 0.0}
        lstrip_err = {"float32": 0.0, "float64": 0.0}
        one = next(tl for tl in VEC_TILES[op]
                   if vec_fused_shared_bytes(tl, vn, n_coef, item) <= SHARED_BYTES)
        for tag, dt_, pl in (("float32", torch.float32, splan),
                             ("float32", torch.float32, FusedPlan(one, vn, (vn,), True)),
                             ("float64", torch.float64, svfn.plan(ny, nx, torch.float64)[0])):
            ops_, _, _, p_ = svfn.operands(ny, nx, dt_)
            we_ = we.to(dt_)
            uv_ = tuple(x.to(dt_) for x in uv)
            st_ = (uv_, halo.exchange_strips(uv_, cells, local_axis, local_axis, stack_dim=1))
            got_k, got_r, got_sk, got_sr = (
                run_round(pl, ops_, p_, we_, torch.full_like(w_dev, float("nan"), dtype=dt_),
                          fn, fill=float("nan"), strips_=sv_)
                for sv_ in (None, st_)
                for fn in (vec_local_fused_pass, vec_local_fused_pass_reference))
            label_ = f"{gname} fused round {pl.tile} {pl.steps} {tag}"
            lf_err[tag] = max(lf_err[tag], compare(label_, got_k, got_r, tag)[0])
            lstrip_err[tag] = max(lstrip_err[tag], compare(label_ + " on strips", got_sk, got_sr,
                                                           tag)[0])
            bitwise(label_ + " on strips", got_sk, got_k, "the round on the extended block")
            del ops_, we_, uv_, st_, got_k, got_r, got_sk, got_sr
        log(f"{gname} fused round vs plain at block {tuple(we.shape[-2:])}: max abs "
            f"{lf_err['float32']:.3e} (float32), {lf_err['float64']:.3e} (float64); on strips "
            f"{lstrip_err['float32']:.3e}, {lstrip_err['float64']:.3e}, bit for bit equal to the round "
            f"on the extended block")

        # 13c. the C-grid Taper through the mesh: 44 steps in three rounds,
        # whose later rounds cut their strips from the carries' cores
        taper = None
        if op == CTAP:
            tkw = dict(filter_scale=10.0, dx_min=0.9, filter_shape=FilterShape.TAPER,
                       grid_type=GridType[gname], grid_vars=kept["gv"], dtype=torch.float32,
                       device=dev)
            kt = Filter(**tkw)
            kt_out = kt.apply_to_vector(u_dev, v_dev)
            ms_kt = event_ms(lambda: kt.apply_to_vector(u_dev, v_dev), 10)
            stf = Filter(mesh=mesh, spatial_axes=axes, **tkw)
            tcells, trounds = stf._vector_fn().operands(ny, nx, torch.float32)[1:3]
            tplans = stf._vector_fn().plan(ny, nx, torch.float32)
            reset_counters()
            tsu, tsv = stf.apply_to_vector(u_dev, v_dev)
            torch.cuda.synchronize()
            launched_since({k: 0 for k in counters()}, "sharded TAPER " + gname, {
                strip_mine: len(tplans), mine: sum(len(pl.steps) - 1 for pl in tplans)})
            t_vs_k = max(bitwise(f"sharded TAPER {gname} {comp}", g.full_tensor(), w,
                                 "the unsharded (fused) kernel path")
                         for comp, g, w in zip("uv", (tsu, tsv), kt_out))
            ms_st, host_st = event_ms(lambda: stf.apply_to_vector(u_dev, v_dev), 10, host=True)
            tparts, tinfo = round_parts(stf, u_dev, v_dev)
            if not tinfo["rounds_alone_equal_apply"]:
                raise AssertionError(f"sharded TAPER {gname}: the rounds alone differ")
            tsplit = {k + "_ms": event_ms(f, 5) for k, f in tparts.items() if k != "apply"}
            tb_ms, tb_by = bound_ms(*vec_rounds_cost(n_coef, tplans, 1, ny, nx, tcells, item,
                                                     key), "float32")
            tfb_ms, _ = bound_ms((n_coef + 4) * ny * nx * item,
                                 VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * stf.n_steps,
                                 "float32")
            log(f"sharded TAPER {gname} {ny}x{nx} float32 on a 1x1 mesh, {stf.n_steps} steps "
                f"in rounds {trounds} (cells {tcells}), plans "
                f"{[(pl.tile, pl.steps) for pl in tplans]}: {ms_st:.4f} ms/apply (host enqueue "
                f"{host_st:.4f}), bit for bit equal to the unsharded {ms_kt:.4f} ms/apply; "
                + ", ".join(f"{k} {v_:.4f}" for k, v_ in tsplit.items())
                + f"; plan bound {tb_ms:.4f} ms ({tb_by}), whole-filter bound {tfb_ms:.4f} ms")
            taper = dict({"ms": ms_st, "host_enqueue_ms": host_st, "n_steps": stf.n_steps,
                          "rounds": list(trounds), "cells": tcells,
                          "plans": [[list(pl.tile), list(pl.steps)] for pl in tplans],
                          "launches_per_apply": len(tplans) + sum(len(pl.steps) - 1
                                                                   for pl in tplans),
                          "strip_launches_per_apply": len(tplans),
                          "vs_unsharded_kernel_max_abs": t_vs_k, "unsharded_ms": ms_kt,
                          "plan_bound_ms": tb_ms, "filter_bound_ms": tfb_ms}, **tsplit)
            del kt, kt_out, stf, tsu, tsv, tparts

        worst_sv = svworst[op]
        replaces = ("gcm_filters_tpu/parallel/sharded.py:908 (gcm_filters_tpu/ops/pallas/"
                    "vec_pass.py:" + ("567" if op == BGRID else "575") + ")")
        block = tuple(we.shape[-2:])
        svec_results[op] = {
            "name": step_mine,
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": replaces,
            "launches": vlocal_step_path[op],
            "launches_from": "Filter(mesh=...).apply_to_vector of a block below the fused "
                             "predicate (phase 12)",
            "max_abs_err": max(lv_err, worst_sv["float32"][0], worst_sv["float64"][0]),
            "max_rel_err_f64": worst_sv["float64"][1],
            "ms": ms_sv_steps,
            "plain_ms": ms_sv_plain,
            "bound_ms": svb_ms,
            "bound_by": svb_by,
            "library_ms": None,
            "unit": f"one sharded headline apply on a 1x1 mesh as the step chain = one halo "
                    f"exchange + {svstep_launches} launches, {ny}x{nx} float32 {gname}, block "
                    f"{block}",
            "filter_bound_ms": svfb_ms,
            "launches_per_apply": svstep_launches,
            "bytes_moved": sv_bytes,
            "plan_bound_ms": svb_ms,
            "middle_step_ms": ms_lvmid,
            "middle_step_bound_ms": lvmid_ms,
            "exchange_ms": ms_vex,
            "steps_alone_ms": ms_vchain,
            "host_enqueue_ms": host_sv_steps,
        }
        svfused_results[op] = {
            "name": mine,
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": replaces,
            "launches": sv_launches,
            "launches_per_apply": len(splan.steps) - 1,
            "strip_launches_per_apply": 1,
            "max_abs_err": max(lf_err["float32"], lf_err["float64"], worst_sv["float32"][0],
                               worst_sv["float64"][0], svfworst[op]["vs_tiled"]),
            "vs_step_chain_max_abs": sv_vs_steps,
            "vs_unsharded_kernel_max_abs": sv_vs_k,
            "headline_vs_f64_engine_max_abs": sv_err,
            "ms": ms_sv,
            "plain_ms": ms_sv_plain,
            "bound_ms": svfb_ms,
            "bound_by": svfb_by,
            "library_ms": None,
            "unit": f"one sharded headline apply on a 1x1 mesh = the halo strips + "
                    f"{len(splan.steps)} launch(es) of {splan.steps} steps on "
                    f"{splan.tile[0]}x{splan.tile[1]} tiles, the first on strips, "
                    f"{ny}x{nx} float32 {gname}, block {block}",
            "bytes_moved": sr_bytes,
            "plan_bound_ms": srb_ms,
            "filter_bound_ms": svfb_ms,
            "step_chain_ms": ms_sv_steps,
            "strips_ms": ms_vstrips,
            "round_alone_ms": ms_vround,
            "stack_ms": ms_vstack,
            "exchange_ms": ms_vex,
            "extended_round_alone_ms": ms_ext_round,
            "steps_alone_ms": ms_vchain,
            "unsharded_ms": vec_fused_results[op]["ms"],
            "host_enqueue_ms": host_sv,
            "round_sweep_ms": rsweep,
            "taper": taper,
            "ptxas": vec_tile_ptxas("vec_pass", "vec_fused_kernel", op, "RoundGeo"),
        }
        svstrip_results[op] = {
            "name": strip_mine,
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": replaces,
            "launches": sv_strip_launches,
            "launches_per_apply": 1,
            "max_abs_err": max(strip_err, lstrip_err["float32"], lstrip_err["float64"]),
            "vs_extended_round_max_abs": 0.0,
            "ms": ms_strip,
            "plain_ms": ms_strip_plain,
            "bound_ms": stb_ms,
            "bound_by": stb_by,
            "library_ms": None,
            "unit": f"one launch, the round's first: {n0} steps on {splan.tile[0]}x"
                    f"{splan.tile[1]} tiles reading u and v in place and their halo strips, "
                    f"{ny}x{nx} float32 {gname}",
            "bytes_moved": st_bytes,
            "extended_first_launch_ms": ms_ext_first,
            "strips_ms": ms_vstrips,
            "ptxas": vec_tile_ptxas("vec_pass", "vec_strip_kernel", op),
        }
        del we, racc, sacc, sparts, sstrips, plain_sv, steps_sv, svhead, svfn, lvops, su, sv
    dist.destroy_process_group()
    store_dir.cleanup()

    # 15. ring small grids: several y-shards resident on the card
    from gcm_filters_tpu_torch import ResidentMesh
    from gcm_filters_tpu_torch.parallel.ring import (
        make_ring_scalar_apply, make_ring_vector_apply,
    )

    ring_axes = ("y", None)
    rworst = {k: 0.0 for k in ("ring_pass", "ring_fused_pass", "vec_ring_pass_bgrid",
                               "vec_ring_pass_ctap", "vec_ring_fused_pass_bgrid",
                               "vec_ring_fused_pass_ctap")}
    # the step kernels launched by the ring where the plan is not fused (one-row shards)
    ring_step_path = {"ring_pass": 0, "vec_ring_pass_bgrid": 0, "vec_ring_pass_ctap": 0}

    def ring_entry(fn):
        """The one shape_cache entry of a ring apply that has run one shape."""
        (entry,) = fn.shape_cache.values()
        return entry

    def ring_launch_plan(filt):
        """(kernel, launches per apply) of a ring Filter that has run once."""
        if filt.grid_type.name in vec_ops:
            key = vkey[vec_ops[filt.grid_type.name]]
            entry = ring_entry(filt._vector_fn())
            if entry.chain is None:
                return f"vec_ring_pass_{key}", filt.n_steps
            return f"vec_ring_fused_pass_{key}", len(entry.plan.steps)
        entry = ring_entry(filt._scalar_fn())
        if entry.chain is None:
            return "ring_pass", filt.n_steps
        return "ring_fused_pass", len(entry.plan.steps)

    def check_ring(label, p_y, fields, **kw):
        """One ring apply against the unsharded kernel path and the step ring
        (bitwise), and the same ring apply on the plain versions (float32
        tolerance)."""
        rmesh = ResidentMesh(p_y, dev)
        filt = Filter(device=dev, dtype=torch.float32, mesh=rmesh, spatial_axes=ring_axes, **kw)
        base = Filter(device=dev, dtype=torch.float32, **kw)
        vector = len(fields) == 2
        if vector:
            plain = make_ring_vector_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                           pass_fn=vec_ring_pass_reference,
                                           fused_fn=vec_ring_fused_pass_reference)
        else:
            plain = make_ring_scalar_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                           exact_nan=filt.exact_nan, pass_fn=ring_pass_reference,
                                           fused_fn=ring_fused_pass_reference)
        reset_fallback_counts()
        before = counters()
        got = filt.apply_to_vector(*fields) if vector else (filt.apply(fields[0]),)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in counters().items()}
        mine, per_apply = ring_launch_plan(filt)
        want_launched = {k: per_apply if k == mine else 0 for k in before}
        if launched != want_launched:
            raise AssertionError(f"{label}: kernel launches {launched}, expected {want_launched}")
        if mine in ring_step_path:
            ring_step_path[mine] += per_apply
        if fallback_counts():
            raise AssertionError(f"{label}: fallbacks recorded: {fallback_counts()}")
        want = base.apply_to_vector(*fields) if vector else (base.apply(fields[0]),)
        ref = plain(*(filt._coerce(f) for f in fields))
        ref = ref if vector else (ref,)
        a = vs_un = vs_steps = 0.0
        for comp, g, w, r in zip("uv", got, want, ref):
            if type(g) is not torch.Tensor:
                raise AssertionError(f"{label}: the ring returned {type(g).__name__}")
            vs_un = max(vs_un, bitwise(f"{label} {comp}", g, w))
            a = max(a, compare(f"{label} {comp} vs plain ring", g, r, "float32")[0])
        if vector:
            steps_ring = make_ring_vector_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                                fused_fn=None)
        else:
            steps_ring = make_ring_scalar_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                                exact_nan=filt.exact_nan, fused_fn=None)
        steps_out = steps_ring(*(filt._coerce(f) for f in fields))
        for comp, g, s_ in zip("uv", got, steps_out if vector else (steps_out,)):
            vs_steps = max(vs_steps, bitwise(f"{label} {comp} vs step ring", g, s_,
                                             "the step ring"))
        entry = ring_entry(filt._vector_fn() if vector else filt._scalar_fn())
        steps_note = (f"; vs the step ring max abs {vs_steps:.3e}; plan {entry.plan.tile} "
                      f"{entry.plan.steps}{'' if entry.chain else ' not fused'}")
        rworst[mine] = max(rworst[mine], a)
        log(f"  {label}: vs the unsharded kernel path max abs {vs_un:.3e}{steps_note}; vs the "
            f"plain ring max abs {a:.3e} ({launched[mine]} {mine} launches for {p_y} shards)")
        return got

    rshape = (768, 256)
    rrng = np.random.default_rng(5)
    ones_r = np.ones(rshape)
    wet2 = ones_r.copy()
    wet2[:2] = 0
    wet1 = ones_r.copy()
    wet1[0] = 0
    pop = GridType.TRIPOLAR_POP_WITH_LAND
    _, pop_gv = scalar_grid_data(pop, required_grid_vars(pop), rshape)
    x_r = rrng.random(rshape)
    x_nan = x_r.copy()
    x_nan[10, 20] = np.nan  # a wet cell
    std = dict(filter_scale=6.0, dx_min=1.0)
    ring_scalar_cases = [
        ("REGULAR", x_r, dict(std)),
        ("REGULAR n_steps=37", x_r, dict(std, n_steps=37)),
        ("IRREGULAR_WITH_LAND", x_r, dict(
            std, grid_type=GridType.IRREGULAR_WITH_LAND,
            grid_vars=dict(wet_mask=wet2, dxw=ones_r, dyw=ones_r, dxs=ones_r, dys=ones_r,
                           area=ones_r, kappa_w=ones_r, kappa_s=ones_r))),
        (tri.name, x_nan, dict(std, grid_type=tri, grid_vars={
            "area": 0.9 + 0.2 * rrng.random(rshape), "wet_mask": wet1})),
        (pop.name, x_nan, dict(std, grid_type=pop, grid_vars=pop_gv)),
        ("REGULAR_WITH_LAND exact_nan, wet NaN", x_nan, dict(
            std, grid_type=GridType.REGULAR_WITH_LAND, grid_vars={"wet_mask": wet2},
            exact_nan=True)),
        ("REGULAR nx=250", rrng.random((768, 250)), dict(std)),
    ]
    log(f"ring small grids at {rshape}, float32, y-shards resident on the card "
        f"(one launch per fused pass, or per step below the plan, for all shards):")
    for p_y in (2, 4, 8):
        for name, x, kw in ring_scalar_cases:
            got = check_ring(f"ring p_y={p_y} {name}", p_y, (x,), **kw)[0]
            if x is x_nan and not bool(torch.isnan(got[10, 20])):
                raise AssertionError("a NaN cell must stay NaN")
        one_row = (p_y, 70)
        d, v = scalar_grid_data(tri, required_grid_vars(tri), (8, 70))
        check_ring(f"ring p_y={p_y} {tri.name} one-row shards {one_row}", p_y,
                   (d[:p_y],), **dict(std, filter_scale=4.0, grid_type=tri,
                                      grid_vars={k: a[:p_y] for k, a in v.items()}))
        u_r, v_r = rrng.random(rshape), rrng.random(rshape)
        # a NaN on the first row of a shard at a tile corner, spikes at the
        # shard-edge tile corners around it and at another shard edge (row 384
        # is an edge at p_y 2, 4 and 8, row 192 at 4 and 8; tiles are 64 wide):
        # the C-grid's diagonal taps reach across both seams
        u_r[384, 64] = np.nan
        v_r[383, 63], u_r[383, 64], v_r[192, 128], u_r[191, 127] = 50.0, -30.0, 40.0, -20.0
        for gname, ka, extra in (("VECTOR_B_GRID", 0.0, {}), ("VECTOR_C_GRID", 0.0, {}),
                                 ("VECTOR_C_GRID", 1.0, {}),
                                 ("VECTOR_C_GRID", 0.0, {"n_steps": 37})):
            gv = unit_vector_grid_vars(gname, rshape, np.random.default_rng(9), ka)
            tag = f" kappa_aniso={ka:g}" if gname == "VECTOR_C_GRID" else ""
            tag += "".join(f" {k}={val}" for k, val in extra.items())
            fu, _ = check_ring(f"ring p_y={p_y} {gname}{tag}", p_y, (u_r, v_r),
                               **dict(std, grid_type=GridType[gname], grid_vars=gv, **extra))
            if not bool(torch.isnan(fu[384, 64])):
                raise AssertionError("a NaN cell must stay NaN")
        for gname in vec_ops:  # 250 columns: no tile width divides them
            gv = unit_vector_grid_vars(gname, (rshape[0], 250), np.random.default_rng(9), 0.0)
            fu, _ = check_ring(f"ring p_y={p_y} {gname} nx=250", p_y,
                               (np.ascontiguousarray(u_r[:, :250]),
                                np.ascontiguousarray(v_r[:, :250])),
                               **dict(std, grid_type=GridType[gname], grid_vars=gv))
            if not bool(torch.isnan(fu[384, 64])):
                raise AssertionError("a NaN cell must stay NaN")
        for gname in vec_ops:  # one-row shards: the vector step ring
            gv = unit_vector_grid_vars(gname, one_row, np.random.default_rng(9), 0.0)
            check_ring(f"ring p_y={p_y} {gname} one-row shards {one_row}", p_y,
                       (u_r[:p_y, :70], v_r[:p_y, :70]),
                       **dict(std, filter_scale=4.0, grid_type=GridType[gname], grid_vars=gv))

    # sentinel outputs (RingGeo): the ragged fold shape at p_y 4 (shards of
    # 99 rows), a first pass, a middle one and a last one; acc and each
    # pass's carry pair out start as NaN; the own rows after the first and
    # the middle pass bitwise equal to the step-kernel chain, the result to
    # the unsharded step-kernel chain
    from gcm_filters_tpu_torch.ops.cuda.ring_pass import RingFusedOperands, RingFusedState

    n0, n1 = SENT
    sd, sv = scalar_grid_data(tri, required_grid_vars(tri), sshape_s)
    sfilt = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri, grid_vars=sv, device=dev)
    sfn_ = make_cuda_scalar_apply(sfilt.operator, sfilt.filter_spec)
    ssteps_ = make_cuda_scalar_apply(sfilt.operator, sfilt.filter_spec, fused_fn=None)
    (ny_s, nx_s), p_ys = sshape_s, 4
    ly_s = ny_s // p_ys
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        ops_, p_ = sfn_.operands(dt, dev)
        n_all = len(p_) - 1
        steps_ = (n0, n1, n_all - n0 - n1)
        x_ = torch.as_tensor(np.random.default_rng(7).random(sshape_s), dtype=dt, device=dev)
        tl = plan_fused_passes(n_all, ly_s, nx_s, dt, fused_planes(ops_),
                               max_fuse=min(16, ly_s), ring=True).tile
        st_ = RingFusedState(RingFusedOperands.cut(ops_, p_ys, max(steps_)), ly_s, nx_s, dt, dev)
        for r, f in enumerate(st_.input):
            f.copy_(x_[r * ly_s:(r + 1) * ly_s])
        snaps = step_snaps(ops_, p_, x_.reshape(1, ny_s, nx_s), (n0, n0 + n1))
        own = slice(st_.pad, st_.pad + ly_s)
        start = 0
        for m, n in enumerate(steps_):
            for buf in st_.t[m % 2] + st_.t_prev[m % 2] + (st_.acc if m == 0 else []):
                buf.fill_(float("nan"))
            ring_fused_pass(st_, p_, start, n, tile=tl, out=m % 2)
            start += n
            if start in snaps:
                for nm, bufs_, w in zip(("t", "t_prev", "acc"),
                                        (st_.t[m % 2], st_.t_prev[m % 2], st_.acc),
                                        snaps[start]):
                    g = torch.cat([b if nm == "acc" else b[own] for b in bufs_])
                    bitwise(f"ring sentinel pass {m} {name} {tl} {nm}", g, w[0],
                            "the step-kernel chain")
        bitwise(f"ring sentinel result {name} {tl}", torch.cat(st_.acc), ssteps_(x_),
                "the step-kernel chain")
        log(f"  ring p_y={p_ys} {tri.name} {sshape_s} {name}: passes {steps_} on {tl} tiles, "
            f"acc and each carry pair out NaN-filled first: bit for bit equal to the step-kernel "
            f"chain")
    del sfilt, sfn_, ssteps_, st_, snaps, x_

    # 16. ring headlines: the phase-4 and phase-7 workloads on resident shards
    def ring_state(fn):
        """The state and p of a ring apply that has run one shape."""
        entry = ring_entry(fn)
        return entry[0], entry[1]

    def ring_headline(label, mine, p_y, fields_np, fields_dev, unsharded, want64, n_chain=chain,
                      **kw):
        filt = Filter(device=dev, dtype=torch.float32, mesh=ResidentMesh(p_y, dev),
                      spatial_axes=ring_axes, **kw)
        vector = len(fields_np) == 2
        run = filt.apply_to_vector if vector else filt.apply
        torch.cuda.synchronize()
        reset_fallback_counts()
        reset_counters()
        t0 = time.perf_counter()
        first = run(*fields_np)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(warm):
            run(*fields_dev)
        ms, host = event_ms(lambda: run(*fields_dev), n_chain, host=True)
        n_applies = 1 + warm + n_chain
        counts = counters()
        kernel, per_apply = ring_launch_plan(filt)
        if kernel != mine:
            raise AssertionError(f"ring headline {label} p_y={p_y} ran {kernel}, expected {mine}")
        n_launched = counts.pop(mine)
        fb = fallback_counts()
        log(f"ring headline {label}, p_y={p_y}, n_steps {filt.n_steps}: {n_launched} {mine} "
            f"launches over {n_applies} applies (first apply with operand set-up {first_s:.2f} s), "
            f"other kernels {counts}, fallbacks {fb}")
        if n_launched != per_apply * n_applies:
            raise AssertionError(f"expected {per_apply * n_applies} launches, saw {n_launched}")
        if any(counts.values()):
            raise AssertionError(f"the ring path launched another kernel: {counts}")
        if fb:
            raise AssertionError(f"fallbacks recorded on the kernel path: {fb}")
        first = first if vector else (first,)
        err = vs_un = 0.0
        for comp, g, un, w in zip("uv", first, unsharded, want64):
            vs_un = max(vs_un, bitwise(f"ring headline {label} p_y={p_y} {comp}", g, un))
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"ring headline {label} {comp} is not finite")
            torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
            err = max(err, float((g.double() - w).abs().max()))
        log(f"  vs the unsharded kernel path max abs {vs_un:.3e} (bit for bit); vs eager engine in "
            f"float64 max abs {err:.3e}; {ms:.4f} ms/apply (host enqueue {host:.4f} ms/apply) on {smi}")
        return filt, first, ms, host, n_launched, err, vs_un

    def scalar_ring_headline(label, p_y, x, k1_out, k1_ms, want64, k1_filt, n_chain=chain,
                             alt=None, **kw):
        """The fused scalar ring on one headline: bitwise equal to the fused
        K1 and to the step ring of this run, timed beside both, and split
        (utils/ring_split.py): its passes alone and the copies around them,
        beside K1's launches alone. With ``alt = (x2, k1_out2)``, 24 applies
        alternating the two inputs, each bitwise equal to K1 of its own."""
        filt, (o,), ms_f, host_f, n_l, err, vs_k1 = ring_headline(
            f"{label}", "ring_fused_pass", p_y, (x.cpu().numpy(),), (x,), (k1_out,), (want64,),
            n_chain=n_chain, **kw)
        parts, _ = ring_parts(filt, x)
        k_launch = unsharded_launches(k1_filt, x)
        split = {k: event_ms(fn_, n_chain) for k, fn_ in
                 (("passes", parts["passes"]), ("copies", parts["copies"]),
                  ("k1_launches", k_launch))}
        bitwise(f"ring headline {label} p_y={p_y} passes alone", torch.cat(
            ring_entry(filt._scalar_fn()).state.acc), k1_out, "the fused K1")
        if alt is not None:
            # a halo row read stale, or a tile skipped, would show as a flicker
            for k in range(24):
                xk, wk = (x, k1_out) if k % 2 else alt
                bitwise(f"ring headline {label} p_y={p_y} alternating apply {k}", filt.apply(xk),
                        wk, "the fused K1 of its own input")
        entry = ring_entry(filt._scalar_fn())
        steps_fn = make_ring_scalar_apply(filt.operator, filt.filter_spec, filt.mesh, ring_axes,
                                          exact_nan=filt.exact_nan, fused_fn=None)
        vs_steps = bitwise(f"ring headline {label} p_y={p_y} vs step ring", o, steps_fn(x),
                           "the step ring")
        ms_s, host_s = event_ms(lambda: steps_fn(x), 10, host=True)
        fops = entry.state.ops
        n_op = sum(1 for k in ("c", "n", "s", "e", "w", "pre", "post", "area")
                   if isinstance(getattr(fops.shards[0], k), torch.Tensor))
        flops = FLOPS_PER_CELL_STEP * ny * nx * filt.n_steps
        fbm, fbb = bound_ms((2 + n_op) * ny * nx * item, flops, "float32")
        wops, _ = make_cuda_scalar_apply(filt.operator, filt.filter_spec,
                                         exact_nan=filt.exact_nan).operands(torch.float32, dev)
        rbytes, rflops = ring_plan_cost(wops, entry.plan, p_y, ny, nx, item)
        pbm, pbb = bound_ms(rbytes, rflops, "float32")
        log(f"  fused ring {label} p_y={p_y}: plan {entry.plan.tile} {entry.plan.steps}, "
            f"{len(entry.plan.steps)} launch(es)/apply, {ms_f:.4f} ms/apply; step ring "
            f"{ms_s:.4f} ms/apply (host enqueue {host_s:.4f}), bit for bit equal; fused K1 "
            f"{k1_ms:.4f} ms/apply, bit for bit equal; passes alone {split['passes']:.4f} ms "
            f"({split['passes'] / split['k1_launches'] - 1:+.1%} over K1's launches alone, "
            f"{split['k1_launches']:.4f}), copies alone {split['copies']:.4f} ms; "
            f"{RingItems(p_y, ny // p_y, nx, entry.plan.tile, entry.plan.steps[0]).tickets} "
            f"tickets a launch; {'24 alternating applies bit for bit; ' if alt else ''}plan bound "
            f"{pbm:.4f} ms ({rbytes / 1e9:.3f} GB, {pbb}), whole-filter bound {fbm:.4f} ms on {smi}")
        return filt, o, {
            "ms": ms_f, "host_enqueue_ms": host_f, "step_ring_ms": ms_s,
            "step_ring_host_enqueue_ms": host_s, "k1_ms": k1_ms, "launches": n_l,
            "launches_per_apply": len(entry.plan.steps), "n_steps": filt.n_steps,
            "passes": list(entry.plan.steps), "tile": list(entry.plan.tile),
            "plan_bound_ms": pbm, "filter_bound_ms": fbm, "filter_bound_by": fbb,
            "bytes_moved": rbytes, "vs_k1_max_abs": vs_k1, "vs_step_ring_max_abs": vs_steps,
            "vs_f64_engine_max_abs": err, "split_ms": split,
            "tickets_per_launch": [RingItems(p_y, ny // p_y, nx, entry.plan.tile, n).tickets
                                   for n in entry.plan.steps]}

    head_kw = dict(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                   grid_vars={"area": area, "wet_mask": wet})
    want64 = scalar_filter_apply(head.operator, head.filter_spec, x_dev.double())
    ms_unsharded_again = event_ms(lambda: head.apply(x_dev), chain)
    ring_by_p = {}
    x_alt = x_dev.flip(0).contiguous()
    alt = (x_alt, head.apply(x_alt))
    for p_y in (4, 2, 8):
        rhead, r_out, r_info = scalar_ring_headline(
            f"{ny}x{nx} float32 {tri.name}", p_y, x_dev, out, ms_unsharded_again, want64, head,
            alt=alt, **head_kw)
        ring_by_p[p_y] = r_info
        if p_y == 4:
            kept4 = (rhead, r_out)
        else:
            del rhead, r_out
    del want64
    rhead, r_out = kept4
    r4 = ring_by_p[4]
    ms_ring, host_ring, ring_launches = r4["ms"], r4["host_enqueue_ms"], r4["launches"]
    if host_ring > ms_ring:
        log(f"  the host holds the card back: {host_ring:.4f} ms to enqueue a {ms_ring:.4f} ms apply")
    # a race in the exchange would show as a flicker between repeats
    for k in range(200):
        if not torch.equal(rhead.apply(x_dev), r_out):
            raise AssertionError(f"ring apply {k + 2} differs from the first")
    log("  200 more fused scalar ring applies, each bitwise equal to the first")

    # the Taper filter (several passes) and the five-plane grid, on the same footing
    ring_more = {}
    m5 = 0.9 + 0.2 * np.random.default_rng(43).random((ny, nx))
    ones5 = np.ones((ny, nx))
    for key, kw5 in (("taper", dict(head_kw, filter_shape=FilterShape.TAPER)),
                     ("irregular_with_land", dict(
                         filter_scale=10.0, dx_min=1.0, grid_type=GridType.IRREGULAR_WITH_LAND,
                         grid_vars=dict(wet_mask=wet, dxw=m5, dyw=m5, dxs=m5, dys=m5,
                                        area=m5 * m5, kappa_w=ones5, kappa_s=ones5)))):
        k1 = Filter(device=dev, dtype=torch.float32, **kw5)
        k1_out = k1.apply(x_dev)
        k1_ms = event_ms(lambda: k1.apply(x_dev), 20)
        w64 = scalar_filter_apply(k1.operator, k1.filter_spec, x_dev.double())
        f5, _, ring_more[key] = scalar_ring_headline(
            f"{key} {ny}x{nx} float32", 4, x_dev, k1_out, k1_ms, w64, k1, n_chain=20, **kw5)
        del k1, k1_out, w64, f5
    del m5, ones5

    # the step ring and the plain versions at p_y = 4
    steps4 = make_ring_scalar_apply(rhead.operator, rhead.filter_spec, rhead.mesh, ring_axes,
                                    fused_fn=None)
    steps4(x_dev)
    rstate, rp_ = ring_state(steps4)
    host_steps_ring = r4["step_ring_host_enqueue_ms"]
    ms_step_ring = r4["step_ring_ms"]
    plain_ring = make_ring_scalar_apply(rhead.operator, rhead.filter_spec, rhead.mesh, ring_axes,
                                        pass_fn=ring_pass_reference,
                                        fused_fn=ring_fused_pass_reference)
    plain_ring(x_dev)
    ms_ring_plain = event_ms(lambda: plain_ring(x_dev), 3)
    plain_steps = make_ring_scalar_apply(rhead.operator, rhead.filter_spec, rhead.mesh, ring_axes,
                                         pass_fn=ring_pass_reference, fused_fn=None)
    plain_steps(x_dev)
    ms_step_plain = event_ms(lambda: plain_steps(x_dev), 3)
    del plain_ring, plain_steps
    # the unsharded steps' bytes plus, per step, 2*p_y halo rows written and read
    halo_bytes = lambda p_y, comps: 2 * (2 * p_y) * comps * nx * item  # noqa: E731
    ring_bytes = apply_bytes + n_steps * halo_bytes(4, 1)
    rb_ms, rb_by = bound_ms(ring_bytes, apply_flops, "float32")
    ms_rmid = event_ms(lambda: ring_pass(rstate, MIDDLE, rp_[2], swap=0), 100)
    rmid_ms, _ = bound_ms(step_bytes(MIDDLE, ops, 1, ny, nx, item) + halo_bytes(4, 1),
                          FLOPS_PER_CELL_STEP * ny * nx, "float32")
    log(f"ring scalar headline: fused {ms_ring:.4f} ms/apply at p_y=4 "
        f"({ring_by_p[2]['ms']:.4f} at 2, {ring_by_p[8]['ms']:.4f} at 8) in "
        f"{r4['launches_per_apply']} launch(es); step ring {ms_step_ring:.4f} "
        f"({ring_by_p[2]['step_ring_ms']:.4f} at 2, {ring_by_p[8]['step_ring_ms']:.4f} at 8) in "
        f"{n_steps}; fused K1 {ms_apply:.4f} (again just now {ms_unsharded_again:.4f}); plain "
        f"fused ring {ms_ring_plain:.4f}, plain step ring {ms_step_plain:.4f}; step ring "
        f"per-launch bound {rb_ms:.4f} ms ({ring_bytes / 1e9:.3f} GB, {rb_by}); middle step "
        f"{ms_rmid:.4f} ms vs bound {rmid_ms:.4f} ms")

    # 17 (scalar). each step kind against its plain version, headline shape
    def ring_step_kinds(label, ops_r, ly, p_, load, pass_fn, ref_fn, dtype, dtype_name):
        """FIRST, MIDDLE and LAST of a ring kernel against its plain version
        on twin states, the plain one fed the kernel's carries before each
        step; returns the largest abs difference."""
        k_state, r_state = (RingState(ops_r, ly, nx, dtype, dev) for _ in "kr")
        names = ("a", "b", "acc")
        worst_ = 0.0
        for kind, args, kw_ in ((FIRST, (p_[0], p_[1]), {}), (MIDDLE, (p_[2],), {"swap": 0}),
                                (LAST, (p_[3],), {"swap": 1})):
            if kind == FIRST:
                load(k_state), load(r_state)
            else:
                for nm in names:
                    for kb, rb in zip(getattr(k_state, nm), getattr(r_state, nm)):
                        rb.copy_(kb)
            pass_fn(k_state, kind, *args, **kw_)
            ref_fn(r_state, kind, *args, **kw_)
            torch.cuda.synchronize()
            for nm in (("acc",) if kind == LAST else names):
                for r, (kb, rb) in enumerate(zip(getattr(k_state, nm), getattr(r_state, nm))):
                    worst_ = max(worst_, compare(f"{label} kind {kind} {nm} of shard {r}",
                                                 kb, rb, dtype_name)[0])
        return worst_

    def load_scalar(dtype):
        def load(state):
            for r, f in enumerate(state.input):
                f.copy_(x_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
        return load

    from gcm_filters_tpu_torch.ops.cuda.ring_pass import (
        RingFusedOperands, RingFusedState, RingOperands, VecRingOperands,
        ring_fused_pass_tiled_reference,
    )

    def ring_fused_kinds(label, ops_w, p_, tile, dtype, dtype_name):
        """Each pass kind of the fused ring kernel (first only, middle, last:
        passes of 3, 3 and 5 steps; first and last: one pass of all 11)
        against its plain and tiled plain versions on triplet states, the
        plain ones fed the kernel's buffers before each pass; returns the
        largest abs difference."""
        worst_ = 0.0
        for steps in ((3, 3, 5), (n_steps,)):
            rops = RingFusedOperands.cut(ops_w, 4, max(steps))
            states = [RingFusedState(rops, ny // 4, nx, dtype, dev) for _ in range(3)]
            for st_ in states:
                load_scalar(dtype)(st_)
            start = 0
            for m, n in enumerate(steps):
                k_st = states[0]
                for st_ in states[1:]:
                    for dst, src in zip(st_.t + st_.t_prev + [st_.field, st_.acc],
                                        k_st.t + k_st.t_prev + [k_st.field, k_st.acc]):
                        for d_, s_ in zip(dst, src):
                            d_.copy_(s_)
                for st_, fn_ in zip(states, (ring_fused_pass, ring_fused_pass_reference,
                                             ring_fused_pass_tiled_reference)):
                    fn_(st_, p_, start, n, tile=tile, out=m % 2)
                torch.cuda.synchronize()
                last = start + n == n_steps
                own = slice(rops.halo, rops.halo + ny // 4)
                for ref_st, what in zip(states[1:], ("plain", "tiled plain")):
                    for r in range(4):
                        pairs = [("acc", k_st.acc[r], ref_st.acc[r])]
                        if not last:
                            pairs += [("t", k_st.t[m % 2][r][own], ref_st.t[m % 2][r][own]),
                                      ("t_prev", k_st.t_prev[m % 2][r][own],
                                       ref_st.t_prev[m % 2][r][own])]
                        for nm, kb, rb in pairs:
                            worst_ = max(worst_, compare(
                                f"{label} pass {steps}[{m}] {nm} of shard {r} vs {what}",
                                kb, rb, dtype_name)[0])
                start += n
            del states
        return worst_

    rstep_err = ring_step_kinds("ring step float32", rstate.ops, ny // 4, rp_,
                                load_scalar(torch.float32), ring_pass, ring_pass_reference,
                                torch.float32, "float32")
    ops64, p64 = fn_scalar_operands(torch.float64, dev)
    rstep_err64 = ring_step_kinds("ring step float64", RingOperands.cut(ops64, 4), ny // 4, p64,
                                  load_scalar(torch.float64), ring_pass, ring_pass_reference,
                                  torch.float64, "float64")
    ring_tile = ring_entry(rhead._scalar_fn()).plan.tile
    t0 = time.perf_counter()
    rfused_err = ring_fused_kinds("fused ring float32", ops, p, ring_tile, torch.float32,
                                  "float32")
    rfused_err64 = ring_fused_kinds("fused ring float64", ops64, p64, ring_tile, torch.float64,
                                    "float64")
    del ops64
    log(f"ring step kinds vs plain at {ny}x{nx}, 4 shards: max abs {rstep_err:.3e} (float32), "
        f"{rstep_err64:.3e} (float64); fused ring pass kinds vs plain and tiled plain: max abs "
        f"{rfused_err:.3e} (float32), {rfused_err64:.3e} (float64) "
        f"({time.perf_counter() - t0:.1f} s)")
    ring_results = [{
        "name": "ring_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1377",
        "launches": ring_step_path["ring_pass"],
        "launches_from": "Filter(mesh=ResidentMesh(...)).apply of one-row shards, below the "
                         "fused ring's plan (phase 15)",
        "max_abs_err": max(rstep_err, rstep_err64, rworst["ring_pass"]),
        "vs_fused_ring_max_abs": r4["vs_step_ring_max_abs"],
        "ms": ms_step_ring,
        "plain_ms": ms_step_plain,
        "bound_ms": rb_ms,
        "bound_by": rb_by,
        "library_ms": None,
        "unit": f"one ring headline apply as the step ring = {n_steps} launches for 4 resident "
                f"y-shards, {ny}x{nx} float32",
        "filter_bound_ms": fb_ms,
        "launches_per_apply": n_steps,
        "bytes_moved": ring_bytes,
        "plan_bound_ms": rb_ms,
        "middle_step_ms": ms_rmid,
        "middle_step_bound_ms": rmid_ms,
        "unsharded_ms": ms_apply,
        "host_enqueue_ms": host_steps_ring,
        "p_y": 4,
        "ms_by_p_y": {str(k): v["step_ring_ms"] for k, v in sorted(ring_by_p.items())},
    }, {
        "name": "ring_fused_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1377",
        "launches": ring_launches,
        "launches_per_apply": r4["launches_per_apply"],
        "max_abs_err": max(rfused_err, rfused_err64, rworst["ring_fused_pass"]),
        "vs_k1_max_abs": max(v["vs_k1_max_abs"] for v in ring_by_p.values()),
        "vs_step_ring_max_abs": max(v["vs_step_ring_max_abs"] for v in ring_by_p.values()),
        "headline_vs_f64_engine_max_abs": r4["vs_f64_engine_max_abs"],
        "ms": ms_ring,
        "plain_ms": ms_ring_plain,
        "bound_ms": r4["filter_bound_ms"],
        "bound_by": r4["filter_bound_by"],
        "library_ms": None,
        "unit": f"one ring headline apply = {r4['launches_per_apply']} launch(es) of "
                f"{tuple(r4['passes'])} steps on {r4['tile'][0]}x{r4['tile'][1]} tiles for 4 "
                f"resident y-shards, {ny}x{nx} float32",
        "bytes_moved": r4["bytes_moved"],
        "plan_bound_ms": r4["plan_bound_ms"],
        "filter_bound_ms": r4["filter_bound_ms"],
        "step_ring_ms": ms_step_ring,
        "k1_ms": ms_apply,
        "k1_again_ms": ms_unsharded_again,
        "host_enqueue_ms": host_ring,
        "p_y": 4,
        "ms_by_p_y": {str(k): v["ms"] for k, v in sorted(ring_by_p.items())},
        "step_ring_ms_by_p_y": {str(k): v["step_ring_ms"] for k, v in sorted(ring_by_p.items())},
        "by_p_y": {str(k): v for k, v in sorted(ring_by_p.items())},
        "taper": ring_more["taper"],
        "irregular_with_land": ring_more["irregular_with_land"],
        "ptxas": scalar_tile_ptxas("ring_pass", "ring_fused_kernel"),
    }]
    del rhead, rstate, r_out, kept4, steps4

    # 16 and 17 (vector). the B-grid and C-grid ring headlines, fused, beside
    # the fused K3 / K4 and the step ring; each step and pass kind vs plain
    from gcm_filters_tpu_torch.ops.cuda.ring_pass import (
        VecRingFusedOperands, VecRingFusedState, vec_ring_fused_pass_tiled_reference,
    )

    def load_vector(dtype):
        def load(state):
            for r, w_ in enumerate(state.input):
                w_[0].copy_(u_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
                w_[1].copy_(v_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
        return load

    def vector_ring_headline(label, gname, op, p_y, k_out, k_ms, k_launch_ms, want64,
                             n_chain=chain, **kw):
        """The fused vector ring on one headline: bitwise equal to the fused
        K3 / K4 and to the step ring of this run, timed beside both, and its
        time split into the fused launches alone and the copies around them
        (``utils/ring_split.py``), beside the fused K3 / K4 launches alone
        (``k_launch_ms``)."""
        key = vkey[op]
        filt, outs, ms_f, host_f, n_l, err, vs_k = ring_headline(
            label, f"vec_ring_fused_pass_{key}", p_y, (u_h, v_h), (u_dev, v_dev), k_out, want64,
            n_chain=n_chain, **kw)
        entry = ring_entry(filt._vector_fn())
        steps_fn = make_ring_vector_apply(filt.operator, filt.filter_spec, filt.mesh, ring_axes,
                                          fused_fn=None)
        s_out = steps_fn(u_dev, v_dev)
        vs_steps = max(bitwise(f"ring headline {label} p_y={p_y} {c} vs step ring", g, s_,
                               "the step ring") for c, g, s_ in zip("uv", outs, s_out))
        ms_s, host_s = event_ms(lambda: steps_fn(u_dev, v_dev), 10, host=True)
        # the split: the fused launches alone and the copies around them alone
        parts, _ = ring_parts(filt, u_dev, v_dev)
        ms_passes = event_ms(parts["passes"], n_chain)
        ms_copies = event_ms(parts["copies"], n_chain)
        n_coef = entry.state.ops.coefs[0].shape[0]
        rbytes, rflops = vec_ring_plan_cost(n_coef, entry.plan, p_y, ny, nx, item, key)
        pbm, pbb = bound_ms(rbytes, rflops, "float32")
        # the whole filter: u, v and the coefficients in, u and v out, every step's flops
        fbm, fbb = bound_ms((n_coef + 4) * ny * nx * item,
                            VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * filt.n_steps, "float32")
        log(f"  fused vector ring {label} p_y={p_y}: plan {entry.plan.tile} {entry.plan.steps}, "
            f"{len(entry.plan.steps)} launch(es)/apply, {ms_f:.4f} ms/apply; step ring "
            f"{ms_s:.4f} ms/apply (host enqueue {host_s:.4f}), bit for bit equal; fused "
            f"{'K3' if op == BGRID else 'K4'} {k_ms:.4f} ms/apply, bit for bit equal; plan bound "
            f"{pbm:.4f} ms ({rbytes / 1e9:.4f} GB, {pbb}), whole-filter bound {fbm:.4f} ms on {smi}")
        log(f"    split: passes alone {ms_passes:.4f} ms, copies around them {ms_copies:.4f} ms, "
            f"fused {'K3' if op == BGRID else 'K4'} launches alone {k_launch_ms:.4f} ms "
            f"(passes {ms_passes / k_launch_ms - 1:+.1%})")
        return filt, outs, steps_fn, {
            "ms": ms_f, "passes_ms": ms_passes, "copies_ms": ms_copies,
            "unsharded_launches_ms": k_launch_ms, "host_enqueue_ms": host_f, "step_ring_ms": ms_s,
            "step_ring_host_enqueue_ms": host_s, "unsharded_ms": k_ms, "launches": n_l,
            "launches_per_apply": len(entry.plan.steps), "n_steps": filt.n_steps,
            "passes": list(entry.plan.steps), "tile": list(entry.plan.tile),
            "plan_bound_ms": pbm, "plan_bound_by": pbb, "filter_bound_ms": fbm,
            "filter_bound_by": fbb, "bytes_moved": rbytes, "vs_unsharded_max_abs": vs_k,
            "vs_step_ring_max_abs": vs_steps, "vs_f64_engine_max_abs": err}

    def vec_ring_fused_kinds(label, ops_w, p_, op, dtype, dtype_name):
        """Each pass kind of the fused vector ring kernel (first only, middle,
        last: passes of 3, 3 and 5 steps; first and last: one pass of a
        5-step filter) against its plain and tiled plain versions on triplet
        states, the plain ones fed the kernel's buffers before each pass, on
        the first tile of the planner's list whose window fits in this dtype,
        the first pass's outputs filled with NaN before it; returns the
        largest abs difference."""
        worst_ = 0.0
        itemsize = torch.empty((), dtype=dtype).element_size()
        for steps, pp in (((3, 3, 5), p_), ((5,), p_[:6])):
            tile = next(tl for tl in VEC_TILES[op] if vec_fused_shared_bytes(
                tl, max(steps), N_COEF[op], itemsize) <= SHARED_BYTES)
            rops = VecRingFusedOperands.cut(ops_w, 4, max(steps))
            states = [VecRingFusedState(rops, ny // 4, nx, dtype, dev) for _ in range(3)]
            for st_ in states:
                load_vector(dtype)(st_)
            # the first pass's carries out and acc start as NaN: a tile that
            # the launch skipped would keep it
            for buf in states[0].t[0] + states[0].t_prev[0] + states[0].acc:
                buf.fill_(float("nan"))
            start = 0
            for m, n in enumerate(steps):
                k_st = states[0]
                for st_ in states[1:]:
                    for dst, src in zip(st_.t + st_.t_prev + [st_.w, st_.acc],
                                        k_st.t + k_st.t_prev + [k_st.w, k_st.acc]):
                        for d_, s_ in zip(dst, src):
                            d_.copy_(s_)
                for st_, fn_ in zip(states, (vec_ring_fused_pass, vec_ring_fused_pass_reference,
                                             vec_ring_fused_pass_tiled_reference)):
                    fn_(st_, pp, start, n, tile=tile, out=m % 2)
                torch.cuda.synchronize()
                last = start + n == len(pp) - 1
                own = slice(rops.halo, rops.halo + ny // 4)
                for ref_st, what in zip(states[1:], ("plain", "tiled plain")):
                    for r in range(4):
                        pairs = [("acc", k_st.acc[r], ref_st.acc[r])]
                        if not last:
                            pairs += [("t", k_st.t[m % 2][r][:, own], ref_st.t[m % 2][r][:, own]),
                                      ("t_prev", k_st.t_prev[m % 2][r][:, own],
                                       ref_st.t_prev[m % 2][r][:, own])]
                        for nm, kb, rb in pairs:
                            worst_ = max(worst_, compare(
                                f"{label} pass {steps}[{m}] {tile} {nm} of shard {r} vs {what}",
                                kb, rb, dtype_name)[0])
                start += n
            del states, rops
        return worst_

    def vec_ring_short_tiles(gname):
        """One 5-step pass of the fused vector ring on 4x16 tiles of a 48x250
        field (a NaN on a shard edge): at p_y 2 each shard has two interior
        tile rows, taken by block index, and two edge rows a side, drawn by
        ticket; at p_y 4 every tile is an edge tile. The kernel bitwise equal
        to the step ring, and against the tiled plain version; returns the
        largest abs difference from the latter."""
        shape_s, tile_s, worst_ = (48, 250), (4, 16), 0.0
        rng_s = np.random.default_rng(11)
        f_s = Filter(filter_scale=4.0, dx_min=1.0, grid_type=GridType[gname], device=dev,
                     grid_vars=unit_vector_grid_vars(gname, shape_s, rng_s, 0.0))
        ops_s, p_s = make_cuda_vector_apply(f_s.operator, f_s.filter_spec).operands(
            torch.float32, dev)
        if len(p_s) - 1 != 5:
            raise AssertionError(f"{gname}: the filter has {len(p_s) - 1} steps, not 5")
        u_s, v_s = (torch.as_tensor(rng_s.random(shape_s), dtype=torch.float32, device=dev)
                    for _ in "uv")
        u_s[24, 40] = float("nan")
        for p_y, n_int in ((2, 2), (4, 0)):
            ly_s = shape_s[0] // p_y
            items = RingItems(p_y, ly_s, shape_s[1], tile_s, 5)
            if (items.int_lo, items.n_int) != (2, n_int):
                raise AssertionError(f"p_y={p_y}: interior rows {items.int_lo}, {items.n_int}")
            outs = []
            for fn_ in (vec_ring_fused_pass, vec_ring_fused_pass_tiled_reference):
                st_ = VecRingFusedState(VecRingFusedOperands.cut(ops_s, p_y, 5), ly_s,
                                        shape_s[1], torch.float32, dev)
                for r, w_ in enumerate(st_.input):
                    w_[0].copy_(u_s[r * ly_s:(r + 1) * ly_s])
                    w_[1].copy_(v_s[r * ly_s:(r + 1) * ly_s])
                for buf in st_.t[0] + st_.t_prev[0] + st_.acc:
                    buf.fill_(float("nan"))
                fn_(st_, p_s, 0, 5, tile=tile_s, out=0)
                outs.append(torch.cat(st_.acc, dim=1))
            steps_s = make_ring_vector_apply(f_s.operator, f_s.filter_spec,
                                             ResidentMesh(p_y, dev), ring_axes, fused_fn=None)
            label_s = f"fused vector ring {gname} p_y={p_y} {tile_s} tiles, one 5-step pass"
            bitwise(label_s, outs[0], torch.stack(steps_s(u_s, v_s)), "the step ring")
            worst_ = max(worst_, compare(f"{label_s} vs tiled plain", outs[0], outs[1],
                                         "float32")[0])
            log(f"  {label_s} ({items.n_int} interior tile rows a shard, {items.tickets} "
                f"tickets): bit for bit equal to the step ring")
        return worst_

    vring = {}
    for gname, op in vec_ops.items():
        key = vkey[op]
        kept = vec_kept[op]
        vkw = dict(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname], grid_vars=kept["gv"])
        k34 = Filter(device=dev, dtype=torch.float32, **vkw)
        for comp, g, w in zip("uv", k34.apply_to_vector(u_dev, v_dev), kept["out"]):
            bitwise(f"{gname} {comp} again", g, w, "the phase-7 result")  # and the set-up done
        for _ in range(warm):
            k34.apply_to_vector(u_dev, v_dev)
        k_ms = event_ms(lambda: k34.apply_to_vector(u_dev, v_dev), chain)
        k_launch = unsharded_launches(k34, u_dev, v_dev)  # without the apply's stack
        k_launch()
        k_launch_ms = event_ms(k_launch, chain)
        by_p = {}
        for p_y in ((4, 2, 8) if op == BGRID else (4,)):
            rv, outs, steps_rv, by_p[p_y] = vector_ring_headline(
                f"{ny}x{nx} float32 {gname}", gname, op, p_y, kept["out"], k_ms, k_launch_ms,
                kept["want"], **vkw)
            if p_y == 4:
                rv4, outs4, steps4v = rv, outs, steps_rv
            else:
                del rv, outs, steps_rv
        r4v = by_p[4]
        if op == BGRID:
            # a race in the exchange would show as a flicker between repeats
            for k in range(50):
                if not all(torch.equal(g, o) for g, o in zip(rv4.apply_to_vector(u_dev, v_dev),
                                                             outs4)):
                    raise AssertionError(f"vector ring apply {k + 2} differs from the first")
            log("  50 more fused vector ring applies, each bitwise equal to the first")
        # a halo value read stale (through L1, or before its send) would show
        # where two inputs alternate: every apply against the fused K3 / K4 of
        # its own input
        u2 = torch.as_tensor(np.random.default_rng(44).random((ny, nx)).astype(np.float32),
                             device=dev)
        v2 = torch.flip(u_dev, dims=(1,)).contiguous()
        pairs = [((u_dev, v_dev), kept["out"]), ((u2, v2), k34.apply_to_vector(u2, v2))]
        for k in range(24):
            (ua, va), want_ = pairs[k % 2]
            for comp, g, w in zip("uv", rv4.apply_to_vector(ua, va), want_):
                bitwise(f"ring headline {gname} p_y=4 alternating apply {k} {comp}", g, w,
                        "the fused K3 / K4 of the same input")
        log(f"  24 fused vector ring applies alternating two inputs, each bitwise equal to the "
            f"fused {'K3' if op == BGRID else 'K4'} of its input")
        del u2, v2, pairs
        taper = None
        if op == CTAP:  # the Taper (44 steps, several passes), on the same footing
            # dx_min = 0.9 as in phase 7c: with 1 the Taper amplifies rounding
            tkw = dict(vkw, dx_min=0.9, filter_shape=FilterShape.TAPER)
            kt = Filter(device=dev, dtype=torch.float32, **tkw)
            kt_out = kt.apply_to_vector(u_dev, v_dev)
            for _ in range(warm):
                kt.apply_to_vector(u_dev, v_dev)
            kt_ms = event_ms(lambda: kt.apply_to_vector(u_dev, v_dev), 20)
            kt64 = vector_filter_apply(kt.operator, kt.filter_spec, u_dev.double(), v_dev.double())
            kt_launch = unsharded_launches(kt, u_dev, v_dev)
            kt_launch()
            ft, _, _, taper = vector_ring_headline(
                f"taper {ny}x{nx} float32 {gname}", gname, op, 4, kt_out, kt_ms,
                event_ms(kt_launch, 20), kt64, n_chain=20, **tkw)
            del kt, kt_out, kt64, ft
        vn = rv4.n_steps
        sstate, vp4 = ring_state(steps4v)  # the step ring's state
        n_coef = sstate.ops.coefs[0].shape[0]
        plain_fused = make_ring_vector_apply(rv4.operator, rv4.filter_spec, rv4.mesh, ring_axes,
                                             pass_fn=vec_ring_pass_reference,
                                             fused_fn=vec_ring_fused_pass_reference)
        plain_fused(u_dev, v_dev)
        ms_rvf_plain = event_ms(lambda: plain_fused(u_dev, v_dev), 3)
        plain_rv = make_ring_vector_apply(rv4.operator, rv4.filter_spec, rv4.mesh, ring_axes,
                                          pass_fn=vec_ring_pass_reference, fused_fn=None)
        plain_rv(u_dev, v_dev)
        ms_rv_plain = event_ms(lambda: plain_rv(u_dev, v_dev), 3)
        del plain_rv, plain_fused
        vkinds = [FIRST] + [MIDDLE] * (vn - 2) + [LAST]
        rv_bytes = (sum(vec_step_bytes(k, n_coef, 1, ny, nx, item) for k in vkinds)
                    + vn * halo_bytes(4, 2))
        rv_flops = VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * vn
        rvb_ms, rvb_by = bound_ms(rv_bytes, rv_flops, "float32")
        ms_rvmid = event_ms(lambda: vec_ring_pass(sstate, MIDDLE, vp4[2], swap=0), 100)
        rvmid_ms, _ = bound_ms(vec_step_bytes(MIDDLE, n_coef, 1, ny, nx, item) + halo_bytes(4, 2),
                               VEC_FLOPS_PER_CELL_STEP[key] * ny * nx, "float32")
        log(f"ring {gname} headline: fused {r4v['ms']:.4f} ms/apply at p_y=4 in "
            f"{r4v['launches_per_apply']} launches beside the fused "
            f"{'K3' if op == BGRID else 'K4'} {k_ms:.4f} (phase 7: "
            f"{vec_fused_results[op]['ms']:.4f}); step ring {r4v['step_ring_ms']:.4f} ms/apply in "
            f"{vn}, per-launch bound {rvb_ms:.4f} ms ({rv_bytes / 1e9:.3f} GB, {rvb_by}); plain "
            f"fused ring {ms_rvf_plain:.4f}, plain step ring {ms_rv_plain:.4f} ms/apply; middle "
            f"step {ms_rvmid:.4f} ms vs bound {rvmid_ms:.4f} ms")
        rvstep = ring_step_kinds(f"ring {gname} step float32", sstate.ops, ny // 4, vp4,
                                 load_vector(torch.float32), vec_ring_pass,
                                 vec_ring_pass_reference, torch.float32, "float32")
        vops32, _ = make_cuda_vector_apply(rv4.operator, rv4.filter_spec).operands(
            torch.float32, dev)
        vops64, vp64 = make_cuda_vector_apply(rv4.operator, rv4.filter_spec).operands(
            torch.float64, dev)
        rvstep64 = ring_step_kinds(f"ring {gname} step float64", VecRingOperands.cut(vops64, 4),
                                   ny // 4, vp64, load_vector(torch.float64), vec_ring_pass,
                                   vec_ring_pass_reference, torch.float64, "float64")
        t0 = time.perf_counter()
        rvf_err = vec_ring_fused_kinds(f"fused vector ring {gname} float32", vops32, vp4, op,
                                       torch.float32, "float32")
        rvf_err64 = vec_ring_fused_kinds(f"fused vector ring {gname} float64", vops64, vp64, op,
                                         torch.float64, "float64")
        rvf_err = max(rvf_err, vec_ring_short_tiles(gname))
        del vops32, vops64
        log(f"ring {gname} step kinds vs plain at {ny}x{nx}, 4 shards: max abs {rvstep:.3e} "
            f"(float32), {rvstep64:.3e} (float64); fused vector ring pass kinds vs plain and "
            f"tiled plain: max abs {rvf_err:.3e} (float32), {rvf_err64:.3e} (float64) "
            f"({time.perf_counter() - t0:.1f} s)")
        replaces = ("gcm_filters_tpu/ops/pallas/vec_pass.py:" + ("567" if op == BGRID else "575")
                    + " (ring mode, :280-343, :366-392, :505-546)")
        ring_results.append({
            "name": f"vec_ring_pass_{key}",
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
            "replaces": replaces,
            "launches": ring_step_path[f"vec_ring_pass_{key}"],
            "launches_from": "Filter(mesh=ResidentMesh(...)).apply_to_vector of one-row shards, "
                             "below the fused ring's plan (phase 15)",
            "max_abs_err": max(rvstep, rvstep64, rworst[f"vec_ring_pass_{key}"]),
            "vs_fused_ring_max_abs": r4v["vs_step_ring_max_abs"],
            "ms": r4v["step_ring_ms"],
            "plain_ms": ms_rv_plain,
            "bound_ms": rvb_ms,
            "bound_by": rvb_by,
            "library_ms": None,
            "unit": f"one ring headline apply as the step ring = {vn} launches for 4 resident "
                    f"y-shards, {ny}x{nx} float32 {gname}",
            "filter_bound_ms": r4v["filter_bound_ms"],
            "launches_per_apply": vn,
            "bytes_moved": rv_bytes,
            "plan_bound_ms": rvb_ms,
            "middle_step_ms": ms_rvmid,
            "middle_step_bound_ms": rvmid_ms,
            "unsharded_ms": k_ms,
            "host_enqueue_ms": r4v["step_ring_host_enqueue_ms"],
            "p_y": 4,
        })
        vring[op] = {
            "name": f"vec_ring_fused_pass_{key}",
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
            "replaces": replaces,
            "launches": r4v["launches"],
            "launches_per_apply": r4v["launches_per_apply"],
            "max_abs_err": max(rvf_err, rvf_err64, rworst[f"vec_ring_fused_pass_{key}"]),
            "vs_unsharded_max_abs": max(v["vs_unsharded_max_abs"] for v in by_p.values()),
            "vs_step_ring_max_abs": max(v["vs_step_ring_max_abs"] for v in by_p.values()),
            "headline_vs_f64_engine_max_abs": r4v["vs_f64_engine_max_abs"],
            "ms": r4v["ms"],
            "plain_ms": ms_rvf_plain,
            "bound_ms": r4v["filter_bound_ms"],
            "bound_by": r4v["filter_bound_by"],
            "library_ms": None,
            "unit": f"one ring headline apply = {r4v['launches_per_apply']} launch(es) of "
                    f"{tuple(r4v['passes'])} steps on {r4v['tile'][0]}x{r4v['tile'][1]} tiles "
                    f"for 4 resident y-shards, {ny}x{nx} float32 {gname}",
            "bytes_moved": r4v["bytes_moved"],
            "plan_bound_ms": r4v["plan_bound_ms"],
            "filter_bound_ms": r4v["filter_bound_ms"],
            "unsharded_ms": k_ms,
            "unsharded_phase7_ms": vec_fused_results[op]["ms"],
            "step_ring_ms": r4v["step_ring_ms"],
            "host_enqueue_ms": r4v["host_enqueue_ms"],
            "p_y": 4,
            "ms_by_p_y": {str(k): v["ms"] for k, v in sorted(by_p.items())},
            "step_ring_ms_by_p_y": {str(k): v["step_ring_ms"] for k, v in sorted(by_p.items())},
            "split_ms_by_p_y": {str(k): {"apply": v["ms"], "passes": v["passes_ms"],
                                         "copies": v["copies_ms"],
                                         "unsharded_launches": v["unsharded_launches_ms"]}
                                for k, v in sorted(by_p.items())},
            "by_p_y": {str(k): v for k, v in sorted(by_p.items())},
            "taper": taper,
            "ptxas": vec_tile_ptxas("ring_pass", "vec_ring_fused_kernel", op),
        }
        del rv4, outs4, steps4v, sstate, k34
    ring_results += [vring[BGRID], vring[CTAP]]

    # 18. the user-facing paths around the kernels, at full width
    print(json.dumps({"user_paths": user_paths(dev, counters, reset_counters, bitwise)}),
          flush=True)

    # 19. the kernels line
    kernels = [{
        "name": "cheb_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/cheb_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:771",
        "launches": step_path["launches"],
        "launches_from": "Filter.apply of fields below the fused plan's predicate (phase 3)",
        "max_abs_err": max(step_err, worst["float32"][0], worst["float64"][0]),
        "max_rel_err_f64": worst["float64"][1],
        "ms": ms_steps,
        "plain_ms": ms_plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "unit": f"one headline apply as the step chain = {step_chain_launches} launches, "
                f"{ny}x{nx} float32",
        "filter_bound_ms": fb_ms,
        "launches_per_apply": step_chain_launches,
        "bytes_moved": apply_bytes,
        "plan_bound_ms": b_ms,
        "middle_step_ms": ms_mid,
        "middle_step_bound_ms": mid_ms,
        "host_enqueue_ms": host_steps,
    }, {
        "name": "cheb_fused_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/cheb_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1150",
        "launches": launches,
        "launches_per_apply": len(plan.steps),
        "max_abs_err": max(fused_err, fworst["vs_plain"], fworst["vs_tiled"]),
        "vs_step_chain_max_abs": head_vs_steps,
        "headline_vs_f64_engine_max_abs": head_err,
        "ms": ms_apply,
        "plain_ms": ms_plain,
        "bound_ms": fb_ms,
        "bound_by": fb_by,
        "library_ms": None,
        "unit": f"one headline apply = {len(plan.steps)} launch(es) of {plan.steps} steps on "
                f"{plan.tile[0]}x{plan.tile[1]} tiles, {ny}x{nx} float32",
        "bytes_moved": p_bytes,
        "plan_bound_ms": pb_ms,
        "filter_bound_ms": fb_ms,
        "step_chain_ms": ms_steps,
        "host_enqueue_ms": host_apply,
        "tile_sweep_ms": sweep,
        "float64_plan": [list(plan64.tile), list(plan64.steps)],
        "float64_tile_sweep_ms": sweep64,
        "taper": more_heads["taper"],
        "irregular_with_land": more_heads["irregular_with_land"],
        "ptxas": scalar_tile_ptxas("cheb_pass", "pass_kernel"),
    }, vec_results[BGRID], vec_results[CTAP], vec_fused_results[BGRID],
        vec_fused_results[CTAP], {
        "name": "local_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/local_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1296",
        "launches": local_step_path["launches"],
        "launches_from": "Filter(mesh=...).apply of a block below the fused predicate (phase 9)",
        "max_abs_err": max(ls_err, sworst["float32"][0], sworst["float64"][0]),
        "max_rel_err_f64": sworst["float64"][1],
        "ms": ms_s_steps,
        "plain_ms": ms_s_plain,
        "bound_ms": sb_ms,
        "bound_by": sb_by,
        "library_ms": None,
        "unit": f"one sharded headline apply on a 1x1 mesh as the step chain = one halo "
                f"exchange + {s_step_chain_launches} launches, {ny}x{nx} float32, block "
                f"{tuple(xe.shape[-2:])}",
        "filter_bound_ms": sfb_ms,
        "launches_per_apply": s_step_chain_launches,
        "bytes_moved": s_bytes,
        "plan_bound_ms": sb_ms,
        "middle_step_ms": ms_lmid,
        "middle_step_bound_ms": lmid_ms,
        "steps_alone_ms": ms_chain,
        "host_enqueue_ms": host_s_steps,
    }, {
        "name": "local_strip_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/local_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1296",
        "launches": s_launches,
        "launches_per_apply": len(rounds),
        "max_abs_err": max(lfused_err, sworst["float32"][0], sworst["float64"][0]),
        "vs_step_chain_max_abs": s_vs_steps,
        "headline_vs_f64_engine_max_abs": s_head_err,
        "ms": ms_sharded,
        "plain_ms": ms_s_plain,
        "bound_ms": sfb_ms,
        "bound_by": sfb_by,
        "library_ms": None,
        "unit": f"one sharded headline apply on a 1x1 mesh = the halo strips + "
                f"{len(rounds)} round(s) on strips, {lplan.tile[0]}x{lplan.tile[1]} tiles, "
                f"{ny}x{nx} float32, core {ny}x{nx}, {cells} cells",
        "bytes_moved": slp_bytes,
        "plan_bound_ms": slb_ms,
        "filter_bound_ms": sfb_ms,
        "step_chain_ms": ms_s_steps,
        "host_enqueue_ms": host_sharded,
        "strips_ms": ms_strips,
        "rounds_alone_ms": ms_rounds_alone,
        "round_alone_ms": ms_round,
        "round_alone_plain_ms": ms_round_plain,
        "parent_exchange_ms": ms_exchange,
        "taper": sh_taper,
        "ptxas": scalar_tile_ptxas("local_pass", "local_strip_kernel"),
    }, svec_results[BGRID], svec_results[CTAP], svfused_results[BGRID],
        svfused_results[CTAP], svstrip_results[BGRID], svstrip_results[CTAP]] + ring_results
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
