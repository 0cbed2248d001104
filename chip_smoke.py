#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and check them on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and nvcc.
It imports only ``gcm_filters_tpu_torch`` (never JAX or ``gcm_filters_tpu``)
and runs these phases; any failed check raises and the script exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compiles ``gcm_filters_tpu_torch/csrc/*.cu`` (one nvcc per source,
   all at once);
3. small grids: all 9 scalar grids at 128x256 in float32 and float64, plus
   ``exact_nan``, a 97x300 shape, a batch and NaN fields, each through
   ``Filter(device="cuda").apply`` against the same dispatch driven by the
   plain PyTorch step ``cheb_pass_reference`` on the card;
4. scalar headline (the scalar path): the ``bench.py`` workload, 2400x3600
   float32 TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED, Gaussian factor 10
   (11 steps), through ``Filter.apply`` on the card, checked against the
   eager engine in float64 and timed with CUDA events; the launch counter
   must equal 11 x applies and no fallback may be recorded;
5. each step kind of the scalar kernel against its plain version at the
   headline shape;
6. small vector grids: VECTOR_B_GRID and VECTOR_C_GRID at 128x256 through
   ``Filter(device="cuda").apply_to_vector`` against the same dispatch driven
   by the plain step ``vec_pass_reference`` on the card: unit-scale metrics in
   float32 and float64 (C-grid at kappa_aniso 1 and 0), the spherical test
   construction in float64, 97x300, a batch and NaN fields; each apply must
   launch its kernel exactly n_steps times;
7. vector headlines (the vector path): both grids at 2400x3600 float32,
   Gaussian factor 10 (11 steps), unit-scale metrics (C-grid at
   kappa_aniso 0), each checked against the float64 eager engine, timed, and
   with launches = 11 x applies and no fallback;
8. each step kind of both vector kernels against its plain version at the
   headline shape;
9. sharded small grids: a one-rank NCCL process group and a 1x1
   ``DeviceMesh``; all 9 scalar grids at 128x256 in float32 and float64, plus
   ``exact_nan``, 97x300, a batch, NaN fields and ``halo_steps`` 1, 3 and
   None, each through ``Filter(mesh=..., spatial_axes=("y", "x")).apply``
   against the same sharded apply driven by the plain local step
   ``local_pass_reference`` on the card, and against the unsharded
   ``Filter.apply``; each apply must launch the local step kernel exactly
   n_steps times and the unsharded step kernel not at all;
10. sharded headline (the sharded path): the phase-4 workload through the
    mesh path, checked against the float64 eager engine and timed, with
    launches = 11 x applies and no fallback; the halo exchange and the chain
    of 11 local steps are also timed alone;
11. each step kind of the local step kernel against its plain version at the
    headline's extended shape;
12. sharded small vector grids, on the same 1x1 mesh: both vector grids at
    128x256 in float32 and float64 (C-grid at kappa_aniso 1 and 0), the
    spherical metrics in float64, 97x300, a batch, NaN fields, a C-grid
    operator with ``zap_nans=False`` and ``halo_steps`` 1, 3 and None, each
    through ``Filter(mesh=..., spatial_axes=("y", "x")).apply_to_vector``
    against the same sharded apply driven by the plain local step
    ``vec_local_pass_reference`` on the card, and against the unsharded
    ``apply_to_vector``; each apply must launch the windowed local kernel of
    its grid exactly n_steps times and no other kernel;
13. sharded vector headlines (the sharded vector path): the phase-7 B-grid
    and C-grid workloads through the mesh path, checked against the float64
    eager engine and timed beside the unsharded time of the same run, with
    launches = 11 x applies, every other counter 0 and no fallback; the halo
    exchange and the chain of 11 local steps are also timed alone;
14. each step kind of both windowed local vector kernels against its plain
    version at the headlines' extended shape;
15. ring small grids: the cases of tests/test_ring.py in float32 (REGULAR,
    also with 37 steps; IRREGULAR_WITH_LAND; both tripolar grids; ``exact_nan``
    with a wet NaN; ``nx = 250``; one-row shards; B-grid; C-grid at
    kappa_aniso 0 and 1 and with 37 steps) through
    ``Filter(mesh=ResidentMesh(p_y, "cuda"), spatial_axes=("y", None))`` at
    ``p_y`` 2, 4 and 8: several y-shards resident on the one card, whose step
    kernel exchanges the halo rows itself. Each result must equal the
    unsharded kernel path bit for bit and agree with the same ring apply
    driven by the plain versions on the card; each apply must launch the ring
    kernel exactly n_steps times (one launch per step, whatever ``p_y``) and
    no other kernel;
16. ring headlines (the ring path): the phase-4 workload at ``p_y`` 4, 2 and
    8 and the phase-7 workloads at ``p_y`` 4, each bitwise equal to the
    unsharded result of this run, checked against the float64 eager engine
    and timed beside the unsharded time of this run, with launches = 11 x
    applies, every other counter 0 and no fallback; then 200 more scalar
    applies, each bitwise equal to the first;
17. each step kind of the three ring kernels against its plain version at the
    headline shape, in float32 and float64;
18. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Without a CUDA device it prints no result and exits 2.
"""
import json
import subprocess
import sys
import tempfile
import time

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


def unit_vector_grid_vars(grid_name, shape, rng, kappa_aniso):
    """Unit-scale metrics, m = 0.9 + 0.2 * uniform, as
    benchmarks/bench_suite.py builds the vector grids."""
    m = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid_name == "VECTOR_B_GRID":
        return dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=m, dyT=m, dxCu=m, dyCu=m,
                dxCv=m, dyCv=m, dxBu=m, dyBu=m, area_u=m * m, area_v=m * m,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was checked", file=sys.stderr)
        return 2

    from gcm_filters_tpu_torch import Filter, GridType, required_grid_vars
    from gcm_filters_tpu_torch.engine import scalar_filter_apply, vector_filter_apply
    from gcm_filters_tpu_torch.models.grids import is_vector_grid
    from gcm_filters_tpu_torch.ops.cuda import build
    from gcm_filters_tpu_torch.ops.cuda.cheb_pass import (
        FIRST, LAST, MIDDLE, cheb_pass, cheb_pass_reference,
    )
    from gcm_filters_tpu_torch.ops.cuda.dispatch import (
        make_cuda_scalar_apply, make_cuda_vector_apply,
    )
    from gcm_filters_tpu_torch.ops.cuda.vec_pass import (
        BGRID, CTAP, vec_pass, vec_pass_reference,
    )
    from gcm_filters_tpu_torch.utils.profiling import bound_ms
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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    dev = torch.device("cuda")

    # 3. small grids: kernel dispatch vs the same dispatch on the plain step
    worst = {"float32": [0.0, 0.0], "float64": [0.0, 0.0]}

    def check_filter(label, filt, x, dtype_name):
        plain = make_cuda_scalar_apply(filt.operator, filt.filter_spec,
                                       exact_nan=filt.exact_nan, pass_fn=cheb_pass_reference)
        before = cheb_pass.launches
        got = filt.apply(x)
        torch.cuda.synchronize()
        launched = cheb_pass.launches - before
        if launched != filt.n_steps:
            raise AssertionError(f"{label}: {launched} kernel launches, expected {filt.n_steps}")
        want = plain(filt._coerce(x))
        if got.shape != want.shape or got.device.type != "cuda":
            raise AssertionError(f"{label}: result {tuple(got.shape)} on {got.device}")
        a, r = compare(label, got, want, dtype_name)
        worst[dtype_name] = [max(worst[dtype_name][0], a), max(worst[dtype_name][1], r)]
        log(f"  {label}: max abs {a:.3e} max rel {r:.3e} ({launched} launches)")

    scalar = [g for g in GridType if not is_vector_grid(g)]
    shape = (128, 256)
    log(f"small grids at {shape}:")
    for g in scalar:
        data, gv = scalar_grid_data(g, required_grid_vars(g), shape)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=g, grid_vars=gv,
                          dtype=dt, device=dev)
            check_filter(f"{g.name} {name}", filt, data, name)

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
        check_filter(f"{tri.name} NaN land+wet {name}", f_nan, nan_d, name)
        out = f_nan.apply(nan_d)
        if not (bool(torch.isnan(out[0, 7])) and bool(torch.isnan(out[90, 150]))):
            raise AssertionError("NaN cells must stay NaN")

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
    torch.cuda.synchronize()

    reset_fallback_counts()
    cheb_pass.launches = 0
    vec_pass.launches = {BGRID: 0, CTAP: 0}
    out = head.apply(field)
    y = out
    for _ in range(warm):
        y = head.apply(y)
    ms_apply, host_apply = event_ms(lambda: head.apply(out), chain, host=True)
    launches = cheb_pass.launches
    other = dict(vec_pass.launches)
    fallbacks = fallback_counts()
    applies = 1 + warm + chain
    if any(other.values()):
        raise AssertionError(f"the scalar path launched vector kernels: {other}")
    log(f"headline {ny}x{nx} float32 {tri.name}, n_steps {n_steps}: "
        f"{launches} launches over {applies} applies, fallbacks {fallbacks}")
    if launches != n_steps * applies:
        raise AssertionError(f"expected {n_steps * applies} kernel launches, saw {launches}")
    if fallbacks:
        raise AssertionError(f"fallbacks recorded on the kernel path: {fallbacks}")

    x_dev = torch.as_tensor(field, device=dev)
    want64 = scalar_filter_apply(head.operator, head.filter_spec, x_dev.double())
    if out.shape != (ny, nx) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError("headline result is not a finite float32 (ny, nx) tensor")
    torch.testing.assert_close(out.double(), want64, rtol=1e-4, atol=1e-5)
    head_err = float((out.double() - want64).abs().max())
    log(f"headline vs eager engine in float64: max abs {head_err:.3e}")
    del want64

    plain_head = make_cuda_scalar_apply(head.operator, head.filter_spec,
                                        pass_fn=cheb_pass_reference)
    plain_head(x_dev)
    ms_plain = event_ms(lambda: plain_head(x_dev), 10)

    # bounds for one apply: per launch (what this kernel design moves) and
    # for the whole filter (one read of field and operands, one write)
    fn = head._scalar_fn()
    fn_scalar_operands = fn.operands
    ops, p = fn.operands(torch.float32, dev)
    item = 4
    kinds = [FIRST] + [MIDDLE] * (n_steps - 2) + [LAST]
    apply_bytes = sum(step_bytes(k, ops, 1, ny, nx, item) for k in kinds)
    apply_flops = FLOPS_PER_CELL_STEP * ny * nx * n_steps
    b_ms, b_by = bound_ms(apply_bytes, apply_flops, "float32")
    st = ops.stencil
    n_operands = sum(1 for k in ("c", "n", "s", "e", "w", "pre", "post", "area")
                     if isinstance(getattr(st, k), torch.Tensor))
    filter_bytes = (2 + n_operands) * ny * nx * item
    fb_ms, _ = bound_ms(filter_bytes, apply_flops, "float32")
    gps = ny * nx * n_steps / (ms_apply * 1e-3)
    log(f"headline: {ms_apply:.4f} ms/apply (host enqueue {host_apply:.4f} ms/apply) = "
        f"{gps:.4e} grid-point-steps/s on {smi}")
    log(f"  per-launch bound {b_ms:.4f} ms ({apply_bytes / 1e9:.3f} GB, {b_by}); "
        f"whole-filter bound {fb_ms:.4f} ms ({filter_bytes / 1e6:.1f} MB); "
        f"plain PyTorch steps {ms_plain:.4f} ms/apply")

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

    # 6. small vector grids: kernel dispatch vs the same dispatch on the plain step
    vec_ops = {"VECTOR_B_GRID": BGRID, "VECTOR_C_GRID": CTAP}
    vworst = {op: {"float32": [0.0, 0.0], "float64": [0.0, 0.0]} for op in (BGRID, CTAP)}

    def check_vector(label, filt, u, v, dtype_name):
        op = vec_ops[filt.grid_type.name]
        plain = make_cuda_vector_apply(filt.operator, filt.filter_spec,
                                       pass_fn=vec_pass_reference)
        before = dict(vec_pass.launches)
        got = filt.apply_to_vector(u, v)
        torch.cuda.synchronize()
        launched = {k: vec_pass.launches[k] - before[k] for k in before}
        want_launched = {k: filt.n_steps if k == op else 0 for k in before}
        if launched != want_launched:
            raise AssertionError(f"{label}: kernel launches {launched}, expected {want_launched}")
        want = plain(filt._coerce(u), filt._coerce(v))
        errs = []
        for comp, g, w in zip("uv", got, want):
            if g.shape != w.shape or g.device.type != "cuda":
                raise AssertionError(f"{label} {comp}: result {tuple(g.shape)} on {g.device}")
            errs.append(compare(f"{label} {comp}", g, w, dtype_name))
        a, r = max(e[0] for e in errs), max(e[1] for e in errs)
        w8 = vworst[op][dtype_name]
        vworst[op][dtype_name] = [max(w8[0], a), max(w8[1], r)]
        log(f"  {label}: max abs {a:.3e} max rel {r:.3e} ({launched[op]} launches)")
        return got

    vshape = (128, 256)
    log(f"small vector grids at {vshape}:")
    vrng = np.random.default_rng(7)
    u_s, v_s = vrng.random(vshape), vrng.random(vshape)
    cases = [("VECTOR_B_GRID", 1.0), ("VECTOR_C_GRID", 1.0), ("VECTOR_C_GRID", 0.0)]
    for gname, ka in cases:
        gv = unit_vector_grid_vars(gname, vshape, np.random.default_rng(42), ka)
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                          grid_vars=gv, dtype=dt, device=dev)
            tag = f" kappa_aniso={ka:g}" if gname == "VECTOR_C_GRID" else ""
            check_vector(f"{gname} unit metrics{tag} {name}", filt, u_s, v_s, name)
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
        u_n, v_n = u_s.copy(), v_s.copy()
        u_n[10, 20] = np.nan
        v_n[50, 7] = np.nan
        for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
            filt = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType[gname],
                          grid_vars=gv, dtype=dt, device=dev)
            fu, fv = check_vector(f"{gname} NaN in u and v {name}", filt, u_n, v_n, name)
            if not (bool(torch.isnan(fu[10, 20])) and bool(torch.isnan(fv[50, 7]))):
                raise AssertionError("NaN cells must stay NaN")

    # 7. vector headlines (the vector path), at full size
    vrng = np.random.default_rng(42)
    u_h = vrng.random((ny, nx)).astype(np.float32)
    v_h = vrng.random((ny, nx)).astype(np.float32)
    u_dev = torch.as_tensor(u_h, device=dev)
    v_dev = torch.as_tensor(v_h, device=dev)
    vec_results = {}
    vec_kept = {}  # per grid: metrics, unsharded results and float64 answers, for phase 13
    for gname, op in vec_ops.items():
        # kappa_aniso=0: with 1, kappa_tension = 1.5 lifts the C-grid operator's
        # spectrum above s_max on unit metrics and the filter amplifies
        vhead_gv = unit_vector_grid_vars(gname, (ny, nx), vrng, 0.0)
        vhead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                       grid_vars=vhead_gv, dtype=torch.float32, device=dev)
        vn = vhead.n_steps
        torch.cuda.synchronize()
        reset_fallback_counts()
        cheb_pass.launches = 0
        vec_pass.launches = {BGRID: 0, CTAP: 0}
        t0 = time.perf_counter()
        fu, fv = vhead.apply_to_vector(u_h, v_h)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(warm):
            vhead.apply_to_vector(u_dev, v_dev)
        ms_v, host_v = event_ms(lambda: vhead.apply_to_vector(u_dev, v_dev), chain, host=True)
        v_launches = vec_pass.launches[op]
        v_other = {k: n for k, n in vec_pass.launches.items() if k != op}
        v_fallbacks = fallback_counts()
        log(f"headline {ny}x{nx} float32 {gname}, n_steps {vn}: {v_launches} launches "
            f"over {applies} applies (first apply with operand set-up {first_s:.2f} s), "
            f"other kernels {v_other} + cheb_pass {cheb_pass.launches}, fallbacks {v_fallbacks}")
        if v_launches != vn * applies:
            raise AssertionError(f"expected {vn * applies} kernel launches, saw {v_launches}")
        if any(v_other.values()) or cheb_pass.launches:
            raise AssertionError("the vector path launched another kernel")
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

        plain_v = make_cuda_vector_apply(vhead.operator, vhead.filter_spec,
                                         pass_fn=vec_pass_reference)
        plain_v(u_dev, v_dev)
        ms_v_plain = event_ms(lambda: plain_v(u_dev, v_dev), 5)

        fn = vhead._vector_fn()
        vops, vp_ = fn.operands(torch.float32, dev)
        n_coef = vops.coef.shape[0]
        vkinds = [FIRST] + [MIDDLE] * (vn - 2) + [LAST]
        key = "bgrid" if op == BGRID else "ctap"
        v_bytes = sum(vec_step_bytes(k, n_coef, 1, ny, nx, item) for k in vkinds)
        v_flops = VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * vn
        vb_ms, vb_by = bound_ms(v_bytes, v_flops, "float32")
        v_filter_bytes = (n_coef + 4) * ny * nx * item  # u, v, coefficients in; u, v out
        vfb_ms, _ = bound_ms(v_filter_bytes, v_flops, "float32")
        log(f"{gname} headline: {ms_v:.4f} ms/apply (host enqueue {host_v:.4f} ms/apply) = "
            f"{ny * nx * vn / (ms_v * 1e-3):.4e} grid-point-steps/s on {smi}")
        log(f"  per-launch bound {vb_ms:.4f} ms ({v_bytes / 1e9:.3f} GB, {vb_by}); "
            f"whole-filter bound {vfb_ms:.4f} ms ({v_filter_bytes / 1e6:.1f} MB); "
            f"plain PyTorch steps {ms_v_plain:.4f} ms/apply")

        # 8. each step kind against its plain version, headline shape
        w3 = torch.stack([u_dev, v_dev]).unsqueeze(0)
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
        worst_v = vworst[op]
        vec_results[op] = {
            "name": f"vec_pass_{key}",
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": "gcm_filters_tpu/ops/pallas/vec_pass.py:"
                        + ("567" if op == BGRID else "575"),
            "launches": v_launches,
            "max_abs_err": max(s_err, worst_v["float32"][0], worst_v["float64"][0]),
            "headline_vs_f64_engine_max_abs": v_err,
            "max_rel_err_f64": worst_v["float64"][1],
            "ms": ms_v,
            "plain_ms": ms_v_plain,
            "bound_ms": vb_ms,
            "bound_by": vb_by,
            "library_ms": None,
            "unit": f"one headline apply = {vn} launches, {ny}x{nx} float32 {gname}",
            "filter_bound_ms": vfb_ms,
            "middle_step_ms": ms_vmid,
            "middle_step_bound_ms": vmid_ms,
            "host_enqueue_ms": host_v,
        }
        del vbufs, w3, plain_v, fu, fv, vhead, fn, vops

    # 9. sharded small grids: a one-rank process group and a 1x1 mesh
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from gcm_filters_tpu_torch.ops.cuda.local_pass import local_pass, local_pass_reference
    from gcm_filters_tpu_torch.parallel import halo
    from gcm_filters_tpu_torch.parallel.sharded import make_sharded_scalar_apply

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

    def check_sharded(label, x, dtype_name, **kw):
        filt = Filter(device=dev, mesh=mesh, spatial_axes=axes, **kw)
        plain = make_sharded_scalar_apply(
            filt.operator, filt.filter_spec, mesh, axes, halo_steps=filt.halo_steps,
            exact_nan=filt.exact_nan, pass_fn=local_pass_reference)
        before = (local_pass.launches, cheb_pass.launches)
        got = filt.apply(x)
        torch.cuda.synchronize()
        launched = (local_pass.launches - before[0], cheb_pass.launches - before[1])
        if launched != (filt.n_steps, 0):
            raise AssertionError(f"{label}: (local_pass, cheb_pass) launches {launched}, "
                                 f"expected {(filt.n_steps, 0)}")
        if not isinstance(got, DTensor):
            raise AssertionError(f"{label}: the mesh path returned {type(got).__name__}")
        got = got.full_tensor()
        want = plain(filt._coerce(x)).full_tensor()
        if got.shape != want.shape or got.device.type != "cuda":
            raise AssertionError(f"{label}: result {tuple(got.shape)} on {got.device}")
        a, r = compare(label, got, want, dtype_name)
        sworst[dtype_name] = [max(sworst[dtype_name][0], a), max(sworst[dtype_name][1], r)]
        kw.pop("halo_steps", None)
        unsharded = Filter(device=dev, **kw).apply(x)
        if not torch.equal(torch.isnan(got), torch.isnan(unsharded)):
            raise AssertionError(f"{label}: NaN positions differ from the unsharded filter")
        torch.testing.assert_close(got, unsharded, equal_nan=True, **tol_unsharded[dtype_name],
                                   msg=lambda m: f"{label} vs unsharded: {m}")
        ok = ~torch.isnan(unsharded)
        u = float((got[ok] - unsharded[ok]).abs().max())
        log(f"  {label}: vs plain max abs {a:.3e} max rel {r:.3e}; vs unsharded max abs "
            f"{u:.3e} ({launched[0]} launches)")
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

    # 10. sharded headline: the phase-4 workload through the mesh path
    shead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                   grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32,
                   device=dev, mesh=mesh, spatial_axes=axes)
    torch.cuda.synchronize()
    reset_fallback_counts()
    cheb_pass.launches = 0
    vec_pass.launches = {BGRID: 0, CTAP: 0}
    local_pass.launches = 0
    s_out = shead.apply(field)
    y = s_out
    for _ in range(warm):
        y = shead.apply(y)
    ms_sharded, host_sharded = event_ms(lambda: shead.apply(x_dev), chain, host=True)
    s_launches = local_pass.launches
    s_other = dict(vec_pass.launches, cheb_pass=cheb_pass.launches)
    s_fallbacks = fallback_counts()
    log(f"sharded headline {ny}x{nx} float32 {tri.name} on a 1x1 mesh, n_steps {n_steps}: "
        f"{s_launches} local_pass launches over {applies} applies, other kernels {s_other}, "
        f"fallbacks {s_fallbacks}")
    if s_launches != n_steps * applies:
        raise AssertionError(f"expected {n_steps * applies} kernel launches, saw {s_launches}")
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

    sfn = shead._scalar_fn()
    lops, cells, rounds, lp_ = sfn.operands(ny, nx, torch.float32)
    if rounds != (n_steps,):
        raise AssertionError(f"expected one round of {n_steps} steps, planned {rounds}")
    plain_shead = make_sharded_scalar_apply(shead.operator, shead.filter_spec, mesh, axes,
                                            pass_fn=local_pass_reference)
    plain_shead(x_dev)
    ms_s_plain = event_ms(lambda: plain_shead(x_dev), 10)

    # the exchange alone, and the chain of local steps alone on an extended block
    local_axis = (None, 1)
    ms_exchange = event_ms(lambda: halo.exchange_2d(x3, cells, local_axis, local_axis, True), chain)
    xe = halo.exchange_2d(x3, cells, local_axis, local_axis, True)
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
    chain_err = compare("local step chain vs sharded apply", kbuf[2][0], s_full, "float32")[0]

    skinds = [(FIRST, 1)] + [(MIDDLE, k) for k in range(2, n_steps)] + [(LAST, cells)]
    s_bytes = sum(local_step_bytes(k, lops, 1, ny, nx, cells, sh, item) for k, sh in skinds)
    s_cells = sum((ny + 2 * (cells - sh)) * (nx + 2 * (cells - sh)) for _, sh in skinds)
    s_flops = FLOPS_PER_CELL_STEP * s_cells
    sb_ms, sb_by = bound_ms(s_bytes, s_flops, "float32")
    sfb_ms, _ = bound_ms(filter_bytes, s_flops, "float32")
    log(f"sharded headline: {ms_sharded:.4f} ms/apply (host enqueue {host_sharded:.4f} "
        f"ms/apply) = {ny * nx * n_steps / (ms_sharded * 1e-3):.4e} grid-point-steps/s on {smi}")
    log(f"  halo exchange alone ({cells} cells, block {tuple(xe.shape[-2:])}) "
        f"{ms_exchange:.4f} ms; the {n_steps} local steps alone {ms_chain:.4f} ms "
        f"(result vs the apply: max abs {chain_err:.3e}); unsharded kernel path "
        f"{ms_apply:.4f} ms/apply")
    log(f"  per-launch bound {sb_ms:.4f} ms ({s_bytes / 1e9:.3f} GB, {sb_by}); "
        f"whole-filter bound {sfb_ms:.4f} ms ({filter_bytes / 1e6:.1f} MB); "
        f"plain PyTorch steps {ms_s_plain:.4f} ms/apply")

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
    # 12. sharded small vector grids on the same 1x1 mesh
    import dataclasses

    from gcm_filters_tpu_torch.ops.cuda.vec_local_pass import (
        vec_local_pass, vec_local_pass_reference,
    )
    from gcm_filters_tpu_torch.ops.cuda.ring_pass import (
        RingState, ring_pass, ring_pass_reference, vec_ring_pass, vec_ring_pass_reference,
    )
    from gcm_filters_tpu_torch.parallel.sharded import make_sharded_vector_apply

    svworst = {op: {"float32": [0.0, 0.0], "float64": [0.0, 0.0]} for op in (BGRID, CTAP)}

    def counters():
        """Every kernel's launch count, by name."""
        return {"cheb_pass": cheb_pass.launches, "local_pass": local_pass.launches,
                "vec_pass_bgrid": vec_pass.launches[BGRID],
                "vec_pass_ctap": vec_pass.launches[CTAP],
                "vec_local_pass_bgrid": vec_local_pass.launches[BGRID],
                "vec_local_pass_ctap": vec_local_pass.launches[CTAP],
                "ring_pass": ring_pass.launches,
                "vec_ring_pass_bgrid": vec_ring_pass.launches[BGRID],
                "vec_ring_pass_ctap": vec_ring_pass.launches[CTAP]}

    def reset_counters():
        cheb_pass.launches = 0
        local_pass.launches = 0
        vec_pass.launches = {BGRID: 0, CTAP: 0}
        vec_local_pass.launches = {BGRID: 0, CTAP: 0}
        ring_pass.launches = 0
        vec_ring_pass.launches = {BGRID: 0, CTAP: 0}

    def check_sharded_vector(label, op, u, v, dtype_name, **kw):
        filt = Filter(device=dev, mesh=mesh, spatial_axes=axes, **kw)
        plain = make_sharded_vector_apply(
            filt.operator, filt.filter_spec, mesh, axes, halo_steps=filt.halo_steps,
            pass_fn=vec_local_pass_reference)
        mine = "vec_local_pass_" + ("bgrid" if op == BGRID else "ctap")
        before = counters()
        got = filt.apply_to_vector(u, v)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in counters().items()}
        want_launched = {k: filt.n_steps if k == mine else 0 for k in before}
        if launched != want_launched:
            raise AssertionError(f"{label}: kernel launches {launched}, expected {want_launched}")
        if not all(isinstance(g, DTensor) for g in got):
            raise AssertionError(f"{label}: the mesh path returned {[type(g).__name__ for g in got]}")
        got = [g.full_tensor() for g in got]
        want = [w.full_tensor() for w in plain(filt._coerce(u), filt._coerce(v))]
        kw.pop("halo_steps", None)
        unsharded = Filter(device=dev, **kw).apply_to_vector(u, v)
        errs, uerr = [], 0.0
        for comp, g, w, un in zip("uv", got, want, unsharded):
            if g.shape != w.shape or g.device.type != "cuda":
                raise AssertionError(f"{label} {comp}: result {tuple(g.shape)} on {g.device}")
            errs.append(compare(f"{label} {comp}", g, w, dtype_name))
            if not torch.equal(torch.isnan(g), torch.isnan(un)):
                raise AssertionError(f"{label} {comp}: NaN positions differ from the unsharded filter")
            torch.testing.assert_close(g, un, equal_nan=True, **tol_unsharded[dtype_name],
                                       msg=lambda m: f"{label} {comp} vs unsharded: {m}")
            ok = ~torch.isnan(un)
            uerr = max(uerr, float((g[ok] - un[ok]).abs().max()))
        a, r = max(e[0] for e in errs), max(e[1] for e in errs)
        w8 = svworst[op][dtype_name]
        svworst[op][dtype_name] = [max(w8[0], a), max(w8[1], r)]
        log(f"  {label}: vs plain max abs {a:.3e} max rel {r:.3e}; vs unsharded max abs "
            f"{uerr:.3e} ({launched[mine]} launches)")
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
            fu, fv = check_sharded_vector(f"sharded {gname} NaN in u and v {name}", op, u_n, v_n,
                                          name, filter_scale=6.0, dx_min=1.0, grid_type=g,
                                          grid_vars=gv, dtype=dt)
            if not (bool(torch.isnan(fu[10, 20])) and bool(torch.isnan(fv[50, 7]))):
                raise AssertionError("NaN cells must stay NaN")
            for hs in (1, 3, None):
                check_sharded_vector(f"sharded {gname} halo_steps={hs} {name}", op, u_s, v_s,
                                     name, filter_scale=6.0, dx_min=1.0, grid_type=g,
                                     grid_vars=gv, dtype=dt, halo_steps=hs)
    # a C-grid operator that does not scrub NaNs: the NaN spreads through the
    # sharded rounds exactly as through the unsharded kernel path
    c_gv = unit_vector_grid_vars("VECTOR_C_GRID", vshape, np.random.default_rng(42), 0.0)
    c_op = Filter(filter_scale=6.0, dx_min=1.0, grid_type=GridType.VECTOR_C_GRID,
                  grid_vars=c_gv, device=dev).operator
    fu, fv = check_sharded_vector("sharded VECTOR_C_GRID zap_nans=False float64", CTAP, u_n, v_n,
                                  "float64", filter_scale=6.0, dx_min=1.0, halo_steps=3,
                                  custom_operator=dataclasses.replace(c_op, zap_nans=False))
    spread = int(torch.isnan(fu).sum()), int(torch.isnan(fv).sum())
    log(f"  zap_nans=False: NaN cells in (u, v) after the filter {spread}")
    if min(spread) <= 1:
        raise AssertionError(f"an unscrubbed NaN must spread, saw {spread} NaN cells")

    # 13. sharded vector headlines: the phase-7 workloads through the mesh path
    w_dev = torch.stack([u_dev, v_dev]).unsqueeze(0)  # (1, 2, ny, nx), as the rounds stack it
    svec_results = {}
    for gname, op in vec_ops.items():
        key = "bgrid" if op == BGRID else "ctap"
        mine = f"vec_local_pass_{key}"
        kept = vec_kept[op]
        svhead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                        grid_vars=kept["gv"], dtype=torch.float32, device=dev,
                        mesh=mesh, spatial_axes=axes)
        vn = svhead.n_steps
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
        sv_launches = counts.pop(mine)
        sv_fallbacks = fallback_counts()
        log(f"sharded headline {ny}x{nx} float32 {gname} on a 1x1 mesh, n_steps {vn}: "
            f"{sv_launches} {mine} launches over {applies} applies (first apply with operand "
            f"set-up {first_s:.2f} s), other kernels {counts}, fallbacks {sv_fallbacks}")
        if sv_launches != vn * applies:
            raise AssertionError(f"expected {vn * applies} kernel launches, saw {sv_launches}")
        if any(counts.values()):
            raise AssertionError(f"the sharded vector path launched another kernel: {counts}")
        if sv_fallbacks:
            raise AssertionError(f"fallbacks recorded on the kernel path: {sv_fallbacks}")
        if not (isinstance(su, DTensor) and isinstance(sv, DTensor)):
            raise AssertionError(f"the mesh path returned {type(su).__name__}")
        sv_err = sv_vs_k = 0.0
        for comp, g, w, un in zip("uv", (su, sv), kept["want"], kept["out"]):
            g = g.full_tensor()
            if g.shape != (ny, nx) or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
                raise AssertionError(
                    f"sharded {gname} headline {comp} is not a finite float32 (ny, nx) tensor")
            torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-5)
            sv_err = max(sv_err, float((g.double() - w).abs().max()))
            sv_vs_k = max(sv_vs_k, float((g - un).abs().max()))
        log(f"sharded {gname} headline vs eager engine in float64: max abs {sv_err:.3e}; "
            f"vs the unsharded kernel path: max abs {sv_vs_k:.3e}")

        svfn = svhead._vector_fn()
        lvops, cells, rounds, lvp = svfn.operands(ny, nx, torch.float32)
        if rounds != (vn,):
            raise AssertionError(f"expected one round of {vn} steps, planned {rounds}")
        n_coef = lvops.coef.shape[0]
        plain_sv = make_sharded_vector_apply(svhead.operator, svhead.filter_spec, mesh, axes,
                                             pass_fn=vec_local_pass_reference)
        plain_sv(u_dev, v_dev)
        ms_sv_plain = event_ms(lambda: plain_sv(u_dev, v_dev), 5)

        # the exchange alone, and the chain of local steps alone on an extended block
        ms_vex = event_ms(lambda: halo.exchange_2d(w_dev, cells, local_axis, local_axis), chain)
        we = halo.exchange_2d(w_dev, cells, local_axis, local_axis)
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
        vchain_err = max(compare(f"{gname} local step chain vs sharded apply {comp}",
                                 vc[2][0, m], g.full_tensor(), "float32")[0]
                         for m, (comp, g) in enumerate((("u", su), ("v", sv))))
        del vc

        svkinds = [(FIRST, 1)] + [(MIDDLE, k) for k in range(2, vn)] + [(LAST, cells)]
        sv_bytes = sum(vec_local_step_bytes(k, n_coef, 1, ny, nx, cells, sh, item)
                       for k, sh in svkinds)
        sv_cells = sum((ny + 2 * (cells - sh)) * (nx + 2 * (cells - sh)) for _, sh in svkinds)
        sv_flops = VEC_FLOPS_PER_CELL_STEP[key] * sv_cells
        svb_ms, svb_by = bound_ms(sv_bytes, sv_flops, "float32")
        svfb_ms, _ = bound_ms((n_coef + 4) * ny * nx * item, sv_flops, "float32")
        log(f"sharded {gname} headline: {ms_sv:.4f} ms/apply (host enqueue {host_sv:.4f} "
            f"ms/apply) = {ny * nx * vn / (ms_sv * 1e-3):.4e} grid-point-steps/s on {smi}")
        log(f"  halo exchange alone ({cells} cells, block {tuple(we.shape[-2:])}) {ms_vex:.4f} ms; "
            f"the {vn} local steps alone {ms_vchain:.4f} ms (result vs the apply: "
            f"max abs {vchain_err:.3e}); unsharded kernel path "
            f"{vec_results[op]['ms']:.4f} ms/apply")
        log(f"  per-launch bound {svb_ms:.4f} ms ({sv_bytes / 1e9:.3f} GB, {svb_by}); "
            f"whole-filter bound {svfb_ms:.4f} ms; plain PyTorch steps {ms_sv_plain:.4f} ms/apply")

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
        worst_sv = svworst[op]
        svec_results[op] = {
            "name": mine,
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/vec_pass.cu",
            "replaces": "gcm_filters_tpu/parallel/sharded.py:908 (gcm_filters_tpu/ops/pallas/"
                        "vec_pass.py:" + ("567" if op == BGRID else "575") + ")",
            "launches": sv_launches,
            "max_abs_err": max(lv_err, worst_sv["float32"][0], worst_sv["float64"][0]),
            "headline_vs_f64_engine_max_abs": sv_err,
            "max_rel_err_f64": worst_sv["float64"][1],
            "ms": ms_sv,
            "plain_ms": ms_sv_plain,
            "bound_ms": svb_ms,
            "bound_by": svb_by,
            "library_ms": None,
            "unit": f"one sharded headline apply on a 1x1 mesh = one halo exchange + {vn} "
                    f"launches, {ny}x{nx} float32 {gname}, block {tuple(we.shape[-2:])}",
            "filter_bound_ms": svfb_ms,
            "middle_step_ms": ms_lvmid,
            "middle_step_bound_ms": lvmid_ms,
            "exchange_ms": ms_vex,
            "steps_alone_ms": ms_vchain,
            "unsharded_ms": vec_results[op]["ms"],
            "host_enqueue_ms": host_sv,
        }
        del vk, vr, we, plain_sv, svhead, svfn, lvops, su, sv
    dist.destroy_process_group()
    store_dir.cleanup()

    # 15. ring small grids: several y-shards resident on the card
    from gcm_filters_tpu_torch import ResidentMesh
    from gcm_filters_tpu_torch.parallel.ring import (
        make_ring_scalar_apply, make_ring_vector_apply,
    )

    ring_axes = ("y", None)
    rworst = {"ring_pass": 0.0, "vec_ring_pass_bgrid": 0.0, "vec_ring_pass_ctap": 0.0}

    def bitwise(label, got, want):
        """Max abs difference, after requiring equality bit for bit (NaNs in
        the same cells)."""
        if got.shape != want.shape or got.dtype != want.dtype or got.device.type != "cuda":
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} on {got.device}")
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{label}: NaN positions differ from the unsharded kernel path")
        ok = ~torch.isnan(want)
        diff = float((got[ok] - want[ok]).abs().max())
        if diff != 0.0 or not torch.equal(got[ok], want[ok]):
            raise AssertionError(f"{label}: differs from the unsharded kernel path, max abs {diff:.3e}")
        return diff

    def check_ring(label, p_y, fields, **kw):
        """One ring apply against the unsharded kernel path (bitwise) and the
        same ring apply on the plain steps (float32 tolerance)."""
        rmesh = ResidentMesh(p_y, dev)
        filt = Filter(device=dev, dtype=torch.float32, mesh=rmesh, spatial_axes=ring_axes, **kw)
        base = Filter(device=dev, dtype=torch.float32, **kw)
        vector = len(fields) == 2
        if vector:
            mine = "vec_ring_pass_" + ("bgrid" if vec_ops[filt.grid_type.name] == BGRID else "ctap")
            plain = make_ring_vector_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                           pass_fn=vec_ring_pass_reference)
        else:
            mine = "ring_pass"
            plain = make_ring_scalar_apply(filt.operator, filt.filter_spec, rmesh, ring_axes,
                                           exact_nan=filt.exact_nan, pass_fn=ring_pass_reference)
        reset_fallback_counts()
        before = counters()
        got = filt.apply_to_vector(*fields) if vector else (filt.apply(fields[0]),)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in counters().items()}
        want_launched = {k: filt.n_steps if k == mine else 0 for k in before}
        if launched != want_launched:
            raise AssertionError(f"{label}: kernel launches {launched}, expected {want_launched}")
        if fallback_counts():
            raise AssertionError(f"{label}: fallbacks recorded: {fallback_counts()}")
        want = base.apply_to_vector(*fields) if vector else (base.apply(fields[0]),)
        ref = plain(*(filt._coerce(f) for f in fields))
        ref = ref if vector else (ref,)
        a = vs_un = 0.0
        for comp, g, w, r in zip("uv", got, want, ref):
            if type(g) is not torch.Tensor:
                raise AssertionError(f"{label}: the ring returned {type(g).__name__}")
            vs_un = max(vs_un, bitwise(f"{label} {comp}", g, w))
            a = max(a, compare(f"{label} {comp} vs plain ring", g, r, "float32")[0])
        rworst[mine] = max(rworst[mine], a)
        log(f"  {label}: vs the unsharded kernel path max abs {vs_un:.3e}; vs the plain ring "
            f"max abs {a:.3e} ({launched[mine]} launches for {p_y} shards)")
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
        f"(one launch per step for all shards):")
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
        for gname, ka, extra in (("VECTOR_B_GRID", 0.0, {}), ("VECTOR_C_GRID", 0.0, {}),
                                 ("VECTOR_C_GRID", 1.0, {}),
                                 ("VECTOR_C_GRID", 0.0, {"n_steps": 37})):
            gv = unit_vector_grid_vars(gname, rshape, np.random.default_rng(9), ka)
            tag = f" kappa_aniso={ka:g}" if gname == "VECTOR_C_GRID" else ""
            tag += "".join(f" {k}={val}" for k, val in extra.items())
            check_ring(f"ring p_y={p_y} {gname}{tag}", p_y, (u_r, v_r),
                       **dict(std, grid_type=GridType[gname], grid_vars=gv, **extra))

    # 16. ring headlines: the phase-4 and phase-7 workloads on resident shards
    def ring_state(fn):
        """The one (RingState, p) of a ring apply that has run one shape."""
        (state, p_), = fn.shape_cache.values()
        return state, p_

    def ring_headline(label, mine, p_y, fields_np, fields_dev, unsharded, want64, **kw):
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
        ms, host = event_ms(lambda: run(*fields_dev), chain, host=True)
        counts = counters()
        n_launched = counts.pop(mine)
        fb = fallback_counts()
        log(f"ring headline {label}, p_y={p_y}, n_steps {filt.n_steps}: {n_launched} {mine} "
            f"launches over {applies} applies (first apply with operand set-up {first_s:.2f} s), "
            f"other kernels {counts}, fallbacks {fb}")
        if n_launched != filt.n_steps * applies:
            raise AssertionError(f"expected {filt.n_steps * applies} launches, saw {n_launched}")
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

    head_kw = dict(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                   grid_vars={"area": area, "wet_mask": wet})
    want64 = scalar_filter_apply(head.operator, head.filter_spec, x_dev.double())
    ring_by_p = {}
    for p_y in (4, 2, 8):
        rhead, (r_out,), ms_r, host_r, r_launches, r_err, r_vs_un = ring_headline(
            f"{ny}x{nx} float32 {tri.name}", "ring_pass", p_y, (field,), (x_dev,), (out,),
            (want64,), **head_kw)
        ring_by_p[p_y] = dict(ms=ms_r, host_enqueue_ms=host_r)
        if p_y == 4:
            kept4 = (rhead, r_out, ms_r, host_r, r_launches, r_err, r_vs_un)
        else:
            del rhead, r_out
    del want64
    rhead, r_out, ms_ring, host_ring, ring_launches, ring_err, ring_vs_un = kept4
    if host_ring > ms_ring:
        log(f"  the host holds the card back: {host_ring:.4f} ms to enqueue a {ms_ring:.4f} ms apply")
    # a race in the exchange would show as a flicker between repeats
    for k in range(200):
        if not torch.equal(rhead.apply(x_dev), r_out):
            raise AssertionError(f"ring apply {k + 2} differs from the first")
    log("  200 more scalar ring applies, each bitwise equal to the first")
    ms_unsharded_again = event_ms(lambda: head.apply(x_dev), chain)

    rfn = rhead._scalar_fn()
    rstate, rp_ = ring_state(rfn)
    plain_ring = make_ring_scalar_apply(rhead.operator, rhead.filter_spec, rhead.mesh, ring_axes,
                                        pass_fn=ring_pass_reference)
    plain_ring(x_dev)
    ms_ring_plain = event_ms(lambda: plain_ring(x_dev), 5)
    del plain_ring
    # the unsharded steps' bytes plus, per step, 2*p_y halo rows written and read
    halo_bytes = lambda p_y, comps: 2 * (2 * p_y) * comps * nx * item  # noqa: E731
    ring_bytes = apply_bytes + n_steps * halo_bytes(4, 1)
    rb_ms, rb_by = bound_ms(ring_bytes, apply_flops, "float32")
    ms_rmid = event_ms(lambda: ring_pass(rstate, MIDDLE, rp_[2], swap=0), 100)
    rmid_ms, _ = bound_ms(step_bytes(MIDDLE, ops, 1, ny, nx, item) + halo_bytes(4, 1),
                          FLOPS_PER_CELL_STEP * ny * nx, "float32")
    log(f"ring scalar headline: {ms_ring:.4f} ms/apply at p_y=4 ({ring_by_p[2]['ms']:.4f} at 2, "
        f"{ring_by_p[8]['ms']:.4f} at 8) beside the unsharded {ms_apply:.4f} (again just now "
        f"{ms_unsharded_again:.4f}); per-launch bound {rb_ms:.4f} ms ({ring_bytes / 1e9:.3f} GB, "
        f"{rb_by}); plain ring steps {ms_ring_plain:.4f} ms/apply; middle step {ms_rmid:.4f} ms "
        f"vs bound {rmid_ms:.4f} ms")

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
            for r, f in enumerate(state.field):
                f.copy_(x_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
        return load

    from gcm_filters_tpu_torch.ops.cuda.ring_pass import RingOperands, VecRingOperands

    rstep_err = ring_step_kinds("ring step float32", rstate.ops, ny // 4, rp_,
                                load_scalar(torch.float32), ring_pass, ring_pass_reference,
                                torch.float32, "float32")
    ops64, p64 = fn_scalar_operands(torch.float64, dev)
    rstep_err64 = ring_step_kinds("ring step float64", RingOperands.cut(ops64, 4), ny // 4, p64,
                                  load_scalar(torch.float64), ring_pass, ring_pass_reference,
                                  torch.float64, "float64")
    del ops64
    log(f"ring step kinds vs plain at {ny}x{nx}, 4 shards: max abs {rstep_err:.3e} (float32), "
        f"{rstep_err64:.3e} (float64)")
    ring_results = [{
        "name": "ring_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1377",
        "launches": ring_launches,
        "max_abs_err": max(rstep_err, rstep_err64, rworst["ring_pass"]),
        "vs_unsharded_kernel_max_abs": ring_vs_un,
        "headline_vs_f64_engine_max_abs": ring_err,
        "ms": ms_ring,
        "plain_ms": ms_ring_plain,
        "bound_ms": rb_ms,
        "bound_by": rb_by,
        "library_ms": None,
        "unit": f"one ring headline apply = {n_steps} launches for 4 resident y-shards, "
                f"{ny}x{nx} float32",
        "filter_bound_ms": fb_ms,
        "middle_step_ms": ms_rmid,
        "middle_step_bound_ms": rmid_ms,
        "unsharded_ms": ms_apply,
        "host_enqueue_ms": host_ring,
        "p_y": 4,
        "ms_by_p_y": {str(k): v["ms"] for k, v in sorted(ring_by_p.items())},
    }]
    del rhead, rstate, rfn, r_out, kept4

    # 16 and 17 (vector). the B-grid and C-grid ring headlines and their step kinds
    def load_vector(dtype):
        def load(state):
            for r, w_ in enumerate(state.input):
                w_[0].copy_(u_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
                w_[1].copy_(v_dev[r * state.ly:(r + 1) * state.ly].to(dtype))
        return load

    for gname, op in vec_ops.items():
        key = "bgrid" if op == BGRID else "ctap"
        mine = f"vec_ring_pass_{key}"
        kept = vec_kept[op]
        vkw = dict(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname], grid_vars=kept["gv"])
        rv, _, ms_rv, host_rv, rv_launches, rv_err, rv_vs_un = ring_headline(
            f"{ny}x{nx} float32 {gname}", mine, 4, (u_h, v_h), (u_dev, v_dev), kept["out"],
            kept["want"], **vkw)
        vn = rv.n_steps
        vstate, vp4 = ring_state(rv._vector_fn())
        n_coef = vstate.ops.coefs[0].shape[0]
        plain_rv = make_ring_vector_apply(rv.operator, rv.filter_spec, rv.mesh, ring_axes,
                                          pass_fn=vec_ring_pass_reference)
        plain_rv(u_dev, v_dev)
        ms_rv_plain = event_ms(lambda: plain_rv(u_dev, v_dev), 3)
        del plain_rv
        vkinds = [FIRST] + [MIDDLE] * (vn - 2) + [LAST]
        rv_bytes = (sum(vec_step_bytes(k, n_coef, 1, ny, nx, item) for k in vkinds)
                    + vn * halo_bytes(4, 2))
        rv_flops = VEC_FLOPS_PER_CELL_STEP[key] * ny * nx * vn
        rvb_ms, rvb_by = bound_ms(rv_bytes, rv_flops, "float32")
        ms_rvmid = event_ms(lambda: vec_ring_pass(vstate, MIDDLE, vp4[2], swap=0), 100)
        rvmid_ms, _ = bound_ms(vec_step_bytes(MIDDLE, n_coef, 1, ny, nx, item) + halo_bytes(4, 2),
                               VEC_FLOPS_PER_CELL_STEP[key] * ny * nx, "float32")
        log(f"ring {gname} headline: {ms_rv:.4f} ms/apply at p_y=4 beside the unsharded "
            f"{vec_results[op]['ms']:.4f}; per-launch bound {rvb_ms:.4f} ms "
            f"({rv_bytes / 1e9:.3f} GB, {rvb_by}); plain ring steps {ms_rv_plain:.4f} ms/apply; "
            f"middle step {ms_rvmid:.4f} ms vs bound {rvmid_ms:.4f} ms")
        rvstep = ring_step_kinds(f"ring {gname} step float32", vstate.ops, ny // 4, vp4,
                                 load_vector(torch.float32), vec_ring_pass,
                                 vec_ring_pass_reference, torch.float32, "float32")
        vops64, vp64 = make_cuda_vector_apply(rv.operator, rv.filter_spec).operands(
            torch.float64, dev)
        vops64 = VecRingOperands.cut(vops64, 4)
        rvstep64 = ring_step_kinds(f"ring {gname} step float64", vops64, ny // 4, vp64,
                                   load_vector(torch.float64), vec_ring_pass,
                                   vec_ring_pass_reference, torch.float64, "float64")
        del vops64
        log(f"ring {gname} step kinds vs plain at {ny}x{nx}, 4 shards: max abs {rvstep:.3e} "
            f"(float32), {rvstep64:.3e} (float64)")
        ring_results.append({
            "name": mine,
            "route": "cuda",
            "source": "gcm_filters_tpu_torch/csrc/ring_pass.cu",
            "replaces": "gcm_filters_tpu/ops/pallas/vec_pass.py:"
                        + ("567" if op == BGRID else "575") + " (ring mode, :280-343)",
            "launches": rv_launches,
            "max_abs_err": max(rvstep, rvstep64, rworst[mine]),
            "vs_unsharded_kernel_max_abs": rv_vs_un,
            "headline_vs_f64_engine_max_abs": rv_err,
            "ms": ms_rv,
            "plain_ms": ms_rv_plain,
            "bound_ms": rvb_ms,
            "bound_by": rvb_by,
            "library_ms": None,
            "unit": f"one ring headline apply = {vn} launches for 4 resident y-shards, "
                    f"{ny}x{nx} float32 {gname}",
            "filter_bound_ms": vec_results[op]["filter_bound_ms"],
            "middle_step_ms": ms_rvmid,
            "middle_step_bound_ms": rvmid_ms,
            "unsharded_ms": vec_results[op]["ms"],
            "host_enqueue_ms": host_rv,
            "p_y": 4,
        })
        del rv, vstate

    kernels = [{
        "name": "cheb_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/cheb_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:771",
        "launches": launches,
        "max_abs_err": max(step_err, worst["float32"][0], worst["float64"][0]),
        "max_rel_err_f64": worst["float64"][1],
        "ms": ms_apply,
        "plain_ms": ms_plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "unit": f"one headline apply = {n_steps} launches, {ny}x{nx} float32",
        "filter_bound_ms": fb_ms,
        "middle_step_ms": ms_mid,
        "middle_step_bound_ms": mid_ms,
        "host_enqueue_ms": host_apply,
    }, vec_results[BGRID], vec_results[CTAP], {
        "name": "local_pass",
        "route": "cuda",
        "source": "gcm_filters_tpu_torch/csrc/local_pass.cu",
        "replaces": "gcm_filters_tpu/ops/pallas/cheb_pass.py:1296",
        "launches": s_launches,
        "max_abs_err": max(ls_err, sworst["float32"][0], sworst["float64"][0]),
        "headline_vs_f64_engine_max_abs": s_head_err,
        "max_rel_err_f64": sworst["float64"][1],
        "ms": ms_sharded,
        "plain_ms": ms_s_plain,
        "bound_ms": sb_ms,
        "bound_by": sb_by,
        "library_ms": None,
        "unit": f"one sharded headline apply on a 1x1 mesh = one halo exchange + {n_steps} "
                f"launches, {ny}x{nx} float32, block {tuple(xe.shape[-2:])}",
        "filter_bound_ms": sfb_ms,
        "middle_step_ms": ms_lmid,
        "middle_step_bound_ms": lmid_ms,
        "exchange_ms": ms_exchange,
        "steps_alone_ms": ms_chain,
        "host_enqueue_ms": host_sharded,
    }, svec_results[BGRID], svec_results[CTAP]] + ring_results
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
