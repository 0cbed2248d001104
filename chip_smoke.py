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
9. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Without a CUDA device it prints no result and exits 2.
"""
import json
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and
# non-tensor-core FP32 / FP64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
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


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, n):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
    ms_apply = event_ms(lambda: head.apply(out), chain)
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
    log(f"headline: {ms_apply:.4f} ms/apply = {gps:.4e} grid-point-steps/s on {smi}")
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
    for gname, op in vec_ops.items():
        # kappa_aniso=0: with 1, kappa_tension = 1.5 lifts the C-grid operator's
        # spectrum above s_max on unit metrics and the filter amplifies
        vhead = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType[gname],
                       grid_vars=unit_vector_grid_vars(gname, (ny, nx), vrng, 0.0),
                       dtype=torch.float32, device=dev)
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
        ms_v = event_ms(lambda: vhead.apply_to_vector(u_dev, v_dev), chain)
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
        log(f"{gname} headline: {ms_v:.4f} ms/apply = {ny * nx * vn / (ms_v * 1e-3):.4e} "
            f"grid-point-steps/s on {smi}")
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
        }
        del vbufs, w3, plain_v, fu, fv, vhead, fn, vops

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
    }, vec_results[BGRID], vec_results[CTAP]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
