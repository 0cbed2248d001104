"""MOM6 OM4_025 velocities on the C-grid through the port, on the CPU.

The benchmark configuration ``mom6_om4p25_uv`` (``perfbench/configs/``)
builds the grid, the land (Antarctica, continents, a one-cell channel across
the x wrap, one-cell islands) and (u, v) with NaN at the land velocity
points; here at 72x96, which keeps the full grid's 3:4 aspect and so its
latitudes. The port's ``Filter.apply_to_vector`` (composed taps,
``ops/ctaps.py``) is held to the benchmark's plain reference, which applies
GCM-Filters' operator in its two stages (``perfbench/reference/
vector_c_grid.py``). The reference alone is held to what the operator is
built to be: symmetric and non-positive in the area-weighted inner product.
The C-grid filter's tap composition records its set-up span.
"""
import math

import pytest
import torch

import gcm_filters_tpu_torch as gft
from gcm_filters_tpu_torch.utils.telemetry import reset_spans, spans
from perfbench import harness
from perfbench.reference import vector_c_grid
from perfbench.reference.filter import reference_filter

CELL = "mom6_om4p25_uv.resident1"
SHAPE = (72, 96)
SEEDS = (2**31 + 5, 2**32 + 77, 12345)
# float32: the port's float32 path is 3.4e-7 to 4.2e-7 of the largest value
# off the float64 reference here (11 steps of float32 rounding, unit
# roundoff 6e-8). 1e-5 leaves 24x room above that, and sits far under the
# reference computed in bfloat16 (8-bit mantissa), 2.5e-2 to 3.0e-2.
F32_TOL = 1e-5


def inputs(seed):
    cell = harness.load_cell(CELL)
    return cell, harness.make_inputs(cell, seed, torch.device("cpu"), SHAPE)


def port(cell, inp, dtype):
    c = cell.cfg
    return gft.Filter(filter_scale=inp.scales["filter_scale"], dx_min=inp.scales["dx_min"],
                      filter_shape=gft.FilterShape[c["filter_shape"]],
                      grid_type=gft.GridType[c["grid_type"]],
                      grid_vars={k: v.numpy() for k, v in inp.grid_vars.items()},
                      dtype=dtype, device="cpu")


def rel_err(got, ref):
    """The widest gap where both are numbers, over the reference's largest
    magnitude there (the benchmark's ``max_rel_err``)."""
    both = ~(torch.isnan(got) | torch.isnan(ref))
    return float((got.double() - ref)[both].abs().max() / ref[both].abs().max())


@pytest.mark.parametrize("batch", [None, 3], ids=["one_pair", "batch_of_3"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float64_port_equals_the_staged_reference(seed, batch):
    cell, inp = inputs(seed)
    filt = port(cell, inp, torch.float64)
    assert filt.n_steps == cell.cfg["n_steps"] == 11
    sel = 0 if batch is None else slice(0, batch)
    u, v = (f[sel].double() for f in inp.fields)
    got = filt.apply_to_vector(u, v)
    ref = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (u, v), torch.float64)
    for g, r in zip(got, ref):
        # only the order of evaluation differs: staged against composed taps
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_nan_stands_exactly_at_the_land_velocity_points(seed):
    cell, inp = inputs(seed)
    u, v = (f[:2].double() for f in inp.fields)
    got = port(cell, inp, torch.float64).apply_to_vector(u, v)
    ref = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (u, v), torch.float64)
    wet_u, wet_v = cell.cfg_module.velocity_masks(inp.grid_vars)
    for g, r, f, wet in zip(got, ref, (u, v), (wet_u, wet_v)):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert torch.equal(torch.isnan(g), torch.isnan(f))
        assert torch.equal(torch.isnan(g[0]), wet == 0)
        assert bool(torch.isfinite(g[:, wet == 1]).all())


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_port_within_its_tolerance(seed):
    cell, inp = inputs(seed)
    u, v = (f[:2] for f in inp.fields)
    got = port(cell, inp, torch.float32).apply_to_vector(u, v)
    ref = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (u, v), torch.float64)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert rel_err(g, r) < F32_TOL


def test_bfloat16_reference_fails_the_float32_tolerance():
    cell, inp = inputs(SEEDS[0])
    u, v = (f[:2] for f in inp.fields)
    low = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (u, v), torch.bfloat16)
    ref = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (u, v), torch.float64)
    assert min(rel_err(g.float(), r) for g, r in zip(low, ref)) > 100 * F32_TOL


def operator_and_fields(seed):
    """The reference's Laplacian on the configuration's grid (land in the
    masks) and two NaN-free (u, v) pairs."""
    _, inp = inputs(seed)
    op = vector_c_grid.operator(inp.grid_vars, torch.float64)
    gen = torch.Generator().manual_seed(seed)
    x, y = (tuple(torch.rand(SHAPE, generator=gen, dtype=torch.float64) - 0.5 for _ in "uv")
            for _ in "xy")
    return inp.grid_vars, op, x, y


def inner(gv, a, b):
    """Sum of area_u u u' + area_v v v'."""
    return float((gv["area_u"] * a[0] * b[0]).sum() + (gv["area_v"] * a[1] * b[1]).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_laplacian_is_symmetric(seed):
    gv, op, x, y = operator_and_fields(seed)
    lx, ly = op.laplacian(*x), op.laplacian(*y)
    scale = math.sqrt(inner(gv, lx, lx) * inner(gv, y, y))
    assert abs(inner(gv, lx, y) - inner(gv, x, ly)) <= 1e-12 * scale


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_laplacian_is_non_positive(seed):
    gv, op, x, _ = operator_and_fields(seed)
    lx = op.laplacian(*x)
    scale = math.sqrt(inner(gv, lx, lx) * inner(gv, x, x))
    assert inner(gv, lx, x) <= 1e-12 * scale
    assert inner(gv, lx, x) < -1e-3 * scale  # the wet cells dissipate


@pytest.mark.parametrize("grid", ["VECTOR_C_GRID", "VECTOR_B_GRID"])
def test_the_tap_composition_records_its_setup_span(grid):
    if grid == "VECTOR_C_GRID":
        cell, inp = inputs(SEEDS[0])
    else:
        cell = harness.load_cell("pop_uv.resident1")
        inp = harness.make_inputs(cell, SEEDS[0], torch.device("cpu"), SHAPE)
    reset_spans()
    filt = port(cell, inp, torch.float32)
    u, v = (f[0] for f in inp.fields)
    filt.apply_to_vector(u, v)
    filt.apply_to_vector(u, v)  # the operands are cached: no second composition
    found = spans()
    taps = [s for s in found if s.name == "gft.setup.ctaps"]
    if grid == "VECTOR_B_GRID":
        assert taps == []
        return
    (ops,) = [s for s in found if s.name == "gft.setup.operands"]
    (tap,) = taps
    assert tap.parent == ops.id and ops.start_ns <= tap.start_ns and tap.end_ns <= ops.end_ns
    assert tap.counts == {"planes": 18, "bytes": 18 * 8 * SHAPE[0] * SHAPE[1]}
    assert tap.ns > 0
