"""POP 0.1° SST under the Taper through the port, on the CPU.

The configuration ``pop_0.1deg_sst_taper`` draws ``pop_0.1deg_sst``'s grid,
land, area weights and snapshots from the seed and filters them with
GCM-Filters' Taper at factor 10 (transition width pi, 39 steps). Here at
96x128, a shape at which the port's scalar plan is fused (at 64x96 it is
not): its 39 steps go in four passes, so the middle passes (carries read from one pair of
buffers and written to the other) run as they do at 2400x3600. The port's
``Filter.apply`` on its plain path is held to the benchmark's plain
reference.
"""
import pytest
import torch

import gcm_filters_tpu_torch as gft
from perfbench import harness
from perfbench.reference.filter import reference_filter

CELL = "pop_sst_taper.resident1"
SHAPE = (96, 128)
SEEDS = (2**31 + 5, 2**32 + 77, 12345)
# float32: the port's float32 path is 6.7e-7 to 7.0e-7 of the largest value
# off the float64 reference here (39 steps of float32 rounding, unit
# roundoff 6e-8, sum of |p_k| 1.3). 1e-5 leaves 14x room above that, and
# sits far under the reference computed in bfloat16 (8-bit mantissa), 4.2e-2
# to 4.5e-2 here (test_the_tolerance_is_far_below_bfloat16).
F32_TOL = 1e-5


def inputs(seed):
    cell = harness.load_cell(CELL)
    return cell, harness.make_inputs(cell, seed, torch.device("cpu"), SHAPE)


def port(cell, inp, dtype):
    c = cell.cfg
    return gft.Filter(filter_scale=inp.scales["filter_scale"], dx_min=inp.scales["dx_min"],
                      filter_shape=gft.FilterShape[c["filter_shape"]],
                      transition_width=inp.scales["transition_width"],
                      grid_type=gft.GridType[c["grid_type"]],
                      grid_vars={k: v.numpy() for k, v in inp.grid_vars.items()},
                      dtype=dtype, device="cpu")


def rel_err(got, ref):
    """The widest gap where both are numbers, over the reference's largest
    magnitude there (the benchmark's ``max_rel_err``)."""
    both = ~(torch.isnan(got) | torch.isnan(ref))
    return float((got.double() - ref)[both].abs().max() / ref[both].abs().max())


def reference(cell, inp, x, dtype=torch.float64):
    (ref,) = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (x,), dtype)
    return ref


def test_the_configuration_is_the_taper_of_the_sst_grid():
    cell, inp = inputs(SEEDS[0])
    sst = harness.load_cell("pop_sst.resident1")
    same = harness.make_inputs(sst, SEEDS[0], torch.device("cpu"), SHAPE)
    for k, v in inp.grid_vars.items():
        assert torch.equal(v, same.grid_vars[k])
    assert torch.equal(torch.nan_to_num(inp.fields[0]), torch.nan_to_num(same.fields[0]))
    assert inp.scales == {**same.scales, "transition_width": cell.cfg["transition_width"]}
    assert cell.cfg["filter_shape"] == "TAPER" and cell.cfg["n_steps"] == 39


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_plan_has_middle_passes(dtype):
    cell, inp = inputs(SEEDS[0])
    filt = port(cell, inp, dtype)
    assert filt.n_steps == 39
    plan = filt._scalar_fn().plan(*SHAPE, dtype)
    assert plan.fused and len(plan.steps) >= 3 and sum(plan.steps) == 39


@pytest.mark.parametrize("batch", [None, 3], ids=["one_snapshot", "batch_of_3"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float64_port_equals_the_reference(seed, batch):
    cell, inp = inputs(seed)
    sel = 0 if batch is None else slice(0, batch)
    x = inp.fields[0][sel].double()
    got = port(cell, inp, torch.float64).apply(x)
    ref = reference(cell, inp, x if batch else x[None])
    ref = ref if batch else ref[0]
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    # only the order of evaluation differs
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("batch", [None, 3], ids=["one_snapshot", "batch_of_3"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float32_port_is_near_the_reference(seed, batch):
    cell, inp = inputs(seed)
    sel = 0 if batch is None else slice(0, batch)
    x = inp.fields[0][sel]
    got = port(cell, inp, torch.float32).apply(x)
    assert got.dtype == torch.float32
    ref = reference(cell, inp, x if batch else x[None])
    ref = ref if batch else ref[0]
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert rel_err(got, ref) < F32_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tolerance_is_far_below_bfloat16(seed):
    cell, inp = inputs(seed)
    x = inp.fields[0][:2]
    low = reference(cell, inp, x, torch.bfloat16)
    assert rel_err(low, reference(cell, inp, x)) > 100 * F32_TOL
