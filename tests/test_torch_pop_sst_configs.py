"""The scalar POP 0.1° configurations of the benchmark through the port, on
the CPU.

Each configuration of ``perfbench/configs/`` that filters POP SST
(``pop_0.1deg_sst``: the Gaussian in float32; ``pop_0.1deg_sst_taper``: the
39-step Taper; ``pop_0.1deg_sst_f64``: the Gaussian in float64) makes its
grid variables and snapshots from a seed, here at 96x144, a shape at which
the port's scalar plans are fused as at 2400x3600 (one pass for 11 steps,
four for 39). The benchmark's ``Program`` drives the port's ``Filter.apply``
on one 2-D snapshot a call, as a run does, and the benchmark's own
comparison holds the results to the plain float64 reference under that
configuration's ``checks``. The float64 configuration's limit has to catch
a filter computed in float32: the same float64 inputs filtered by the port
in float32 fail it.
"""
import pytest
import torch

import gcm_filters_tpu_torch as gft
from perfbench import harness

SHAPE = (96, 144)
SEEDS = (2**31 + 7, 2**32 + 91)
CELLS = {  # configuration -> the cell that runs it
    "pop_0.1deg_sst": "pop_sst.resident1",
    "pop_0.1deg_sst_taper": "pop_sst_taper.resident1",
    "pop_0.1deg_sst_f64": "pop_sst.resident1_f64",
}
CPU = torch.device("cpu")


def inputs(config, seed):
    cell = harness.load_cell(CELLS[config])
    assert cell.cfg["name"] == config
    return cell, harness.make_inputs(cell, seed, CPU, SHAPE)


def results(program, calls):
    """``(idx, outputs)`` of the first ``calls`` calls of the cell's traffic."""
    it = harness.calls(program.traffic, program.fields[0].shape[0])
    return [(idx, program(idx)) for idx in (next(it) for _ in range(calls))]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_port_passes_the_configurations_checks(config, seed):
    cell, inp = inputs(config, seed)
    program = harness.Program(cell, inp, CPU)
    assert program.filter.n_steps == cell.cfg["n_steps"]
    plan = program.filter._scalar_fn().plan(*SHAPE, harness.DTYPES[cell.cfg["dtype"]])
    assert plan.fused and sum(plan.steps) == cell.cfg["n_steps"]
    kept = results(program, 3)
    assert all(out[0].dtype == harness.DTYPES[cell.cfg["dtype"]] and out[0].shape == SHAPE
               for _, out in kept)
    checks = harness.compare(cell, inp, kept, CPU)
    assert checks["compared"] == 3
    for name, limit in cell.cfg["checks"].items():
        assert checks[name] <= limit, (name, checks[name], limit)


def test_the_float64_configuration_filters_the_float32_draws():
    """The same grid and values as ``pop_0.1deg_sst`` from a seed, the
    snapshots cast once to float64 (exactly), at the same filter."""
    cell, inp = inputs("pop_0.1deg_sst_f64", SEEDS[0])
    f32_cell, f32 = inputs("pop_0.1deg_sst", SEEDS[0])
    for k, v in inp.grid_vars.items():
        assert torch.equal(v, f32.grid_vars[k])
    (x,), (y,) = inp.fields, f32.fields
    assert x.dtype == torch.float64 and y.dtype == torch.float32
    assert torch.equal(torch.isnan(x), torch.isnan(y))
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y).double())
    assert inp.scales == f32.scales
    same = {k: v for k, v in cell.cfg.items() if k not in ("name", "deployment", "assumed",
                                                          "dtype", "checks")}
    assert same == {k: f32_cell.cfg[k] for k in same}
    assert cell.cfg["dtype"] == "float64" and cell.cfg["assumed"][:3] == f32_cell.cfg["assumed"]


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_arithmetic_fails_the_float64_limit(seed):
    """The float64 inputs filtered by the port in float32: near float32's
    rounding off the reference, and far above the float64 limit."""
    cell, inp = inputs("pop_0.1deg_sst_f64", seed)
    filt = gft.Filter(filter_scale=inp.scales["filter_scale"], dx_min=inp.scales["dx_min"],
                      filter_shape=gft.FilterShape[cell.cfg["filter_shape"]],
                      grid_type=gft.GridType[cell.cfg["grid_type"]],
                      grid_vars={k: v.numpy() for k, v in inp.grid_vars.items()},
                      dtype=torch.float32, device="cpu")
    kept = [(range(i, i + 1), (filt.apply(inp.fields[0][i]),)) for i in range(2)]
    assert kept[0][1][0].dtype == torch.float32
    checks = harness.compare(cell, inp, kept, CPU)
    limit = cell.cfg["checks"]["max_rel_err"]
    assert checks["nan_mismatch"] == 0
    assert checks["max_rel_err"] > 100 * limit, (checks["max_rel_err"], limit)
