"""The yardstick's own arithmetic: the work count, the Gaussian fit and the
plain filter, held to hand-checked values and to the port's plain path."""
import math

import numpy as np
import pytest
import torch

from perfbench import harness, workcount
from perfbench.reference.chebyshev import gaussian_coefficients, n_steps_gaussian
from perfbench.reference.filter import reference_filter

SHAPE = (48, 72)


def cfg(name):
    return harness.load_cell({"sst": "pop_sst.resident1", "uv": "pop_uv.resident1"}[name]).cfg


@pytest.mark.parametrize("name, snapshots, planes", [
    ("sst", 1, 4),  # field in, result out, area, wet_mask
    ("sst", 8, 18),
    ("uv", 1, 12),  # u, v in and out, eight metric planes
])
def test_call_bound_counts_the_configuration_planes(name, snapshots, planes):
    nbytes, flops = workcount.call_work(cfg(name), snapshots)
    assert nbytes == planes * 2400 * 3600 * 4
    per = 15 if name == "sst" else 48
    assert flops == per * 2400 * 3600 * 11 * snapshots
    ms, by = workcount.bound_ms(nbytes, flops, "float32")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * planes * 2400 * 3600 * 4 / 3.35e12)


def test_call_bound_hand_values():
    assert workcount.call_bound_ms(cfg("sst"), 1) == pytest.approx(0.041266, abs=1e-6)
    assert workcount.call_bound_ms(cfg("uv"), 1) == pytest.approx(0.123797, abs=1e-6)
    assert workcount.call_bound_ms(cfg("sst"), 8) == pytest.approx(0.185696, abs=1e-6)


def test_gaussian_fit_pins_both_ends():
    p, s_max = gaussian_coefficients(10.0, 1.0, 11)
    assert s_max == 8.0 and len(p) == 12
    cheb = np.polynomial.chebyshev.chebval
    assert cheb(-1.0, p) == pytest.approx(1.0, abs=1e-14)  # the mean is kept
    assert cheb(1.0, p) == pytest.approx(math.exp(-8.0 * 100 / 24), abs=1e-13)
    t = np.linspace(-1, 1, 201)
    gauss = np.exp(-(8.0 * (t + 1) / 2) * 100 / 24)
    assert np.abs(cheb(t, p) - gauss).max() < 0.02


@pytest.mark.parametrize("factor, steps", [(10.0, 11), (20.0, 22), (2.0, 3)])
def test_step_count(factor, steps):
    assert n_steps_gaussian(factor, 1.0) == steps


def inputs(name, seed=7):
    cell = harness.load_cell({"sst": "pop_sst.resident8", "uv": "pop_uv.resident1"}[name])
    return cell, harness.make_inputs(cell, seed, torch.device("cpu"), SHAPE)


def test_scalar_reference_conserves_area_weighted_sum():
    cell, inp = inputs("sst")
    x = inp.fields[0][:2]
    (out,) = reference_filter(cell.cfg, inp.grid_vars, inp.scales, (x,), torch.float64)
    wet = inp.grid_vars["wet_mask"].bool()
    area = inp.grid_vars["area"]
    assert torch.isnan(out[:, ~wet]).all() and torch.isfinite(out[:, wet]).all()
    before = (area * x.double())[:, wet].sum(-1)
    after = (area * out)[:, wet].sum(-1)
    torch.testing.assert_close(after, before, rtol=1e-12, atol=0)
    assert float(out[:, wet].var()) < 0.5 * float(x.double()[:, wet].var())


def test_vector_reference_is_linear_and_smooths():
    cell, inp = inputs("uv")
    a = tuple(f[:2].double() for f in inp.fields)
    b = tuple(f[2:4].double() for f in inp.fields)

    def filt(fields):
        return reference_filter(cell.cfg, inp.grid_vars, inp.scales, fields, torch.float64)

    both = filt(tuple(x + 2.0 * y for x, y in zip(a, b)))
    for w, fa, fb in zip(both, filt(a), filt(b)):
        torch.testing.assert_close(w, fa + 2.0 * fb, rtol=1e-12, atol=1e-12)
    for f, x in zip(filt(a), a):
        assert float(f.var()) < 0.5 * float(x.var())


@pytest.mark.parametrize("name", ["sst", "uv"])
def test_reference_equals_the_ports_plain_float64_path(name):
    """The yardstick and the program's plain path agree in float64 (the
    test may import the program; the reference does not)."""
    import gcm_filters_tpu_torch as gft

    cell, inp = inputs(name)
    c = cell.cfg
    filt = gft.Filter(filter_scale=inp.scales["filter_scale"], dx_min=inp.scales["dx_min"],
                      grid_type=gft.GridType[c["grid_type"]],
                      grid_vars={k: v.numpy() for k, v in inp.grid_vars.items()},
                      dtype=torch.float64, device="cpu")
    assert filt.n_steps == c["n_steps"]
    fields = tuple(f[:2].double() for f in inp.fields)
    ref = reference_filter(c, inp.grid_vars, inp.scales, fields, torch.float64)
    got = filt.apply_to_vector(*fields) if c["kind"] == "vector" else (filt.apply(fields[0]),)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12, equal_nan=True)
