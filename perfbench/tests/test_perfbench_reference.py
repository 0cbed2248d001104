"""The yardstick's own arithmetic: the work count, the Gaussian and Taper
fits, their step counts and the plain filter, held to hand-checked values,
to the values the Gaussian fit gave before the Taper joined it, and to the
port's plain path."""
import math

import numpy as np
import pytest
import torch

from perfbench import harness, workcount
from perfbench.reference.chebyshev import filter_coefficients, n_steps_default
from perfbench.reference.filter import reference_filter

SHAPE = (48, 72)


def cfg(name):
    return harness.load_cell({"sst": "pop_sst.resident1", "uv": "pop_uv.resident1",
                              "taper": "pop_sst_taper.resident1"}[name]).cfg


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


def test_call_bound_of_the_taper_is_its_operations():
    """39 steps of 15 operations a cell: 15 * 8,640,000 * 39 / 67e12 s, over
    the 0.041266 ms that its four planes take to move."""
    nbytes, flops = workcount.call_work(cfg("taper"), 1)
    assert flops == 15 * 2400 * 3600 * 39
    assert workcount.bound_ms(nbytes, flops, "float32")[1] == "operations"
    assert workcount.call_bound_ms(cfg("taper"), 1) == pytest.approx(0.075439, abs=1e-6)


def test_gaussian_fit_pins_both_ends():
    p, s_max = filter_coefficients("GAUSSIAN", 10.0, 1.0, 11)
    assert s_max == 8.0 and len(p) == 12
    cheb = np.polynomial.chebyshev.chebval
    assert cheb(-1.0, p) == pytest.approx(1.0, abs=1e-14)  # the mean is kept
    assert cheb(1.0, p) == pytest.approx(math.exp(-8.0 * 100 / 24), abs=1e-13)
    t = np.linspace(-1, 1, 201)
    gauss = np.exp(-(8.0 * (t + 1) / 2) * 100 / 24)
    assert np.abs(cheb(t, p) - gauss).max() < 0.02


# The Gaussian's p for 11 steps as the Gaussian-only fit gave it, bit for
# bit: every Gaussian configuration's scales fit these (float.hex).
GAUSSIAN_11 = [
    "0x1.94fcb50a0ebb0p-4", "-0x1.883e7005c62cep-3", "0x1.660ea2381f3ebp-3",
    "-0x1.32b212e9bc8a7p-3", "0x1.f01f0e809740bp-4", "-0x1.78c518568dbc4p-4",
    "0x1.0f5e7846519bep-4", "-0x1.6ef237e3baab4p-5", "0x1.da73cd3a60aabp-6",
    "-0x1.1d012d395f911p-6", "0x1.465c63818e3f6p-7", "-0x1.2a07a8a3793c0p-8",
]


@pytest.mark.parametrize("filter_scale, dx_min", [
    (10.0, 1.0),  # pop_0.1deg_sst
    (22187.668084077566, 2218.766808407757),  # pop_0.1deg_uv at 2400x3600
    (48375.81216624173, 4837.581216624173),  # mom6_om4p25_uv at 1080x1440
])
def test_gaussian_fit_is_frozen(filter_scale, dx_min):
    assert n_steps_default("GAUSSIAN", filter_scale, dx_min) == 11
    p, s_max = filter_coefficients("GAUSSIAN", filter_scale, dx_min, 11)
    assert [float(v).hex() for v in p] == GAUSSIAN_11
    assert s_max == 2 * (2.0 / dx_min) ** 2


@pytest.mark.parametrize("factor, steps", [(10.0, 11), (20.0, 22), (2.0, 3)])
def test_step_count(factor, steps):
    assert n_steps_default("GAUSSIAN", factor, 1.0) == steps


@pytest.mark.parametrize("factor, dx_min, width, ndim, steps", [
    (10.0, 1.0, math.pi, 2, 39),  # pop_0.1deg_sst_taper
    (10.0, 1.0, math.pi, 1, 29),
    (7.3, 0.9, 2.0, 2, 46),
    (3.0, 1.0, 1.5, 2, 26),
    (0.5, 1.0, math.pi, 2, 3),  # the floor
])
def test_taper_step_count(factor, dx_min, width, ndim, steps):
    """GCM-Filters' rule, and the port's copy of it, give the same count."""
    from gcm_filters_tpu_torch.filter_spec import FilterShape, compute_n_steps_default

    assert n_steps_default("TAPER", factor, dx_min, width, ndim) == steps
    assert compute_n_steps_default(ndim, FilterShape.TAPER, factor, dx_min, width) == steps


@pytest.mark.parametrize("factor, dx_min, width, ndim", [
    (10.0, 1.0, math.pi, 2),  # pop_0.1deg_sst_taper
    (10.0, 1.0, math.pi, 1),
    (7.3, 0.9, 2.0, 2),
    (30.0, 1.0, 4.0, 2),
])
def test_taper_fit_equals_the_ports_spec(factor, dx_min, width, ndim):
    """The reference's Taper fit, written out apart from the program, and
    the port's ``compute_filter_spec`` agree (the test may import the
    program; the reference does not)."""
    from gcm_filters_tpu_torch.filter_spec import FilterShape, compute_filter_spec

    n = n_steps_default("TAPER", factor, dx_min, width, ndim)
    p, s_max = filter_coefficients("TAPER", factor, dx_min, n, width, ndim)
    spec = compute_filter_spec(factor, dx_min, FilterShape.TAPER, width, ndim, n)
    assert s_max == spec.s_max
    np.testing.assert_allclose(p, np.asarray(spec.p), rtol=0, atol=1e-12)


def test_taper_fit_is_a_sharp_low_pass():
    """1 at k = 0 and 0 at s_max, near 1 below the transition band and near
    0 above the cutoff; bounded coefficients (sum of |p_k| 1.295)."""
    p, s_max = filter_coefficients("TAPER", 10.0, 1.0, 39)
    assert len(p) == 40 and s_max == 8.0
    cheb = np.polynomial.chebyshev.chebval
    assert cheb(-1.0, p) == pytest.approx(1.0, abs=1e-13)
    assert cheb(1.0, p) == pytest.approx(0.0, abs=1e-13)

    def t(k):  # k = sqrt(s_max (t + 1) / 2)
        return 2 * k ** 2 / s_max - 1

    assert abs(cheb(t(0.5 * 2 * math.pi / (math.pi * 10)), p) - 1) < 0.05
    assert abs(cheb(t(np.linspace(1.5 * 2 * math.pi / 10, math.sqrt(8), 50)), p)).max() < 0.05
    assert np.abs(p).sum() == pytest.approx(1.295035, abs=1e-6)


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
