"""The C-grid configuration ``mom6_om4p25_uv`` at tiny sizes on the CPU: its
reference against the port's plain float64 path, what its builder makes
(land share, ``wet_mask_q``, the channels and islands, NaN at the land
velocity points, 11 steps), and the reader of ``ctap_build_s``."""
import math

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference.filter import reference_filter

CELL = "mom6_om4p25_uv.resident1"
SHAPE = (48, 72)
SHAPES = [SHAPE, (36, 48), (72, 96)]


def inputs(seed=7, shape=SHAPE):
    cell = harness.load_cell(CELL)
    return cell, harness.make_inputs(cell, seed, torch.device("cpu"), shape)


def test_reference_equals_the_ports_plain_float64_path():
    """As ``test_reference_equals_the_ports_plain_float64_path`` holds the
    POP configurations: the staged reference and the port's composed taps
    agree in float64."""
    import gcm_filters_tpu_torch as gft

    cell, inp = inputs()
    c = cell.cfg
    filt = gft.Filter(filter_scale=inp.scales["filter_scale"], dx_min=inp.scales["dx_min"],
                      grid_type=gft.GridType[c["grid_type"]],
                      grid_vars={k: v.numpy() for k, v in inp.grid_vars.items()},
                      dtype=torch.float64, device="cpu")
    assert filt.n_steps == c["n_steps"] == 11
    fields = tuple(f[:2].double() for f in inp.fields)
    ref = reference_filter(c, inp.grid_vars, inp.scales, fields, torch.float64)
    got = filt.apply_to_vector(*fields)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_land_share_and_step_count(shape):
    cell, inp = inputs(shape=shape)
    land = 1.0 - float(inp.grid_vars["wet_mask_t"].mean())
    assert 0.25 <= land <= 0.35
    steps = math.ceil(1.1 * inp.scales["filter_scale"] / inp.scales["dx_min"])
    assert steps == cell.cfg["n_steps"] == 11
    assert inp.scales["filter_scale"] == pytest.approx(10 * inp.scales["dx_min"], rel=1e-14)
    lengths = [inp.grid_vars[k] for k in cell.cfg_module.LENGTHS]
    assert inp.scales["dx_min"] == min(float(a.min()) for a in lengths)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_wet_mask_q_is_the_product_of_the_four_t_masks(shape):
    _, inp = inputs(shape=shape)
    t = inp.grid_vars["wet_mask_t"].numpy()
    q = inp.grid_vars["wet_mask_q"].numpy()
    ny, nx = shape
    for j in range(ny):
        for i in range(nx):
            jn, ie = (j + 1) % ny, (i + 1) % nx
            assert q[j, i] == t[j, i] * t[j, ie] * t[jn, i] * t[jn, ie]
    assert set(np.unique(t)) == {0.0, 1.0}


def test_the_land_has_its_channels_islands_and_a_continent_across_the_wrap():
    _, inp = inputs(shape=(72, 96))
    t = inp.grid_vars["wet_mask_t"].numpy()
    ny, nx = t.shape
    land = t == 0
    # the southern rows are Antarctica; the top row is not all land
    assert land[0].all() and not land[-1].all()
    # a row with land in both its first and last column (the x wrap)
    assert (land[:, 0] & land[:, -1] & ~land.all(axis=1)).any()
    # a wet cell with land east and west (a north-south channel), and one
    # with land north and south (an east-west channel) in the continent
    # across the wrap
    wet = ~land
    ns = wet & np.roll(land, 1, 1) & np.roll(land, -1, 1)
    ew = wet & np.roll(land, 1, 0) & np.roll(land, -1, 0)
    assert ns[1:-1].any() and (ew[1:-1, :3].any() or ew[1:-1, -3:].any())
    # one-cell islands: land with its eight neighbours wet
    around = sum(np.roll(np.roll(wet, a, 0), b, 1) for a in (-1, 0, 1) for b in (-1, 0, 1)
                 if (a, b) != (0, 0))
    assert (land & (around == 8)).sum() >= 3


@pytest.mark.parametrize("seed", [2**31 + 99, 2**33 + 1])
def test_nan_stands_exactly_at_the_land_velocity_points(seed):
    _, inp = inputs(seed)
    t = inp.grid_vars["wet_mask_t"].numpy()
    wet_u = t * np.roll(t, -1, 1)  # T(j, i) and T(j, i + 1)
    wet_v = t * np.roll(t, -1, 0)  # T(j, i) and T(j + 1, i), across the y wrap
    for f, wet in zip(inp.fields, (wet_u, wet_v)):
        nan = torch.isnan(f).numpy()
        assert (nan == (wet == 0)[None]).all()
        x = f.numpy()[:, wet == 1]
        assert x.min() >= -1.0 and x.max() < 1.0


def test_ctap_build_s_answers_in_a_traced_run(tmp_path, capsys):
    r = harness.run(CELL, 2**33 + 11, 2.0, True, "cpu", shape=SHAPE, trace_dir=tmp_path)
    assert r["correct"] is True
    m = r["metrics"]
    assert 0 < m["ctap_build_s"]["value"] <= m["operator_build_s"]["value"]
    setup_s = float(capsys.readouterr().err.split("set-up ")[1].split(" s")[0])
    assert m["operator_build_s"]["value"] < setup_s


def test_ctap_build_s_reads_nothing_without_the_span():
    from perfbench.metrics import ctap_build_s

    record = harness.RunRecord({}, [harness.Span(1e12, 1e12, 1e12, 1, False)], None)
    assert ctap_build_s.read(harness.RunRecord({}, [], None)) is None
    from gcm_filters_tpu_torch.utils.telemetry import reset_spans

    reset_spans()
    assert ctap_build_s.read(record) is None
