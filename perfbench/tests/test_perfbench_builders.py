"""Every configuration's inputs and every traffic mix at a tiny size on the
CPU, and one run of every cell there through the port's plain path."""
import json

import numpy as np
import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SHAPE = (48, 72)


@pytest.mark.parametrize("cell_name", CELLS)
def test_inputs_from_the_seed(cell_name):
    cell = harness.load_cell(cell_name)
    a = harness.make_inputs(cell, 2**31 + 99, torch.device("cpu"), SHAPE)
    b = harness.make_inputs(cell, 2**31 + 99, torch.device("cpu"), SHAPE)
    c = harness.make_inputs(cell, 2**31 + 100, torch.device("cpu"), SHAPE)
    assert set(a.grid_vars) == set(cell.cfg["grid_vars"])
    for k, v in a.grid_vars.items():
        assert v.shape == SHAPE and v.dtype == torch.float64 and bool(torch.isfinite(v).all())
        assert torch.equal(v, b.grid_vars[k])
    t = cell.traffic
    n = (t["resident_planes"] // (2 if cell.cfg["kind"] == "vector" else 1)
         if t["entry"] == "resident" else t["host_snapshots"])
    for fa, fb, fc in zip(a.fields, b.fields, c.fields):
        assert fa.shape == (n, *SHAPE) and fa.dtype == torch.float32
        assert torch.equal(fa, fb, ) if not torch.isnan(fa).any() else torch.equal(
            torch.nan_to_num(fa, 7.0), torch.nan_to_num(fb, 7.0))
        assert not torch.equal(torch.nan_to_num(fa), torch.nan_to_num(fc))
    if "wet_mask" in a.grid_vars:
        land = a.grid_vars["wet_mask"] == 0
        assert bool(torch.isnan(a.fields[0][:, land]).all())
        assert not bool(torch.isnan(a.fields[0][:, ~land]).any())
    if t["entry"] == "streamed":
        assert all(isinstance(h, np.ndarray) for h in a.host_fields)
    assert a.scales == b.scales


@pytest.mark.parametrize("cell_name", CELLS)
def test_traffic_calls(cell_name):
    cell = harness.load_cell(cell_name)
    t = cell.traffic
    n = 32 if t["entry"] == "streamed" else t["resident_planes"] // (
        2 if cell.cfg["kind"] == "vector" else 1)
    it = harness.calls(t, n)
    got = [next(it) for _ in range(2 * n + 3)]
    if t["entry"] == "streamed":
        assert all(g == range(n) for g in got)
        return
    per = t["snapshots_per_call"]
    assert all(len(g) == per for g in got)
    cover = [i for g in got[: n // per] for i in g]
    assert cover == list(range(n))  # round robin: each snapshot once a cycle
    assert got[n // per] == got[0]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_run_on_the_cpu(cell_name, trace, tmp_path, traced_from_the_start):
    r = harness.run(cell_name, 2**33 + 5, 0.3, trace, "cpu", shape=SHAPE, trace_dir=tmp_path)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", *(
        ["breakdown"] if trace else []), "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = harness.load_cell(cell_name)
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        # no card, so no device metric: only the host spans' readers answer
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "filter_roofline" not in r["metrics"]
        assert r["device"]["window_s"] > 0
    assert r["checks"]["max_rel_err"]["value"] < r["checks"]["max_rel_err"]["limit"]
    assert r["checks"]["nan_mismatch"] == {"value": 0, "limit": 0}
