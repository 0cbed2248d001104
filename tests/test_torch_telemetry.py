"""The port's telemetry (``utils/telemetry.py``): fallback counters and spans.

The counterpart of tests/test_telemetry.py. The JAX package's dispatcher
falls back to its XLA engine after a kernel build fails and counts that; the
port has no fallback tier (a CUDA tensor launches a kernel or raises), so
here the counters must stay empty through every engine the port runs on the
CPU: the unsharded scalar and vector applies, their streamed twins, a
one-rank gloo ``DeviceMesh`` and a CPU ``ResidentMesh``. ``Filter`` with its
default device asks for the card: without one it raises and counts nothing.

The spans are driven on the plain path: each public entry under a CPU
profiler records its root span, a ``gft.launch`` under it for every pass the
plan runs and, streamed, the four stage spans of every chunk; the profiler's
trace holds them; with no profiler and no ``recording()`` nothing on the hot
path records or enters ``record_function``; set-up spans always record; and
threads keep parents of their own.
"""
import collections
import json
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import build
from gcm_filters_tpu_torch.utils import profiling, telemetry
from gcm_filters_tpu_torch.utils.telemetry import (
    PerformanceWarning,
    fallback_counts,
    record_fallback,
    recording,
    reset_fallback_counts,
    reset_spans,
    span,
    spans,
)

SHAPE = (32, 48)


def _scalar_kw(shape=SHAPE, scale=4.0):
    rng = np.random.default_rng(2)
    wet = np.ones(shape)
    wet[0] = 0
    return dict(filter_scale=scale, dx_min=1.0,
                grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                grid_vars={"area": 0.9 + 0.2 * rng.random(shape), "wet_mask": wet})


def _vector_kw(grid, shape=SHAPE, scale=4.0):
    rng = np.random.default_rng(3)
    m = 0.9 + 0.2 * rng.random(shape)
    one = np.ones(shape)
    if grid == "bgrid":
        gv = dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
        return dict(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType.VECTOR_B_GRID,
                    grid_vars=gv)
    gv = dict(wet_mask_t=one, wet_mask_q=one, dxT=m, dyT=m, dxCu=m, dyCu=m, dxCv=m, dyCv=m,
              dxBu=m, dyBu=m, area_u=m * m, area_v=m * m, kappa_iso=one, kappa_aniso=0 * one)
    return dict(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType.VECTOR_C_GRID,
                grid_vars=gv)


def _run(filt, vector, streamed, batch=(), shape=SHAPE):
    rng = np.random.default_rng(4)
    x = rng.random(batch + shape).astype(np.float32)
    if vector:
        y = rng.random(batch + shape).astype(np.float32)
        if streamed:
            return filt.apply_to_vector_streamed(x, y, chunk=2)
        return filt.apply_to_vector(x, y)
    return filt.apply_streamed(x, chunk=2) if streamed else filt.apply(x)


@pytest.mark.parametrize("streamed", [False, True], ids=["apply", "streamed"])
@pytest.mark.parametrize("grid", ["scalar", "bgrid", "cgrid"])
def test_no_fallback_unsharded(grid, streamed):
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        _run(gt.Filter(device="cpu", **kw), grid != "scalar", streamed, batch=(3,))
    assert fallback_counts() == {}


def test_no_fallback_one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    reset_fallback_counts()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
        sharded = dict(device="cpu", mesh=mesh, spatial_axes=("y", "x"))
        with warnings.catch_warnings():
            warnings.simplefilter("error", PerformanceWarning)
            for grid in ("scalar", "bgrid", "cgrid"):
                kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
                for streamed in (False, True):
                    _run(gt.Filter(**sharded, **kw), grid != "scalar", streamed, batch=(2,))
    finally:
        dist.destroy_process_group()
    assert fallback_counts() == {}


@pytest.mark.parametrize("grid", ["scalar", "bgrid", "cgrid"])
def test_no_fallback_resident_mesh(grid):
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    filt = gt.Filter(device="cpu", mesh=gt.ResidentMesh(4, "cpu"), spatial_axes=("y", None),
                     **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        out = _run(filt, grid != "scalar", False)
    assert fallback_counts() == {}
    for o in out if grid != "scalar" else (out,):
        assert isinstance(o, torch.Tensor) and tuple(o.shape) == SHAPE


@pytest.mark.parametrize("grid", ["scalar", "cgrid"])
def test_default_device_raises_without_a_card(grid):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would run")
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    filt = gt.Filter(**kw)
    assert filt.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(filt, grid != "scalar", False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(filt, grid != "scalar", True, batch=(2,))
    assert fallback_counts() == {}


def test_record_fallback_warns_and_counts():
    reset_fallback_counts()
    with pytest.warns(PerformanceWarning, match="forced: a test"):
        record_fallback("forced", "a test")
    with pytest.warns(PerformanceWarning):
        record_fallback("forced", "again")
    assert fallback_counts() == {"forced": 2}
    snapshot = fallback_counts()
    snapshot["forced"] = 0  # a snapshot, not the counters
    assert fallback_counts() == {"forced": 2}
    reset_fallback_counts()
    assert fallback_counts() == {}


# -- spans ----------------------------------------------------------------------

STAGES = ("gft.stream.read", "gft.stream.upload", "gft.launch", "gft.stream.download",
          "gft.stream.assemble")
CHUNKS = (2, 2, 1)  # a batch of 5 streamed in chunks of 2
# grid -> (kind, shape, filter scale): at SHAPE the plans run the step chain,
# at FUSED_SHAPE with a scale of 16 (18 steps) several fused passes
FUSED_SHAPE = (80, 128)
GRIDS = {
    "tripolar_steps": ("scalar", SHAPE, 4.0),
    "tripolar_fused": ("scalar", FUSED_SHAPE, 16.0),
    "bgrid_fused": ("bgrid", FUSED_SHAPE, 16.0),
    "cgrid_steps": ("cgrid", SHAPE, 4.0),
}
CASES = [(entry, grid) for grid, (kind, _, _) in GRIDS.items()
         for entry in (("apply", "apply_streamed") if kind == "scalar"
                       else ("apply_to_vector", "apply_to_vector_streamed"))]


def _filter(grid):
    kind, shape, scale = GRIDS[grid]
    kw = _scalar_kw(shape, scale) if kind == "scalar" else _vector_kw(kind, shape, scale)
    return gt.Filter(device="cpu", **kw), kind != "scalar", shape


def _launches_per_apply(filt, vector, shape):
    """What the plan launches for one apply: a pass each, or a step each."""
    fn = filt._vector_fn() if vector else filt._scalar_fn()
    pl = fn.plan(*shape, torch.float32)
    return len(pl.steps) if pl.fused else filt.n_steps


def _hot():
    return [s for s in spans() if not s.name.startswith("gft.setup.")]


def _inside(s, root):
    return root.start_ns <= s.start_ns and s.end_ns <= root.end_ns


def test_the_fused_cases_plan_several_passes():
    for grid in ("tripolar_fused", "bgrid_fused"):
        filt, vector, shape = _filter(grid)
        fn = filt._vector_fn() if vector else filt._scalar_fn()
        pl = fn.plan(*shape, torch.float32)
        assert pl.fused and len(pl.steps) > 1


@pytest.mark.parametrize("entry, grid", CASES)
def test_a_public_call_records_its_spans(entry, grid):
    from torch.profiler import ProfilerActivity, profile

    filt, vector, shape = _filter(grid)
    streamed = entry.endswith("streamed")
    per = _launches_per_apply(filt, vector, shape)
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(filt, vector, streamed, batch=(sum(CHUNKS),), shape=shape)
    hot = _hot()
    roots = [s for s in hot if s.parent is None]
    assert [r.name for r in roots] == [f"gft.{entry}"]
    root = roots[0]
    assert all(s.call == root.id and s.parent == root.id and _inside(s, root)
               for s in hot if s is not root)
    assert len({s.id for s in spans()}) == len(spans())
    # the first call of a filter fills its operand cache, under the call
    (ops,) = [s for s in spans() if s.name == "gft.setup.operands"]
    assert ops.parent == root.id and ops.call == root.id and _inside(ops, root)
    launch = [s for s in hot if s.name == "gft.launch"]
    if not streamed:
        assert [s.name for s in hot] == [f"gft.{entry}"] + ["gft.launch"] * per
        return
    # each chunk: read, upload, the plan's launches, download, assemble, in order
    expect = []
    for _ in CHUNKS:
        expect += ["gft.stream.read", "gft.stream.upload"] + ["gft.launch"] * per + [
            "gft.stream.download", "gft.stream.assemble"]
    assert [s.name for s in hot[1:]] == expect
    assert len(launch) == per * len(CHUNKS)
    assert all(a.end_ns <= b.start_ns for a, b in zip(hot[1:], hot[2:]))
    components = 2 if vector else 1
    nbytes = [components * n * shape[0] * shape[1] * 4 for n in CHUNKS]
    for stage in ("gft.stream.upload", "gft.stream.download"):
        assert [s.counts for s in hot if s.name == stage] == [{"bytes": b} for b in nbytes]


@pytest.mark.parametrize("grid", ["tripolar_fused", "bgrid_fused"])
def test_the_trace_holds_the_spans(grid, tmp_path):
    filt, vector, shape = _filter(grid)
    per = _launches_per_apply(filt, vector, shape)
    _run(filt, vector, False, shape=shape)  # operands cached
    reset_spans()
    with profiling.trace(str(tmp_path)) as log_dir:
        _run(filt, vector, False, shape=shape)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert log_dir == str(tmp_path)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("gft.")]
    root_name = "gft.apply_to_vector" if vector else "gft.apply"
    assert collections.Counter(e["name"] for e in marks) == {root_name: 1, "gft.launch": per}
    (root,) = [e for e in marks if e["name"] == root_name]
    for e in marks:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
    # the records and the trace's events agree on each span's length: a
    # record is timed inside its record_function
    recs = sorted(_hot(), key=lambda s: s.start_ns)
    got = sorted(marks, key=lambda e: e["ts"])
    assert [r.name for r in recs] == [e["name"] for e in got]
    for r, e in zip(recs, got):
        assert r.ns <= 1e3 * e["dur"] + 1e3


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler running")


def _all_entries():
    """Every public entry of a scalar and a vector filter, each built and
    warmed up (operand caches filled)."""
    scalar, _, shape = _filter("tripolar_fused")
    vector, _, vshape = _filter("bgrid_fused")
    calls = [lambda: _run(scalar, False, False, shape=shape),
             lambda: _run(scalar, False, True, batch=(3,), shape=shape),
             lambda: _run(vector, True, False, shape=vshape),
             lambda: _run(vector, True, True, batch=(3,), shape=vshape)]
    for c in calls:
        c()
    return calls


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    calls = _all_entries()
    reset_spans()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    for c in calls:
        c()
    assert spans() == []
    assert span("gft.apply") is span("gft.launch", bytes=1)  # one shared null context
    with span("gft.apply") as s:
        assert s is None


def test_recording_records_without_a_profiler(monkeypatch):
    calls = _all_entries()
    reset_spans()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with recording():
        with recording():  # blocks nest
            calls[0]()
        calls[2]()
    roots = [s.name for s in spans() if s.parent is None]
    assert roots == ["gft.apply", "gft.apply_to_vector"]
    assert {s.name for s in spans()} == {"gft.apply", "gft.apply_to_vector", "gft.launch"}
    reset_spans()
    calls[1]()  # off again after the block
    assert spans() == []


def test_setup_spans_always_record(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    reset_spans()
    filt, vector, shape = _filter("tripolar_fused")
    assert [s.name for s in spans()] == ["gft.setup.spec", "gft.setup.operator"]
    _run(filt, vector, False, shape=shape)
    _run(filt, vector, False, shape=shape)
    assert [s.name for s in spans()] == ["gft.setup.spec", "gft.setup.operator",
                                         "gft.setup.operands"]  # one miss, then hits
    filt.apply(torch.zeros(shape, dtype=torch.float64))  # another dtype, another miss
    assert [s.name for s in spans()][-1] == "gft.setup.operands"
    assert all(s.parent is None and s.call == s.id and s.ns > 0 for s in spans())
    # loading a kernel library: a build when none is on disk
    reset_spans()
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", lambda names: {n: "no such library" for n in names})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "no such directory")
    build.load("cheb_pass")
    build.load("cheb_pass")  # loaded: no span
    (s,) = spans()
    assert s.name == "gft.setup.kernels" and s.counts == {"builds": 1}


def test_threads_keep_their_own_parents():
    n_threads, rounds = 4 * len(os.sched_getaffinity(0)), 200  # more threads than cores
    errors = []

    def work(i):
        try:
            for _ in range(rounds):
                with span(f"root{i}"):
                    with span(f"child{i}"):
                        with span(f"leaf{i}"):
                            pass
        except Exception as err:  # reported below, with the thread's index
            errors.append((i, err))

    reset_spans()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    got = spans()
    assert len(got) == 3 * n_threads * rounds
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    above = {"child": "root", "leaf": "child"}
    for s in got:
        kind = s.name.rstrip("0123456789")
        if kind == "root":
            assert s.parent is None and s.call == s.id
            continue
        parent = by_id[s.parent]
        assert parent.name == above[kind] + s.name[len(kind):]
        assert s.call == parent.call and _inside(s, parent)


def test_the_buffer_drops_the_oldest():
    reset_spans()
    with recording():
        for i in range(telemetry.SPAN_BUFFER + 5):
            with span("s", i=i):
                pass
    got = spans()
    assert len(got) == telemetry.SPAN_BUFFER
    assert got[0].counts == {"i": 5} and got[-1].counts == {"i": telemetry.SPAN_BUFFER + 4}
    reset_spans()
    assert spans() == []


@pytest.mark.parametrize("grid", ["scalar", "bgrid"])
def test_the_ring_engine_launches_under_the_call(grid):
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    filt = gt.Filter(device="cpu", mesh=gt.ResidentMesh(4, "cpu"), spatial_axes=("y", None),
                     **kw)
    _run(filt, grid != "scalar", False)
    reset_spans()
    with recording():
        _run(filt, grid != "scalar", False)
    hot = _hot()
    root = hot[0]
    assert root.name == ("gft.apply" if grid == "scalar" else "gft.apply_to_vector")
    assert len(hot) > 1 and all(s.name == "gft.launch" and s.parent == root.id for s in hot[1:])


STEP_CASES = {  # filter shape -> its steps at factor 10 (one pass, and four)
    "GAUSSIAN": 11,
    "TAPER": 39,
}


def _step_filter(shape_name, shape, **kw):
    return gt.Filter(device="cpu", filter_shape=gt.FilterShape[shape_name],
                     **{**_scalar_kw(shape, 10.0), **kw})


def _steps_per_call(filt, calls, batch=()):
    """The ``steps=`` of each call's ``gft.launch`` spans, summed a call."""
    _run(filt, False, False, batch=batch, shape=FUSED_SHAPE)  # operands cached
    reset_spans()
    with recording():
        for _ in range(calls):
            _run(filt, False, False, batch=batch, shape=FUSED_SHAPE)
    hot = _hot()
    roots = [s for s in hot if s.parent is None]
    assert [r.name for r in roots] == ["gft.apply"] * calls
    launches = [s for s in hot if s.name == "gft.launch"]
    assert launches and all("steps" in s.counts and "path" not in s.counts for s in launches)
    return [sum(s.counts["steps"] for s in launches if s.call == r.id) for r in roots]


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one_field", "batch_of_3"])
@pytest.mark.parametrize("shape_name", sorted(STEP_CASES))
def test_the_scalar_tile_launches_count_the_filter_steps(shape_name, batch):
    """On the CPU each launch of the scalar tile carries ``steps=`` (and no
    ``path=``, which is the card's), and a call's add up to ``n_steps``."""
    filt = _step_filter(shape_name, FUSED_SHAPE)
    assert filt.n_steps == STEP_CASES[shape_name]
    plan = filt._scalar_fn().plan(*FUSED_SHAPE, torch.float32)
    assert plan.fused and len(plan.steps) == (1 if shape_name == "GAUSSIAN" else 4)
    assert _steps_per_call(filt, 2, batch) == [filt.n_steps] * 2


@pytest.mark.parametrize("shape_name", sorted(STEP_CASES))
def test_the_ring_launches_count_the_filter_steps(shape_name):
    filt = _step_filter(shape_name, FUSED_SHAPE, mesh=gt.ResidentMesh(2, "cpu"),
                        spatial_axes=("y", None))
    assert _steps_per_call(filt, 2) == [filt.n_steps] * 2


def test_the_sharded_rounds_count_the_filter_steps(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
        for shape_name in sorted(STEP_CASES):
            filt = _step_filter(shape_name, FUSED_SHAPE, mesh=mesh, spatial_axes=("y", "x"))
            assert _steps_per_call(filt, 2) == [filt.n_steps] * 2
    finally:
        dist.destroy_process_group()
