"""The readers of the program's own spans (``gcm_filters_tpu_torch.utils.
telemetry``): on the CPU, each answers in a traced run of a resident and of
the streamed cell, within what the benchmark itself times around the calls;
on the card, every kernel the program launches was issued inside the
``gft.launch`` span matched to it by order and starts after that span's
start (on the device's clock to within the trace's alignment of it with the
host's, which the test measures), and the span records and the trace keep
one clock."""
import json
import math
import re
import statistics

import pytest
import torch

from perfbench import harness, tracing

SHAPE = (48, 72)
READERS = ("dispatch_host_ms", "launch_host_ms", "upload_ms_per_snapshot",
           "download_ms_per_snapshot", "assemble_ms_per_snapshot", "operator_build_s")


@pytest.mark.parametrize("cell_name", ["pop_sst.resident1", "pop_sst.streamed"])
def test_the_span_readers_answer_on_the_cpu(cell_name, tmp_path, monkeypatch, capsys,
                                           traced_from_the_start):
    kept = {}
    window = harness.window

    def keep(*args, **kwargs):
        out = window(*args, **kwargs)
        kept["calls"] = out[0]
        return out

    monkeypatch.setattr(harness, "window", keep)
    r = harness.run(cell_name, 2**33 + 11, 2.0, True, "cpu", shape=SHAPE, trace_dir=tmp_path)
    assert r["correct"] is True
    mine = [m["name"] for m in harness.load_cell(cell_name).per_layer
            if harness.base_name(m["name"]) in READERS]
    assert "operator_build_s" in mine and len(mine) >= 3
    for name in mine:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
    setup_s = float(re.search(r"set-up ([0-9.]+) s", capsys.readouterr().err).group(1))
    assert r["metrics"]["operator_build_s"]["value"] < setup_s
    profiled = [s for s in kept["calls"] if s.profiled]
    call_ms = 1e3 * sum(s.done - s.start for s in profiled) / len(profiled)
    if "dispatch_host_ms" in mine:
        inside = r["metrics"]["dispatch_host_ms"]["value"] + r["metrics"]["launch_host_ms"]["value"]
        assert inside <= call_ms


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["pop_sst.resident1", "pop_uv.resident1"])
def test_kernels_start_after_their_launch_spans(cell_name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gcm_filters_tpu_torch.utils import telemetry

    device = torch.device("cuda")
    cell = harness.load_cell(cell_name)
    inputs = harness.make_inputs(cell, 2**31 + 7, device, (480, 720))
    program = harness.Program(cell, inputs, device)
    it = harness.calls(cell.traffic, inputs.fields[0].shape[0])
    for _ in range(3):
        program(next(it))
    torch.cuda.synchronize()
    telemetry.reset_spans()
    prof = tracing.start()
    for _ in range(21):
        with tracing.annotate(tracing.call_label):
            program(next(it))
            torch.cuda.synchronize()
    tracing.stop(prof, tmp_path)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # the first call is left out: the profiler can miss the first kernels
    # after it starts
    second = sorted(e["ts"] for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == tracing.call_label)[1]
    launch_calls = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
                    and e["ts"] >= second}
    # the program's kernels, not PyTorch's own (the stack of u and v)
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and "at::" not in e["name"]
                      and e["args"].get("correlation") in launch_calls), key=lambda e: e["ts"])
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "gft.launch" and e["ts"] >= second),
                   key=lambda e: e["ts"])
    records = [s for s in telemetry.spans() if s.name == "gft.launch"]
    records = [s for s in records if s.call != records[0].call]
    assert len(kernels) == len(marks) == len(records) > 0
    assert len(records) % 20 == 0
    # matched by order, each kernel was issued inside its span: the runtime
    # call that launched it (the trace links the two) lies in the span, and
    # starts after the span's start, on the host's clock
    for k, m in zip(kernels, marks):
        call = launch_calls[k["args"]["correlation"]]
        assert m["ts"] <= call["ts"] and call["ts"] + call["dur"] <= m["ts"] + m["dur"], k["name"]
    # on the device's clock, as the trace aligns it with the host's: a kernel
    # cannot start before its launch call, so where the trace says it does,
    # that is the alignment's error in this trace
    lag_us = min(k["ts"] - m["ts"] for k, m in zip(kernels, marks))
    skew_us = max(launch_calls[k["args"]["correlation"]]["ts"] - k["ts"] for k in kernels)
    # a record is timed inside its record_function: the offset between the
    # records' clock and the trace's is the same for every span, up to that
    # call's cost
    offsets = [1e3 * m["ts"] - r.start_ns for m, r in zip(marks, records)]
    spread_us = 1e-3 * (max(offsets) - min(offsets))
    print(f"{cell_name}: {len(records)} launches, clock offset spread {spread_us:.1f} us, "
          f"kernel after its span's start by at least {lag_us:.1f} us, device clock before the "
          f"host's by at most {max(skew_us, 0.0):.1f} us")
    assert spread_us < 250.0
    assert lag_us > -1000.0 and skew_us < 1000.0
    mid = statistics.median(offsets)
    for k, r in zip(kernels, records):
        assert 1e3 * k["ts"] - mid >= r.start_ns - 1000e3
