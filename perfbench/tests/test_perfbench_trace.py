"""The reduction of a profiler trace, on a hand-made one."""
import pytest

from perfbench import tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(tracing.call_label, "user_annotation", 1000.0, 100.0),
    ev(tracing.call_label, "user_annotation", 1100.0, 100.0),
    ev("aten::empty", "cpu_op", 1000.0, 15.0),
    ev("cudaDeviceSynchronize", "cuda_runtime", 1060.0, 40.0),
    ev("tile", "kernel", 1020.0, 60.0),
    ev("tile", "kernel", 1120.0, 50.0),
    ev("Memcpy HtoD", "gpu_memcpy", 1170.0, 20.0),
    ev("tile", "kernel", 5000.0, 10.0),  # outside the profiled calls
]


def test_summary():
    t = tracing.summarize(EVENTS)
    assert t.calls == 2
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(130e-6)  # 60 + 50 + 20, the copy abutting the kernel
    assert [k[0] for k in t.kernels] == ["tile", "tile"] and len(t.memcpys) == 1
    assert t.device_ops[0] == ["tile", pytest.approx(110e-6)]
    gaps = dict((n, s) for n, s in t.idle_gaps)
    # the gaps go to the shortest host span around their middle: 1000-1020
    # (1010: aten::empty), 1080-1120 (1100: the synchronize's end), 1190-1200
    # (1195: the second call's span)
    assert gaps["aten::empty"] == pytest.approx(20e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(40e-6)
    assert gaps[tracing.call_label] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_no_label_raises():
    with pytest.raises(RuntimeError):
        tracing.summarize([ev("tile", "kernel", 0.0, 1.0)])
