"""The profiled sub-window of a ``--trace 1`` run, reduced to what the
per-layer metrics and the result line's ``breakdown`` read.

``torch.profiler`` (CUPTI) records the device's kernels, copies and sets
beside the host's operators. The benchmark labels each profiled call; the
sub-window runs from the first label's start to the last one's end. The
trace is written to a fixed file inside the checkout and read back.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import torch

call_label = "perfbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    calls: int  # profiled calls
    window_s: float  # first call's start to the last call's end
    busy_s: float  # seconds in which a kernel, copy or set ran on the device
    kernels: List[Tuple[str, float, float]]  # (name, start us, duration us)
    memcpys: List[Tuple[str, float, float]]
    device_ops: List[list]  # [name, seconds], the most time first
    idle_gaps: List[list]  # [what the host was doing, seconds], the most first


def start():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    return prof


@contextlib.contextmanager
def annotate(label: Optional[str]):
    if label is None:
        yield
        return
    with torch.profiler.record_function(label):
        yield


def stop(prof, out_dir: Path) -> TraceSummary:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    return summarize(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list) -> TraceSummary:
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    labels = [e for e in complete if e.get("name") == call_label and e.get("cat") == "user_annotation"]
    if not labels:
        raise RuntimeError(f"the trace ({len(events)} events) holds no {call_label!r} span")
    w0 = min(float(e["ts"]) for e in labels)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in labels)

    def inside(e):
        return float(e["ts"]) >= w0 and float(e["ts"]) + float(e["dur"]) <= w1

    device = [e for e in complete if e.get("cat") in DEVICE_CATS and inside(e)]
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    busy_us = sum(b - a for a, b in busy)

    by_name = collections.Counter()
    for e in device:
        by_name[str(e["name"])[:200]] += float(e["dur"]) * 1e-6
    device_ops = [[n, s] for n, s in by_name.most_common(TOP)]

    host = [e for e in complete if e.get("cat") in HOST_CATS
            and float(e["ts"]) <= w1 and float(e["ts"]) + float(e["dur"]) >= w0]
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        around = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        what = min(around, key=lambda e: float(e["dur"]))["name"] if around else "no host span"
        gaps[str(what)[:200]] += (b - a) * 1e-6
    idle_gaps = [[n, s] for n, s in gaps.most_common(TOP)]

    def triple(e):
        return (str(e["name"]), float(e["ts"]), float(e["dur"]))

    return TraceSummary(
        calls=len(labels), window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        kernels=[triple(e) for e in device if e.get("cat") == "kernel"],
        memcpys=[triple(e) for e in device if e.get("cat") == "gpu_memcpy"],
        device_ops=device_ops, idle_gaps=idle_gaps)
