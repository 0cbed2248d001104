"""Benchmark and profiling helpers: timing, roofline accounting, traces.

PyTorch-port counterpart of ``gcm_filters_tpu/utils/profiling.py`` with the
same function names: :func:`benchmark_fn` (CUDA-event timing for work on the
card, the host clock for work on the CPU), :func:`roofline` and
:func:`bound_ms` (the share of, and the least time under, the card's
published peaks), and :func:`trace` (a ``torch.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import torch

# Published H100 SXM peaks (NVIDIA data sheet, at the full 700 W power
# limit): HBM3 rate, and the FP32 / FP64 rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


@contextlib.contextmanager
def trace(log_dir: str = "gcm_filters_tpu_torch_trace"):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when there is a
    card) of the enclosed block into ``log_dir/trace.json``.

    View it with Perfetto or ``chrome://tracing``. Yields ``log_dir``.
    """
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def roofline(
    seconds_per_call: float,
    bytes_moved: int,
    hbm_gbps: float = HBM_BYTES_PER_S / 1e9,  # H100 SXM; pass the target card's bandwidth
) -> float:
    """Fraction of the HBM bandwidth roofline achieved by a memory-bound op."""
    return (bytes_moved / seconds_per_call) / (hbm_gbps * 1e9)


def bound_ms(nbytes: float, flops: float, dtype_name: str) -> Tuple[float, str]:
    """``(ms, bound_by)``: the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``flops`` operations in ``dtype_name`` ("float32" or "float64"): the
    larger of the two times at the published peaks, and which of the two
    ("bytes" or "operations") it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _on_cuda(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_on_cuda(o) for o in obj)
    if isinstance(obj, dict):
        return any(_on_cuda(o) for o in obj.values())
    return False


def benchmark_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> Tuple[float, object]:
    """Time a function, returning ``(seconds_per_call, last_result)``.

    The first ``warmup`` calls are not timed (kernel build, operand caches).
    Where an argument or the result lies on the card, the ``iters`` calls are
    timed with CUDA events on the current stream (device time: PyTorch
    returns before the device finishes, so a host clock alone would measure
    the enqueue); otherwise with ``time.perf_counter``.
    """
    result = None
    for _ in range(warmup):
        result = fn(*args)
    if _on_cuda(args) or _on_cuda(result):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            result = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters, result
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
    return (time.perf_counter() - t0) / iters, result
