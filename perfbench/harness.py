"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name in files of its own (``BENCHMARK.json`` names them):

- ``configs/<config>.json``: the configuration as it is run, and beside it
  ``configs/<config>.py``, which makes its grid variables and snapshots from
  the seed (``grid_vars``, ``scales``, ``snapshots``);
- ``reference/<grid type>.py``: the plain Laplacian of the configuration's
  grid, which ``reference/filter.py`` turns into the whole filter;
- ``traffic/<mix>.json``: the parameters that :func:`calls` reads;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the per-layer metric
  from the run's spans and trace, or None where it finds nothing to read. A
  metric named ``<quantity>.<cells>`` (the same quantity in another group of
  cells, moving another end-to-end metric) is read by ``metrics/<quantity>.py``
  unless it has a file of its own.

The program is ``gcm_filters_tpu_torch.Filter``; the harness hands it the
inputs and times its public entries. Nothing here imports JAX or the JAX
package.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tracing, workcount
from .reference.filter import reference_filter

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gcm_filters_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
REF_BLOCK = 4  # snapshots the reference filters at once


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    cfg_module: object
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path.name}; it has {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_path = ROOT / entry["file"]
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, w["chips"], cfg, load_module(cfg_path.with_suffix(".py")), traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


# --------------------------------------------------------------------------
# inputs and traffic


@dataclasses.dataclass
class Inputs:
    device: torch.device
    grid_vars: Dict[str, torch.Tensor]  # float64, on the device
    scales: Dict[str, float]  # filter_scale, dx_min (and transition_width), handed to both sides
    # one (n, ny, nx) stack a component: on the device for a resident mix; for
    # the streamed mix on the host, numpy arrays and tensors on their memory
    fields: Tuple[torch.Tensor, ...]
    host_fields: Optional[Tuple[np.ndarray, ...]]


def make_inputs(cell: Cell, seed: int, device: torch.device, shape=None) -> Inputs:
    shape = tuple(shape or (cell.cfg["ny"], cell.cfg["nx"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mod, t = cell.cfg_module, cell.traffic
    gv = mod.grid_vars(cell.cfg, shape, gen, device)
    if t["entry"] == "resident":
        n = t["resident_planes"] // workcount.components(cell.cfg)
    else:
        n = t["host_snapshots"]
    fields = mod.snapshots(cell.cfg, shape, n, gen, device, gv)
    host = None
    if t["entry"] == "streamed":
        host = tuple(f.cpu().numpy() for f in fields)
        fields = tuple(torch.from_numpy(h) for h in host)
    return Inputs(device, gv, mod.scales(cell.cfg, gv), fields, host)


def calls(traffic: dict, n_snapshots: int):
    """The closed loop's calls, endlessly: each a range of snapshot indices.
    Resident: consecutive groups of ``snapshots_per_call``, round robin over
    the resident stack. Streamed: the whole host stack, every call."""
    if traffic["entry"] == "streamed":
        while True:
            yield range(n_snapshots)
    per = traffic["snapshots_per_call"]
    groups = n_snapshots // per
    k = 0
    while True:
        a = (k % groups) * per
        yield range(a, a + per)
        k += 1


# --------------------------------------------------------------------------
# the program under test


class Program:
    """``gcm_filters_tpu_torch.Filter`` built from the inputs, and the entry
    the traffic drives. ``__call__(idx)`` returns one (n, ny, nx) result a
    component: tensors on the device (resident) or numpy arrays (streamed)."""

    def __init__(self, cell: Cell, inputs: Inputs, device: torch.device):
        import gcm_filters_tpu_torch as gft

        cfg = cell.cfg
        extra = {}  # the Taper's transition width, only where the configuration sets one
        if "transition_width" in inputs.scales:
            extra["transition_width"] = inputs.scales["transition_width"]
        self.filter = gft.Filter(
            filter_scale=inputs.scales["filter_scale"], dx_min=inputs.scales["dx_min"],
            filter_shape=gft.FilterShape[cfg["filter_shape"]], grid_type=gft.GridType[cfg["grid_type"]],
            grid_vars={k: v.cpu().numpy() for k, v in inputs.grid_vars.items()},
            dtype=DTYPES[cfg["dtype"]], device=device, **extra)
        if self.filter.n_steps != cfg["n_steps"]:
            raise ValueError(f"the program plans {self.filter.n_steps} steps, the configuration "
                             f"states {cfg['n_steps']}")
        self.vector = cfg["kind"] == "vector"
        self.traffic = cell.traffic
        self.fields, self.host = inputs.fields, inputs.host_fields

    def __call__(self, idx: range):
        f, t = self.filter, self.traffic
        if t["entry"] == "streamed":
            if self.vector:
                return f.apply_to_vector_streamed(*self.host, chunk=t["chunk"])
            return (f.apply_streamed(self.host[0], chunk=t["chunk"]),)
        # one snapshot a call goes in as the 2-D field a user passes
        sel = idx.start if len(idx) == 1 else slice(idx.start, idx.stop)
        if self.vector:
            return f.apply_to_vector(self.fields[0][sel], self.fields[1][sel])
        return (f.apply(self.fields[0][sel]),)


class ReferenceProgram:
    """The reference put in the program's place, computing in ``dtype``: the
    control of the check (``control.py``), never part of a run."""

    def __init__(self, cell: Cell, inputs: Inputs, device: torch.device, dtype: torch.dtype):
        self.cell, self.inputs, self.dtype = cell, inputs, dtype

    def __call__(self, idx: range):
        out = reference_outputs(self.cell, self.inputs, idx, self.dtype,
                                DTYPES[self.cell.cfg["dtype"]])
        if self.cell.traffic["entry"] == "streamed":
            return tuple(o.cpu().numpy() for o in out)
        return out


def reference_outputs(cell: Cell, inputs: Inputs, idx, dtype, out_dtype) -> Tuple[torch.Tensor, ...]:
    """The reference's results for the snapshots ``idx``, in blocks."""
    idx = list(idx)
    parts = []
    for a in range(0, len(idx), REF_BLOCK):
        sel = torch.tensor(idx[a:a + REF_BLOCK], device=inputs.fields[0].device)
        block = tuple(f.index_select(0, sel).to(inputs.device) for f in inputs.fields)
        parts.append(tuple(r.to(out_dtype) for r in reference_filter(
            cell.cfg, inputs.grid_vars, inputs.scales, block, dtype)))
    return tuple(torch.cat([p[c] for p in parts]) for c in range(len(parts[0])))


# --------------------------------------------------------------------------
# the window


class Sampler:
    """A reservoir of ``k`` calls' results, drawn from the seed over the
    whole window: the calls whose results the check compares."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, n: int, idx: range, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((idx, out))
        else:
            j = self.rng.randrange(n + 1)
            if j < self.k:
                self.kept[j] = (idx, out)


@dataclasses.dataclass
class Span:
    start: float
    enqueued: float  # the call returned, before the synchronize
    done: float  # the synchronize returned
    snapshots: int
    profiled: bool


@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric's reader gets."""

    cfg: dict
    spans: List[Span]
    trace: Optional[tracing.TraceSummary]

    def unprofiled(self) -> List[Span]:
        return [s for s in self.spans if not s.profiled]

    def bound_ms(self, snapshots: int) -> float:
        """The least time one call of ``snapshots`` snapshots could take."""
        return workcount.call_bound_ms(self.cfg, snapshots)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(program: Callable, traffic: dict, n_snapshots: int, seconds: float, device,
           sampler: Sampler, trace_dir: Optional[Path]):
    """Drive ``program`` in a closed loop for ``seconds``; with ``trace_dir``
    profile ``trace_calls`` calls from ``trace_start`` of the window on.
    Returns the spans, the window's length, the calls that raised and the
    trace (or None)."""
    spans, failed = [], 0
    prof, profiled, summary = None, 0, None
    it = calls(traffic, n_snapshots)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n = 0
    while True:
        idx = next(it)
        if trace_dir is not None and prof is None and profiled == 0 \
                and time.perf_counter() >= t_start + traffic["trace_start"] * seconds:
            prof = tracing.start()
        label = tracing.call_label if prof is not None else None
        t0 = time.perf_counter()
        try:
            with tracing.annotate(label):
                out = program(idx)
                t1 = time.perf_counter()
                synchronize(device)
        except RuntimeError as err:
            failed += 1
            log(f"call {n} raised: {err}")
            out, t1 = None, time.perf_counter()
        t2 = time.perf_counter()
        spans.append(Span(t0, t1, t2, len(idx), prof is not None))
        if out is not None:
            sampler.offer(n, idx, out)
        n += 1
        if prof is not None:
            profiled += 1
            if profiled == traffic["trace_calls"]:
                summary = tracing.stop(prof, trace_dir)
                prof = None
        if t2 >= deadline and prof is None:
            break
    return spans, spans[-1].done - t_start, failed, summary


# --------------------------------------------------------------------------
# the check


def compare(cell: Cell, inputs: Inputs, kept, device) -> Dict[str, float]:
    """The widest gap between the kept results and the reference in float64,
    over each component's largest reference magnitude, and the count of
    cells where exactly one side is NaN."""
    out_dtype = DTYPES[cell.cfg["dtype"]]
    refs: Dict[int, Tuple[torch.Tensor, ...]] = {}
    needed = sorted({i for idx, _ in kept for i in idx})
    for a in range(0, len(needed), REF_BLOCK):
        block = needed[a:a + REF_BLOCK]
        ref = reference_outputs(cell, inputs, block, torch.float64, torch.float64)
        for j, i in enumerate(block):
            refs[i] = tuple(r[j] for r in ref)
    worst, nan_mismatch, compared = 0.0, 0, 0
    for idx, out in kept:
        for j, i in enumerate(idx):
            for c, ref in enumerate(refs[i]):
                res = out[c] if out[c].ndim == 3 else out[c][None]
                got = torch.as_tensor(res[j]).to(device=device, dtype=out_dtype).double()
                got_nan, ref_nan = torch.isnan(got), torch.isnan(ref)
                nan_mismatch += int((got_nan != ref_nan).sum())
                both = ~(got_nan | ref_nan)
                scale = float(ref[both].abs().max()) if bool(both.any()) else 1.0
                gap = float((got[both] - ref[both]).abs().max()) if bool(both.any()) else 0.0
                worst = max(worst, gap / scale if scale > 0 else gap)
                if not math.isfinite(gap):
                    worst = math.inf
            compared += 1
    return {"max_rel_err": worst, "nan_mismatch": nan_mismatch, "compared": compared}


# --------------------------------------------------------------------------
# one run


def card_lines(device: torch.device) -> Dict[str, object]:
    """The card's name, count and power limit, printed on the run's first
    lines: every number is read beside them."""
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1}
    power = "not read"
    if device.type == "cuda":
        try:
            power = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as err:
            power = f"nvidia-smi failed: {err}"
    log(f"card: {info['kind']}; nvidia-smi name, power.limit: {power}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return info


def base_name(metric: str) -> str:
    """A metric's quantity: ``snapshots_per_s.streamed`` is ``snapshots_per_s``
    measured in the cells that the qualifier after the dot names."""
    return metric.split(".")[0]


def reader_path(metric: str) -> Path:
    """The per-layer metric's reader: ``metrics/<name>.py`` where that file
    exists, else the reader of its quantity, ``metrics/<base name>.py``."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() else HERE / "metrics" / f"{base_name(metric)}.py"


def clocks(device: torch.device) -> str:
    """The card's SM clock, power draw and temperature, for reading a run
    that strays."""
    if device.type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def call_stats(spans: List[Span]) -> str:
    """Quartiles of the calls' times and the host's share, and the rate of
    each half of the window: where runs spread, whether within or between."""
    ms = sorted(1e3 * (s.done - s.start) for s in spans)
    q = np.percentile(ms, [25, 50, 75, 95]) if ms else [0.0] * 4
    enq = 1e3 * sum(s.enqueued - s.start for s in spans) / max(len(spans), 1)
    half = len(spans) // 2
    rates = [sum(s.snapshots for s in part) / (part[-1].done - part[0].start)
             for part in (spans[:half], spans[half:]) if len(part) > 1]
    return (f"call ms q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} p95 {q[3]:.4f}, "
            f"enqueue mean {enq:.4f}; snapshots/s by half {[round(r, 3) for r in rates]}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t_process=None,
        shape=None, make_program=None, trace_dir: Path = ROOT / "build" / "perfbench") -> dict:
    """One run of ``workload``; returns the result line as a dict, its
    ``checks`` last. ``shape`` and ``make_program`` serve the tests and the
    control: a smaller grid, and something else in the program's place."""
    t_process = time.perf_counter() if t_process is None else t_process
    phases = [("imports", time.perf_counter())]
    device = torch.device(device)
    cell = load_cell(workload)
    info = card_lines(device)
    phases.append(("card", time.perf_counter()))
    inputs = make_inputs(cell, seed, device, shape)
    synchronize(device)
    phases.append(("inputs", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # not the streamed mix's staging
    n_snap = inputs.fields[0].shape[0]
    program = (make_program or Program)(cell, inputs, device)
    phases.append(("program", time.perf_counter()))
    it = calls(cell.traffic, n_snap)
    for _ in range(cell.traffic["warmup_calls"]):
        program(next(it))
        synchronize(device)
        phases.append(("warm-up call", time.perf_counter()))
    setup_s = time.perf_counter() - t_process
    t = t_process
    split = []
    for name, t_end in phases:
        split.append(f"{name} {t_end - t:.3f}")
        t = t_end
    log(f"set-up {setup_s:.3f} s: " + ", ".join(split))

    sampler = Sampler(cell.traffic["sample_calls"], seed)
    log(f"before the window: {clocks(device)}")
    spans, window_s, failed, summary = window(
        program, cell.traffic, n_snap, seconds, device, sampler, trace_dir if trace else None)
    log(f"after the window: {clocks(device)}; {call_stats(spans)}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: JAX or the JAX package must not be in the process")
        raise SystemExit(3)
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, inputs, sampler.kept, device)
    limits = cell.cfg["checks"]
    correct = (failed == 0 and checks["compared"] > 0
               and all(checks[k] <= limits[k] for k in limits))

    snapshots = sum(s.snapshots for s in spans)
    metrics = {}
    if not trace:
        values = {"snapshots_per_s": snapshots / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[base_name(m["name"])], "unit": m["unit"]}
    else:
        record = RunRecord(cell.cfg, spans, summary)
        for m in cell.per_layer:
            value = load_module(reader_path(m["name"])).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info["memory_peak_bytes"] = int(peak)
    if trace and summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    result = {"correct": bool(correct), "attempted": len(spans), "failed": failed,
              "metrics": metrics, "device": info}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    log(f"window {window_s:.3f} s, {len(spans)} calls, {snapshots} snapshots, set-up "
        f"{setup_s:.3f} s, {checks['compared']} snapshots compared with the float64 reference")
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    for k in limits:
        log(f"check {k}: {checks[k]!r} limit {limits[k]!r}")
    return result
