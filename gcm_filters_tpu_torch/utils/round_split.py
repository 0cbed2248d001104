"""Split a sharded apply's time on one card: the whole apply, what it does
around its fused launches, and the launches alone, beside the unsharded
fused apply.

    python3 -m gcm_filters_tpu_torch.utils.round_split [--rounds N] [--chain N] [--json PATH]

Run from the root of the repository on a machine with a CUDA card and nvcc.
The cases are the sharded headlines of ``chip_smoke.py`` phases 10 and 13 on
a 1x1 ``DeviceMesh`` over a one-rank NCCL group, 2400x3600 float32: the
scalar headline (``TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED``, drawn as
phase 4 draws it; Gaussian of factor 10, 11 steps in one round, and the
Taper, 39 steps in three rounds), the B-grid and C-grid, Gaussian of factor
10 (11 steps, one round), and the C-grid Taper (``dx_min`` 0.9, 44 steps in
three rounds), on unit-scale metrics and fields drawn as phase 7 draws them.
For each it times, with CUDA events (3 warm-ups, then ``--chain`` calls),
every part in turn, ``--rounds`` times:

- ``apply``: one ``Filter(mesh=...).apply`` or ``apply_to_vector`` of device
  tensors (and ``host_enqueue``, the host's time to enqueue it);
- ``stack`` (vector): ``torch.stack`` of u and v into one ``(1, 2, ly,
  lx)`` state, as the apply did before its rounds read u and v in place;
- ``exchange``: the extended blocks the rounds built before they read
  strips: ``halo.exchange_2d`` of the input, and for each later round
  ``torch.stack`` of both carries' cores and ``exchange_2d`` of it;
- ``strips``: ``halo.exchange_strips`` of the input and, for each later
  round, of both carries' cores (the scalar round's carry pair, one
  tensor);
- ``rounds_alone``: the apply's rounds (``local_rounds_scalar`` or
  ``local_rounds_vector``) with every exchange replaced by the result it
  gave the first time: the fused launches;
- ``unsharded``: ``Filter(device="cuda").apply`` or ``apply_to_vector``,
  the fused K1 or K3 / K4 apply of the same filter on the same fields.

The rounds alone must equal the apply bit for bit, and a vector apply the
unsharded one too (a scalar one's coefficients meet the tripolar seam in
another order). Launches per apply are read from the launch table
(``ops/cuda/launch.py::launch_counts``). It prints one line per case, then
the card's name and power limit and a JSON object of every time; ``--json``
writes that object to a file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda.launch import launch_counts
from .ring_split import SCALAR, scalar_headline_data, unit_vector_grid_vars

SHAPE = (2400, 3600)
# (label, grid, filter shape, dx_min) of the phase-10 and phase-13 sharded headlines
CASES = (("scalar", SCALAR, "GAUSSIAN", 1.0), ("scalar Taper", SCALAR, "TAPER", 1.0),
         ("B-grid", "VECTOR_B_GRID", "GAUSSIAN", 1.0), ("C-grid", "VECTOR_C_GRID", "GAUSSIAN", 1.0),
         ("C-grid Taper", "VECTOR_C_GRID", "TAPER", 0.9))


@contextlib.contextmanager
def frozen_exchanges(recorded):
    """Within the block, ``halo.exchange_2d`` and ``halo.exchange_strips``
    return, call by call in order, the results in ``recorded``; a call past
    its end runs and its result is appended (the first run records). A call
    made inside another (``exchange_2d`` calls ``exchange_strips``) runs as
    it is."""
    from ..parallel import halo

    names = ("exchange_2d", "exchange_strips")
    real = {n: getattr(halo, n) for n in names}
    at, inside = [0], [False]

    def frozen(name):
        def fn(*a, **k):
            if inside[0]:
                return real[name](*a, **k)
            i = at[0]
            at[0] += 1
            if i == len(recorded):
                inside[0] = True
                try:
                    recorded.append(real[name](*a, **k))
                finally:
                    inside[0] = False
            return recorded[i]
        return fn

    for n in names:
        setattr(halo, n, frozen(n))
    try:
        yield
    finally:
        for n in names:
            setattr(halo, n, real[n])


def timed(fn, n):
    """``(device ms, host ms)`` per call over ``n`` calls: CUDA events, and
    the host's time to enqueue the calls (no synchronize inside)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def _launches(apply, entries):
    """``apply()``'s result, once the card has run it, and the launches of
    the kernel entries ``entries`` that it made."""
    before = launch_counts()
    out = apply()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, sum(n - before.get(k, 0) for k, n in after.items() if k[0] in entries)


def round_parts(filt, u, v):
    """``({part: fn}, info)`` of one sharded vector Filter on a 1x1 mesh and
    (ly, lx) device fields: the functions the module docstring names (but
    ``unsharded``), and the rounds, the plans, the launches per apply and
    the check that the rounds alone give the apply's bits."""
    from ..parallel import halo
    from ..parallel import sharded

    fn = filt._vector_fn()
    ly, lx = u.shape
    ops, cells, rounds, p = fn.operands(ly, lx, u.dtype)
    plans = fn.plan(ly, lx, u.dtype)
    out, launches = _launches(lambda: [g.to_local() for g in filt.apply_to_vector(u, v)],
                              ("vec_local_fused_pass", "vec_local_strip_pass"))
    u3, v3 = u[None], v[None]
    ext = (1, 2, ly + 2 * cells, lx + 2 * cells)
    carries = [torch.zeros(ext, device=u.device, dtype=u.dtype) for _ in range(2)]
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    w = torch.stack([u3, v3], dim=1)

    def exchange():
        halo.exchange_2d(w, cells, (None, 1), (None, 1))
        for _ in rounds[1:]:
            halo.exchange_2d(torch.stack([core(c) for c in carries]), cells, (None, 1), (None, 1))

    def strips_fn():
        halo.exchange_strips((u3, v3), cells, (None, 1), (None, 1), stack_dim=1)
        for _ in rounds[1:]:
            halo.exchange_strips(tuple(core(c) for c in carries), cells, (None, 1), (None, 1))

    recorded = []

    def rounds_alone():
        with frozen_exchanges(recorded):
            return sharded.local_rounds_vector(ops, (u3, v3), p, cells, rounds, (None, 1),
                                               (None, 1))

    alone = rounds_alone()
    torch.cuda.synchronize()
    same = all(torch.equal(alone[0, m], out[m]) for m in (0, 1))
    parts = {"apply": lambda: filt.apply_to_vector(u, v),
             "stack": lambda: torch.stack([u3, v3], dim=1),
             "exchange": exchange, "strips": strips_fn, "rounds_alone": rounds_alone}
    info = {"cells": cells, "rounds": list(rounds),
            "plans": [[list(pl.tile), list(pl.steps)] for pl in plans],
            "launches_per_apply": launches, "rounds_alone_equal_apply": bool(same),
            "out": out}
    return parts, info


def scalar_round_parts(filt, x):
    """``({part: fn}, info)`` of one sharded scalar Filter on a 1x1 mesh and
    an (ly, lx) device field: the functions the module docstring names (but
    ``unsharded`` and ``stack``), and the rounds, the launches per apply and
    the check that the rounds alone give the apply's bits."""
    from ..parallel import halo
    from ..parallel import sharded

    fn = filt._scalar_fn()
    ly, lx = x.shape
    ops, cells, rounds, p = fn.operands(ly, lx, x.dtype)
    fold = filt.operator.fold_north
    local = (None, 1)
    out, launches = _launches(lambda: filt.apply(x).to_local(), ("local_strip_pass",))
    x3 = x[None]
    carries = torch.zeros((2,) + tuple(x3.shape), device=x.device, dtype=x.dtype)
    ext = (1, ly + 2 * cells, lx + 2 * cells)
    ext_carries = [torch.zeros(ext, device=x.device, dtype=x.dtype) for _ in range(2)]
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731

    def exchange():
        halo.exchange_2d(x3, cells, local, local, fold)
        for _ in rounds[1:]:
            halo.exchange_2d(torch.stack([core(c) for c in ext_carries]), cells, local, local,
                             fold)

    def strips_fn():
        halo.exchange_strips(x3, cells, local, local, fold)
        for _ in rounds[1:]:
            halo.exchange_strips(carries, cells, local, local, fold)

    recorded = []

    def rounds_alone():
        with frozen_exchanges(recorded):
            return sharded.local_rounds_scalar(ops, x3, p, cells, rounds, local, local, fold)

    alone = rounds_alone()
    torch.cuda.synchronize()
    parts = {"apply": lambda: filt.apply(x), "exchange": exchange, "strips": strips_fn,
             "rounds_alone": rounds_alone}
    info = {"cells": cells, "rounds": list(rounds), "launches_per_apply": launches,
            "rounds_alone_equal_apply": bool(torch.equal(alone[0], out)), "out": out}
    return parts, info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--chain", type=int, default=20)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("round_split: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..filter import Filter
    from ..filter_spec import FilterShape
    from ..models.grids import GridType

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    x, wet, area = scalar_headline_data(SHAPE, np.random.default_rng(42))
    x = torch.as_tensor(x, device=dev)
    rng = np.random.default_rng(42)
    u, v = (torch.as_tensor(rng.random(SHAPE).astype(np.float32), device=dev) for _ in "uv")
    gvs = {g: unit_vector_grid_vars(g, SHAPE, rng) for g in ("VECTOR_B_GRID", "VECTOR_C_GRID")}
    gvs[SCALAR] = {"area": area, "wet_mask": wet}
    store = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{store.name}/store", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("y", "x"))
        cases, infos = {}, {}
        for label, grid, shape, dx_min in CASES:
            kw = dict(filter_scale=10.0, dx_min=dx_min, filter_shape=FilterShape[shape],
                      grid_type=GridType[grid], grid_vars=gvs[grid], dtype=torch.float32,
                      device=dev)
            base = Filter(**kw)
            sharded_filt = Filter(mesh=mesh, spatial_axes=("y", "x"), **kw)
            if grid == SCALAR:
                parts, info = scalar_round_parts(sharded_filt, x)
                info.pop("out")
                ok = info["rounds_alone_equal_apply"]
                parts["unsharded"] = lambda b=base: b.apply(x)
            else:
                want = base.apply_to_vector(u, v)
                parts, info = round_parts(sharded_filt, u, v)
                out = info.pop("out")
                info["vs_unsharded_bitwise"] = all(
                    torch.equal(torch.isnan(o), torch.isnan(w_))
                    and torch.equal(o.nan_to_num(), w_.nan_to_num()) for o, w_ in zip(out, want))
                ok = info["vs_unsharded_bitwise"] and info["rounds_alone_equal_apply"]
                parts["unsharded"] = lambda b=base: b.apply_to_vector(u, v)
            if not ok:
                raise AssertionError(f"{label}: {info}")
            cases[label], infos[label] = parts, info
        times = {label: {} for label in cases}
        host = {label: [] for label in cases}
        for _ in range(args.rounds):
            for label, parts in cases.items():
                for k, fn in parts.items():
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                    ms, host_ms = timed(fn, args.chain)
                    times[label].setdefault(k, []).append(ms)
                    if k == "apply":
                        host[label].append(host_ms)
    finally:
        dist.destroy_process_group()
        store.cleanup()
    for label, info in infos.items():
        t = {k: min(ts) for k, ts in times[label].items()}
        around = t["apply"] - t["rounds_alone"]
        print(f"{label}, rounds {info['rounds']} plans {info.get('plans')}, "
              f"{info['launches_per_apply']} launches per apply: " + ", ".join(
                  f"{k} {', '.join(f'{ms:.4f}' for ms in ts)}" for k, ts in times[label].items())
              + f" ms; apply over rounds alone {around:+.4f} ms, over unsharded "
              f"{t['apply'] / t['unsharded'] - 1:+.1%}", flush=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ms": times,
              "host_ms": host, "cases": infos}
    print(smi)
    print(json.dumps(result))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
