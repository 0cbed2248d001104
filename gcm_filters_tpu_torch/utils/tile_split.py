"""Split the fused scalar tile's time into its window load and its steps, on one card.

    python3 -m gcm_filters_tpu_torch.utils.tile_split [--rounds N] [--json PATH]

Run from the root of the repository on a machine with a CUDA card and nvcc.
It builds four copies of ``csrc/cheb_pass.cu`` under ``build/tile_split/``
(git-ignored), each with its own copy of ``csrc/cheb_tile.cuh``: as it is
("full"), with the window's load cut from ``fused_tile`` ("no load": the
steps read whatever shared memory holds), with the steps cut ("no steps":
the load and the stores of the carries), and with both cut ("store only").
The kernel sources in the package are not changed and nothing in them
switches a part off: the cuts are made on the copies, by the text markers
of ``fused_tile`` (the comment ``// 1. the window`` opens the load, ``// 2.
the steps`` opens the steps, whose ``for (int i = 0; i < H; ++i)`` loop is
cut).

Each copy then runs the fused plan of two 2400x3600 float32 headlines of
``chip_smoke.py`` phase 4 (the Gaussian of factor 10 on
TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED, and IRREGULAR_WITH_LAND) through
``ops.cuda.dispatch._fused_chain``, timed with CUDA events as phase 4 times
it (3 warm-ups, then ``--chain`` applies), every copy in turn, ``--rounds``
times. The "full" copy is also held bit for bit to the package's own build.
load = full - no load, steps = full - no steps; where the parts do not
overlap, no load + no steps - store only comes back to full.

It prints one line per case and copy, then the card's name and power limit
and a JSON object of every time; ``--json`` writes that object to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda import cheb_pass as cp

OUT_DIR = build.BUILD_DIR.parent / "tile_split"
VARIANTS = ("full", "no load", "no steps", "store only")
_LOAD = re.compile(r"\n  // 1\. the window.*?(?=\n  // 2\. the steps)", re.S)
_STEPS = re.compile(r"\n  for \(int i = 0; i < H; \+\+i\) \{\n.*?\n  \}\n", re.S)


def cut(text: str, variant: str) -> str:
    """``cheb_tile.cuh`` with the parts that ``variant`` cuts taken out of
    ``fused_tile``; raises where a marker is missing."""
    head, sep, body = text.partition("__device__ __forceinline__ void fused_tile(")
    if not sep:
        raise ValueError("fused_tile not found in cheb_tile.cuh")
    for part, pat in (("load", _LOAD), ("steps", _STEPS)):
        if variant in ("store only", f"no {part}"):
            body, n = pat.subn("\n", body, count=1)
            if n != 1:
                raise ValueError(f"the {part} of fused_tile not found in cheb_tile.cuh")
    return head + sep + body


def build_variants():
    """Build the four copies at once (one nvcc each); their libraries by name."""
    nvcc = build._nvcc()
    procs = {}
    for v in VARIANTS:
        src = OUT_DIR / v.replace(" ", "_")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.SRC_DIR, src)
        header = src / "cheb_tile.cuh"
        header.write_text(cut(header.read_text(), v))
        lib = src / "cheb_pass.so"
        procs[v] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src / "cheb_pass.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {v!r} copy:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"built {v!r}: {len(regs)} kernels", flush=True)
        libs[v] = ctypes.CDLL(str(lib))
    return libs


def use(lib) -> None:
    """Route cheb_fused_pass to ``lib`` (the wrappers bind its argtypes)."""
    for fn in (lib.cheb_pass_f32, lib.cheb_pass_f64):
        fn.argtypes = cp._ARGTYPES
        fn.restype = ctypes.c_int
    lib.cheb_pass_error_string.argtypes = [ctypes.c_int]
    lib.cheb_pass_error_string.restype = ctypes.c_char_p
    cp._lib = lib


def headlines(dev):
    """The two phase-4 headlines: (label, Filter, field) at 2400x3600 float32."""
    from ..filter import Filter
    from ..models.grids import GridType

    ny, nx = 2400, 3600
    rng = np.random.default_rng(42)
    wet = np.ones((ny, nx))
    wet[0, :] = 0  # Antarctica
    wet[: ny // 6, : nx // 5] = 0  # an idealized continent
    area = 0.9 + 0.2 * rng.random((ny, nx))
    field = torch.as_tensor(rng.random((ny, nx)).astype(np.float32), device=dev)
    tri = GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED
    head = Filter(filter_scale=10.0, dx_min=1.0, grid_type=tri,
                  grid_vars={"area": area, "wet_mask": wet}, dtype=torch.float32, device=dev)
    m = 0.9 + 0.2 * rng.random((ny, nx))
    ones = np.ones((ny, nx))
    irr = Filter(filter_scale=10.0, dx_min=1.0, grid_type=GridType.IRREGULAR_WITH_LAND,
                 grid_vars=dict(wet_mask=wet, dxw=m, dyw=m, dxs=m, dys=m, area=m * m,
                                kappa_w=ones, kappa_s=ones), dtype=torch.float32, device=dev)
    return [(tri.name, head, field), ("IRREGULAR_WITH_LAND", irr, field)]


def event_ms(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--chain", type=int, default=30)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_split: no CUDA device", file=sys.stderr)
        return 2
    from ..ops.cuda.dispatch import _fused_chain

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    own = build.load("cheb_pass")
    libs = build_variants()
    cases = []
    for label, filt, field in headlines(dev):
        fn = filt._scalar_fn()
        ops, p = fn.operands(torch.float32, dev)
        pl = fn.plan(*field.shape, torch.float32)
        cases.append((label, ops, p, pl, field.reshape(1, *field.shape)))
    # the "full" copy is the package's kernel: the same bits
    for label, ops, p, pl, x in cases:
        use(own)
        want = _fused_chain(cp.cheb_fused_pass, ops, p, pl, x)
        use(libs["full"])
        got = _fused_chain(cp.cheb_fused_pass, ops, p, pl, x)
        if not torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)):
            raise AssertionError(f"{label}: the full copy differs from the package's build")
    times = {label: {v: [] for v in VARIANTS} for label, *_ in cases}
    for _ in range(args.rounds):
        for label, ops, p, pl, x in cases:
            for v in VARIANTS:
                use(libs[v])
                run = lambda: _fused_chain(cp.cheb_fused_pass, ops, p, pl, x)  # noqa: E731
                for _ in range(3):
                    run()
                times[label][v].append(event_ms(run, args.chain))
    use(own)
    for label, ops, p, pl, x in cases:
        t = {v: min(ts) for v, ts in times[label].items()}
        load, steps = t["full"] - t["no load"], t["full"] - t["no steps"]
        print(f"{label}, plan {pl.tile} {pl.steps}: " + ", ".join(
            f"{v} {', '.join(f'{ms:.4f}' for ms in times[label][v])}" for v in VARIANTS)
            + f" ms/apply; load {load:.4f} ({load / t['full']:.0%}), steps {steps:.4f} "
            f"({steps / t['full']:.0%}), no load + no steps - store only "
            f"{t['no load'] + t['no steps'] - t['store only']:.4f}", flush=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ms_per_apply": times,
              "plans": {label: [list(pl.tile), list(pl.steps)] for label, _, _, pl, _ in cases}}
    print(smi)
    print(json.dumps(result))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
