"""Split a fused ring's time on one card: the whole apply, its fused passes
alone and the copies around them, beside the unsharded fused launches alone.

    python3 -m gcm_filters_tpu_torch.utils.ring_split [--rounds N] [--chain N] [--json PATH]

Run from the root of the repository on a machine with a CUDA card and nvcc.
The cases are the ring headlines of ``chip_smoke.py`` phase 16, 2400x3600
float32, Gaussian of factor 10 (11 steps): the scalar headline
(``TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED``, drawn as phase 4 draws it) at
``p_y`` 2, 4 and 8, the B-grid at ``p_y`` 4, 2 and 8 and the C-grid at 4, on
unit-scale metrics and fields drawn as phase 7 draws them. For each it
times, with CUDA events (3 warm-ups, then ``--chain`` calls), every case in
turn, ``--rounds`` times:

- ``apply``: one ``Filter.apply`` or ``apply_to_vector`` through
  ``ResidentMesh(p_y)``;
- ``passes``: the apply's fused launches alone (``parallel.ring._passes`` on
  the state whose input the apply set);
- ``copies``: what the apply does around them, the copies of the field (or
  of u and v) into the shards' input rows and the ``torch.cat`` of acc out;
- ``k_launches``: the unsharded fused K1 (or K3 / K4) launches of the same
  filter on the same field (``ops.cuda.dispatch._fused_chain`` on a state
  made once), without the apply around them.

``chip_smoke.py`` times the same parts through :func:`ring_parts` and
:func:`unsharded_launches`. It prints one line per case, then the card's
name and power limit and a JSON object of every time; ``--json`` writes that
object to a file. In a tree whose scalar ring predates these parts the
script runs as well (copy it into a ``git archive`` of that tree).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .tile_split import event_ms

SHAPE = (2400, 3600)
SCALAR = "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED"
# (grid, p_y) of the phase-16 ring headlines
CASES = ((SCALAR, 4), (SCALAR, 2), (SCALAR, 8), ("VECTOR_B_GRID", 4), ("VECTOR_B_GRID", 2),
         ("VECTOR_B_GRID", 8), ("VECTOR_C_GRID", 4))


def unit_vector_grid_vars(grid_name, shape, rng, kappa_aniso=0.0):
    """Unit-scale metrics, m = 0.9 + 0.2 * uniform, as
    benchmarks/bench_suite.py builds the vector grids."""
    m = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid_name == "VECTOR_B_GRID":
        return dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=m, dyT=m, dxCu=m, dyCu=m,
                dxCv=m, dyCv=m, dxBu=m, dyBu=m, area_u=m * m, area_v=m * m,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


def scalar_headline_data(shape, rng):
    """The phase-4 scalar headline's field, wet mask and area, drawn as
    ``chip_smoke.py`` draws them (an Antarctica row of land, an idealized
    continent, area in [0.9, 1.1))."""
    ny, nx = shape
    wet = np.ones(shape)
    wet[0, :] = 0
    wet[: ny // 6, : nx // 5] = 0
    area = 0.9 + 0.2 * rng.random(shape)
    return rng.random(shape).astype(np.float32), wet, area


def ring_parts(filt, *fields):
    """``({"apply", "passes", "copies"}, entry)``: functions that run a
    ring Filter's whole apply (of one scalar field, or of u and v), its fused
    launches alone on the state whose input the last apply set, and the
    copies around them alone; and the apply's ``RingEntry``."""
    from ..parallel import ring

    vector = len(fields) == 2
    apply = filt.apply_to_vector if vector else filt.apply
    apply(*fields)
    fn = filt._vector_fn() if vector else filt._scalar_fn()
    (entry,) = fn.shape_cache.values()
    if entry.chain is None:
        raise ValueError("the ring runs the step ring here, not fused passes")
    state, ly = entry.state, entry.state.ly

    def copies():
        for r, w in enumerate(state.input):
            if vector:
                for m, f in enumerate(fields):
                    w[m].copy_(f[r * ly:(r + 1) * ly])
            else:
                w.copy_(fields[0][r * ly:(r + 1) * ly])
        return torch.cat(state.acc, dim=-2)

    return {"apply": lambda: apply(*fields),
            "passes": lambda: ring._passes(entry.chain, state, entry.p),
            "copies": copies}, entry


def unsharded_launches(filt, *fields):
    """A function that runs the unsharded fused launches of ``filt`` (no
    mesh) on a state made once: K1 on one scalar field, K3 / K4 on u and v
    stacked."""
    from ..ops.cuda.cheb_pass import cheb_fused_pass
    from ..ops.cuda.dispatch import _fused_chain
    from ..ops.cuda.vec_pass import vec_fused_pass

    if len(fields) == 2:
        fn = filt._vector_fn()
        ops, p = fn.operands(torch.float32, fields[0].device)
        pl = fn.plan(*fields[0].shape, torch.float32)
        w = torch.stack(fields).unsqueeze(0)
        return lambda: _fused_chain(vec_fused_pass, ops, p, pl, w, name="w")
    fn = filt._scalar_fn()
    ops, p = fn.operands(torch.float32, fields[0].device)
    pl = fn.plan(*fields[0].shape, torch.float32)
    x = fields[0][None]
    return lambda: _fused_chain(cheb_fused_pass, ops, p, pl, x)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--chain", type=int, default=30)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_split: no CUDA device", file=sys.stderr)
        return 2
    from ..filter import Filter
    from ..models.grids import GridType
    from ..parallel.ring import ResidentMesh

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    # drawn as chip_smoke.py phases 4 and 7 draw them: the scalar field, its
    # mask and area; u, v, then each grid's metrics
    x, wet, area = scalar_headline_data(SHAPE, np.random.default_rng(42))
    x = torch.as_tensor(x, device=dev)
    rng = np.random.default_rng(42)
    u, v = (torch.as_tensor(rng.random(SHAPE).astype(np.float32), device=dev) for _ in "uv")
    gvs = {g: unit_vector_grid_vars(g, SHAPE, rng) for g in ("VECTOR_B_GRID", "VECTOR_C_GRID")}
    gvs[SCALAR] = {"area": area, "wet_mask": wet}
    kw = dict(filter_scale=10.0, dx_min=1.0, dtype=torch.float32, device=dev)
    unsharded, cases = {}, {}
    for grid, p_y in CASES:
        fields = (x,) if grid == SCALAR else (u, v)
        if grid not in unsharded:
            unsharded[grid] = unsharded_launches(
                Filter(grid_type=GridType[grid], grid_vars=gvs[grid], **kw), *fields)
        filt = Filter(grid_type=GridType[grid], grid_vars=gvs[grid], mesh=ResidentMesh(p_y, dev),
                      spatial_axes=("y", None), **kw)
        parts, entry = ring_parts(filt, *fields)
        cases[f"{grid} p_y={p_y}"] = (dict(parts, k_launches=unsharded[grid]), entry)
    times = {label: {} for label in cases}
    for _ in range(args.rounds):
        for label, (parts, _) in cases.items():
            for k, fn in parts.items():
                for _ in range(3):
                    fn()
                times[label].setdefault(k, []).append(event_ms(fn, args.chain))
    for label, (_, entry) in cases.items():
        t = {k: min(ts) for k, ts in times[label].items()}
        print(f"{label}, plan {entry.plan.tile} {entry.plan.steps}: " + ", ".join(
            f"{k} {', '.join(f'{ms:.4f}' for ms in ts)}" for k, ts in times[label].items())
            + f" ms; passes over the unsharded launches {t['passes'] / t['k_launches'] - 1:+.1%}, "
            f"apply over passes + copies {t['apply'] - t['passes'] - t['copies']:+.4f} ms",
            flush=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ms": times,
              "plans": {label: [list(e.plan.tile), list(e.plan.steps)]
                        for label, (_, e) in cases.items()}}
    print(smi)
    print(json.dumps(result))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
