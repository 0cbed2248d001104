"""The sharded scalar round on halo strips, on the CPU.

The sharded engine's fused round (``local_strip_pass``, entries
``local_strip_pass_f32/f64`` of csrc/local_pass.cu on ``BlockStripGeo`` of
csrc/cheb_tile.cuh) builds no extended block of the field or the carries: it
reads the core planes in place and the four halo strips of
``halo.exchange_strips``, and writes core-shaped carries. Its kernel runs
only on the card (chip_smoke.py and tests/test_torch_fused_pass_card.py
hold it bit for bit to the local step-kernel chain); here its plain versions
are held, bit for bit and with NaNs in the same cells, to the parent's
rounds on the extended block (:func:`extended_scalar_rounds` with
``local_fused_pass_tiled_reference``, ``BlockGeo``'s windows) and to the
local step chain: the tiled plain version
cuts every window cell from the core or a strip by ``strip_index``, the
kernel's index map. Fold grids (the north strip of the top mesh row, the
coefficients' swapped seam planes), ``IRREGULAR_WITH_LAND`` (FLUX), a batch,
NaN fields, a ragged shape and the multi-round Taper, in one process (a 1x1
mesh: both axes wrap locally) and on 4 gloo ranks (2x2 and 4x1; this file,
run as ``python tests/test_torch_local_strips.py <rank> 4 <workdir> <mesh>``,
is one rank and imports the port only, started by ``spawn_ranks`` of
tests/test_torch_sharded.py), where the strip rounds must also post the
parent's messages.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

from test_torch_sharded import MESHES, spawn_ranks

LOCAL = (None, 1)
TRI = "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED"
POP = "TRIPOLAR_POP_WITH_LAND"
TILE = (8, 16)  # several tiles a block at the tests' sizes
GLOBAL = (48, 64)  # the gloo meshes' global field: 24x32 or 12x64 blocks
# name -> (grid, dtype, halo_steps, batch, nan, taper), for the gloo ranks
RANK_CASES = {
    "tri f64": (TRI, "float64", None, 1, False, False),
    "tri f32 rounds nan": (TRI, "float32", 3, 2, True, False),
    "pop f64 rounds": (POP, "float64", 2, 1, False, False),
    "irregular f32": ("IRREGULAR_WITH_LAND", "float32", 4, 2, True, False),
    "tri f64 taper": (TRI, "float64", None, 1, False, True),
}


def _grid_vars(gt, grid_name, shape, seed=0):
    """Grid variables from a numpy seed: a land mask with an Antarctica row
    and an island, metrics in [0.9, 1.1), the POP seam rows folded onto
    themselves."""
    ny, nx = shape
    rng = np.random.default_rng(seed)
    wet = np.ones(shape)
    wet[0] = 0
    wet[: ny // 2, : nx // 3] = 0
    gv = {}
    for k in gt.required_grid_vars(gt.GridType[grid_name]):
        gv[k] = (wet if k == "wet_mask" else np.ones(shape) if "kappa" in k
                 else 0.9 + 0.2 * rng.random(shape))
    if grid_name == POP:
        for k in ("dxn", "dyn"):
            gv[k][-1, nx // 2:] = gv[k][-1, : nx // 2][::-1]
    return gv


def _field(shape, batch, nan, seed=1):
    ny, nx = shape
    x = np.random.default_rng(seed).random((batch,) + shape)
    x[0, -1, 3] = 40.0          # a spike on the fold row
    x[-1, -1, nx - 4] = -25.0   # and its mirror side
    if nan:
        x[0, ny // 2, nx // 2] = np.nan  # wet
        x[-1, 0, 5] = np.nan              # land
    return x


def _filter(gt, grid, shape, dtype, halo_steps, taper, **kw):
    """Gaussian of factor 4 (5 steps), or the Taper of factor 10 (39 steps:
    several rounds whatever ``halo_steps``)."""
    extra = dict(filter_shape=gt.FilterShape.TAPER, filter_scale=10.0) if taper else dict(
        filter_scale=4.0)
    return gt.Filter(grid_type=gt.GridType[grid], grid_vars=_grid_vars(gt, grid, shape),
                     dtype=getattr(torch, dtype), dx_min=1.0, halo_steps=halo_steps, **extra,
                     **kw)


def extended_scalar_rounds(fused_fn, ops, field, p, cells, rounds, y_axis, x_axis, fold, tile):
    """The scalar rounds as the engine ran them before its strip round:
    per round ``exchange_2d`` of the field, or of both carries' cores
    stacked, and ``fused_fn`` (``local_fused_pass_tiled_reference``) on the
    extended block, whose carries go into the core of fresh extended
    buffers."""
    from gcm_filters_tpu_torch.parallel import halo

    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    acc = torch.empty_like(field)
    t = t_prev = None
    start = 0
    for i, n_ops in enumerate(rounds):
        last = i == len(rounds) - 1
        ext_raw = None
        if i == 0:
            ext_raw = halo.exchange_2d(field, cells, y_axis, x_axis, fold)
        else:
            ext = halo.exchange_2d(torch.stack([core(t), core(t_prev)]), cells, y_axis, x_axis,
                                   fold)
            t, t_prev = ext[0], ext[1]
        shape = (ext_raw if ext_raw is not None else t).shape
        t_out = t_prev_out = None
        if not last:
            t_out, t_prev_out = field.new_empty(shape), field.new_empty(shape)
        fused_fn(ops, p, start, n_ops, cells=cells, tile=tile, field=ext_raw,
                 field_own=field if last else None, t=t, t_prev=t_prev, t_out=t_out,
                 t_prev_out=t_prev_out, acc=acc)
        t, t_prev = t_out, t_prev_out
        start += n_ops
    return acc


def _routes(ops, x, p, cells, rounds, y_axis, x_axis, fold, tile=TILE):
    """``{route: result}`` of one rank's block: the local step chain, the
    strip rounds (plain and tiled plain) and the parent's extended-block
    rounds (tiled plain)."""
    from gcm_filters_tpu_torch.ops.cuda import local_pass as lp
    from gcm_filters_tpu_torch.parallel import sharded

    def tiled(fn):
        return lambda o, pp, s, n, *, tile, **kw: fn(o, pp, s, n, tile=tile, **kw)

    args = (ops, x, p, cells, rounds, y_axis, x_axis, fold)
    return {
        "steps": sharded.local_rounds_scalar(*args, fused_fn=None),
        "strips": sharded._fused_rounds(lp.local_strip_pass, *args, tile),
        "strips tiled": sharded._fused_rounds(tiled(lp.local_strip_pass_tiled_reference),
                                              *args, tile),
        "extended tiled": extended_scalar_rounds(tiled(lp.local_fused_pass_tiled_reference),
                                                 *args, tile),
    }


def _same(a, b):
    """Equal bit for bit, NaNs in the same cells."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.5), b.nan_to_num(7.5)))


# --------------------------------------------------------------------------
# the rank process: imports the port only
# --------------------------------------------------------------------------

def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import gcm_filters_tpu_torch as gt
    from gcm_filters_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    shape, names = MESHES[mesh_key]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    y_axis, x_axis = sharded._mesh_axis(mesh, "y"), sharded._mesh_axis(mesh, "x")
    sent = []
    batch_isend_irecv = dist.batch_isend_irecv

    def recording(ops):
        sent.append(sorted((o.op is dist.isend, o.peer, o.tag, o.tensor.numel()
                            * o.tensor.element_size()) for o in ops))
        return batch_isend_irecv(ops)

    dist.batch_isend_irecv = recording
    report = {}
    for name, (grid, dtype, hs, batch, nan, taper) in RANK_CASES.items():
        filt = _filter(gt, grid, GLOBAL, dtype, hs, taper, mesh=mesh, spatial_axes=("y", "x"),
                       device="cpu")
        fn = filt._scalar_fn()
        x = sharded._Layout(mesh, ("y", "x"), None).block(
            torch.as_tensor(_field(GLOBAL, batch, nan), dtype=getattr(torch, dtype)))
        x = x.contiguous()
        ops, cells, rounds, p = fn.operands(*x.shape[-2:], x.dtype)
        fold = filt.operator.fold_north
        res = _routes(ops, x, p, cells, rounds, y_axis, x_axis, fold)
        msgs = {}
        for route, rounds_fn in (("strips", sharded._fused_rounds),
                                 ("extended", extended_scalar_rounds)):
            del sent[:]
            rounds_fn(lambda *a, **k: None, ops, x, p, cells, rounds, y_axis, x_axis, fold, TILE)
            msgs[route] = list(sent)
        for route in ("strips", "strips tiled", "extended tiled"):
            report[f"{name}/{route} == steps"] = _same(res[route], res["steps"])
        report[f"{name}/rounds"] = len(rounds)
        report[f"{name}/same messages"] = msgs["strips"] == msgs["extended"]
        report[f"{name}/messages"] = sum(len(b) for b in msgs["strips"])
    np.savez(os.path.join(workdir, f"report{rank}.npz"), **report)
    if rank == 0:
        np.savez(os.path.join(workdir, "outputs.npz"), done=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# the parent: pytest
# --------------------------------------------------------------------------

import pytest  # noqa: E402

import gcm_filters_tpu_torch as gt  # noqa: E402
from gcm_filters_tpu_torch.ops.cuda import local_pass as lp  # noqa: E402
from gcm_filters_tpu_torch.parallel import halo, sharded  # noqa: E402

F32, F64 = "float32", "float64"
_SPAWNED = {}


def _one_process(grid, shape, dtype, hs, batch, nan, taper=False):
    filt = _filter(gt, grid, shape, dtype, hs, taper, device="cpu")
    op, spec = filt.operator, filt.filter_spec
    drop_pre = sharded.hspace_drop_pre(op) and not filt.exact_nan
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if drop_pre else op
    cells, rounds = sharded.plan_rounds(spec.n_steps, *shape, hs)
    p_host = np.asarray(spec.p, dtype=np.float64)
    dt = getattr(torch, dtype)
    ops = sharded.local_scalar_operands(
        hot.to(dt, "cpu"), cells, LOCAL, LOCAL, dt,
        -2.0 * sharded._laplacian_scale(spec, op.is_dimensional), drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, p_host)))
    p = [float(v) for v in p_host.astype(np.float32 if dtype == F32 else np.float64)]
    x = torch.as_tensor(_field(shape, batch, nan), dtype=dt)
    return ops, x, p, cells, rounds, op.fold_north


CASES = {
    f"{grid} {dtype} {label}": (grid, shape, dtype, hs, batch, nan, taper)
    for grid in (TRI, POP, "IRREGULAR_WITH_LAND", "REGULAR_WITH_LAND")
    for dtype in (F32, F64)
    for label, shape, hs, batch, nan, taper in (
        ("one round", (40, 72), None, 1, False, False),
        ("rounds 3 batch NaN", (40, 72), 3, 2, True, False),
        ("ragged 37x70", (37, 70), 4, 1, True, False),
    )
}
CASES.update({
    f"{grid} Taper {dtype}": (grid, (40, 72), dtype, None, 2, True, True)
    for grid in (TRI, "IRREGULAR_WITH_LAND") for dtype in (F32, F64)
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_strip_rounds_equal_the_extended_block_and_the_step_chain(case):
    """One process, both axes wrapping locally: the strip rounds' plain and
    tiled plain versions equal the parent's extended-block rounds and the
    local step chain bit for bit, NaNs in the same cells."""
    grid, shape, dtype, hs, batch, nan, taper = CASES[case]
    ops, x, p, cells, rounds, fold = _one_process(grid, shape, dtype, hs, batch, nan, taper)
    if taper:
        assert len(rounds) > 1
    got = _routes(ops, x, p, cells, rounds, LOCAL, LOCAL, fold)
    for route in ("strips", "strips tiled", "extended tiled"):
        assert _same(got[route], got["steps"]), route
    if nan:
        assert bool(got["steps"].isnan().any())


@pytest.mark.parametrize("tile", [(16, 32), (8, 24), (40, 72)])
def test_strip_tiled_reference_at_other_tiles(tile):
    """Tiles larger than the block and ragged against it: the same bits."""
    ops, x, p, cells, rounds, fold = _one_process(TRI, (37, 70), F64, 3, 2, True)
    got = _routes(ops, x, p, cells, rounds, LOCAL, LOCAL, fold, tile)
    assert _same(got["strips tiled"], got["steps"])
    assert _same(got["extended tiled"], got["steps"])


def _rank_reports(mesh_key, tmp_path_factory):
    if mesh_key not in _SPAWNED:
        workdir = str(tmp_path_factory.mktemp(f"local_strips_{mesh_key}"))
        _SPAWNED[mesh_key] = spawn_ranks(os.path.abspath(__file__), workdir, mesh_key)[1]
    return _SPAWNED[mesh_key]


@pytest.mark.parametrize("route", ["strips", "strips tiled", "extended tiled"])
@pytest.mark.parametrize("case", sorted(RANK_CASES))
@pytest.mark.parametrize("mesh_key", ["2x2", "4x1"])
def test_strip_rounds_on_gloo_ranks(tmp_path_factory, mesh_key, case, route):
    """Every rank's block: each route equals the local step chain bit for
    bit (the fold's north strip on the top mesh row, the messages between
    ranks)."""
    reports = _rank_reports(mesh_key, tmp_path_factory)
    bad = [r for r, rep in enumerate(reports) if not bool(rep[f"{case}/{route} == steps"])]
    assert not bad, f"ranks {bad}: {route} differs from the local step chain"


@pytest.mark.parametrize("case", sorted(RANK_CASES))
@pytest.mark.parametrize("mesh_key", ["2x2", "4x1"])
def test_strip_rounds_post_the_parents_messages(tmp_path_factory, mesh_key, case):
    """The strip rounds post, rank by rank, the messages of the parent's
    rounds (batches, peers, tags, bytes): one exchange a round."""
    reports = _rank_reports(mesh_key, tmp_path_factory)
    assert all(bool(rep[f"{case}/same messages"]) for rep in reports)
    assert sum(int(rep[f"{case}/messages"]) for rep in reports) > 0
    if "rounds" in case or "taper" in case:
        assert all(int(rep[f"{case}/rounds"]) > 1 for rep in reports)


@pytest.mark.parametrize("batch", [1, 3])
def test_strip_index_assembles_the_extended_block(batch):
    """Every cell of the extended block taken through ``strip_index`` from
    the core and the strips equals ``exchange_2d``'s block, for a field and
    for the two carries' strips stacked along dim 0."""
    cells, shape = 3, (9, 11)
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.random((batch,) + shape))
    g = torch.as_tensor(rng.random((batch,) + shape))
    ly, lx = shape
    r = torch.arange(ly + 2 * cells)[:, None]
    c = torch.arange(lx + 2 * cells)[None, :]
    src, row, col = lp.strip_index(r, c, cells, ly, lx)
    for own, s in lp.strip_planes(False, cells, None, f, g,
                                  halo.exchange_strips((f, g), cells, LOCAL, LOCAL)).values():
        parts = {lp.OWN: own, lp.SOUTH: s.south, lp.NORTH: s.north, lp.WEST: s.west,
                 lp.EAST: s.east}
        got = torch.zeros((batch,) + tuple(src.shape), dtype=own.dtype)
        rows, cols = row.expand_as(src), col.expand_as(src)
        for k, x in parts.items():
            m = src == k
            got[:, m] = x[:, rows[m], cols[m]]
        assert torch.equal(got, halo.exchange_2d(own, cells, LOCAL, LOCAL))
        assert torch.equal(lp.around(own, s), got)


def test_the_engine_reads_cores_and_strips_once_a_round():
    """The fused path builds no extended block: ``fused_fn`` gets the
    core-shaped field or carries and their strips, once a round, and
    ``exchange_2d`` is never called (a block the fused plan takes)."""
    ops, x, p, cells, rounds, fold = _one_process(TRI, (128, 256), F64, 3, 2, True)
    assert len(rounds) > 1
    seen = []

    def spy(o, pp, start, n, **kw):
        state = {k: tuple(kw[k].shape) for k in ("field", "t", "t_prev") if kw.get(k) is not None}
        seen.append((start, n, state, tuple(kw["strips"].west.shape)))
        lp.local_strip_pass(o, pp, start, n, **kw)

    real = halo.exchange_2d
    halo.exchange_2d = None  # a call would raise
    try:
        got = sharded.local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold,
                                          fused_fn=spy)
    finally:
        halo.exchange_2d = real
    want = sharded.local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold,
                                       fused_fn=None)
    assert _same(got, want)
    assert [n for _, n, _, _ in seen] == list(rounds)
    core = tuple(x.shape)
    assert seen[0][2] == {"field": core} and seen[0][3] == (2, 128, cells)
    assert all(s == {"t": core, "t_prev": core} and w == (2, 2, 128, cells)
               for _, _, s, w in seen[1:])


def test_strip_wrappers_refuse_what_they_cannot_take():
    ops, x, p, cells, rounds, fold = _one_process(TRI, (40, 72), F64, 3, 1, False)
    s = halo.exchange_strips(x, cells, LOCAL, LOCAL, fold)
    acc = torch.empty_like(x)
    with pytest.raises(TypeError, match="halo.Strips"):
        lp.local_strip_pass(ops, p, 0, 2, cells=cells, field=x, acc=acc, tile=TILE,
                            t_out=acc.clone(), t_prev_out=acc.clone(), strips=tuple(s))
    with pytest.raises(ValueError, match="first round on strips takes the field only"):
        lp.local_strip_pass(ops, p, 0, 2, cells=cells, field=x, t=x, acc=acc, tile=TILE,
                            t_out=acc.clone(), t_prev_out=acc.clone(), strips=s)
    with pytest.raises(ValueError, match="do not fit"):
        lp.local_strip_pass(ops, p, 0, 2, cells=cells + 1, field=x, acc=acc, tile=TILE,
                            t_out=acc.clone(), t_prev_out=acc.clone(), strips=s)
    with pytest.raises(ValueError, match="later round on strips takes t and t_prev"):
        lp.local_strip_pass(ops, p, 2, 2, cells=cells, field=x, acc=acc, tile=TILE,
                            t_out=acc.clone(), t_prev_out=acc.clone(), strips=s)


def test_strip_launch_checks_before_it_calls_the_library(monkeypatch):
    """The launch refuses outputs that alias what it reads and carries'
    strips that do not follow each other, and passes the kernel the core's
    pitch and batch stride and T_{k-1}'s planes (a fake library)."""
    import contextlib
    import types

    ops, x, p, cells, rounds, fold = _one_process(TRI, (40, 72), F64, 3, 2, False, taper=True)
    seen = []
    lib = types.SimpleNamespace(local_strip_pass_f64=lambda *a: seen.append(a) or 0,
                                local_strip_pass_f32=lambda *a: 0,
                                local_pass_error_string=lambda err: b"")
    monkeypatch.setattr(lp._STRIP_KERNEL, "fns", None)
    lp._STRIP_KERNEL.bind(lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: contextlib.nullcontext())
    acc = torch.empty_like(x)
    t, tp = torch.rand_like(x), torch.rand_like(x)
    s = halo.exchange_strips((t, tp), cells, LOCAL, LOCAL, fold)
    bufs = dict(field=None, field_own=None, t=t, t_prev=tp, acc=acc,
                t_out=torch.empty_like(x), t_prev_out=torch.empty_like(x))
    lp._strip_launch(ops, p, 3, 3, cells, TILE, bufs, s)
    args = seen[-1]
    assert args[11:15] == (t.data_ptr(), tp.data_ptr(), 40 * 72, 72)
    assert args[15:19] == tuple(a[0].data_ptr() for a in s)
    with pytest.raises(ValueError, match="must not alias"):
        lp._strip_launch(ops, p, 3, 3, cells, TILE, dict(bufs, t_out=t), s)
    # T_{k-1}'s strips must follow T_k's in one tensor: the kernel finds them there
    gapped = []
    for a in s:
        buf = a.new_empty((3,) + tuple(a.shape[1:]))
        buf[0], buf[2] = a[0], a[1]
        gapped.append(buf[::2])
    with pytest.raises(ValueError, match="follow each other"):
        lp._strip_launch(ops, p, 3, 3, cells, TILE, bufs, lp.Strips(*gapped))
    column_major = t.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="unit column stride"):
        lp._strip_launch(ops, p, 3, 3, cells, TILE, dict(bufs, t=column_major), s)
    assert len(seen) == 1


@pytest.mark.parametrize("taper", [False, True], ids=["one round", "Taper, three rounds"])
def test_the_rounds_enqueue_fewer_tensor_ops_than_the_parents(taper):
    """Around its launches (stubbed here), a strip round enqueues at most the
    parent's tensor ops less ``exchange_2d``'s two ``torch.cat``s: the later
    rounds exchange the strips of the carry pair as one tensor, with no
    stack of the carries' cores. Counted as ATen ops on the CPU; run with
    ``-s`` to see the counts."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    ops, x, p, cells, rounds, fold = _one_process(TRI, (128, 256), F32, None, 1, False, taper)
    counts = {}
    for name, rounds_fn in (("strips", sharded._fused_rounds), ("parent", extended_scalar_rounds)):
        with Count() as c:
            rounds_fn(lambda *a, **k: None, ops, x, p, cells, rounds, LOCAL, LOCAL, fold, TILE)
        counts[name] = c.ops
    print({k: (sum(v.values()), dict(v)) for k, v in counts.items()})
    assert sum(counts["strips"].values()) <= sum(counts["parent"].values()) - 2 * len(rounds)
    assert counts["strips"]["cat"] == counts["parent"]["cat"] - 2 * len(rounds)
    assert counts["strips"]["stack"] == 0
