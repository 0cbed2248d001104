"""The blocks and the window loads of the fused scalar ring kernel, on the CPU.

``ring_fused_kernel`` (csrc/ring_pass.cu) gives its interior tiles their
items by block index (``ring_item``, the vector ring's item map) and lets
only the sends and the edge tiles draw tickets; a tile copies the state of
the window rows that read the shard's own rows (``RingGeo::own`` of
csrc/cheb_tile.cuh: rows [0, ly) and, on the top shard of a fold grid, the
mirror rows above them) by cp.async before any flag wait, and loads its halo
rows through registers past L1 after it (``fused_halo_load``). The kernel
runs only on the card (chip_smoke.py holds it to the fused K1 and to the step
ring bit for bit); here the headers' formulas, read from their text, are held
to their Python mirror :class:`~.ring_pass.RingItems`, and the mirror to what
the protocol needs, for every pass the scalar ring planner gives at the
2400x3600 headline (p_y 2, 4 and 8; Gaussian, Taper, ``IRREGULAR_WITH_LAND``)
and at the ring tests' shapes, with and without the fold: no cp.async copy
outside the shard's own rows [0, ly), every halo row loaded after the flag of
its side, every item of a launch taken by exactly one block, every send drawn
before every edge tile, and the wrapper's count of tickets.
"""
import contextlib
import re
import types
from pathlib import Path

import pytest
import torch

from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.parallel import ring

CSRC = Path(rp.__file__).resolve().parents[2] / "csrc"
RING_CU = (CSRC / "ring_pass.cu").read_text()
CHEB_TILE = (CSRC / "cheb_tile.cuh").read_text()


def _c_expr(text: str) -> str:
    """A C++ expression of the headers as Python: integer division, no casts,
    unsigned compares as ranges, logic as words, ternaries as conditionals,
    fields as plain names."""
    text = re.sub(r"\(unsigned\)(\w+) < \(unsigned\)(\w+)", r"(0 <= \1 < \2)", text)
    text = re.sub(r"\((?:long long|unsigned|int)\)", "", text)
    for a, b in (("std::", ""), ("q->", ""), ("q.", ""), ("a.", ""), ("geo.", ""),
                 ("&&", " and "), ("||", " or "), ("!", " not "), ("/", "//")):
        text = text.replace(a, b)
    m = re.fullmatch(r"(.*?) \? (.*?) : (.*)", text)
    return f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))" if m else text


def _body(text: str, head: str) -> str:
    m = re.search(re.escape(head) + r".*?\n\}\n", text, re.S)
    assert m, f"{head} not found"
    return m.group(0)


def _cuh_items(p, ly, nx, tile, n_ops):
    """``fused_ring``'s tile counts and interior rows, ``fused_items``,
    ``ring_interior`` and ``ring_tickets`` as ring_pass.cu states them,
    evaluated."""
    by, bx = tile
    env = dict(p=p, ly=ly, nx=nx, by=by, bx=bx, n_ops=n_ops)
    body = _body(RING_CU, "bool fused_ring(")
    for name in ("tiles_x", "tiles_y", "int_lo", "n_int"):
        expr = re.search(r"q->" + name + r" = (.*?);\n", body).group(1)
        env[name] = eval(_c_expr(expr), {}, env)
    for fn in ("fused_items", "ring_interior", "ring_tickets"):
        expr = re.search(r"return (.*?);", _body(RING_CU, f"inline long long {fn}(")).group(1)
        expr = re.sub(r"(\w+)\(q\)", lambda m: str(env[m.group(1)]), expr)
        env[fn] = eval(_c_expr(expr), {}, env)
    return env


def _cuh_window(ly, tile, n_ops, ty, fold):
    """The window rows of a tile in row ``ty`` that fused_window_load copies
    by cp.async (``RingGeo::own``), that ``fused_halo_load`` loads (its
    ``lo`` and ``hi``), and the flags ``ring_fused_kernel`` hands the tile
    (its two conditions), evaluated."""
    by, bx = tile
    env = dict(ly=ly, by=by, H=n_ops, y0=ty * by, wy=by + 2 * n_ops, fold=fold)
    own_fn = re.search(r"bool own\(int gy\) const \{ return (.*?); \}", CHEB_TILE).group(1)
    assert "geo.own(gy)" in _body(CHEB_TILE, "void fused_window_load(")
    own = [env["y0"] - n_ops + r for r in range(env["wy"])
           if eval(_c_expr(own_fn), {}, dict(env, gy=env["y0"] - n_ops + r))]
    halo_fn = _body(CHEB_TILE, "void fused_halo_load(")
    for name in ("lo", "hi"):
        expr = re.search(r"const int " + name + r" = (.*?);", halo_fn).group(1)
        env[name] = eval(_c_expr(expr), {}, env)
    halo = [env["y0"] - n_ops + r for r in (*range(env["lo"]), *range(env["hi"], env["wy"]))]
    kernel = _body(RING_CU, "ring_fused_kernel(")
    assert "ring_item(q, tid)" in kernel
    conds = re.search(r"RingTile\{it\.ty, it\.tx, (.*?) \? flags : nullptr,\s*"
                      r"(.*?) \? flags \+ 1 : nullptr", kernel).groups()  # south, north
    env.update(folds=fold)
    flags = tuple(bool(eval(_c_expr(c), {}, env)) for c in conds)
    return own, halo, flags


def _plans():
    """(p, ly, nx, tile, n_ops) of every pass of the plans the scalar ring
    planner gives (as parallel/ring.py asks it) at the 2400x3600 headline
    (Gaussian and Taper of factor 10 with the headline's four planes,
    ``IRREGULAR_WITH_LAND``'s seven; p_y 2, 4, 8) and at the shapes of
    tests/test_torch_ring_fused.py (48x70 with its 8x32 tiles and the
    planner's own, 6-row shards under a 5-step pass, 4-row tiles under a
    5-step pass)."""
    cases = {}
    for planes in (4, 7):
        for p_y in (2, 4, 8):
            for ny, nx, steps in ((2400, 3600, 11), (2400, 3600, 39), (48, 70, 5),
                                  (48, 70, 37)):
                ly = ny // p_y
                pl = cp.plan_fused_passes(steps, ly, nx, torch.float32, planes,
                                          max_fuse=min(ring._max_fuse(None), ly), ring=True)
                if pl.fused:
                    for n in set(pl.steps):
                        cases[f"{ny}x{nx} p{p_y} planes{planes} {pl.tile} H{n}"] = (
                            p_y, ly, nx, pl.tile, n)
    for p_y in (2, 4, 8):
        for n in (2, 3, 5):
            if n <= 48 // p_y:
                cases[f"48x70 p{p_y} (8, 32) H{n}"] = (p_y, 48 // p_y, 70, (8, 32), n)
        cases[f"48x70 p{p_y} (4, 16) H5"] = (p_y, 48 // p_y, 70, (4, 16), 5)
    return cases


PLANS = _plans()


def test_the_plans_cover_the_headline():
    assert {k.split(" ")[1] for k in PLANS if k.startswith("2400")} == {"p2", "p4", "p8"}
    assert len(PLANS) > 20


@pytest.mark.parametrize("case", list(PLANS))
def test_the_mirror_states_the_headers_counts(case):
    p, ly, nx, tile, n = PLANS[case]
    got = rp.RingItems(p, ly, nx, tile, n)
    want = _cuh_items(p, ly, nx, tile, n)
    assert (got.tiles_x, got.tiles_y, got.int_lo, got.n_int) == tuple(
        want[k] for k in ("tiles_x", "tiles_y", "int_lo", "n_int"))
    assert (got.total, got.interior, got.tickets) == tuple(
        want[k] for k in ("fused_items", "ring_interior", "ring_tickets"))


@pytest.mark.parametrize("fold", [False, True], ids=["no fold", "top shard of a fold grid"])
@pytest.mark.parametrize("case", list(PLANS))
def test_windows_copy_own_rows_only_and_load_halo_rows_after_their_flags(case, fold):
    p, ly, nx, tile, n = PLANS[case]
    items = rp.RingItems(p, ly, nx, tile, n)
    interior = range(items.int_lo, items.int_lo + items.n_int)
    for ty in range(items.tiles_y):
        own, halo, (south, north) = items.window(ty, fold)
        assert (own, halo, (south, north)) == _cuh_window(ly, tile, n, ty, fold)
        window = list(range(ty * tile[0] - n, (ty + 1) * tile[0] + n))
        # a cp.async copy reads the shard's own rows [0, ly) only: a row
        # above them is a mirror cell of row 2*ly-1-g (RingGeo::row)
        assert all(0 <= (g if g < ly else max(2 * ly - 1 - g, 0)) < ly for g in own)
        assert all(0 <= g < ly for g in own) or fold
        assert sorted(own + halo) == window and not set(own) & set(halo)
        # every other row after the flag of its side; a fold grid's top
        # shard reads no north halo
        assert all(south if g < 0 else north for g in halo)
        assert south == any(g < 0 for g in halo) and north == any(g >= ly for g in halo)
        assert not (fold and north)
        # an interior tile waits for nothing and has no halo row
        if ty in interior:
            assert not halo and not south and not north


@pytest.mark.parametrize("case", list(PLANS))
def test_every_item_is_taken_once_and_the_sends_come_first(case):
    p, ly, nx, tile, n = PLANS[case]
    items = rp.RingItems(p, ly, nx, tile, n)
    by_block = [items.block(b) for b in range(items.total)]
    ticketed = [b for b, it in enumerate(by_block) if it is None]
    assert ticketed == [*range(2 * p), *range(2 * p + items.interior, items.total)]
    assert len(ticketed) == items.tickets
    by_ticket = [items.ticket(t) for t in range(items.tickets)]
    sends = [t for t, it in enumerate(by_ticket) if it[0] == "send"]
    edges = [t for t, it in enumerate(by_ticket) if it[0] == "tile"]
    assert sends == list(range(2 * p)) and (not edges or max(sends) < min(edges))
    assert sorted(it[1:] for it in by_ticket if it[0] == "send") == [
        (r, s) for r in range(p) for s in (0, 1)]
    tiles = [it[1:] for it in by_block if it] + [by_ticket[t][1:] for t in edges]
    assert sorted(tiles) == [(r, ty, tx) for r in range(p) for ty in range(items.tiles_y)
                             for tx in range(items.tiles_x)]
    # by blockIdx only tiles that wait for nothing, whatever the fold
    assert all(not items.window(it[2], f)[1] for it in by_block if it for f in (False, True))


def test_the_headline_launch_draws_a_ticket_for_a_sixth_of_its_blocks():
    """At p_y 4 the headline's pass (40x80 tiles, 11 steps) leaves one edge
    row at each end of a shard's 15: of the 2708 blocks, 8 sends and 360
    edge tiles draw tickets, the rest take their item from blockIdx."""
    ly = 600
    pl = cp.plan_fused_passes(11, ly, 3600, torch.float32, 4, max_fuse=16, ring=True)
    assert pl.tile == (40, 80) and pl.steps == (11,)
    items = rp.RingItems(4, ly, 3600, pl.tile, 11)
    assert (items.total, items.tiles_y, items.n_int, items.tickets) == (
        4 * (2 + 15 * 45), 15, 13, 8 + 4 * 2 * 45)


def test_the_wrapper_counts_the_tickets_each_launch_draws(monkeypatch):
    """Each launch gets the tickets drawn before it as ``base`` and adds only
    its sends' and edge tiles' (a launch on the card draws exactly those)."""
    import gcm_filters_tpu_torch as gt
    from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply

    seen = []

    def fake(*args):
        seen.append(args)
        return 0

    lib = types.SimpleNamespace(ring_fused_pass_f32=fake, ring_fused_pass_f64=fake,
                                ring_pass_error_string=lambda e: b"")
    monkeypatch.setattr(rp._FUSED_KERNEL, "fns", None)
    rp._FUSED_KERNEL.bind(lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: contextlib.nullcontext())
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", dtype=torch.float32)
    ops, _ = make_cuda_scalar_apply(filt.operator, filt.filter_spec).operands(
        torch.float32, torch.device("cpu"))
    state = rp.RingFusedState(rp.RingFusedOperands.cut(ops, 4, 5), 12, 70, torch.float32,
                              "cpu")
    p = [0.1] * 14
    start, drawn = 0, 0
    passes = ((3, (8, 32)), (2, (8, 32)), (3, (4, 16)), (5, (16, 64)))
    for m, (n, tile) in enumerate(passes):
        rp._fused_launch(state, p, start, n, tile, out=m % 2)
        assert seen[-1][14:16] == (drawn, m + 1)  # base, epoch
        drawn += rp.RingItems(4, 12, 70, tile, n).tickets
        assert state.drawn == drawn
        start += n
    assert drawn < sum(rp.RingItems(4, 12, 70, t, n).total for n, t in passes)
