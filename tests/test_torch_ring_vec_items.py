"""The blocks and the window loads of the fused vector ring kernel, on the CPU.

``vec_ring_fused_kernel`` (csrc/ring_pass.cu) gives its interior tiles their
items by block index and lets only the sends and the edge tiles draw
tickets; a tile copies the state of the shard's own rows by cp.async before
any flag wait and loads its halo rows through registers past L1 after it
(``vec_window_load`` and ``vec_halo_load`` of csrc/vec_tile.cuh). The kernel
runs only on the card (chip_smoke.py holds it to the fused K3 / K4 and to
the step ring bit for bit); here the header's formulas, read from its text,
are held to their Python mirror :class:`~.ring_pass.RingItems`, and the
mirror is held to what the protocol needs, for every plan that the ring
planner gives at the headline and at the tests' own shapes: no row outside
``[0, ly)`` in a cp.async copy, every such window row loaded after the flag
of its side, every item of a launch taken by exactly one block, every send
drawn before every edge tile, and the wrapper's count of tickets.
"""
import contextlib
import re
import types
from pathlib import Path

import pytest
import torch

from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.parallel import ring

CSRC = Path(rp.__file__).resolve().parents[2] / "csrc"
RING_CU = (CSRC / "ring_pass.cu").read_text()
VEC_TILE = (CSRC / "vec_tile.cuh").read_text()


def _c_expr(text: str) -> str:
    """A C++ integer expression of the headers as Python: integer division,
    no casts, ``std::min`` as ``min``, fields as plain names."""
    text = re.sub(r"\((?:long long|unsigned|int)\)", "", text)
    text = text.replace("std::", "").replace("q->", "").replace("q.", "").replace("a.", "")
    return text.replace("geo.rows()", "ly").replace("/", "//")


def _body(text: str, head: str) -> str:
    m = re.search(re.escape(head) + r".*?\n\}\n", text, re.S)
    assert m, f"{head} not found"
    return m.group(0)


def _cuh_items(p, ly, nx, tile, n_ops):
    """``fused_ring``'s tile counts and interior rows, ``fused_items``,
    ``ring_interior`` and ``ring_tickets`` as ring_pass.cu states
    them, evaluated."""
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


def _cuh_window(ly, tile, n_ops, ty):
    """The window rows of a tile in row ``ty`` that the headers copy by
    cp.async (``vec_window_load``'s own-row test), that ``vec_halo_load``
    loads (its ``lo`` and ``hi``), and the flags the kernel waits for (its
    two ``wait_flag`` conditions), evaluated."""
    by, bx = tile
    env = dict(ly=ly, by=by, H=n_ops, y0=ty * by, wy=by + 2 * n_ops)
    cond = re.search(r"\} else if \(\(unsigned\)\((.*?)\) < \(unsigned\)geo\.rows\(\)\) \{",
                     _body(VEC_TILE, "void vec_window_load(")).group(1)
    own = [env["y0"] - n_ops + r for r in range(env["wy"])
           if 0 <= eval(_c_expr(cond), {}, dict(env, r=r)) < ly]
    halo_fn = _body(VEC_TILE, "void vec_halo_load(")
    for name in ("lo", "hi"):
        expr = re.search(r"const int " + name + r" = (.*?);", halo_fn).group(1)
        env[name] = eval(_c_expr(expr), {}, env)
    halo = [env["y0"] - n_ops + r for r in (*range(env["lo"]), *range(env["hi"], env["wy"]))]
    kernel = _body(RING_CU, "vec_ring_fused_kernel(")
    waits = re.findall(r"if \((.*?)\) wait_flag\(q\.flags \+ 2 \* it\.shard( \+ 1)?,", kernel)
    assert [side for _, side in waits] == ["", " + 1"], "south, then north"
    env["by"] = by
    flags = tuple(bool(eval(_c_expr(c), {}, env)) for c, _ in waits)
    return own, halo, flags


def _plans():
    """(p, ly, nx, tile, n_ops) of every pass of the plans the ring planner
    gives at the 2400x3600 headline (float32, both grids, p_y 2, 4 and 8,
    and float64 at 4) and at the shapes of test_torch_ring_vec_fused.py
    (48x70 with 8x32 tiles, the planner's own plans, 6-row shards with a
    5-step pass, 4-row tiles under a 5-step pass, one-row shards with
    one-step passes)."""
    cases = {}
    for op in (vp.BGRID, vp.CTAP):
        for dtype, p_ys in ((torch.float32, (2, 4, 8)), (torch.float64, (4,))):
            for p_y in p_ys:
                for ny, nx, steps in ((2400, 3600, 11), (48, 70, 5), (48, 70, 37)):
                    ly = ny // p_y
                    pl = vp.plan_vec_fused_passes(steps, ly, nx, dtype, op,
                                                  max_fuse=min(ring._max_fuse(None), ly),
                                                  ring=True)
                    if pl.fused:
                        for n in set(pl.steps):
                            cases[f"{ny}x{nx} p{p_y} {pl.tile} H{n}"] = (p_y, ly, nx, pl.tile, n)
    for p_y in (2, 4, 8):
        for n in (1, 2, 3, 5):
            if n <= 48 // p_y:
                cases[f"48x70 p{p_y} (8, 32) H{n}"] = (p_y, 48 // p_y, 70, (8, 32), n)
        cases[f"48x70 p{p_y} (4, 16) H5"] = (p_y, 48 // p_y, 70, (4, 16), 5)
    cases["8x70 p8 (8, 32) H1"] = (8, 1, 70, (8, 32), 1)
    return cases


PLANS = _plans()


@pytest.mark.parametrize("case", list(PLANS))
def test_the_mirror_states_the_headers_counts(case):
    p, ly, nx, tile, n = PLANS[case]
    got = rp.RingItems(p, ly, nx, tile, n)
    want = _cuh_items(p, ly, nx, tile, n)
    assert (got.tiles_x, got.tiles_y, got.int_lo, got.n_int) == tuple(
        want[k] for k in ("tiles_x", "tiles_y", "int_lo", "n_int"))
    assert (got.total, got.interior, got.tickets) == tuple(
        want[k] for k in ("fused_items", "ring_interior", "ring_tickets"))


@pytest.mark.parametrize("case", list(PLANS))
def test_windows_copy_own_rows_only_and_load_halo_rows_after_their_flags(case):
    p, ly, nx, tile, n = PLANS[case]
    items = rp.RingItems(p, ly, nx, tile, n)
    interior = range(items.int_lo, items.int_lo + items.n_int)
    for ty in range(items.tiles_y):
        own, halo, (south, north) = items.window(ty)
        assert (own, halo, (south, north)) == _cuh_window(ly, tile, n, ty)
        window = list(range(ty * tile[0] - n, (ty + 1) * tile[0] + n))
        # no row outside [0, ly) in a cp.async copy; every other row after its flag
        assert all(0 <= g < ly for g in own)
        assert sorted(own + halo) == window and not set(own) & set(halo)
        assert all(south if g < 0 else north for g in halo)
        assert south == any(g < 0 for g in halo) and north == any(g >= ly for g in halo)
        # an interior tile waits for nothing and has no halo row; an edge tile has some
        assert (ty in interior) == (not halo)


@pytest.mark.parametrize("case", list(PLANS))
def test_every_item_is_taken_once_and_the_sends_come_first(case):
    p, ly, nx, tile, n = PLANS[case]
    items = rp.RingItems(p, ly, nx, tile, n)
    by_block = [items.block(b) for b in range(items.total)]
    ticketed = [b for b, it in enumerate(by_block) if it is None]
    # the ticketed blocks sit at both ends of blockIdx, the sends' first
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
    # by blockIdx only the tiles that wait for nothing; by ticket every edge tile
    assert all(not items.window(it[2])[1] for it in by_block if it)
    assert all(items.window(by_ticket[t][2])[1] for t in edges)


def test_the_headline_launch_draws_a_ticket_for_a_tenth_of_its_blocks():
    """At p_y 4 the B-grid's 32x64 tiles leave two edge rows of 19 a shard,
    the C-grid's 16x64 two of 38: the rest of the 4340 and 8672 blocks take
    their item from blockIdx."""
    b = rp.RingItems(4, 600, 3600, (32, 64), 6)
    c = rp.RingItems(4, 600, 3600, (16, 64), 6)
    assert (b.total, b.tiles_y, b.n_int, b.tickets) == (4340, 19, 17, 8 + 4 * 2 * 57)
    assert (c.total, c.tiles_y, c.n_int, c.tickets) == (8672, 38, 36, 8 + 4 * 2 * 57)


def test_the_wrapper_counts_the_tickets_each_launch_draws(monkeypatch):
    """Each launch gets the tickets drawn before it as ``base`` and adds only
    its sends' and edge tiles' (a launch on the card draws exactly those)."""
    seen = []

    def fake(*args):
        seen.append(args)
        return 0

    lib = types.SimpleNamespace(vec_ring_fused_pass_f32=fake, vec_ring_fused_pass_f64=fake,
                                ring_pass_error_string=lambda e: b"")
    monkeypatch.setattr(rp._VEC_FUSED_KERNEL, "fns", None)
    rp._VEC_FUSED_KERNEL.bind(lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device=None: contextlib.nullcontext())
    coef = torch.zeros((vp.N_COEF[vp.BGRID], 48, 70))
    ops = rp.VecRingFusedOperands.cut(vp.VecPassOperands(vp.BGRID, coef, True), 4, 3)
    state = rp.VecRingFusedState(ops, 12, 70, torch.float32, "cpu")
    p = [0.1] * 12
    start, drawn = 0, 0
    for m, (n, tile) in enumerate(((3, (8, 32)), (2, (8, 32)), (3, (4, 16)), (3, (16, 64)))):
        rp._vec_fused_launch(state, p, start, n, tile, out=m % 2)
        assert seen[-1][15:17] == (drawn, m + 1)  # base, epoch
        drawn += rp.RingItems(4, 12, 70, tile, n).tickets
        assert state.drawn == drawn
        start += n
    assert drawn < sum(rp.RingItems(4, 12, 70, t, n).total
                       for n, t in ((3, (8, 32)), (2, (8, 32)), (3, (4, 16)), (3, (16, 64))))
