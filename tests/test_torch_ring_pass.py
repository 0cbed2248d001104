"""The port's ring steps on the CPU: the plain versions of the kernels of
``csrc/ring_pass.cu`` against the unsharded plain steps.

``ring_pass_reference`` and ``vec_ring_pass_reference`` cut a field into
``p_y`` y-shards with buffers of their own, move each shard's gathered edge
rows into its neighbours' halo rows and run the unsharded plain step's
arithmetic on ``cat(halo_s, own, halo_n)``. Each step kind is held against
``cheb_pass_reference`` / ``vec_pass_reference`` on the whole field,
``assert_array_equal`` (the same torch ops on the same values, cell by cell).
After a step the halo rows must hold exactly the neighbours' gathered edge
rows, and the NaN that the halo rows start with must never reach a result
(it does as soon as the sends are dropped). The CUDA kernels themselves are
checked against the same plain versions on the card by chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import (
    FIRST, LAST, MIDDLE, cheb_pass_reference,
)
from gcm_filters_tpu_torch.ops.cuda.dispatch import (
    make_cuda_scalar_apply, make_cuda_vector_apply,
)
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.cuda.vec_pass import vec_pass_reference

KINDS = {"first": FIRST, "middle": MIDDLE, "last": LAST}
NY, NX = 48, 40
P_YS = [2, 4, 8]


def _scalar_grid_vars(name, rng):
    ones = np.ones((NY, NX))
    wet = ones.copy()
    wet[0] = 0                 # the Antarctica row of the tripolar grids
    wet[:9, :7] = 0            # land across the first shard edge at p_y = 8
    wet[20:27, 30:] = 0        # land across the x wrap and more shard edges
    irr = lambda: 0.9 + 0.2 * rng.random((NY, NX))  # noqa: E731
    if name == "REGULAR":
        return {}
    if name == "REGULAR_WITH_LAND":
        return {"wet_mask": wet}
    if name == "IRREGULAR_WITH_LAND":
        return dict(wet_mask=wet, dxw=irr(), dyw=irr(), dxs=irr(), dys=irr(), area=irr(),
                    kappa_w=ones, kappa_s=ones)
    if name == "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED":
        return {"area": irr(), "wet_mask": wet}
    if name == "TRIPOLAR_POP_WITH_LAND":
        gv = dict(wet_mask=wet, dxe=irr(), dye=irr(), dxn=irr(), dyn=irr(), tarea=irr())
        for k in ("dxn", "dyn"):  # the seam's two halves face each other
            gv[k][-1, NX // 2:] = gv[k][-1, : NX // 2][::-1]
        return gv
    raise KeyError(name)


SCALAR_CASES = {
    "regular": ("REGULAR", False),
    "irregular_land": ("IRREGULAR_WITH_LAND", False),
    "tripolar_area": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", False),
    "tripolar_pop": ("TRIPOLAR_POP_WITH_LAND", False),
    "land_exact_nan": ("REGULAR_WITH_LAND", True),
}


def _scalar_setup(case, dtype=torch.float32):
    """The unsharded operands, p, and a field with a land and a wet NaN."""
    grid, exact_nan = SCALAR_CASES[case]
    rng = np.random.default_rng(3)
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid],
                     grid_vars=_scalar_grid_vars(grid, rng), device="cpu", exact_nan=exact_nan)
    ops, p = make_cuda_scalar_apply(filt.operator, filt.filter_spec,
                                    exact_nan=exact_nan).operands(dtype, torch.device("cpu"))
    x = rng.random((NY, NX))
    if grid != "REGULAR":
        x[3, 2] = np.nan       # land
        x[30, 10] = np.nan     # wet
    return ops, p, torch.as_tensor(x, dtype=dtype)


def _cut(x, p_y, r):
    ly = x.shape[-2] // p_y
    return x[..., r * ly:(r + 1) * ly, :]


def _whole_chain(ops, p, x):
    """The unsharded plain steps FIRST, MIDDLE, MIDDLE, LAST on the whole
    field: the carries before and after each step, by kind."""
    x3 = x[None]
    h, t, acc = (torch.empty_like(x3) for _ in range(3))
    snap = lambda: dict(a=h[0].clone(), b=t[0].clone(), acc=acc[0].clone())  # noqa: E731
    out = {}
    cheb_pass_reference(ops, FIRST, p[0], p[1], field=x3, t_next=t, acc=acc, h=h)
    out["first"] = (None, snap())
    before = snap()
    cheb_pass_reference(ops, MIDDLE, p[2], t=t, t_prev=h, t_next=h, acc=acc)  # swap 0
    out["middle"] = (before, snap())
    before = snap()
    cheb_pass_reference(ops, LAST, p[3], field=x3, t=h, t_prev=t, acc=acc)    # swap 1
    out["last"] = (before, snap())
    return out


def _load(state, p_y, carries):
    for name, whole in carries.items():
        for r, buf in enumerate(getattr(state, name)):
            buf.copy_(_cut(whole, p_y, r))


def _gathered(state, name):
    return torch.cat(getattr(state, name), dim=-2)


def _assert_equal(got, want, msg):
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=msg)


@pytest.mark.parametrize("p_y", P_YS)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(SCALAR_CASES))
def test_scalar_ring_step_equals_the_unsharded_plain_step(case, kind, p_y):
    ops, p, x = _scalar_setup(case)
    before, after = _whole_chain(ops, p, x)[kind]
    rops = rp.RingOperands.cut(ops, p_y)
    state = rp.RingState(rops, NY // p_y, NX, torch.float32, "cpu")
    for r, f in enumerate(state.field):
        f.copy_(_cut(x, p_y, r))
    if before is not None:
        _load(state, p_y, before)
    counted = launch_counts()
    if kind == "first":
        rp.ring_pass(state, FIRST, p[0], p[1])
        names = ("a", "b", "acc")
    elif kind == "middle":
        rp.ring_pass(state, MIDDLE, p[2], swap=0)
        names = ("a", "b", "acc")
    else:
        rp.ring_pass(state, LAST, p[3], swap=1)
        names = ("acc",)
    for name in names:
        _assert_equal(_gathered(state, name), after[name], f"{case} {kind} p_y={p_y} {name}")
    assert launch_counts() == counted  # the plain version does not count


def test_scalar_ring_step_in_float64_too():
    ops, p, x = _scalar_setup("tripolar_area", torch.float64)
    _, after = _whole_chain(ops, p, x)["first"]
    state = rp.RingState(rp.RingOperands.cut(ops, 4), NY // 4, NX, torch.float64, "cpu")
    for r, f in enumerate(state.field):
        f.copy_(_cut(x, 4, r))
    rp.ring_pass(state, FIRST, p[0], p[1])
    for name in ("a", "b", "acc"):
        _assert_equal(_gathered(state, name), after[name], name)


def _vector_grid_vars(grid, rng, kappa_aniso):
    m = 0.9 + 0.2 * rng.random((NY, NX))
    ones = np.ones((NY, NX))
    if grid == "VECTOR_B_GRID":
        return dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=m, dyT=m, dxCu=m, dyCu=m, dxCv=m,
                dyCv=m, dxBu=m, dyBu=m, area_u=m * m, area_v=m * m, kappa_iso=ones,
                kappa_aniso=kappa_aniso * ones)


VECTOR_CASES = {"bgrid": ("VECTOR_B_GRID", 0.0), "cgrid_aniso0": ("VECTOR_C_GRID", 0.0),
                "cgrid_aniso1": ("VECTOR_C_GRID", 1.0)}


def _vector_setup(case, zap=True):
    grid, ka = VECTOR_CASES[case]
    rng = np.random.default_rng(4)
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid],
                     grid_vars=_vector_grid_vars(grid, rng, ka), device="cpu")
    operator = filt.operator if zap else dataclasses.replace(filt.operator, zap_nans=False)
    ops, p = make_cuda_vector_apply(operator, filt.filter_spec).operands(
        torch.float32, torch.device("cpu"))
    w = rng.random((2, NY, NX))
    w[0, 5, 5] = np.nan     # inside a shard
    w[1, 11, 39] = np.nan   # on a shard edge at p_y = 4 and 8, on the x wrap
    return ops, p, torch.as_tensor(w, dtype=torch.float32)


def _whole_vector_chain(ops, p, w):
    a, b, acc = w[None].clone(), torch.empty_like(w[None]), torch.empty_like(w[None])
    snap = lambda: dict(a=a[0].clone(), b=b[0].clone(), acc=acc[0].clone())  # noqa: E731
    out = {}
    before = snap()
    vec_pass_reference(ops, FIRST, p[0], p[1], w=a, t_next=b, acc=acc)
    out["first"] = (before, snap())
    before = snap()
    vec_pass_reference(ops, MIDDLE, p[2], t=b, t_prev=a, t_next=a, acc=acc)  # swap 0
    out["middle"] = (before, snap())
    before = snap()
    vec_pass_reference(ops, LAST, p[3], t=a, t_prev=b, acc=acc)              # swap 1
    out["last"] = (before, snap())
    return out


@pytest.mark.parametrize("p_y", P_YS)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", list(VECTOR_CASES))
def test_vector_ring_step_equals_the_unsharded_plain_step(case, kind, p_y):
    ops, p, w = _vector_setup(case)
    before, after = _whole_vector_chain(ops, p, w)[kind]
    state = rp.RingState(rp.VecRingOperands.cut(ops, p_y), NY // p_y, NX, torch.float32, "cpu")
    _load(state, p_y, {"a": before["a"]} if kind == "first" else before)
    counted = launch_counts()
    if kind == "first":
        rp.vec_ring_pass(state, FIRST, p[0], p[1])
        names = ("b", "acc")
    elif kind == "middle":
        rp.vec_ring_pass(state, MIDDLE, p[2], swap=0)
        names = ("a", "b", "acc")
    else:
        rp.vec_ring_pass(state, LAST, p[3], swap=1)
        names = ("acc",)
    for name in names:
        _assert_equal(_gathered(state, name), after[name], f"{case} {kind} p_y={p_y} {name}")
    assert launch_counts() == counted


def test_vector_ring_step_without_nan_scrub_spreads_a_nan_as_unsharded():
    ops, p, w = _vector_setup("cgrid_aniso0", zap=False)
    _, after = _whole_vector_chain(ops, p, w)["first"]
    state = rp.RingState(rp.VecRingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
    _load(state, 4, {"a": w})
    rp.vec_ring_pass(state, FIRST, p[0], p[1])
    got = _gathered(state, "b")
    _assert_equal(got, after["b"], "T_1")
    assert int(torch.isnan(got).sum()) > 2  # the NaN reached its neighbours


@pytest.mark.parametrize("p_y", P_YS)
def test_halo_rows_hold_the_neighbours_gathered_edge_rows(p_y):
    # MIDDLE on the regular grid: the gathered value is t itself
    ops, p, x = _scalar_setup("regular")
    before, _ = _whole_chain(ops, p, x)["middle"]
    state = rp.RingState(rp.RingOperands.cut(ops, p_y), NY // p_y, NX, torch.float32, "cpu")
    _load(state, p_y, before)
    t = [b.clone() for b in state.b]
    rp.ring_pass(state, MIDDLE, p[2], swap=0)
    for r in range(p_y):
        _assert_equal(state.halo_s[r], t[(r - 1) % p_y][-1], f"south halo of shard {r}")
        _assert_equal(state.halo_n[r], t[(r + 1) % p_y][0], f"north halo of shard {r}")

    # FIRST with area and the h-space mask: post * nan_to_num(field * area)
    ops, p, x = _scalar_setup("tripolar_area")
    st = ops.stencil
    assert ops.drop_pre and st.area is not None
    h0 = st.post * torch.nan_to_num(x * st.area)
    state = rp.RingState(rp.RingOperands.cut(ops, p_y), NY // p_y, NX, torch.float32, "cpu")
    for r, f in enumerate(state.field):
        f.copy_(_cut(x, p_y, r))
    rp.ring_pass(state, FIRST, p[0], p[1])
    for r in range(p_y):
        _assert_equal(state.halo_s[r], _cut(h0, p_y, (r - 1) % p_y)[-1], f"south {r}")
        _assert_equal(state.halo_n[r], _cut(h0, p_y, (r + 1) % p_y)[0], f"north {r}")

    # MIDDLE under exact_nan: pre * nan_to_num(t), with a NaN planted on an edge row
    ops, p, x = _scalar_setup("land_exact_nan")
    st = ops.stencil
    assert not ops.drop_pre and st.pre is not None and st.zap_nans
    before, _ = _whole_chain(ops, p, x)["middle"]
    before["b"][NY // p_y - 1, 17] = float("nan")
    g = st.pre * torch.nan_to_num(before["b"])
    state = rp.RingState(rp.RingOperands.cut(ops, p_y), NY // p_y, NX, torch.float32, "cpu")
    _load(state, p_y, before)
    rp.ring_pass(state, MIDDLE, p[2], swap=0)
    for r in range(p_y):
        _assert_equal(state.halo_s[r], _cut(g, p_y, (r - 1) % p_y)[-1], f"south {r}")
        _assert_equal(state.halo_n[r], _cut(g, p_y, (r + 1) % p_y)[0], f"north {r}")
    assert not torch.isnan(state.halo_s[1]).any()


def test_vector_halo_rows_carry_both_components():
    ops, p, w = _vector_setup("cgrid_aniso1")
    state = rp.RingState(rp.VecRingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
    _load(state, 4, {"a": w})
    rp.vec_ring_pass(state, FIRST, p[0], p[1])
    g = torch.nan_to_num(w)
    for r in range(4):
        assert state.halo_s[r].shape == (2, NX)
        _assert_equal(state.halo_s[r], _cut(g, 4, (r - 1) % 4)[:, -1], f"south {r}")
        _assert_equal(state.halo_n[r], _cut(g, 4, (r + 1) % 4)[:, 0], f"north {r}")


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_poisoned_halos_never_reach_a_result_unless_the_sends_are_dropped(monkeypatch, vector):
    if vector:
        ops, p, w = _vector_setup("bgrid")
        w = torch.nan_to_num(w)
        state = rp.RingState(rp.VecRingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
        step, load = rp.vec_ring_pass, lambda: _load(state, 4, {"a": w})
    else:
        ops, p, x = _scalar_setup("regular")
        state = rp.RingState(rp.RingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
        step, load = rp.ring_pass, lambda: [f.copy_(_cut(x, 4, r))
                                            for r, f in enumerate(state.field)]
    for halo in state.halo_s + state.halo_n:
        assert torch.isnan(halo).all()  # poisoned at build
    load()
    step(state, FIRST, p[0], p[1])
    assert not torch.isnan(_gathered(state, "b")).any()
    assert not torch.isnan(_gathered(state, "acc")).any()

    # without the sends, every shard's two edge rows read the poison
    fresh = rp.RingState(state.ops, NY // 4, NX, torch.float32, "cpu")
    monkeypatch.setattr(rp, "_exchange", lambda state, gathered: None)
    state = fresh
    load()
    step(state, FIRST, p[0], p[1])
    t1 = _gathered(state, "b")
    rows = torch.isnan(t1).reshape(-1, NY, NX).any(0).any(-1).nonzero().flatten().tolist()
    assert rows == sorted({r * (NY // 4) for r in range(4)} | {r * (NY // 4) - 1 for r in range(1, 5)})


def test_the_fold_keeps_the_top_shards_north_halo_out_of_the_result():
    ops, p, x = _scalar_setup("tripolar_area")
    assert ops.stencil.fold_north
    rops = rp.RingOperands.cut(ops, 4)
    assert [st.fold_north for st in rops.shards] == [False, False, False, True]
    state = rp.RingState(rops, NY // 4, NX, torch.float32, "cpu")
    before, after = _whole_chain(ops, p, x)["middle"]
    _load(state, 4, before)
    # the top shard's north halo is filled by the wrap, but the seam reads the
    # shard's own top row instead: the result equals the folded whole field's
    rp.ring_pass(state, MIDDLE, p[2], swap=0)
    _assert_equal(state.halo_n[3], before["b"][0], "the wrap's row")
    _assert_equal(_gathered(state, "a"), after["a"], "T_2")


def test_shards_are_allocations_of_their_own():
    ops, _, _ = _scalar_setup("tripolar_area")
    rops = rp.RingOperands.cut(ops, 4)
    state = rp.RingState(rops, NY // 4, NX, torch.float32, "cpu")
    vops, _, _ = _vector_setup("cgrid_aniso0")
    vstate = rp.RingState(rp.VecRingOperands.cut(vops, 4), NY // 4, NX, torch.float32, "cpu")
    tensors = [t for name in ("field", "a", "b", "acc", "halo_s", "halo_n")
               for t in getattr(state, name)]
    tensors += [t for name in ("a", "b", "acc", "halo_s", "halo_n") for t in getattr(vstate, name)]
    tensors += [getattr(st, k) for st in rops.shards for k in ("c", "post", "area")]
    tensors += list(vstate.ops.coefs)
    for t in tensors:
        assert t._base is None and t.is_contiguous()
    storages = [t.untyped_storage().data_ptr() for t in tensors]
    assert len(set(storages)) == len(storages)
    assert vstate.field is None and vstate.input is vstate.a and state.input is state.field
    # pre and post were one tensor before the cut and are one tensor per shard after
    xops, _, _ = _scalar_setup("land_exact_nan")
    assert xops.stencil.pre is xops.stencil.post
    assert all(st.pre is st.post for st in rp.RingOperands.cut(xops, 2).shards)


def test_state_and_wrappers_refuse_what_the_kernels_do_not_take():
    ops, p, _ = _scalar_setup("tripolar_area")
    vops, _, _ = _vector_setup("bgrid")
    rops = rp.RingOperands.cut(ops, 4)
    with pytest.raises(ValueError, match="at least 2 shards"):
        rp.RingState(rp.RingOperands.cut(ops, 1), NY, NX, torch.float32, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        rp.RingState(rops, NY // 4, NX, torch.float16, "cpu")
    with pytest.raises(ValueError, match="shape"):
        rp.RingState(rops, NY // 2, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="expected torch.float64"):
        rp.RingState(rops, NY // 4, NX, torch.float64, "cpu")
    with pytest.raises(ValueError, match="at least 1 row"):
        rp.RingState(rops, 0, NX, torch.float32, "cpu")
    with pytest.raises(TypeError, match="RingOperands or VecRingOperands"):
        rp.RingState(ops, NY // 4, NX, torch.float32, "cpu")
    bad = dataclasses.replace(rops, shards=(
        dataclasses.replace(rops.shards[0], fold_north=True),) + rops.shards[1:])
    with pytest.raises(ValueError, match="inconsistent"):
        rp.RingState(bad, NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown vector contraction"):
        rp.RingState(dataclasses.replace(rp.VecRingOperands.cut(vops, 2), op=7),
                     NY // 2, NX, torch.float32, "cpu")
    state = rp.RingState(rops, NY // 4, NX, torch.float32, "cpu")
    vstate = rp.RingState(rp.VecRingOperands.cut(vops, 4), NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(TypeError, match="use vec_ring_pass"):
        rp.ring_pass(vstate, FIRST, p[0], p[1])
    with pytest.raises(TypeError, match="use ring_pass"):
        rp.vec_ring_pass(state, FIRST, p[0], p[1])
    with pytest.raises(ValueError, match="unknown step kind"):
        rp.ring_pass(state, 9, p[0])


def test_one_row_shards_are_the_smallest_the_steps_take():
    assert rp.MIN_ROWS == 1
    ops, p, x = _scalar_setup("tripolar_area")
    _, after = _whole_chain(ops, p, x)["first"]
    state = rp.RingState(rp.RingOperands.cut(ops, NY), 1, NX, torch.float32, "cpu")
    for r, f in enumerate(state.field):
        f.copy_(_cut(x, NY, r))
    rp.ring_pass(state, FIRST, p[0], p[1])
    _assert_equal(_gathered(state, "b"), after["b"], "T_1 on one-row shards")
