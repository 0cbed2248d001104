"""The port's fallback telemetry (``utils/telemetry.py``).

The counterpart of tests/test_telemetry.py. The JAX package's dispatcher
falls back to its XLA engine after a kernel build fails and counts that; the
port has no fallback tier (a CUDA tensor launches a kernel or raises), so
here the counters must stay empty through every engine the port runs on the
CPU: the unsharded scalar and vector applies, their streamed twins, a
one-rank gloo ``DeviceMesh`` and a CPU ``ResidentMesh``. ``Filter`` with its
default device asks for the card: without one it raises and counts nothing.
"""
import warnings

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.utils.telemetry import (
    PerformanceWarning,
    fallback_counts,
    record_fallback,
    reset_fallback_counts,
)

SHAPE = (32, 48)


def _scalar_kw():
    rng = np.random.default_rng(2)
    wet = np.ones(SHAPE)
    wet[0] = 0
    return dict(filter_scale=4.0, dx_min=1.0,
                grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                grid_vars={"area": 0.9 + 0.2 * rng.random(SHAPE), "wet_mask": wet})


def _vector_kw(grid):
    rng = np.random.default_rng(3)
    m = 0.9 + 0.2 * rng.random(SHAPE)
    one = np.ones(SHAPE)
    if grid == "bgrid":
        gv = dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
        return dict(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_B_GRID,
                    grid_vars=gv)
    gv = dict(wet_mask_t=one, wet_mask_q=one, dxT=m, dyT=m, dxCu=m, dyCu=m, dxCv=m, dyCv=m,
              dxBu=m, dyBu=m, area_u=m * m, area_v=m * m, kappa_iso=one, kappa_aniso=0 * one)
    return dict(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_C_GRID, grid_vars=gv)


def _run(filt, vector, streamed, batch=()):
    rng = np.random.default_rng(4)
    x = rng.random(batch + SHAPE).astype(np.float32)
    if vector:
        y = rng.random(batch + SHAPE).astype(np.float32)
        if streamed:
            return filt.apply_to_vector_streamed(x, y, chunk=2)
        return filt.apply_to_vector(x, y)
    return filt.apply_streamed(x, chunk=2) if streamed else filt.apply(x)


@pytest.mark.parametrize("streamed", [False, True], ids=["apply", "streamed"])
@pytest.mark.parametrize("grid", ["scalar", "bgrid", "cgrid"])
def test_no_fallback_unsharded(grid, streamed):
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        _run(gt.Filter(device="cpu", **kw), grid != "scalar", streamed, batch=(3,))
    assert fallback_counts() == {}


def test_no_fallback_one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    reset_fallback_counts()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
        sharded = dict(device="cpu", mesh=mesh, spatial_axes=("y", "x"))
        with warnings.catch_warnings():
            warnings.simplefilter("error", PerformanceWarning)
            for grid in ("scalar", "bgrid", "cgrid"):
                kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
                for streamed in (False, True):
                    _run(gt.Filter(**sharded, **kw), grid != "scalar", streamed, batch=(2,))
    finally:
        dist.destroy_process_group()
    assert fallback_counts() == {}


@pytest.mark.parametrize("grid", ["scalar", "bgrid", "cgrid"])
def test_no_fallback_resident_mesh(grid):
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    filt = gt.Filter(device="cpu", mesh=gt.ResidentMesh(4, "cpu"), spatial_axes=("y", None),
                     **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        out = _run(filt, grid != "scalar", False)
    assert fallback_counts() == {}
    for o in out if grid != "scalar" else (out,):
        assert isinstance(o, torch.Tensor) and tuple(o.shape) == SHAPE


@pytest.mark.parametrize("grid", ["scalar", "cgrid"])
def test_default_device_raises_without_a_card(grid):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would run")
    reset_fallback_counts()
    kw = _scalar_kw() if grid == "scalar" else _vector_kw(grid)
    filt = gt.Filter(**kw)
    assert filt.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(filt, grid != "scalar", False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(filt, grid != "scalar", True, batch=(2,))
    assert fallback_counts() == {}


def test_record_fallback_warns_and_counts():
    reset_fallback_counts()
    with pytest.warns(PerformanceWarning, match="forced: a test"):
        record_fallback("forced", "a test")
    with pytest.warns(PerformanceWarning):
        record_fallback("forced", "again")
    assert fallback_counts() == {"forced": 2}
    snapshot = fallback_counts()
    snapshot["forced"] = 0  # a snapshot, not the counters
    assert fallback_counts() == {"forced": 2}
    reset_fallback_counts()
    assert fallback_counts() == {}
