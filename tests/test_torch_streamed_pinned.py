"""The streamed loop through page-locked memory (``Filter._streamed_pinned``).

On one CUDA device ``apply_streamed`` and ``apply_to_vector_streamed`` stage
each chunk in page-locked host memory, upload it without a wait, copy each
result by DMA into one page-locked result and wait for the card once, after
the last chunk. The ``card`` cases run that path on the card and hold it to
``apply`` of the resident stack bit for bit; they skip without a card (run
them there with ``python -m pytest --noconftest -m card
tests/test_torch_streamed_pinned.py``, which needs no JAX). The ``cpu``
cases rehearse the same loop on the CPU: ``_streamed`` is routed to it and
the page-locked allocator is a plain ``torch.empty``, so the loop's control
flow, spans, counts and fallback are checked here too. Nothing in this file
imports JAX.
"""
import warnings

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch import filter as filter_mod
from gcm_filters_tpu_torch.utils.telemetry import (
    PerformanceWarning,
    fallback_counts,
    recording,
    reset_fallback_counts,
    reset_spans,
    spans,
)

SHAPE = (48, 80)
WHERE = [pytest.param("card", marks=pytest.mark.card), "cpu"]


def _scalar_kw(shape):
    rng = np.random.default_rng(20)
    wet = np.ones(shape)
    wet[0] = 0
    wet[: shape[0] // 4, : shape[1] // 5] = 0
    return dict(filter_scale=4.0, dx_min=1.0,
                grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                grid_vars={"area": 0.9 + 0.2 * rng.random(shape), "wet_mask": wet})


def _bgrid_kw(shape):
    m = 0.9 + 0.2 * np.random.default_rng(21).random(shape)
    gv = dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_B_GRID, grid_vars=gv)


def _field(lead, shape=SHAPE, seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).random(lead + shape).astype(dtype)
    x[..., 0, :] = np.nan  # the land row
    return x


@pytest.fixture
def where(request, monkeypatch):
    """The device of the filters under test, with the page-locked loop in
    ``_streamed``'s place: the card as it is, or the CPU with plain memory."""
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the page-locked loop runs on one device's card")
        return "cuda"
    monkeypatch.setattr(gt.Filter, "_streamed", gt.Filter._streamed_pinned)
    monkeypatch.setattr(filter_mod, "_pinned",
                        lambda shape, dtype: torch.empty(shape, dtype=dtype))
    return "cpu"


def _resident(filt, *arrays):
    """``apply`` (or ``apply_to_vector``) of the whole stack at once, as
    numpy arrays: what each streamed component must equal bit for bit."""
    xs = [torch.as_tensor(a).to(filt.device) for a in arrays]
    if len(xs) == 1:
        return [filt.apply(xs[0]).cpu().numpy()]
    return [r.cpu().numpy() for r in filt.apply_to_vector(*xs)]


def _stage_spans():
    return [s for s in spans() if s.name.startswith("gft.stream.")]


def _check_pinned_spans(n_chunks):
    """Every chunk's upload and download moved all its bytes through
    page-locked memory, and the stages ran in order."""
    stages = _stage_spans()
    assert [s.name for s in stages] == n_chunks * [
        "gft.stream.read", "gft.stream.upload", "gft.stream.download", "gft.stream.assemble"]
    for s in stages:
        if s.name in ("gft.stream.upload", "gft.stream.download"):
            assert s.counts["bytes"] > 0 and s.counts["pinned"] == s.counts["bytes"], s


@pytest.mark.parametrize("where", WHERE, indirect=True)
@pytest.mark.parametrize("lead, chunk, shape", [
    ((5,), 2, SHAPE), ((6,), 3, SHAPE), ((5,), 16, SHAPE), ((2, 3), 4, SHAPE),
    ((7,), 3, (512, 768))], ids=["5by2", "6by3", "one_chunk", "lead_2x3", "7by3_512x768"])
def test_streamed_equals_apply_bitwise(where, lead, chunk, shape):
    filt = gt.Filter(device=where, **_scalar_kw(shape))
    data = _field(lead, shape)
    reset_fallback_counts()
    reset_spans()
    with warnings.catch_warnings():
        warnings.simplefilter("error", PerformanceWarning)
        with recording():
            got = filt.apply_streamed(data, chunk=chunk)
    assert isinstance(got, np.ndarray) and got.shape == data.shape and got.dtype == np.float32
    n = int(np.prod(lead))
    (want,) = _resident(filt, data.reshape((n,) + shape))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    _check_pinned_spans(-(-n // chunk))
    assert fallback_counts() == {}


@pytest.mark.parametrize("where", WHERE, indirect=True)
def test_float64_input_cast_to_float32_in_the_staging_copy(where):
    filt = gt.Filter(device=where, dtype=torch.float32, **_scalar_kw(SHAPE))
    data = _field((5,), dtype=np.float64)
    reset_spans()
    with recording():
        got = filt.apply_streamed(data, chunk=2)
    assert got.dtype == np.float32
    (want,) = _resident(filt, data.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    # the staging copy casts, so each copy moves float32 bytes
    uploads = [s.counts for s in _stage_spans() if s.name == "gft.stream.upload"]
    assert [c["bytes"] for c in uploads] == [4 * k * SHAPE[0] * SHAPE[1] for k in (2, 2, 1)]
    _check_pinned_spans(3)


@pytest.mark.parametrize("where", WHERE, indirect=True)
def test_memmap_input(where, tmp_path):
    filt = gt.Filter(device=where, **_scalar_kw(SHAPE))
    data = _field((5,))
    mm = np.memmap(tmp_path / "stack.f32", dtype=np.float32, mode="w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    got = filt.apply_streamed(mm, chunk=2)
    np.testing.assert_array_equal(got, _resident(filt, data)[0])


@pytest.mark.parametrize("where", WHERE, indirect=True)
def test_a_result_outlives_the_next_call(where):
    """The blocks of a result the caller holds are not handed to the next
    call: the first result reads the same after a second call."""
    filt = gt.Filter(device=where, **_scalar_kw(SHAPE))
    a, b = _field((5,), seed=1), _field((5,), seed=2)
    first = filt.apply_streamed(a, chunk=2)
    kept = first.copy()
    second = filt.apply_streamed(b, chunk=2)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(first, _resident(filt, a)[0])
    np.testing.assert_array_equal(second, _resident(filt, b)[0])


@pytest.mark.parametrize("where", WHERE, indirect=True)
def test_vector_twin(where):
    filt = gt.Filter(device=where, **_bgrid_kw(SHAPE))
    u, v = _field((5,), seed=3), _field((5,), seed=4)
    reset_fallback_counts()
    reset_spans()
    with recording():
        gu, gv = filt.apply_to_vector_streamed(u, v, chunk=2)
    wu, wv = _resident(filt, u, v)
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gv, wv)
    _check_pinned_spans(3)
    assert fallback_counts() == {}


@pytest.mark.parametrize("where", WHERE, indirect=True)
def test_pageable_result_where_the_result_cannot_be_page_locked(where, monkeypatch):
    """A result the host cannot page-lock comes down through pageable memory,
    counted as ``stream_pageable_result``; the staging stays page-locked."""
    filt = gt.Filter(device=where, **_scalar_kw(SHAPE))
    data = _field((5,))
    pin = filter_mod._pinned

    def no_result(shape, dtype):
        if tuple(shape) == data.shape:
            raise RuntimeError("page-locked allocation refused")
        return pin(shape, dtype)

    monkeypatch.setattr(filter_mod, "_pinned", no_result)
    reset_fallback_counts()
    reset_spans()
    with pytest.warns(PerformanceWarning, match="stream_pageable_result"):
        with recording():
            got = filt.apply_streamed(data, chunk=2)
    np.testing.assert_array_equal(got, _resident(filt, data)[0])
    assert fallback_counts() == {"stream_pageable_result": 1}
    stages = _stage_spans()
    assert [s.counts["pinned"] for s in stages if s.name == "gft.stream.download"] == [0, 0, 0]
    assert all(s.counts["pinned"] == s.counts["bytes"]
               for s in stages if s.name == "gft.stream.upload")

