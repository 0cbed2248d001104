"""The port's halo primitives in one process, with no process group.

Size-1 axes wrap locally: ``exchange_2d``, ``extend_x``, ``fold_row``,
``shifted`` and ``north_neighbor_sharded`` of the port are held against the
JAX functions of ``gcm_filters_tpu.parallel.halo`` on an unsharded axis and
against ``jnp.roll``, bit for bit (they only move data).

Sharded axes: a 2x4 (and odd-sized) decomposition of one global array runs in
one process, one thread per rank, with queues standing in for
``torch.distributed`` (the two functions of halo.py that touch it are
replaced). Every rank's extended block must equal the matching slice of a
numpy model of the global extension, fold and ``fold_src`` included. The real
gloo transport is driven by tests/test_torch_sharded.py.
"""
import collections
import queue
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcm_filters_tpu.parallel import halo as jhalo
from gcm_filters_tpu_torch.parallel import halo

LOCAL = (None, 1)


def _model(g, s, k, fold):
    """The global (..., ny+2k, nx+2k) extension in numpy: periodic in x and to
    the south; to the north periodic, or with ``fold`` the top k rows of ``s``
    flipped in y and x."""
    gx = np.concatenate([g[..., -k:], g, g[..., :k]], axis=-1)
    sx = np.concatenate([s[..., -k:], s, s[..., :k]], axis=-1)
    north = sx[..., -k:, :][..., ::-1, ::-1] if fold else gx[..., :k, :]
    return np.concatenate([gx[..., -k:, :], gx, north], axis=-2)


@pytest.mark.parametrize("fold,with_src", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("k", [1, 3])
def test_exchange_2d_unsharded_matches_jax(fold, with_src, k):
    rng = np.random.default_rng(0)
    g, s = rng.random((2, 12, 16)), rng.random((2, 12, 16))
    src = s if with_src else None
    want = np.asarray(jhalo.exchange_2d(jnp.asarray(g), k, LOCAL, LOCAL, fold,
                                        None if src is None else jnp.asarray(src)))
    got = halo.exchange_2d(torch.as_tensor(g), k, LOCAL, LOCAL, fold,
                           None if src is None else torch.as_tensor(src)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _model(g, g if src is None else s, k, fold))


def test_one_row_primitives_unsharded_match_jax():
    g = np.random.default_rng(1).random((3, 10, 14))
    t, j = torch.as_tensor(g), jnp.asarray(g)
    assert np.array_equal(halo.extend_x(t, 2, LOCAL).numpy(),
                          np.asarray(jhalo.extend_x(j, 2, LOCAL)))
    assert np.array_equal(halo.fold_row(t, LOCAL).numpy(),
                          np.asarray(jhalo.fold_row(j, None, 1)))
    for shift, dim in ((+1, -2), (-1, -2), (+1, -1), (-1, -1)):
        got = halo.shifted(t, shift, dim, LOCAL).numpy()
        assert np.array_equal(got, np.asarray(jhalo.shifted(j, shift, dim, None, 1)))
        assert np.array_equal(got, np.asarray(jnp.roll(j, shift, dim)))
    for fold in (False, True):
        assert np.array_equal(
            halo.north_neighbor_sharded(t, fold, LOCAL, LOCAL).numpy(),
            np.asarray(jhalo.north_neighbor_sharded(j, fold, LOCAL, LOCAL)))
    with pytest.raises(ValueError, match=r"\+1 or -1"):
        halo.shifted(t, 2, -1, LOCAL)


class _Group:
    """One rank's handle on one mesh dimension of the in-process mesh."""

    def __init__(self, wire, gid, index):
        self.wire, self.gid, self.index = wire, gid, index


def _run_decomposed(monkeypatch, Y, X, fn):
    """Run ``fn(iy, ix, y_axis, x_axis)`` on every rank of a Y x X mesh, one
    thread each; messages travel through queues. Returns {(iy, ix): result}."""
    wire = collections.defaultdict(queue.Queue)

    def exchange(group, sends, tag0=0):
        for tag, (x, dst, _) in enumerate(sends, tag0):
            wire[group.gid, group.index, dst, tag].put(x.contiguous().clone())
        return [wire[group.gid, src, group.index, tag].get(timeout=60)
                for tag, (_, _, src) in enumerate(sends, tag0)]

    monkeypatch.setattr(halo, "_exchange", exchange)
    monkeypatch.setattr(halo, "_group_index", lambda group: group.index)
    results, errors = {}, []

    def rank(iy, ix):
        try:
            results[iy, ix] = fn(iy, ix, (_Group(wire, ("y", ix), iy), Y),
                                 (_Group(wire, ("x", iy), ix), X))
        except Exception as e:  # surfaced below, in the test's own thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(iy, ix)) for iy in range(Y) for ix in range(X)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == Y * X, "a rank did not finish: the exchange deadlocked"
    return results


@pytest.mark.parametrize("fold,with_src", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("Y,X", [(2, 4), (1, 3), (3, 1), (2, 2)])
def test_exchange_2d_decomposed_matches_model(monkeypatch, Y, X, fold, with_src):
    k, ly, lx = 3, 4, 5
    rng = np.random.default_rng(2)
    g, s = rng.random((2, Y * ly, X * lx)), rng.random((2, Y * ly, X * lx))
    blk = lambda a, iy, ix: torch.as_tensor(  # noqa: E731
        a[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx].copy())

    def fn(iy, ix, y_axis, x_axis):
        return halo.exchange_2d(blk(g, iy, ix), k, y_axis, x_axis, fold,
                                blk(s, iy, ix) if with_src else None).numpy()

    model = _model(g, s if with_src else g, k, fold)
    for (iy, ix), got in _run_decomposed(monkeypatch, Y, X, fn).items():
        want = model[..., iy * ly:iy * ly + ly + 2 * k, ix * lx:ix * lx + lx + 2 * k]
        assert np.array_equal(got, want), (iy, ix)


@pytest.mark.parametrize("Y,X", [(2, 4), (1, 3)])
def test_one_row_primitives_decomposed(monkeypatch, Y, X):
    ly, lx = 4, 5
    g = np.random.default_rng(3).random((Y * ly, X * lx))
    blk = lambda a, iy, ix: a[iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx]  # noqa: E731
    north = np.roll(g, -1, 0)
    north[-1] = g[-1, ::-1]

    def fn(iy, ix, y_axis, x_axis):
        t = torch.as_tensor(blk(g, iy, ix).copy())
        return (halo.shifted(t, +1, -2, y_axis).numpy(), halo.shifted(t, -1, -1, x_axis).numpy(),
                halo.north_neighbor_sharded(t, True, y_axis, x_axis).numpy())

    for (iy, ix), (south, east, nn) in _run_decomposed(monkeypatch, Y, X, fn).items():
        assert np.array_equal(south, blk(np.roll(g, 1, 0), iy, ix))
        assert np.array_equal(east, blk(np.roll(g, -1, 1), iy, ix))
        assert np.array_equal(nn, blk(north, iy, ix))
