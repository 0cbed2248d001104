"""One Chebyshev step on the y-shards of a ring: the CUDA kernels' wrappers
and their plain PyTorch versions, scalar and coupled vector.

PyTorch-port counterpart of the ring mode of the JAX pass kernels:
``gcm_filters_tpu/ops/pallas/cheb_pass.py::build_ring_pass`` (scalar) and the
``ring_axis`` mode of ``gcm_filters_tpu/ops/pallas/vec_pass.py::build_vec_pass``
and ``build_ctap_pass``. The kernels are in
``gcm_filters_tpu_torch/csrc/ring_pass.cu``; its head comment states the work
order, the flags and the memory order of the halo exchange that the kernel
does itself.

A field of ``ny`` rows is cut along y into ``p_y`` shards of ``ly = ny/p_y``
rows; x is not cut. A :class:`RingState` owns, per shard and as separate
allocations, the carries ``a`` and ``b``, the running sum ``acc``, the raw
input (scalar) and the two halo rows, plus the flag words and the ticket of
the kernel's protocol. One call runs one step of all shards:

- FIRST reads the input (``state.input``: ``field`` for scalars, ``a`` for the
  stacked pair) and writes ``T_0`` to ``a`` (scalar), ``T_1`` to ``b`` and
  ``acc``;
- MIDDLE reads ``t`` and ``t_prev``, writes ``T_{k+1}`` over ``t_prev`` and
  updates ``acc``; ``swap`` says which carry is which: 0 means ``t = b,
  t_prev = a`` (the step after FIRST), 1 the reverse, alternating;
- LAST leaves the result in ``acc``.

A step first sends every shard's edge rows, already gathered (area, masks and
``nan_to_num`` applied at the sender's own index), into the neighbours' halo
rows, then computes every shard from its own rows and its two halo rows. The
tripolar seam folds the top shard's top row onto itself; the bottom shard's
south halo is the top shard's top row (y wraps), as in the unsharded step.

:func:`ring_pass` and :func:`vec_ring_pass` launch the kernel for a state on a
CUDA device and run the plain versions :func:`ring_pass_reference` and
:func:`vec_ring_pass_reference` for a state on the CPU; for a CUDA state they
launch or raise. The plain versions move the rows with tensor copies and run
the unsharded plain step's arithmetic on ``cat(halo_s, own, halo_n)``, so on
one device they equal the unsharded plain step bit for bit.

The fused pass runs S <= 16 steps of all shards per launch, the counterpart
of what ``build_ring_pass`` computes per call: :class:`RingFusedOperands`
holds every shard's coefficient planes extended by ``halo`` rows below and
above (filled once from the neighbours through the y wrap),
:class:`RingFusedState` the extended input, two extended carry pairs and
acc. A pass sends the S rows nearest each edge of every live field (the raw
field on a first pass, else ``t`` and ``t_prev``) into the neighbours' halo
rows, then runs the fused K1 tile on windows cut from the extended planes.
:func:`ring_fused_pass` is its wrapper, :func:`ring_fused_pass_reference`
its plain version (the sends as tensor copies, then the unsharded plain
fused pass on each extended block) and
:func:`ring_fused_pass_tiled_reference` the kernel's tile decomposition in
torch.

The fused vector pass is the same for the stacked (u, v) pair, the
counterpart of what the ring mode of ``build_vec_pass`` / ``build_ctap_pass``
computes per call: :class:`VecRingFusedOperands` holds every shard's
``(n_coef, ly+2*halo, nx)`` coefficients, :class:`VecRingFusedState` the
extended ``(2, ly+2*halo, nx)`` input ``w``, two extended carry pairs and
acc; a pass sends the S rows nearest each edge of both components of every
live field (``w`` on a first pass, else ``t`` and ``t_prev``), then runs the
fused K3 / K4 tile on windows cut from the extended planes.
:func:`vec_ring_fused_pass` is its wrapper, :func:`vec_ring_fused_pass_reference`
its plain version (the unsharded plain fused pass on each extended block) and
:func:`vec_ring_fused_pass_tiled_reference` the kernel's tile decomposition.
:class:`RingItems` mirrors the blocks of both fused ring kernels: the
interior tiles by block index, the sends and the edge tiles by ticket, and
the window rows a tile loads before and after its flag waits.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple, Union

import torch

from ..stencil import (
    ARRAY_FIELDS, COEF_FIELDS, ScalarStencil5, east_neighbor, west_neighbor,
)
from . import cheb_pass as _scalar
from . import vec_pass as _vector
from .build import load
from .cheb_pass import (
    FIRST, LAST, MAX_FUSE, MIDDLE, PassOperands, check_shared, fused_planes, fused_shared_bytes,
)
from .launch import Kernel, pointer, route
from .vec_pass import N_COEF, VecPassOperands, vec_fused_shared_bytes

Tensor = torch.Tensor

MIN_ROWS = 1  # the smallest shard the kernels take: one row, both edges at once
MAX_RING_SHARDS = 16  # shards of a fused ring launch at most (csrc/ring_pass.cu)


def _own(x: Tensor) -> Tensor:
    """A contiguous copy in an allocation of its own."""
    return x.contiguous().clone()


@dataclasses.dataclass(frozen=True)
class RingOperands:
    """What every scalar ring step reads besides the carries.

    ``shards[r]`` is shard ``r``'s block of the hot stencil (rows ``r*ly`` to
    ``(r+1)*ly``), every plane an allocation of its own, coefficients
    pre-scaled by ``-2*lap_scale`` as in :class:`~.cheb_pass.PassOperands`.
    ``fold_north`` is kept on the top shard only. ``drop_pre`` and
    ``land_gain`` are the unsharded step's.
    """

    shards: Tuple[ScalarStencil5, ...]
    drop_pre: bool
    land_gain: float

    @property
    def p_y(self) -> int:
        return len(self.shards)

    @classmethod
    def cut(cls, ops: PassOperands, p_y: int) -> "RingOperands":
        """Cut the unsharded step's operands into ``p_y`` shards along y."""
        st = ops.stencil
        shards = []
        for r in range(p_y):
            planes, seen = {}, {}
            for k in ARRAY_FIELDS:
                v = getattr(st, k)
                if not isinstance(v, Tensor):
                    continue
                if id(v) not in seen:  # pre and post may share one tensor
                    ly = v.shape[-2] // p_y
                    seen[id(v)] = _own(v[r * ly:(r + 1) * ly])
                planes[k] = seen[id(v)]
            shards.append(dataclasses.replace(
                st, **planes, fold_north=st.fold_north and r == p_y - 1))
        return cls(tuple(shards), ops.drop_pre, ops.land_gain)


@dataclasses.dataclass(frozen=True)
class VecRingOperands:
    """What every vector ring step reads besides the carries: per shard the
    ``(n_coef, ly, nx)`` block of the pre-scaled coefficient planes of
    :class:`~.vec_pass.VecPassOperands`, an allocation of its own."""

    op: int
    coefs: Tuple[Tensor, ...]
    zap: bool

    @property
    def p_y(self) -> int:
        return len(self.coefs)

    @classmethod
    def cut(cls, ops: VecPassOperands, p_y: int) -> "VecRingOperands":
        """Cut the unsharded step's operands into ``p_y`` shards along y."""
        ly = ops.coef.shape[-2] // p_y
        return cls(ops.op, tuple(_own(ops.coef[:, r * ly:(r + 1) * ly]) for r in range(p_y)),
                   ops.zap)


def _check_shards(ops, shape, device, dtype) -> None:
    """Every shard's stencil of the same kind as shard 0's, its planes
    contiguous ``shape`` of ``dtype`` on ``device``, and the fold on the top
    shard only."""
    first = ops.shards[0]
    for r, st in enumerate(ops.shards):
        for k in ARRAY_FIELDS:
            v, v0 = getattr(st, k), getattr(first, k)
            if isinstance(v, Tensor) != isinstance(v0, Tensor) or (
                    not isinstance(v, Tensor) and v != v0):
                raise ValueError(f"{k} differs in kind or value between shards 0 and {r}")
            if isinstance(v, Tensor):
                pointer(f"{k} of shard {r}", v, shape, device, dtype)
        if st.zap_nans != first.zap_nans or st.fold_north != (
                ops.shards[-1].fold_north and r == ops.p_y - 1):
            raise ValueError(f"zap_nans or fold_north of shard {r} is inconsistent")
    if ops.drop_pre and first.post is None:
        raise ValueError("drop_pre needs the wet mask as post")


class RingState:
    """The buffers of one ring on one device, for one (shape, dtype).

    Per shard, each an allocation of its own (never a view of one global
    array: a view would need no exchange at all): ``field`` (scalar only),
    the carries ``a`` and ``b``, ``acc``, and the halo rows ``halo_s`` and
    ``halo_n``, which start as NaN. ``flags`` holds an epoch word per halo and
    ``ticket`` the kernel's work counter; ``epoch`` counts the launches.
    On a CUDA device the pointer table that the kernel reads is made at the
    first launch from these tensors and the operands', all of which the state
    keeps alive. A state serves one stream at a time, and its launches cannot
    be replayed from a CUDA graph: each launch's epoch is an argument.
    """

    def __init__(self, ops: Union[RingOperands, VecRingOperands], ly: int, nx: int,
                 dtype: torch.dtype, device) -> None:
        self.ops, self.ly, self.nx = ops, int(ly), int(nx)
        self.dtype, self.device = dtype, torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.vector = isinstance(ops, VecRingOperands)
        if not self.vector and not isinstance(ops, RingOperands):
            raise TypeError(f"RingState takes RingOperands or VecRingOperands, got {type(ops).__name__}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the ring step takes float32 or float64, got {dtype}")
        p = ops.p_y
        if p < 2:
            raise ValueError(f"a ring needs at least 2 shards, got {p}")
        if ly < MIN_ROWS or nx < 1:
            raise ValueError(f"a shard needs at least {MIN_ROWS} row and 1 column, got {(ly, nx)}")
        self._check_operands()
        lead = (2,) if self.vector else ()

        def new(shape, fill=None):
            make = torch.empty if fill is None else (lambda *a, **k: torch.full(*a, fill, **k))
            return [make(lead + shape, dtype=dtype, device=self.device) for _ in range(p)]

        self.field = None if self.vector else new((ly, nx))
        self.a, self.b, self.acc = new((ly, nx)), new((ly, nx)), new((ly, nx))
        # poisoned: a halo row that no send has filled must never reach a result
        self.halo_s, self.halo_n = new((nx,), float("nan")), new((nx,), float("nan"))
        self.flags = torch.zeros((p, 2), dtype=torch.int32, device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.epoch = 0
        self._table = None
        self._padded = {}  # shard -> operands of the plain vector step, made at first use

    @property
    def input(self) -> List[Tensor]:
        """Where a caller puts each shard's rows before FIRST."""
        return self.a if self.vector else self.field

    def carries(self, swap: int):
        """``(t, t_prev)`` for a MIDDLE or LAST step."""
        return (self.a, self.b) if swap else (self.b, self.a)

    def _check_operands(self) -> None:
        ops = self.ops
        if self.vector:
            if ops.op not in N_COEF:
                raise ValueError(f"unknown vector contraction {ops.op}")
            for r, c in enumerate(ops.coefs):
                pointer(f"coef of shard {r}", c, (N_COEF[ops.op], self.ly, self.nx), self.device,
                        self.dtype)
            return
        _check_shards(ops, (self.ly, self.nx), self.device, self.dtype)

    def table(self) -> Tensor:
        """The kernel's pointer table, one row per shard (csrc/ring_pass.cu:
        ``Shard`` / ``VecShard``), in device memory."""
        if self._table is None:
            rows = []
            for r in range(self.ops.p_y):
                flag = self.flags[r].data_ptr()
                item = self.flags.element_size()
                own = [x[r].data_ptr() for x in (self.a, self.b, self.acc, self.halo_s, self.halo_n)]
                own += [flag, flag + item]
                if self.vector:
                    rows.append(own + [self.ops.coefs[r].data_ptr()])
                else:
                    st = self.ops.shards[r]
                    planes = [getattr(st, k) for k in ARRAY_FIELDS]
                    rows.append([self.field[r].data_ptr()] + own + [
                        v.data_ptr() if isinstance(v, Tensor) else 0 for v in planes])
            want = load("ring_pass").ring_pass_table_row(int(self.vector))
            if any(len(row) != want for row in rows):
                raise RuntimeError(f"pointer table rows hold {len(rows[0])} pointers, "
                                   f"the kernel expects {want}")
            self._table = torch.tensor(rows, dtype=torch.int64, device=self.device)
        return self._table

    def padded_operands(self, r: int) -> VecPassOperands:
        """Shard ``r``'s coefficient planes with a zero row below and above,
        for the plain vector step on ``cat(halo_s, own, halo_n)``. The halo
        rows are gathered already, so these operands scrub no NaN."""
        if r not in self._padded:
            c = self.ops.coefs[r]
            zero = torch.zeros_like(c[:, :1])
            self._padded[r] = VecPassOperands(self.ops.op, torch.cat([zero, c, zero], dim=1), False)
        return self._padded[r]


# -- plain versions ------------------------------------------------------------

def _exchange(state: RingState, gathered: List[Tensor]) -> None:
    """Every shard's gathered bottom row into its down-neighbour's north halo
    and its top row into its up-neighbour's south halo."""
    p = state.ops.p_y
    for r, g in enumerate(gathered):
        state.halo_n[(r - 1) % p].copy_(g[..., 0, :])
        state.halo_s[(r + 1) % p].copy_(g[..., -1, :])


def ring_pass_reference(state: RingState, kind: int, p_a: float, p_b: float = 0.0,
                        swap: int = 0) -> None:
    """The plain PyTorch version of one scalar ring launch, on any device."""
    ops = state.ops
    t, t_prev = state.carries(swap)
    if kind == FIRST:
        src = []
        for st, f in zip(ops.shards, state.field):
            fbar = st.prepare(f)
            src.append(st.post * torch.nan_to_num(fbar) if ops.drop_pre else fbar)
    else:
        src = t
    _exchange(state, [st.gather_input(x) for st, x in zip(ops.shards, src)])
    for r, st in enumerate(ops.shards):
        halo_s, halo_n = state.halo_s[r], state.halo_n[r]

        def laplacian(x, st=st, halo_s=halo_s, halo_n=halo_n):
            g = st.gather_input(x)
            top = g[-1:].flip(-1) if st.fold_north else halo_n[None]
            return st.contract(g, torch.cat([g[1:], top]), torch.cat([halo_s[None], g[:-1]]),
                               east_neighbor(g), west_neighbor(g))

        _scalar.reference_step(
            PassOperands(st, ops.drop_pre, ops.land_gain), kind, p_a, p_b, laplacian,
            field=state.field[r], t=t[r], t_prev=t_prev[r],
            t_next=state.b[r] if kind == FIRST else t_prev[r], acc=state.acc[r], h=state.a[r])


def vec_ring_pass_reference(state: RingState, kind: int, p_a: float, p_b: float = 0.0,
                            swap: int = 0) -> None:
    """The plain PyTorch version of one vector ring launch, on any device."""
    ops = state.ops
    t, t_prev = state.carries(swap)
    scrub = torch.nan_to_num if ops.zap else (lambda x: x)
    _exchange(state, [scrub(x) for x in (state.a if kind == FIRST else t)])
    for r in range(ops.p_y):
        ext_ops = state.padded_operands(r)
        halo_s, halo_n = state.halo_s[r], state.halo_n[r]

        def laplacian(x, ext_ops=ext_ops, halo_s=halo_s, halo_n=halo_n):
            ext = torch.cat([halo_s[:, None], scrub(x), halo_n[:, None]], dim=1)
            return _vector._lap(ext_ops, ext[None])[0][:, 1:-1]

        _vector.reference_step(
            kind, p_a, p_b, laplacian, w=state.a[r], t=t[r], t_prev=t_prev[r],
            t_next=state.b[r] if kind == FIRST else t_prev[r], acc=state.acc[r])


# -- the fused pass: S steps per launch, S halo rows sent once per pass -------

def _extended(x: Tensor, r: int, ly: int, halo: int) -> Tensor:
    """Shard ``r``'s rows of ``x`` extended by ``halo`` rows below and above
    (global rows ``r*ly - halo`` to ``(r+1)*ly + halo``, y wrapping), an
    allocation of its own."""
    rows = torch.arange(r * ly - halo, (r + 1) * ly + halo, device=x.device) % x.shape[-2]
    return _own(x.index_select(-2, rows))


@dataclasses.dataclass(frozen=True)
class RingFusedOperands:
    """What every fused ring pass reads besides the carries.

    ``shards[r]`` is shard ``r``'s block of the hot stencil extended by
    ``halo`` rows below and above (global rows ``r*ly - halo`` to
    ``(r+1)*ly + halo``, y wrapping), every plane an allocation of its own,
    coefficients pre-scaled as in :class:`~.cheb_pass.PassOperands`: the
    counterpart of the JAX ring's ``host_ext_inputs``, a one-time cost per
    (shape, dtype, halo); only carries travel per pass. ``fold_north`` is
    kept on the top shard only. ``drop_pre`` and ``land_gain`` are the
    unsharded pass's.
    """

    shards: Tuple[ScalarStencil5, ...]
    halo: int
    drop_pre: bool
    land_gain: float

    @property
    def p_y(self) -> int:
        return len(self.shards)

    @classmethod
    def cut(cls, ops: PassOperands, p_y: int, halo: int) -> "RingFusedOperands":
        """Cut the unsharded pass's operands into ``p_y`` extended shards."""
        if halo < 1:
            raise ValueError(f"the fused ring needs a halo of at least 1 row, got {halo}")
        st = ops.stencil
        shards = []
        for r in range(p_y):
            planes, seen = {}, {}
            for k in ARRAY_FIELDS:
                v = getattr(st, k)
                if not isinstance(v, Tensor):
                    continue
                if id(v) not in seen:  # pre and post may share one tensor
                    seen[id(v)] = _extended(v, r, v.shape[-2] // p_y, halo)
                planes[k] = seen[id(v)]
            shards.append(dataclasses.replace(
                st, **planes, fold_north=st.fold_north and r == p_y - 1))
        return cls(tuple(shards), int(halo), ops.drop_pre, ops.land_gain)


@dataclasses.dataclass(frozen=True)
class VecRingFusedOperands:
    """What every fused vector ring pass reads besides the carries: per shard
    the ``(n_coef, ly+2*halo, nx)`` block of the pre-scaled coefficients of
    :class:`~.vec_pass.VecPassOperands`, extended as in
    :class:`RingFusedOperands` (the counterpart of the JAX ring's
    ``host_vec_ext_inputs`` / ``host_ctap_ext_inputs``), an allocation of its
    own; ``op`` and ``zap`` are the unsharded pass's."""

    op: int
    coefs: Tuple[Tensor, ...]
    halo: int
    zap: bool

    @property
    def p_y(self) -> int:
        return len(self.coefs)

    @classmethod
    def cut(cls, ops: VecPassOperands, p_y: int, halo: int) -> "VecRingFusedOperands":
        """Cut the unsharded pass's operands into ``p_y`` extended shards."""
        if halo < 1:
            raise ValueError(f"the fused ring needs a halo of at least 1 row, got {halo}")
        ly = ops.coef.shape[-2] // p_y
        return cls(ops.op, tuple(_extended(ops.coef, r, ly, halo) for r in range(p_y)),
                   int(halo), ops.zap)


class RingFusedState:
    """The buffers of one fused ring on one device, for one (shape, dtype).

    Per shard, each an allocation of its own, every "in" plane extended by
    ``pad = ops.halo`` rows below and above: ``field`` (the raw input), two
    carry pairs ``t[i]`` and ``t_prev[i]`` (a pass reads one pair and writes
    the own rows of the other: its tiles read their neighbours' cells, so it
    cannot update its carries in place), and the own-shaped ``acc``. Every
    extended buffer starts as NaN: a halo row that no send has filled must
    never reach a result. ``flags``, ``ticket``, ``epoch`` and ``drawn`` (the
    tickets drawn so far) are the kernel's protocol. A state serves one
    stream at a time, and its launches cannot be replayed from a CUDA graph.
    """

    lead: Tuple[int, ...] = ()  # the components a field stacks: none
    operands = RingFusedOperands

    def __init__(self, ops, ly: int, nx: int, dtype: torch.dtype, device) -> None:
        self.ops, self.ly, self.nx = ops, int(ly), int(nx)
        self.dtype, self.device = dtype, torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if not isinstance(ops, self.operands):
            raise TypeError(f"{type(self).__name__} takes {self.operands.__name__}, "
                            f"got {type(ops).__name__}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the fused ring pass takes float32 or float64, got {dtype}")
        p = ops.p_y
        if p < 2:
            raise ValueError(f"a ring needs at least 2 shards, got {p}")
        if ly < MIN_ROWS or nx < 1:
            raise ValueError(f"a shard needs at least {MIN_ROWS} row and 1 column, got {(ly, nx)}")
        self.pad = ops.halo
        self._check_operands()

        def new():
            return [torch.full(self.lead + (self.ly + 2 * self.pad, self.nx), float("nan"),
                               dtype=dtype, device=self.device) for _ in range(p)]

        self.field = new()
        self.t, self.t_prev = [new(), new()], [new(), new()]
        self.acc = [torch.empty(self.lead + (self.ly, self.nx), dtype=dtype, device=self.device)
                    for _ in range(p)]
        self.flags = torch.zeros((p, 2), dtype=torch.int32, device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.epoch = 0
        self.drawn = 0
        self._planes = {}  # out -> the kernel's table, made at first launch

    def _check_operands(self) -> None:
        _check_shards(self.ops, (self.ly + 2 * self.pad, self.nx), self.device, self.dtype)

    @property
    def input(self) -> List[Tensor]:
        """Where a caller puts each shard's rows before the first pass: the
        own rows of ``field``."""
        return [f[..., self.pad:self.pad + self.ly, :] for f in self.field]

    def _table(self, out: int, rows) -> ctypes.Array:
        """The kernel's table of a pass that writes carry pair ``out``, from
        ``rows(r, src)``: each shard's pointers (None for an absent plane), a
        host array that the launch copies into the kernel's parameters."""
        if out not in self._planes:
            ptrs = [x.data_ptr() if isinstance(x, Tensor) else x
                    for r in range(self.ops.p_y) for x in rows(r, 1 - out)]
            self._planes[out] = (ctypes.c_void_p * len(ptrs))(*ptrs)
        return self._planes[out]

    def planes(self, out: int):
        """The kernel's table of a pass that writes carry pair ``out``: 16
        pointers per shard (csrc/ring_pass.cu: ``ShardPlanes``)."""
        return self._table(out, lambda r, src: [
            self.field[r], self.input[r], self.t[src][r], self.t_prev[src][r], self.acc[r],
            self.t[out][r], self.t_prev[out][r], self.acc[r]] + [
            v if isinstance(v, Tensor) else None
            for v in (getattr(self.ops.shards[r], k) for k in ARRAY_FIELDS)])


class VecRingFusedState(RingFusedState):
    """The buffers of one fused vector ring, as :class:`RingFusedState` has
    them for a scalar, every field a stacked ``(2, ...)`` pair of u and v:
    per shard ``w`` (the raw input, ``field`` of the scalar state), the two
    extended carry pairs and acc ``(2, ly, nx)``."""

    lead = (2,)
    operands = VecRingFusedOperands

    @property
    def w(self) -> List[Tensor]:
        return self.field

    def _check_operands(self) -> None:
        if self.ops.op not in N_COEF:
            raise ValueError(f"unknown vector contraction {self.ops.op}")
        for r, c in enumerate(self.ops.coefs):
            pointer(f"coef of shard {r}", c, (N_COEF[self.ops.op], self.ly + 2 * self.pad,
                                              self.nx), self.device, self.dtype)

    def planes(self, out: int):
        """The kernel's table of a pass that writes carry pair ``out``: 8
        pointers per shard (csrc/ring_pass.cu: ``VecShardPlanes``)."""
        return self._table(out, lambda r, src: [
            self.w[r], self.t[src][r], self.t_prev[src][r], self.acc[r], self.t[out][r],
            self.t_prev[out][r], self.acc[r], self.ops.coefs[r]])


def _fused_kinds(state: RingFusedState, p, start: int, n_ops: int, out: int,
                 cls=RingFusedState):
    """``(first, last)`` of a pass, after checking that the state takes it."""
    first, last = _scalar._kinds(p, start, n_ops)
    if type(state) is not cls:
        raise TypeError(f"the fused ring pass takes a {cls.__name__}, got {type(state).__name__}")
    if n_ops > min(MAX_FUSE, state.pad, state.ly):
        raise ValueError(f"a fused ring pass of {n_ops} steps needs at most {MAX_FUSE} steps, "
                         f"a halo of {state.pad} rows and shards of {state.ly} rows")
    if out not in (0, 1):
        raise ValueError(f"out names carry pair 0 or 1, got {out}")
    return first, last


def _send_rows(state: RingFusedState, n: int, first: bool, out: int) -> None:
    """The sends of one pass: the ``n`` rows nearest each edge of every live
    field (``field`` on a first pass, else the pair ``1 - out``), every
    component of a stacked one, into the neighbours' halo rows: the bottom
    rows into the down-neighbour's north halo, the top rows into the
    up-neighbour's south halo."""
    p, pad, ly = state.ops.p_y, state.pad, state.ly
    live = [state.field] if first else [state.t[1 - out], state.t_prev[1 - out]]
    for bufs in live:
        for r in range(p):
            bufs[(r - 1) % p][..., pad + ly:pad + ly + n, :].copy_(bufs[r][..., pad:pad + n, :])
            bufs[(r + 1) % p][..., pad - n:pad, :].copy_(bufs[r][..., pad + ly - n:pad + ly, :])


def _store(state: RingFusedState, r: int, last: bool, out: int, outs) -> None:
    """A shard's own-shaped results of a pass into its buffers."""
    state.acc[r].copy_(outs["acc"])
    if not last:
        own = (Ellipsis, slice(state.pad, state.pad + state.ly), slice(None))
        state.t[out][r][own].copy_(outs["t"])
        state.t_prev[out][r][own].copy_(outs["t_prev"])


def ring_fused_pass_reference(state: RingFusedState, p, start: int, n_ops: int, *,
                              tile=None, out: int) -> None:
    """The plain PyTorch version of one fused ring launch, on any device:
    steps ``start+1 .. start+n_ops`` of the filter on every shard.

    The sends move the rows with tensor copies; then each shard's extended
    block runs :func:`~.cheb_pass.cheb_fused_pass_reference`, the unsharded
    plain steps (``tile`` is not used). The block's own y wrap touches only
    rows within ``n_ops`` of its ends, which lie in the halo. The top shard of
    a fold grid folds at its own top row: its block ends there. A first pass
    reads ``field``, any other the carry pair ``1 - out``; a pass that does
    not end the filter writes the own rows of pair ``out``; acc is updated in
    place and holds the result after the last pass.
    """
    first, last = _fused_kinds(state, p, start, n_ops, out)
    _send_rows(state, n_ops, first, out)
    ops, pad, ly, src = state.ops, state.pad, state.ly, 1 - out
    own = slice(pad, pad + ly)
    for r, st in enumerate(ops.shards):
        rows = slice(0, pad + ly) if st.fold_north else slice(None)
        block = dataclasses.replace(st, **{
            k: getattr(st, k)[rows] for k in ARRAY_FIELDS if isinstance(getattr(st, k), Tensor)})
        one = lambda x: x[rows][None]  # noqa: E731
        acc = torch.zeros_like(one(state.field[r]))
        if not first:
            acc[0, own] = state.acc[r]
        t_out, t_prev_out = (None, None) if last else (torch.empty_like(acc), torch.empty_like(acc))
        _scalar.cheb_fused_pass_reference(
            PassOperands(block, ops.drop_pre, ops.land_gain), p, start, n_ops,
            field=one(state.field[r]), t=None if first else one(state.t[src][r]),
            t_prev=None if first else one(state.t_prev[src][r]), t_out=t_out,
            t_prev_out=t_prev_out, acc=acc)
        _store(state, r, last, out, {"acc": acc[0, own]} if last else {
            "acc": acc[0, own], "t": t_out[0, own], "t_prev": t_prev_out[0, own]})


def ring_fused_pass_tiled_reference(state: RingFusedState, p, start: int, n_ops: int, *,
                                    tile, out: int) -> None:
    """One fused ring launch computed as the kernel decomposes it, in torch:
    the sends as tensor copies, then every shard's tiles of ``tile = (by,
    bx)`` own cells with their windows cut from the extended planes as
    ``RingGeo`` of csrc/cheb_tile.cuh cuts them (halo rows below and above,
    mirror cells of the shard's own top rows on the top shard of a fold grid,
    rows further than ``n_ops`` from every own row clamped into the block).
    Same arguments and outputs as :func:`ring_fused_pass_reference`, and the
    same torch arithmetic per cell, so the two are equal bit for bit wherever
    the decomposition is right."""
    first, last = _fused_kinds(state, p, start, n_ops, out)
    _send_rows(state, n_ops, first, out)
    ops, pad, ly, src = state.ops, state.pad, state.ly, 1 - out
    for r, st in enumerate(ops.shards):
        def rows(g, fold=st.fold_north):
            mirror = (g >= ly) if fold else torch.zeros_like(g, dtype=torch.bool)
            g = torch.where(mirror, (2 * ly - 1 - g).clamp(min=0), g)
            return g.clamp(-pad, ly + pad - 1) + pad, mirror

        outs = _scalar.tiled_pass(
            PassOperands(st, ops.drop_pre, ops.land_gain), p, start, n_ops, tile, rows,
            field=state.field[r][None], field_own=state.input[r][None],
            t=None if first else state.t[src][r][None],
            t_prev=None if first else state.t_prev[src][r][None], acc=state.acc[r][None])
        _store(state, r, last, out, {k: v[0] for k, v in outs.items()})


def vec_ring_fused_pass_reference(state: VecRingFusedState, p, start: int, n_ops: int, *,
                                  tile=None, out: int) -> None:
    """The plain PyTorch version of one fused vector ring launch, on any
    device: steps ``start+1 .. start+n_ops`` of the filter on every shard.

    The sends move the rows of both components with tensor copies; then each
    shard's extended block runs :func:`~.vec_pass.vec_fused_pass_reference`,
    the unsharded plain steps (``tile`` is not used). The block's own y wrap
    touches only rows within ``n_ops`` of its ends, which lie in the halo. A
    first pass reads ``w``, any other the carry pair ``1 - out``; a pass that
    does not end the filter writes the own rows of pair ``out``; acc is
    updated in place and holds the result after the last pass.
    """
    first, last = _fused_kinds(state, p, start, n_ops, out, VecRingFusedState)
    _send_rows(state, n_ops, first, out)
    ops, pad, ly, src = state.ops, state.pad, state.ly, 1 - out
    own = (0, slice(None), slice(pad, pad + ly))
    for r in range(ops.p_y):
        acc = torch.zeros_like(state.w[r][None])
        if not first:
            acc[own] = state.acc[r]
        t_out, t_prev_out = (None, None) if last else (torch.empty_like(acc), torch.empty_like(acc))
        _vector.vec_fused_pass_reference(
            VecPassOperands(ops.op, ops.coefs[r], ops.zap), p, start, n_ops,
            w=state.w[r][None] if first else None,
            t=None if first else state.t[src][r][None],
            t_prev=None if first else state.t_prev[src][r][None], t_out=t_out,
            t_prev_out=t_prev_out, acc=acc)
        _store(state, r, last, out, {"acc": acc[own]} if last else {
            "acc": acc[own], "t": t_out[own], "t_prev": t_prev_out[own]})


def vec_ring_fused_pass_tiled_reference(state: VecRingFusedState, p, start: int, n_ops: int,
                                        *, tile, out: int) -> None:
    """One fused vector ring launch computed as the kernel decomposes it, in
    torch: the sends as tensor copies, then every shard's tiles of ``tile =
    (by, bx)`` own cells with their windows cut from the extended planes as
    ``RingGeo`` without a fold cuts them (halo rows below and above, x
    periodic with the corners, rows further than ``n_ops`` from every own row
    clamped into the block; :func:`~.vec_pass.vec_tiled_pass`). Same
    arguments and outputs as :func:`vec_ring_fused_pass_reference`, and the
    same torch arithmetic per cell, so the two are equal bit for bit
    wherever the decomposition is right."""
    first, last = _fused_kinds(state, p, start, n_ops, out, VecRingFusedState)
    _send_rows(state, n_ops, first, out)
    ops, pad, ly, src = state.ops, state.pad, state.ly, 1 - out
    for r in range(ops.p_y):
        outs = _vector.vec_tiled_pass(
            VecPassOperands(ops.op, ops.coefs[r], ops.zap), p, start, n_ops, tile,
            lambda g: g.clamp(-pad, ly + pad - 1) + pad,
            w=state.w[r][None] if first else None,
            t=None if first else state.t[src][r][None],
            t_prev=None if first else state.t_prev[src][r][None], acc=state.acc[r][None])
        _store(state, r, last, out, {k: v[0] for k, v in outs.items()})


# -- the fused kernels' blocks -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingItems:
    """The blocks of one fused ring launch, scalar or vector, as
    csrc/ring_pass.cu lays them out (``fused_ring``, ``ring_interior``,
    ``ring_tickets``, ``ring_item``) and the window rows each tile loads
    before and after its flag waits (``RingGeo::own`` and
    ``fused_halo_load`` of csrc/cheb_tile.cuh, ``vec_window_load`` and
    ``vec_halo_load`` of csrc/vec_tile.cuh).

    A shard has ``tiles_y`` rows of ``tiles_x`` tiles of ``tile = (by, bx)``
    own cells; tile rows ``[int_lo, int_lo + n_int)`` are interior (their
    windows, ``n_ops`` rows past the tile on each side, lie in the shard's own
    rows ``[0, ly)``), the others are edge rows. Blocks ``[2p, 2p +
    interior)`` are the interior tiles, shard by shard and row by row; the
    other blocks draw ``tickets`` tickets from one counter: the two sends of
    every shard first, then every shard's edge tiles.
    """

    p: int
    ly: int
    nx: int
    tile: Tuple[int, int]
    n_ops: int

    @property
    def tiles_x(self) -> int:
        return -(-self.nx // self.tile[1])

    @property
    def tiles_y(self) -> int:
        return -(-self.ly // self.tile[0])

    @property
    def int_lo(self) -> int:
        return min(-(-self.n_ops // self.tile[0]), self.tiles_y)

    @property
    def n_int(self) -> int:
        return max(0, min((self.ly - self.n_ops) // self.tile[0], self.tiles_y) - self.int_lo)

    @property
    def total(self) -> int:
        return self.p * (2 + self.tiles_x * self.tiles_y)

    @property
    def interior(self) -> int:
        return self.p * self.n_int * self.tiles_x

    @property
    def tickets(self) -> int:
        return self.total - self.interior

    def block(self, b: int):
        """Block ``b``'s item, ``("tile", shard, ty, tx)``, or None where it
        draws a ticket."""
        i = b - 2 * self.p
        if not 0 <= i < self.interior:
            return None
        shard, rem = divmod(i, self.n_int * self.tiles_x)
        return ("tile", shard, self.int_lo + rem // self.tiles_x, rem % self.tiles_x)

    def ticket(self, t: int):
        """The item of ticket ``t`` (drawn since the launch began):
        ``("send", shard, side)`` or ``("tile", shard, ty, tx)``."""
        if t < 2 * self.p:
            return ("send", t // 2, t % 2)
        shard, rem = divmod(t - 2 * self.p, (self.tiles_y - self.n_int) * self.tiles_x)
        e, tx = divmod(rem, self.tiles_x)
        return ("tile", shard, e if e < self.int_lo else e + self.n_int, tx)

    def window(self, ty: int, fold: bool = False):
        """``(own, halo, waits)`` of a tile in row ``ty``: the window rows,
        in the shard's row numbers, whose state goes by cp.async before any
        wait; those whose state is loaded past L1 after the waits; and the
        flags waited for, ``(south, north)``. With ``fold`` (the scalar
        ring's top shard of a fold grid) the rows from ``ly`` on are mirror
        cells of the shard's own rows: copied by cp.async, no north flag."""
        by, h = self.tile[0], self.n_ops
        y0 = ty * by
        wy = by + 2 * h
        rows = [y0 - h + r for r in range(wy)]
        own = [g for g in rows if 0 <= g < self.ly or (fold and g >= self.ly)]
        lo = min(max(h - y0, 0), wy)
        hi = wy if fold else max(min(self.ly + h - y0, wy), lo)
        halo = [y0 - h + r for r in (*range(lo), *range(hi, wy))]
        return own, halo, (y0 - h < 0, y0 + by + h > self.ly and not fold)


# -- kernels -------------------------------------------------------------------

_KERNEL = Kernel("ring_pass", "ring_pass", (
    [ctypes.c_int] * 5            # kind, swap, p, ly, nx
    + [ctypes.c_void_p] * 2       # table, ticket
    + [ctypes.c_uint]             # epoch
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 3          # zap, fold, drop_pre
    + [ctypes.c_void_p]           # stream
))
_VEC_KERNEL = Kernel("ring_pass", "vec_ring_pass", (
    [ctypes.c_int] * 6            # op, kind, swap, p, ly, nx
    + [ctypes.c_void_p] * 2       # table, ticket
    + [ctypes.c_uint]             # epoch
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))
_FUSED_KERNEL = Kernel("ring_pass", "ring_fused_pass", (
    [ctypes.c_int] * 9            # p, ly, nx, pad, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 3       # planes (host pointers), ticket, flags
    + [ctypes.c_ulonglong, ctypes.c_uint]  # base, epoch
    + [ctypes.c_void_p] * 5       # shard 0's c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # shard 0's pre, post, area
    + [ctypes.c_double]           # land_gain
    + [ctypes.c_int] * 3          # zap, fold, drop_pre
    + [ctypes.c_void_p]           # stream
))
_VEC_FUSED_KERNEL = Kernel("ring_pass", "vec_ring_fused_pass", (
    [ctypes.c_int] * 10           # op, p, ly, nx, pad, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 3       # planes (host pointers), ticket, flags
    + [ctypes.c_ulonglong, ctypes.c_uint]  # base, epoch
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))


def _launch(state: RingState, kind: int, p_a: float, p_b: float, swap: int) -> None:
    if kind not in (FIRST, MIDDLE, LAST):
        raise ValueError(f"unknown step kind {kind}")
    ops = state.ops
    table = state.table().data_ptr()
    # the flag value of this launch: grows with every step and apply, so no
    # flag is ever reset (compared for equality; wraps after 2**32 launches)
    state.epoch = (state.epoch + 1) & 0xFFFFFFFF
    geometry = (kind, int(bool(swap)), ops.p_y, state.ly, state.nx, table,
                state.ticket.data_ptr(), state.epoch)
    if state.vector:
        _VEC_KERNEL(state.device, state.dtype, ops.op, *geometry, float(p_a), float(p_b),
                    int(ops.zap), detail=ops.op)
        return
    st = ops.shards[-1]
    consts = [0.0 if isinstance(getattr(st, k), Tensor) else float(getattr(st, k))
              for k in COEF_FIELDS]
    _KERNEL(state.device, state.dtype, *geometry, *consts, float(p_a), float(p_b),
            float(ops.land_gain), int(st.zap_nans), int(st.fold_north), int(ops.drop_pre))


def ring_pass(state: RingState, kind: int, p_a: float, p_b: float = 0.0, swap: int = 0) -> None:
    """One scalar Chebyshev step of every shard of ``state``, halo exchange
    included, as :func:`ring_pass_reference` documents it.

    A state on a CUDA device launches the kernel once (counted under
    ``("ring_pass", None)`` in :func:`~.launch.launch_counts`) on the current
    stream, without synchronizing; a state on the CPU runs the plain
    version. Anything else raises.
    """
    if state.vector:
        raise TypeError("ring_pass takes a scalar RingState; use vec_ring_pass")
    with route("ring_pass", state.device) as card:
        if card:
            _launch(state, kind, p_a, p_b, swap)
        else:
            ring_pass_reference(state, kind, p_a, p_b, swap)


def vec_ring_pass(state: RingState, kind: int, p_a: float, p_b: float = 0.0,
                  swap: int = 0) -> None:
    """One coupled Chebyshev step of every shard of ``state``, halo exchange
    included, as :func:`vec_ring_pass_reference` documents it.

    A state on a CUDA device launches the kernel once (counted per
    contraction under ``("vec_ring_pass", BGRID)`` and ``("vec_ring_pass",
    CTAP)`` in :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; a state on the CPU runs the plain version. Anything else
    raises.
    """
    if not state.vector:
        raise TypeError("vec_ring_pass takes a vector RingState; use ring_pass")
    with route("vec_ring_pass", state.device) as card:
        if card:
            _launch(state, kind, p_a, p_b, swap)
        else:
            vec_ring_pass_reference(state, kind, p_a, p_b, swap)


def _fused_args(state, p, start: int, n_ops: int, tile, out: int, first: bool, last: bool):
    """The arguments every fused ring launch begins with, after the checks
    both kernels share; draws the launch's epoch."""
    by, bx = tile
    if state.ops.p_y > MAX_RING_SHARDS:
        raise ValueError(f"the fused ring kernel takes at most {MAX_RING_SHARDS} shards, "
                         f"got {state.ops.p_y}")
    pa, p_b = _scalar._pass_args(p, start, n_ops, first, {}, ())
    # the flag value of this launch: grows with every pass and apply, so no
    # flag is ever reset (compared for equality; wraps after 2**32 launches)
    state.epoch = (state.epoch + 1) & 0xFFFFFFFF
    return (state.ops.p_y, state.ly, state.nx, state.pad, by, bx, n_ops, int(first), int(last),
            pa, p_b, state.planes(out), state.ticket.data_ptr(), state.flags.data_ptr(),
            state.drawn, state.epoch)


def _fused_launch(state: RingFusedState, p, start: int, n_ops: int, tile, out: int) -> None:
    first, last = _fused_kinds(state, p, start, n_ops, out)
    ops = state.ops
    st = ops.shards[0]
    check_shared(fused_shared_bytes(tile, n_ops, fused_planes(PassOperands(
        st, ops.drop_pre, ops.land_gain)), state.field[0].element_size()), tile, n_ops)
    coef_ptr = [v.data_ptr() if isinstance(v, Tensor) else None
                for v in (getattr(st, k) for k in COEF_FIELDS)]
    coef_val = [0.0 if isinstance(v, Tensor) else float(v)
                for v in (getattr(st, k) for k in COEF_FIELDS)]
    masks = [v.data_ptr() if v is not None else None for v in (st.pre, st.post, st.area)]
    _FUSED_KERNEL(state.device, state.dtype,
                  *_fused_args(state, p, start, n_ops, tile, out, first, last), *coef_ptr,
                  *coef_val, *masks, float(ops.land_gain), int(st.zap_nans),
                  int(ops.shards[-1].fold_north), int(ops.drop_pre), detail="shared")
    # only the sends and the edge tiles draw tickets
    state.drawn += RingItems(ops.p_y, state.ly, state.nx, tile, n_ops).tickets


def ring_fused_pass(state: RingFusedState, p, start: int, n_ops: int, *, tile,
                    out: int) -> None:
    """Steps ``start+1 .. start+n_ops`` of the filter on every shard of
    ``state`` in one launch, halo exchange included, on tiles of ``tile =
    (by, bx)`` own cells, as :func:`ring_fused_pass_reference` documents it.

    A state on a CUDA device launches the kernel once on the current stream,
    without synchronizing, counted under ``("ring_fused_pass", "shared")`` in
    :func:`~.launch.launch_counts` and with ``path="shared"`` on the span, as
    :func:`~.cheb_pass.cheb_fused_pass` counts its launches: the ring always
    steps in shared memory, since its register steps would spill. A state on
    the CPU runs the plain version. Anything else raises.
    """
    with route("ring_fused_pass", state.device, "shared") as card:
        if card:
            _fused_launch(state, p, start, n_ops, tuple(tile), out)
        else:
            ring_fused_pass_reference(state, p, start, n_ops, out=out)


def _vec_fused_launch(state: VecRingFusedState, p, start: int, n_ops: int, tile,
                      out: int) -> None:
    first, last = _fused_kinds(state, p, start, n_ops, out, VecRingFusedState)
    ops = state.ops
    check_shared(vec_fused_shared_bytes(tile, n_ops, N_COEF[ops.op],
                                        state.field[0].element_size()), tile, n_ops)
    _VEC_FUSED_KERNEL(state.device, state.dtype, ops.op,
                      *_fused_args(state, p, start, n_ops, tile, out, first, last),
                      int(ops.zap), detail=ops.op)
    # only the sends and the edge tiles draw tickets
    state.drawn += RingItems(ops.p_y, state.ly, state.nx, tile, n_ops).tickets


def vec_ring_fused_pass(state: VecRingFusedState, p, start: int, n_ops: int, *, tile,
                        out: int) -> None:
    """Steps ``start+1 .. start+n_ops`` of the vector filter on every shard
    of ``state`` in one launch, halo exchange included, on tiles of ``tile =
    (by, bx)`` own cells, as :func:`vec_ring_fused_pass_reference` documents
    it.

    A state on a CUDA device launches the kernel once (counted per
    contraction under ``("vec_ring_fused_pass", BGRID)`` and
    ``("vec_ring_fused_pass", CTAP)`` in :func:`~.launch.launch_counts`) on
    the current stream, without synchronizing; a state on the CPU runs the
    plain version. Anything else raises.
    """
    with route("vec_ring_fused_pass", state.device) as card:
        if card:
            _vec_fused_launch(state, p, start, n_ops, tuple(tile), out)
        else:
            vec_ring_fused_pass_reference(state, p, start, n_ops, out=out)
