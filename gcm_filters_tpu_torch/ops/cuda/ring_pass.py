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
from .cheb_pass import FIRST, LAST, MIDDLE, PassOperands
from .vec_pass import BGRID, CTAP, N_COEF, VecPassOperands

Tensor = torch.Tensor

MIN_ROWS = 1  # the smallest shard the kernels take: one row, both edges at once


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
        def check(name, x, shape):
            if x.device != self.device or x.dtype != self.dtype:
                raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {self.dtype} "
                                 f"on {self.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

        ops = self.ops
        if self.vector:
            if ops.op not in N_COEF:
                raise ValueError(f"unknown vector contraction {ops.op}")
            for r, c in enumerate(ops.coefs):
                check(f"coef of shard {r}", c, (N_COEF[ops.op], self.ly, self.nx))
            return
        first = ops.shards[0]
        for r, st in enumerate(ops.shards):
            for k in ARRAY_FIELDS:
                v, v0 = getattr(st, k), getattr(first, k)
                if isinstance(v, Tensor) != isinstance(v0, Tensor) or (
                        not isinstance(v, Tensor) and v != v0):
                    raise ValueError(f"{k} differs in kind or value between shards 0 and {r}")
                if isinstance(v, Tensor):
                    check(f"{k} of shard {r}", v, (self.ly, self.nx))
            if st.zap_nans != first.zap_nans or st.fold_north != (
                    ops.shards[-1].fold_north and r == ops.p_y - 1):
                raise ValueError(f"zap_nans or fold_north of shard {r} is inconsistent")
        if ops.drop_pre and first.post is None:
            raise ValueError("drop_pre needs the wet mask as post")

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
            want = _library().ring_pass_table_row(int(self.vector))
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


# -- kernels -------------------------------------------------------------------

_SCALAR_ARGTYPES = (
    [ctypes.c_int] * 5            # kind, swap, p, ly, nx
    + [ctypes.c_void_p] * 2       # table, ticket
    + [ctypes.c_uint]             # epoch
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 3          # zap, fold, drop_pre
    + [ctypes.c_void_p]           # stream
)
_VECTOR_ARGTYPES = (
    [ctypes.c_int] * 6            # op, kind, swap, p, ly, nx
    + [ctypes.c_void_p] * 2       # table, ticket
    + [ctypes.c_uint]             # epoch
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("ring_pass")
        for fn, argtypes in ((lib.ring_pass_f32, _SCALAR_ARGTYPES),
                             (lib.ring_pass_f64, _SCALAR_ARGTYPES),
                             (lib.vec_ring_pass_f32, _VECTOR_ARGTYPES),
                             (lib.vec_ring_pass_f64, _VECTOR_ARGTYPES)):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ring_pass_table_row.argtypes = [ctypes.c_int]
        lib.ring_pass_table_row.restype = ctypes.c_int
        lib.ring_pass_error_string.argtypes = [ctypes.c_int]
        lib.ring_pass_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(state: RingState, kind: int, p_a: float, p_b: float, swap: int) -> None:
    if kind not in (FIRST, MIDDLE, LAST):
        raise ValueError(f"unknown step kind {kind}")
    lib = _library()
    ops = state.ops
    f32 = state.dtype == torch.float32
    table = state.table().data_ptr()
    # the flag value of this launch: grows with every step and apply, so no
    # flag is ever reset (compared for equality; wraps after 2**32 launches)
    state.epoch = (state.epoch + 1) & 0xFFFFFFFF
    geometry = (kind, int(bool(swap)), ops.p_y, state.ly, state.nx, table,
                state.ticket.data_ptr(), state.epoch)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        if state.vector:
            fn = lib.vec_ring_pass_f32 if f32 else lib.vec_ring_pass_f64
            err = fn(ops.op, *geometry, float(p_a), float(p_b), int(ops.zap), stream)
        else:
            st = ops.shards[-1]
            consts = [0.0 if isinstance(getattr(st, k), Tensor) else float(getattr(st, k))
                      for k in COEF_FIELDS]
            fn = lib.ring_pass_f32 if f32 else lib.ring_pass_f64
            err = fn(*geometry, *consts, float(p_a), float(p_b), float(ops.land_gain),
                     int(st.zap_nans), int(st.fold_north), int(ops.drop_pre), stream)
    if err != 0:
        msg = lib.ring_pass_error_string(err).decode()
        raise RuntimeError(f"ring_pass kernel launch failed: {msg} (cudaError {err})")


def ring_pass(state: RingState, kind: int, p_a: float, p_b: float = 0.0, swap: int = 0) -> None:
    """One scalar Chebyshev step of every shard of ``state``, halo exchange
    included, as :func:`ring_pass_reference` documents it.

    A state on a CUDA device launches the kernel once (counted in
    ``ring_pass.launches``) on the current stream, without synchronizing; a
    state on the CPU runs the plain version. Anything else raises.
    """
    if state.vector:
        raise TypeError("ring_pass takes a scalar RingState; use vec_ring_pass")
    if state.device.type == "cuda":
        _launch(state, kind, p_a, p_b, swap)
        ring_pass.launches += 1
    elif state.device.type == "cpu":
        ring_pass_reference(state, kind, p_a, p_b, swap)
    else:
        raise RuntimeError(f"ring_pass has no kernel for device {state.device}")


def vec_ring_pass(state: RingState, kind: int, p_a: float, p_b: float = 0.0,
                  swap: int = 0) -> None:
    """One coupled Chebyshev step of every shard of ``state``, halo exchange
    included, as :func:`vec_ring_pass_reference` documents it.

    A state on a CUDA device launches the kernel once (counted per contraction
    in ``vec_ring_pass.launches[BGRID]`` and ``[CTAP]``) on the current
    stream, without synchronizing; a state on the CPU runs the plain version.
    Anything else raises.
    """
    if not state.vector:
        raise TypeError("vec_ring_pass takes a vector RingState; use ring_pass")
    if state.device.type == "cuda":
        _launch(state, kind, p_a, p_b, swap)
        vec_ring_pass.launches[state.ops.op] += 1
    elif state.device.type == "cpu":
        vec_ring_pass_reference(state, kind, p_a, p_b, swap)
    else:
        raise RuntimeError(f"vec_ring_pass has no kernel for device {state.device}")


# kernel launches (one per step, whatever the number of shards); the plain
# versions do not count
ring_pass.launches = 0
vec_ring_pass.launches = {BGRID: 0, CTAP: 0}
