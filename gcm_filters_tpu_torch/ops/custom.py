"""The free-form custom-operator protocol.

PyTorch-port counterpart of ``gcm_filters_tpu/ops/custom.py``. Users define
ANY Laplacian by subclassing :class:`BaseScalarOperator` (define
``__call__(self, field)``) or :class:`BaseVectorOperator` (define
``__call__(self, u, v)``) with any torch math -- 9-point, biharmonic,
spectral -- and pass the instance as ``Filter(custom_operator=...)``. The
operator runs through the eager engine (engine.py) on the filter's device,
on tensors of the compute dtype; it keeps its own tensors where it needs
them and does its own boundary handling (e.g. ``torch.roll`` wraparound for
periodic domains).

Radius-1 operators expressed as framework stencil types
(:class:`~gcm_filters_tpu_torch.ops.stencil.ScalarStencil5`,
``BGridVectorStencil``, ``CGridVectorOperator``) go through the step kernels
instead and, for scalar stencils, mesh sharding. Protocol-form operators
cannot be sharded (the engine cannot know their communication pattern);
``Filter(mesh=...)`` rejects them.
"""
from __future__ import annotations

import inspect


class BaseScalarOperator:
    """Subclass and define ``__call__(self, field) -> laplacian_of_field``.

    ``prepare``/``finalize`` default to identity; override them for
    fixed-factor (area-weighted) style transforms applied once per filter.
    Set ``is_dimensional = True`` if the operator carries physical units
    (the shifted-operator scale then uses s_max rather than
    s_max * dx_min**2).
    """

    is_vector = False
    is_dimensional = False

    def prepare(self, field):
        return field

    def finalize(self, field):
        return field

    def __call__(self, field):  # pragma: no cover - interface stub
        raise NotImplementedError


class BaseVectorOperator:
    """Subclass and define ``__call__(self, u, v) -> (lap_u, lap_v)``."""

    is_vector = True
    is_dimensional = False

    def prepare(self, u, v):
        return u, v

    def finalize(self, u, v):
        return u, v

    def __call__(self, u, v):  # pragma: no cover - interface stub
        raise NotImplementedError


def _call_arity(op) -> int:
    """Number of field arguments the operator's apply function takes
    (-1 when the object has no apply function at all)."""
    fn = getattr(op, "laplacian", None) or getattr(op, "__call__", None)
    if fn is None:
        return -1
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover - builtins
        return -1
    n = 0
    for p in sig.parameters.values():
        if p.name == "self":
            continue
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is p.empty:
                n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return -1
    return n


def operator_is_vector(op) -> bool:
    """Scalar-vs-vector classification for ``Filter(custom_operator=...)``.

    Framework stencil types are classified by type; protocol operators by
    their ``is_vector`` attribute when present (the base classes set it),
    else by the arity of ``__call__``/``laplacian`` (1 field arg = scalar,
    2 = vector).
    """
    from .stencil import BGridVectorStencil, CGridVectorOperator, ScalarStencil5

    if isinstance(op, ScalarStencil5):
        return False
    if isinstance(op, (BGridVectorStencil, CGridVectorOperator)):
        return True
    flag = getattr(op, "is_vector", None)
    if flag is not None:
        return bool(flag)
    arity = _call_arity(op)
    if arity == 1:
        return False
    if arity == 2:
        return True
    raise ValueError(
        "Could not classify custom_operator as scalar or vector: give it an "
        "`is_vector` attribute (or subclass BaseScalarOperator / "
        "BaseVectorOperator), or define __call__ with exactly one (scalar) "
        "or two (vector) field arguments."
    )


class _ProtocolAdapter:
    """Uniform engine-facing view of a free-form protocol operator.

    Fills in missing ``prepare``/``finalize`` (identity) and
    ``is_dimensional`` (False), and routes ``laplacian`` to the operator's
    ``laplacian`` method or ``__call__``. The engine treats it as opaque.
    """

    def __init__(self, op):
        self._op = op
        self.is_dimensional = bool(getattr(op, "is_dimensional", False))
        self.zap_nans = bool(getattr(op, "zap_nans", False))
        self._lap = getattr(op, "laplacian", None) or op

    def to(self, dtype=None, device=None) -> "_ProtocolAdapter":
        """The engine casts framework stencils per call; a protocol operator
        owns its tensors, so there is nothing to cast or move."""
        return self

    def laplacian(self, *fields):
        return self._lap(*fields)

    __call__ = laplacian

    def prepare(self, *fields):
        fn = getattr(self._op, "prepare", None)
        if fn is None:
            return fields[0] if len(fields) == 1 else fields
        return fn(*fields)

    def finalize(self, *fields):
        fn = getattr(self._op, "finalize", None)
        if fn is None:
            return fields[0] if len(fields) == 1 else fields
        return fn(*fields)


def as_protocol_adapter(op) -> _ProtocolAdapter:
    return _ProtocolAdapter(op)
