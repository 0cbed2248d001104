"""Carry operator coefficients across from host arrays to the port's tensors.

The port's builders compute in numpy float64 on the host, exactly as the JAX
package's do, and hand their arrays to :func:`stencil_from_numpy` (scalar
grids) or :func:`vector_operator_from_numpy` (vector grids). The same
functions take the fields of an operator built by the JAX package
(``dataclasses.asdict`` of it, each array through ``np.asarray``), so both
packages can compute with the same coefficients.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ops.stencil import (
    ARRAY_FIELDS,
    BGRID_FIELDS,
    CGRID_FIELDS,
    COEF_FIELDS,
    BGridVectorStencil,
    CGridVectorOperator,
    ScalarStencil5,
)

_VECTOR_FLAGS = ("is_dimensional", "zap_nans", "fold_north")


def stencil_from_numpy(
    fields: Dict,
    *,
    fold_north: bool,
    zap_nans: bool,
    is_dimensional: bool,
    device="cpu",
    dtype: Optional[torch.dtype] = torch.float64,
) -> ScalarStencil5:
    """A :class:`ScalarStencil5` from host arrays and floats.

    ``fields`` maps the stencil's array fields (``c, n, s, e, w, pre, post,
    area``) to numpy arrays, Python floats (coefficients only) or ``None``;
    any other key is an error. Arrays are copied to ``device`` as ``dtype``
    (``None`` keeps the array's own dtype). Fields that hold the same array
    object share one tensor, as the JAX package's stencils share one device
    array for a mask used as both ``pre`` and ``post``.
    """
    unknown = set(fields) - set(ARRAY_FIELDS)
    if unknown:
        raise ValueError(f"Unknown stencil fields {sorted(unknown)}; expected {ARRAY_FIELDS}")
    out, seen = {}, {}
    for name in ARRAY_FIELDS:
        v = fields.get(name)
        if v is None:
            if name in COEF_FIELDS:
                raise ValueError(f"Stencil coefficient {name!r} is missing")
            out[name] = None
            continue
        if isinstance(v, (int, float)) and name in COEF_FIELDS:
            out[name] = float(v)
            continue
        if id(v) not in seen:
            seen[id(v)] = torch.tensor(np.asarray(v), dtype=dtype, device=device)
        out[name] = seen[id(v)]
    return ScalarStencil5(
        **out, fold_north=fold_north, zap_nans=zap_nans, is_dimensional=is_dimensional
    )


def vector_operator_from_numpy(fields: Dict):
    """A :class:`BGridVectorStencil` or :class:`CGridVectorOperator` from
    host arrays.

    ``fields`` maps every array field of one of the two classes to a numpy
    array (the class is the one whose field names they are) and may also
    hold the boolean flags ``is_dimensional``, ``zap_nans`` and
    ``fold_north``. Arrays are copied to float64 CPU tensors: the vector
    dispatch computes its coefficient planes from them on the host.
    """
    arrays = {k: v for k, v in fields.items() if k not in _VECTOR_FLAGS}
    flags = {k: bool(v) for k, v in fields.items() if k in _VECTOR_FLAGS}
    for cls, names in ((BGridVectorStencil, BGRID_FIELDS), (CGridVectorOperator, CGRID_FIELDS)):
        if set(arrays) == set(names):
            return cls(**{k: torch.tensor(np.asarray(arrays[k]), dtype=torch.float64)
                          for k in names}, **flags)
    raise ValueError(
        f"Fields {sorted(arrays)} are neither a B-grid {BGRID_FIELDS} nor a "
        f"C-grid {CGRID_FIELDS} vector operator"
    )
