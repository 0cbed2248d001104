"""Carry stencil coefficients across from host arrays to the port's tensors.

The port's stencil builders compute in numpy float64 on the host, exactly as
the JAX package's do, and hand their arrays to :func:`stencil_from_numpy`.
The same function takes the fields of a stencil built by the JAX package
(``dataclasses.asdict`` of its ``ScalarStencil5``, each array through
``np.asarray``), so both packages can compute with the same coefficients.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ops.stencil import ARRAY_FIELDS, COEF_FIELDS, ScalarStencil5


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
