"""The scalar 5-point stencil that represents every scalar grid Laplacian.

PyTorch-port counterpart of the scalar part of ``gcm_filters_tpu/ops/stencil.py``.
Every scalar Laplacian is *data*: one 5-point stencil with per-cell
coefficient tensors (or Python floats for constant-coefficient grids),
optional pre/post masks, and two boundary flags::

    out = post * (c*g + n*g_north + s*g_south + e*g_east + w*g_west),
    g   = pre * nan_to_num(field)

Boundary semantics: x is periodic; y is periodic unless ``fold_north`` is
set, in which case the north neighbour of the top row is the top row itself
reversed in x (the tripolar seam).

The vector operators (B-grid and C-grid) come with a later part of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

Tensor = torch.Tensor
Coef = Union[Tensor, float]  # Python floats stay immediates in the kernel

# Fields of ScalarStencil5 that may hold tensors, in kernel argument order:
# the five coefficients (tensors or floats), then the optional masks.
COEF_FIELDS = ("c", "n", "s", "e", "w")
ARRAY_FIELDS = COEF_FIELDS + ("pre", "post", "area")


def hspace_drop_pre(stencil) -> bool:
    """True when the mask pattern admits the exact h-space elimination used
    by the kernel path: the same 0/1 wet mask as both pre- and
    post-multiplier, with NaN scrubbing (see ops/cuda/dispatch.py)."""
    pre, post = stencil.pre, stencil.post
    if pre is None or post is None or not stencil.zap_nans:
        return False
    if pre is not post:  # identity is the common case; fall back to values
        if pre.shape != post.shape or not torch.equal(pre, post):
            return False
    return bool(((pre == 0) | (pre == 1)).all())


def north_neighbor(g: Tensor, fold_north: bool) -> Tensor:
    """Value of the cell to the north (j+1), with wraparound or tripolar fold.

    With ``fold_north``, the north neighbour of the top row is the top row
    reversed in x (the two halves of the tripolar seam face each other).
    """
    if fold_north:
        return torch.cat([g[..., 1:, :], g[..., -1:, :].flip(-1)], dim=-2)
    return torch.roll(g, -1, dims=-2)


def south_neighbor(g: Tensor) -> Tensor:
    return torch.roll(g, 1, dims=-2)


def east_neighbor(g: Tensor) -> Tensor:
    return torch.roll(g, -1, dims=-1)


def west_neighbor(g: Tensor) -> Tensor:
    return torch.roll(g, 1, dims=-1)


@dataclasses.dataclass(frozen=True)
class ScalarStencil5:
    """A grid-aware scalar Laplacian as a masked 5-point stencil.

    Coefficient fields are 2-D tensors (spatially varying grids) or Python
    floats (constant-coefficient grids). ``pre``/``post`` are optional
    multiplicative masks applied before/after the contraction (land
    masking). ``area`` is the optional fixed-factor weighting applied once
    per filter in prepare/finalize, not per step.
    """

    c: Coef  # center
    n: Coef  # north  (j+1)
    s: Coef  # south  (j-1)
    e: Coef  # east   (i+1)
    w: Coef  # west   (i-1)
    pre: Optional[Tensor] = None
    post: Optional[Tensor] = None
    area: Optional[Tensor] = None
    fold_north: bool = False
    zap_nans: bool = False
    is_dimensional: bool = False

    def to(self, dtype=None, device=None) -> "ScalarStencil5":
        """A copy with every floating tensor field cast to ``dtype`` and moved
        to ``device``. Fields that share one tensor (pre/post both the wet
        mask) still share one afterwards, so it is cast and moved once."""
        out, seen = {}, {}
        for name in ARRAY_FIELDS:
            v = getattr(self, name)
            if not isinstance(v, Tensor):
                continue
            if id(v) not in seen:
                seen[id(v)] = v.to(
                    device=device,
                    dtype=dtype if v.is_floating_point() else None,
                )
            out[name] = seen[id(v)]
        return dataclasses.replace(self, **out)

    def gather_input(self, f: Tensor) -> Tensor:
        """The masked, NaN-scrubbed field the stencil contracts over."""
        g = torch.nan_to_num(f) if self.zap_nans else f
        if self.pre is not None:
            g = self.pre * g
        return g

    def contract(self, g: Tensor, gn: Tensor, gs: Tensor, ge: Tensor, gw: Tensor) -> Tensor:
        out = self.c * g + self.n * gn + self.s * gs + self.e * ge + self.w * gw
        if self.post is not None:
            out = self.post * out
        return out

    def laplacian(self, f: Tensor) -> Tensor:
        """Apply the Laplacian on the full (periodic/folded) domain."""
        g = self.gather_input(f)
        return self.contract(
            g,
            north_neighbor(g, self.fold_north),
            south_neighbor(g),
            east_neighbor(g),
            west_neighbor(g),
        )

    __call__ = laplacian

    def prepare(self, f: Tensor) -> Tensor:
        """Fixed-factor transform to the unit-spacing grid (once per filter)."""
        return f * self.area if self.area is not None else f

    def finalize(self, f: Tensor) -> Tensor:
        """Inverse of :meth:`prepare` (once per filter)."""
        return f / self.area if self.area is not None else f
