"""Stencil representations of every grid Laplacian, scalar and vector.

PyTorch-port counterpart of ``gcm_filters_tpu/ops/stencil.py``.
Every scalar Laplacian is *data*: one 5-point stencil with per-cell
coefficient tensors (or Python floats for constant-coefficient grids),
optional pre/post masks, and two boundary flags::

    out = post * (c*g + n*g_north + s*g_south + e*g_east + w*g_west),
    g   = pre * nan_to_num(field)

Boundary semantics: x is periodic; y is periodic unless ``fold_north`` is
set, in which case the north neighbour of the top row is the top row itself
reversed in x (the tripolar seam).

The vector operators act on a (u, v) pair, doubly periodic with no land
mask: :class:`BGridVectorStencil` (POP B-grid friction, two coupled 5-point
stencils) and :class:`CGridVectorOperator` (Griffies & Hallberg C-grid
viscosity, a two-stage strain/divergence stencil).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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


def _to(obj, names, dtype, device):
    """``dataclasses.replace`` of ``obj`` with the tensor fields ``names``
    cast to ``dtype`` (floating ones only) and moved to ``device``."""
    out = {}
    for name in names:
        v = getattr(obj, name)
        out[name] = v.to(device=device, dtype=dtype if v.is_floating_point() else None)
    return dataclasses.replace(obj, **out)


# Fields of BGridVectorStencil: the diffusion set (applied to each component)
# then the mixing set (coupling u and v).
BGRID_DIFF = ("cc", "dun", "dus", "due", "duw")
BGRID_MIX = ("dmc", "dmn", "dms", "dme", "dmw")
BGRID_FIELDS = BGRID_DIFF + BGRID_MIX


@dataclasses.dataclass(frozen=True)
class BGridVectorStencil:
    """POP B-grid friction operator: two coupled 5-point stencils.

    u_out = S_diff(u) + S_mix(v);  v_out = S_diff(v) + S_mix(u),

    with all ten coefficient tensors precomputed by the builder. Periodic
    boundaries, no land mask.
    """

    cc: Tensor  # central, diffusion part (DUC + DUM)
    dun: Tensor
    dus: Tensor
    due: Tensor
    duw: Tensor
    dmc: Tensor  # central, u/v mixing part
    dmn: Tensor
    dms: Tensor
    dme: Tensor
    dmw: Tensor
    is_dimensional: bool = True
    zap_nans: bool = True
    fold_north: bool = False

    def to(self, dtype=None, device=None) -> "BGridVectorStencil":
        return _to(self, BGRID_FIELDS, dtype, device)

    @staticmethod
    def _s5(f, c, n, s, e, w):
        return (c * f + n * north_neighbor(f, False) + s * south_neighbor(f)
                + e * east_neighbor(f) + w * west_neighbor(f))

    def laplacian(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        if self.zap_nans:
            u = torch.nan_to_num(u)
            v = torch.nan_to_num(v)
        w2 = torch.stack([u, v])
        diff = self._s5(w2, *(getattr(self, k) for k in BGRID_DIFF))
        mix = self._s5(w2, *(getattr(self, k) for k in BGRID_MIX))
        # u picks up the mixing term of v, and v that of u
        return diff[0] + mix[1], diff[1] + mix[0]

    __call__ = laplacian

    def prepare(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        return u, v

    def finalize(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        return u, v


CGRID_FIELDS = (
    "dy_dxT", "dx_dyT", "dy_dxBu", "dx_dyBu", "dx2h", "dy2h", "dx2q", "dy2q",
    "r_dxCu", "r_dyCu", "r_dxCv", "r_dyCv", "recip_area_u", "recip_area_v",
    "kappa_tension", "kappa_iso",
)


@dataclasses.dataclass(frozen=True)
class CGridVectorOperator:
    """Griffies & Hallberg (2000) C-grid viscosity operator.

    Two-stage stencil: horizontal tension str_xx at T points and shear strain
    str_xy at q (vorticity) points, scaled by the (an)isotropic viscosities,
    then divergence back to the u/v points. All metric combinations are
    precomputed by the builder. Periodic boundaries; zero-area cells carry a
    reciprocal area of 0.
    """

    dy_dxT: Tensor  # (dyT/dxT) * wet_mask_t
    dx_dyT: Tensor
    dy_dxBu: Tensor  # (dyBu/dxBu) * wet_mask_q
    dx_dyBu: Tensor
    dx2h: Tensor  # dxT^2
    dy2h: Tensor
    dx2q: Tensor  # dxBu^2
    dy2q: Tensor
    r_dxCu: Tensor  # 1/dxCu
    r_dyCu: Tensor
    r_dxCv: Tensor
    r_dyCv: Tensor
    recip_area_u: Tensor
    recip_area_v: Tensor
    kappa_tension: Tensor  # kappa_iso + 0.5 * kappa_aniso
    kappa_iso: Tensor
    is_dimensional: bool = True
    zap_nans: bool = True
    fold_north: bool = False

    def to(self, dtype=None, device=None) -> "CGridVectorOperator":
        return _to(self, CGRID_FIELDS, dtype, device)

    def laplacian(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        if self.zap_nans:
            u = torch.nan_to_num(u)
            v = torch.nan_to_num(v)
        N = lambda a: north_neighbor(a, False)  # noqa: E731

        # Stage 1: strains.
        u_dy = u * self.r_dyCu
        v_dx = v * self.r_dxCv
        str_xx = -self.kappa_tension * (
            self.dy_dxT * (u_dy - west_neighbor(u_dy))
            - self.dx_dyT * (v_dx - south_neighbor(v_dx))
        )
        v_dy = v * self.r_dyCv
        u_dx = u * self.r_dxCu
        str_xy = -self.kappa_iso * (
            self.dy_dxBu * (east_neighbor(v_dy) - v_dy)
            + self.dx_dyBu * (N(u_dx) - u_dx)
        )

        # Stage 2: divergence of the stress tensor back to u/v points.
        a = self.dy2h * str_xx
        b = self.dx2q * str_xy
        u_out = (
            self.r_dyCu * (a - east_neighbor(a))
            + self.r_dxCu * (south_neighbor(b) - b)
        ) * self.recip_area_u

        c = self.dy2q * str_xy
        d = self.dx2h * str_xx
        v_out = (
            self.r_dyCv * (west_neighbor(c) - c)
            - self.r_dxCv * (d - N(d))
        ) * self.recip_area_v
        return u_out, v_out

    __call__ = laplacian

    def prepare(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        return u, v

    def finalize(self, u: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        return u, v
