"""Filter types walkthrough: fixed scale, fixed factor, shape, anisotropy.

The PyTorch port's counterpart of ``example_filter_types.py``: the same API
covers the four filtering regimes, and they differ in what they cost in
n_steps. On the card each filter runs the fused scalar kernel in the mode its
stencil selects (the flux form of ``IRREGULAR_WITH_LAND``, the h-space form
of the masked area-weighted grid, the constant-coefficient ``REGULAR``).

Run: python examples/torch_filter_types.py                 (on the CUDA card)
     python examples/torch_filter_types.py --device cpu    (plain PyTorch)
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402


def make_inputs(shape):
    """The field, the wet mask and the gently varying zonal spacing."""
    ny, nx = shape
    rng = np.random.default_rng(7)
    data = rng.standard_normal((ny, nx))
    wet = np.ones((ny, nx))
    wet[0, :] = 0
    dx = 1.0 + 0.1 * np.cos(np.linspace(0, 2 * np.pi, nx))[None, :].repeat(ny, 0)
    return data, wet, dx


def filter_kwargs(wet, dx):
    """name -> the Filter arguments of each regime (without the device)."""
    dy = np.ones_like(dx)

    def irregular(kappa_w):
        return dict(wet_mask=wet, dxw=dx, dyw=dy, dxs=dx, dys=dy, area=dx * dy,
                    kappa_w=kappa_w * np.ones_like(dx), kappa_s=np.ones_like(dx))

    return {
        # 1. fixed *scale* on an irregular grid: filter_scale in physical
        #    units, metric arrays describe the cell geometry
        "fixed scale": dict(filter_scale=8.0, dx_min=float(dx.min()),
                            grid_type=gt.GridType.IRREGULAR_WITH_LAND,
                            grid_vars=irregular(1.0)),
        # 2. simple fixed *factor*: coarsen by 8x via area weighting (dx_min=1)
        "fixed factor": dict(filter_scale=8.0, dx_min=1.0,
                             grid_type=gt.GridType.REGULAR_WITH_LAND_AREA_WEIGHTED,
                             grid_vars=dict(area=dx * dy, wet_mask=wet)),
        # 3. Taper shape: sharper spectral cutoff, ~3x the steps
        "taper": dict(filter_scale=8.0, dx_min=1.0, filter_shape=gt.FilterShape.TAPER,
                      grid_type=gt.GridType.REGULAR),
        # 4. anisotropic: kappa_w < 1 shrinks the zonal filter scale only
        "anisotropic": dict(filter_scale=8.0, dx_min=float(dx.min()),
                            grid_type=gt.GridType.IRREGULAR_WITH_LAND,
                            grid_vars=irregular(0.25)),
    }


def main(device="cuda", shape=(256, 512)):
    """Filter one field in the four regimes on ``device``; returns the input
    and, per regime, ``n_steps``, the variance before and after and the
    filtered field."""
    data, wet, dx = make_inputs(shape)
    results = {}
    for name, kw in filter_kwargs(wet, dx).items():
        filt = gt.Filter(device=device, **kw)
        out = filt.apply(data).cpu().numpy()
        var_in, var_out = float(data.var()), float(np.nanvar(out))
        print(f"{name:13s} n_steps={filt.n_steps:3d} var {var_in:.3f} -> {var_out:.4f}")
        results[name] = dict(n_steps=filt.n_steps, var_in=var_in, var_out=var_out, out=out)
    return dict(data=data, wet=wet, results=results)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
