"""Vector (viscosity) filtering of a velocity field on a spherical C-grid.

The PyTorch port's counterpart of ``example_viscosity_filter.py``: filtering
(u, v) with the Griffies & Hallberg C-grid operator preserves solid-body
rotation exactly, the invariant that distinguishes a *vector* filter from
filtering the two components independently. On the card
``Filter.apply_to_vector`` runs the fused C-grid tap kernel.

Run: python examples/torch_viscosity_filter.py                 (on the CUDA card)
     python examples/torch_viscosity_filter.py --device cpu    (plain PyTorch)
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402


def spherical_c_grid(ny=128, nx=256, lat_max=70.0, lon_max=60.0):
    """NeverWorld2-like spherical sector C-grid metric arrays (metres)."""
    R = 6378000.0
    latCu = np.linspace(-lat_max + lat_max / ny, lat_max - lat_max / ny, ny)
    latCv = np.linspace(-lat_max + 2 * lat_max / ny, lat_max, ny)
    geolatCu = np.meshgrid(np.linspace(0, lon_max, nx), latCu)[1]
    geolatCv = np.meshgrid(np.linspace(0, lon_max, nx), latCv)[1]

    dxCu = R * np.cos(np.deg2rad(geolatCu))
    dxCv = R * np.cos(np.deg2rad(geolatCv))
    dy = np.full((ny, nx), dxCu.max())
    ones = np.ones((ny, nx))
    gv = dict(
        wet_mask_t=ones, wet_mask_q=ones,
        dxT=dxCu, dyT=dy, dxCu=dxCu, dyCu=dy, dxCv=dxCv, dyCv=dy,
        dxBu=dxCv, dyBu=dy,
        area_u=dxCu * dy, area_v=dxCv * dy,
        kappa_iso=ones, kappa_aniso=ones,
    )
    return gv, geolatCu, float(dxCu.min())


def main(device="cuda", shape=(128, 256)):
    """Filter solid-body rotation and a noisy field on ``device``; returns
    the grid, both inputs and outputs, the solid-body deviations and the
    variances before and after."""
    ny, nx = shape
    gv, geolat, dx_min = spherical_c_grid(ny, nx)
    filt = gt.Filter(filter_scale=4 * dx_min,  # filter at 4x the smallest grid spacing
                     dx_min=dx_min, grid_type=gt.GridType.VECTOR_C_GRID, grid_vars=gv,
                     device=device)
    print(f"n_steps = {filt.n_steps}")

    # Solid-body rotation: u = cos(lat), v = 0, in the operator's null space.
    u_sb = np.cos(np.deg2rad(geolat))
    v_sb = np.zeros((ny, nx))
    fu_sb, fv_sb = (a.cpu().numpy() for a in filt.apply_to_vector(u_sb, v_sb))
    dev_u, dev_v = float(np.abs(fu_sb - u_sb).max()), float(np.abs(fv_sb).max())
    print("solid-body u max deviation:", dev_u)
    print("solid-body v max deviation:", dev_v)

    # A noisy eddying field is smoothed.
    rng = np.random.default_rng(3)
    u = u_sb + 0.5 * rng.standard_normal((ny, nx))
    v = 0.5 * rng.standard_normal((ny, nx))
    fu, fv = (a.cpu().numpy() for a in filt.apply_to_vector(u, v))
    var = {"u": (float(u.var()), float(fu.var())), "v": (float(v.var()), float(fv.var()))}
    print(f"u variance {var['u'][0]:.3f} -> {var['u'][1]:.3f}; "
          f"v variance {var['v'][0]:.3f} -> {var['v'][1]:.3f}")
    return dict(grid_vars=gv, dx_min=dx_min, u_sb=u_sb, v_sb=v_sb, fu_sb=fu_sb, fv_sb=fv_sb,
                u=u, v=v, fu=fu, fv=fv, solid_body_dev=(dev_u, dev_v), var=var)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
