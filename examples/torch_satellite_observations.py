"""Filtering gridded satellite observations: eddy/mean flow decomposition.

The PyTorch port's counterpart of ``example_satellite_observations.py``.
Gridded surface-velocity products (e.g. OSCAR) come as lat/lon fields with
land gaps and NaNs. Spatial filtering splits the kinetic energy into mean
and eddy parts:

    KE  = (u^2 + v^2) / 2
    MKE = (u_bar^2 + v_bar^2) / 2          (energy of the large-scale flow)
    EKE = KE_bar - MKE                     (energy carried by the eddies)

The example synthesizes an OSCAR-like field (a large-scale gyre and
mesoscale eddies on a 1/2-degree lat/lon grid with continents and NaN data
gaps) and shows the whole workflow:

  1. build the latitude-dependent metric arrays from the lat/lon grid,
  2. filter through land/NaN gaps with IRREGULAR_WITH_LAND (fixed scale, in
     metres): NaN observations are treated as missing, land stays land,
  3. batch over the time axis in one call (on the card one launch per fused
     pass covers every snapshot),
  4. compute the MKE / EKE maps.

Run: python examples/torch_satellite_observations.py                 (on the CUDA card)
     python examples/torch_satellite_observations.py --device cpu    (plain PyTorch)
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402

R_EARTH = 6.371e6  # m


def synthesize_observations(nlat, nlon, nt, rng):
    """An OSCAR-like surface velocity product: gyres, eddies and gaps."""
    lat = np.linspace(-60, 60, nlat)
    lon = np.linspace(0, 360, nlon, endpoint=False)
    LON, LAT = np.meshgrid(lon, lat)

    # large-scale double gyre and a mesoscale eddy field, drifting in time
    u = np.empty((nt, nlat, nlon))
    v = np.empty((nt, nlat, nlon))
    for t in range(nt):
        ph = 2 * np.pi * t / nt
        u[t] = 0.4 * np.sin(2 * np.pi * LAT / 60) \
            + 0.15 * np.sin(18 * np.pi * LON / 360 + ph) * np.cos(10 * np.pi * LAT / 60)
        v[t] = 0.1 * np.cos(2 * np.pi * LON / 360) \
            + 0.15 * np.cos(16 * np.pi * LON / 360 - ph) * np.sin(12 * np.pi * LAT / 60)
    u += 0.02 * rng.standard_normal(u.shape)
    v += 0.02 * rng.standard_normal(v.shape)

    # continents and a few swath-like NaN data gaps
    wet = np.ones((nlat, nlon))
    wet[:, : nlon // 8] = 0
    wet[nlat // 2:, 3 * nlon // 8: nlon // 2] = 0
    u[:, wet == 0] = np.nan
    v[:, wet == 0] = np.nan
    gap = rng.random((nlat, nlon)) < 0.01
    u[:, gap] = np.nan
    v[:, gap] = np.nan
    return lat, lon, u, v, wet


def metrics_from_latlon(lat, lon):
    """Cell spacings and areas of a regular lat/lon grid, in metres: dx
    shrinks with cos(latitude), the anisotropy that IRREGULAR_WITH_LAND's
    flux-form metric arrays express."""
    nlat, nlon = len(lat), len(lon)
    dlat = np.deg2rad(lat[1] - lat[0])
    dlon = np.deg2rad(lon[1] - lon[0])
    coslat = np.cos(np.deg2rad(lat))[:, None] * np.ones((1, nlon))
    dx = R_EARTH * coslat * dlon   # zonal spacing (m)
    dy = R_EARTH * dlat * np.ones((nlat, nlon))
    return dx, dy, dx * dy


def grid_vars(wet, dx, dy, area):
    return {"wet_mask": wet, "dxw": dx, "dyw": dy, "dxs": dx, "dys": dy, "area": area,
            "kappa_w": np.ones_like(dx), "kappa_s": np.ones_like(dx)}


def main(device="cuda", shape=(240, 720), nt=4):
    """Decompose the kinetic energy of ``nt`` synthetic snapshots of
    ``shape`` on ``device``; returns the inputs, the filtered fields, the
    MKE and EKE maps and the three mean energies over the ocean."""
    rng = np.random.default_rng(42)
    nlat, nlon = shape
    lat, lon, u, v, wet = synthesize_observations(nlat, nlon, nt, rng)
    dx, dy, area = metrics_from_latlon(lat, lon)

    # Fixed-SCALE filter at 600 km: filter_scale and dx_min in metres. NaN
    # gaps are ingested as missing data (NaN -> 0 with no-flux walls at land);
    # kappa == 1 everywhere keeps the scale isotropic in physical space even
    # though dx varies with latitude.
    filt = gt.Filter(filter_scale=600e3, dx_min=float(dx.min()),
                     grid_type=gt.GridType.IRREGULAR_WITH_LAND,
                     grid_vars=grid_vars(wet, dx, dy, area), device=device)
    print(f"600 km Gaussian on a {nlat}x{nlon} lat/lon grid: n_steps = {filt.n_steps}")

    # One call filters the whole (time, lat, lon) stack: leading dims batch.
    ke = 0.5 * (np.nan_to_num(u) ** 2 + np.nan_to_num(v) ** 2)
    u_bar = filt.apply(np.nan_to_num(u) * wet).cpu().numpy()
    v_bar = filt.apply(np.nan_to_num(v) * wet).cpu().numpy()
    ke_bar = filt.apply(ke * wet).cpu().numpy()

    mke = 0.5 * (u_bar ** 2 + v_bar ** 2)
    eke = ke_bar - mke

    ocean = wet == 1
    means = {"ke": float(ke[:, ocean].mean()), "mke": float(mke[:, ocean].mean()),
             "eke": float(eke[:, ocean].mean())}
    print(f"mean KE : {means['ke']:.4f} m^2/s^2")
    print(f"mean MKE: {means['mke']:.4f} m^2/s^2 (large-scale flow)")
    print(f"mean EKE: {means['eke']:.4f} m^2/s^2 (eddies)")
    if not means["eke"] > 0:
        raise RuntimeError("eddy energy must be positive on average")
    if not means["mke"] < means["ke"]:  # the filter removed the mesoscale
        raise RuntimeError("the filtered flow must hold less energy than the whole")
    print("decomposition consistent: MKE + EKE == filtered KE (by construction)")
    return dict(u=u, v=v, wet=wet, dx=dx, dy=dy, area=area, n_steps=filt.n_steps,
                u_bar=u_bar, v_bar=v_bar, ke_bar=ke_bar, mke=mke, eke=eke, means=means)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
