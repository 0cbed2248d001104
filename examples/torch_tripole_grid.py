"""Tripolar-grid walkthrough: filtering across the Arctic seam.

The PyTorch port's counterpart of ``example_tripole_grid.py``. Global ocean
models (POP, MOM, NEMO) avoid the north-pole singularity with a TRIPOLAR grid
whose top row folds onto itself: column i of the last row is physically
adjacent to column nx-1-i. Filtering must carry information across that seam
or the Arctic gets artificial boundaries.

Shows:
  1. the two tripolar grid types (simple fixed-factor vs POP flux-form),
  2. the fold-consistency validation the constructor enforces,
  3. seam symmetry: a spike on the top row diffuses across the fold,
  4. the same filter sharded. On the card the field is cut into y-shards
     resident on the one device (``ResidentMesh``), whose ring kernel sends
     the halo rows, the fold included, itself; its float32 result equals the
     unsharded kernel's bit for bit. On the CPU the filter runs on a 1x1
     ``DeviceMesh`` over a one-rank gloo process group.

Run: python examples/torch_tripole_grid.py                 (on the CUDA card)
     python examples/torch_tripole_grid.py --device cpu    (plain PyTorch)
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402

P_Y = 4  # y-shards of the resident mesh on the card


def make_tripolar_grid(ny, nx, rng):
    """An idealized tripolar T-grid: Antarctica land row at j=0 (required:
    the fold means there is no southern wraparound), an idealized continent,
    and northern metric rows that FOLD onto themselves: the edge shared by
    columns i and nx-1-i has one length, so the top dxn/dyn rows satisfy
    row == row[::-1]."""
    wet = np.ones((ny, nx))
    wet[0, :] = 0                          # Antarctica
    wet[ny // 3: ny // 2, : nx // 4] = 0   # a continent

    def folding_metric():
        m = 0.9 + 0.2 * rng.random((ny, nx))
        m[-1, :] = 0.5 * (m[-1, :] + m[-1, ::-1])  # make the top row fold
        return m

    dxe, dye = folding_metric(), folding_metric()
    dxn, dyn = folding_metric(), folding_metric()
    return wet, dxe, dye, dxn, dyn, dxe * dye


def sharded_apply(kwargs, data, device):
    """``data`` filtered by the sharded filter of ``kwargs``: on the card over
    ``ResidentMesh(P_Y)`` (the ring engine), on the CPU over a 1x1
    ``DeviceMesh`` (the halo-exchange rounds); a numpy array."""
    if torch.device(device).type == "cuda":
        ring = gt.Filter(**kwargs, device=device, mesh=gt.ResidentMesh(P_Y, device),
                         spatial_axes=("y", None))
        return ring.apply(data).cpu().numpy()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("gloo", init_method=f"file://{store}/store", world_size=1,
                                rank=0)
        try:
            mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
            sharded = gt.Filter(**kwargs, device=device, mesh=mesh, spatial_axes=("y", "x"))
            return sharded.apply(data).full_tensor().numpy()
        finally:
            dist.destroy_process_group()


def main(device="cuda", shape=(128, 256)):
    """Run the four parts on ``device``; returns the grid, the spike, each
    grid's filtered spike with its mass error and the value across the seam,
    and the sharded comparison (its float32 input, both results and the max
    abs difference)."""
    ny, nx = shape
    rng = np.random.default_rng(11)
    wet, dxe, dye, dxn, dyn, tarea = make_tripolar_grid(ny, nx, rng)

    # --- 1. simple fixed-factor tripolar (area-weighted 5-point) ----------
    simple_kw = dict(filter_scale=8.0, dx_min=1.0,
                     grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                     grid_vars={"area": tarea, "wet_mask": wet})
    simple = gt.Filter(**simple_kw, device=device)
    # --- POP flux-form tripolar (full metric terms) ------------------------
    pop_vars = {"wet_mask": wet, "dxe": dxe, "dye": dye, "dxn": dxn, "dyn": dyn,
                "tarea": tarea}
    pop = gt.Filter(filter_scale=8.0, dx_min=1.0, grid_type=gt.GridType.TRIPOLAR_POP_WITH_LAND,
                    grid_vars=pop_vars, device=device)

    # --- 2. the constructor validates the fold ----------------------------
    bad_dxn = dxn.copy()
    bad_dxn[-1, 0] += 1.0  # top row no longer folds onto itself
    try:
        gt.Filter(filter_scale=8.0, dx_min=1.0, grid_type=gt.GridType.TRIPOLAR_POP_WITH_LAND,
                  grid_vars=dict(pop_vars, dxn=bad_dxn), device=device)
        raise RuntimeError("a top row that does not fold was accepted")
    except AssertionError as e:
        print("fold validation works:", str(e)[:60], "...")

    # --- 3. seam symmetry --------------------------------------------------
    spike = np.zeros((ny, nx))
    spike[-1, nx // 4] = 1.0  # on the seam row
    out = dict(wet=wet, tarea=tarea, spike=spike)
    mass_in = (spike * tarea * wet).sum()
    for name, filt in [("simple", simple), ("pop", pop)]:
        sm = filt.apply(spike).cpu().numpy()
        mass_err = abs((sm * tarea * wet).sum() - mass_in) / mass_in
        across = float(sm[-2, nx - 1 - nx // 4])
        print(f"{name:>7}: mass conserved to {mass_err:.2e}, spike spread across seam: "
              f"{across:.3e} (mirror cell is nonzero)")
        if not across > 0:
            raise RuntimeError(f"{name}: nothing crossed the fold")
        out[name] = dict(out=sm, mass_err=mass_err, across=across)

    # --- 4. sharded: the fold as communication ----------------------------
    data = rng.random((ny, nx)).astype(np.float32)
    single = simple.apply(data).cpu().numpy()
    sharded = sharded_apply(simple_kw, data, device)
    err = float(np.nanmax(np.abs(sharded - single)))
    print(f"sharded == unsharded across the fold seam: max err {err:.2e}")
    out["sharded"] = dict(data=data, single=single, sharded=sharded, max_err=err)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
