"""Sharded filtering: the halo-exchange rounds and the resident ring.

The PyTorch port's counterpart of ``example_sharded_filtering.py``, with two
sharded paths checked against single-device execution:

  1. ``Filter(mesh=DeviceMesh, spatial_axes=("y", "x"))``: every rank holds
     one block and exchanges halo rows, the tripolar fold included, with its
     neighbours before each round of steps. This script runs one process,
     so the mesh is 1x1 over a one-rank process group (NCCL on the card,
     gloo on the CPU); a multi-rank mesh runs the same code with one process
     per rank.
  2. ``Filter(mesh=ResidentMesh(p_y, device), spatial_axes=("y", None))``:
     ``p_y`` y-shards held on one device, whose ring kernel sends each pass's
     halo rows itself. On 2-D float32 fields it equals the unsharded kernel
     path bit for bit.

The JAX example's ``use_pallas`` switch and its virtual CPU devices have no
counterpart here: the card always runs the hand-written kernels, the CPU
their plain PyTorch versions, and ``--device`` picks between the two.

Run: python examples/torch_sharded_filtering.py                 (on the CUDA card)
     python examples/torch_sharded_filtering.py --device cpu    (plain PyTorch)
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402

P_Y = 4  # y-shards of the resident mesh


def one_rank_sharded_apply(kwargs, data, device):
    """``data`` filtered over a 1x1 ``DeviceMesh`` of a one-rank process
    group on ``device``, gathered into a numpy array."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    with tempfile.TemporaryDirectory() as store:
        if device.type == "cuda":
            dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1,
                                    rank=0, device_id=torch.device("cuda", 0))
        else:
            dist.init_process_group("gloo", init_method=f"file://{store}/store", world_size=1,
                                    rank=0)
        try:
            mesh = init_device_mesh(device.type, (1, 1), mesh_dim_names=("y", "x"))
            sharded = gt.Filter(**kwargs, device=device, mesh=mesh, spatial_axes=("y", "x"))
            return sharded.apply(data).full_tensor().cpu().numpy()
        finally:
            dist.destroy_process_group()


def main(device="cuda", shape=(240, 360)):
    """Both sharded paths against the single-device filter on ``device``;
    returns each path's input, results and max abs difference."""
    ny, nx = shape
    rng = np.random.default_rng(0)
    wet = np.ones((ny, nx))
    wet[0, :] = 0
    area = 0.9 + 0.2 * rng.random((ny, nx))
    data = rng.random((ny, nx))
    kwargs = dict(filter_scale=10.0, dx_min=1.0,
                  grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                  grid_vars={"area": area, "wet_mask": wet})
    want = gt.Filter(**kwargs, device=device).apply(data).cpu().numpy()
    print(f"1x1 mesh over one {torch.device(device).type} process")
    got = one_rank_sharded_apply(kwargs, data, device)
    mesh_err = float(np.abs(got - want).max())
    print("max |sharded - single|:", mesh_err)

    # The ring: y-shards resident on one device; ny must divide by P_Y, and
    # the ring takes unbatched 2-D float32 fields.
    ny_r = 96 * P_Y
    wet_r = np.ones((ny_r, nx))
    wet_r[0, :] = 0
    rkw = dict(kwargs, grid_vars={"area": 0.9 + 0.2 * rng.random((ny_r, nx)),
                                  "wet_mask": wet_r})
    data_r = rng.random((ny_r, nx)).astype(np.float32)
    ring = gt.Filter(**rkw, device=device, mesh=gt.ResidentMesh(P_Y, device),
                     spatial_axes=("y", None))
    got_r = ring.apply(data_r).cpu().numpy()
    want_r = gt.Filter(**rkw, device=device).apply(data_r).cpu().numpy()
    ring_err = float(np.abs(got_r - want_r).max())
    print(f"ring ({P_Y} resident y-shards) max |ring - unsharded|:", ring_err)
    return dict(mesh=dict(data=data, grid_vars=kwargs["grid_vars"], sharded=got, single=want,
                          max_err=mesh_err),
                ring=dict(data=data_r, grid_vars=rkw["grid_vars"], sharded=got_r, single=want_r,
                          max_err=ring_err))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
