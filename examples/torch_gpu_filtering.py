"""GPU filtering walkthrough: the 0.1-degree tripolar headline on the card.

The PyTorch port's counterpart of ``example_tpu_filtering.py``: the workload
of the reference's GPU tutorial (0.1-degree POP-style tripolar SST,
2400x3600, Gaussian fixed factor 10) with synthetic data, in float32 through
``Filter.apply`` on the CUDA card, where one launch of the fused scalar
kernel runs the whole filter. It prints the time per filter (CUDA events
over 10 applies after a first one that builds the kernels) beside the card's
name and power limit, which bound what any time means.

Run: python examples/torch_gpu_filtering.py                 (on the CUDA card)
     python examples/torch_gpu_filtering.py --device cpu    (plain PyTorch; slow at this size)
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import gcm_filters_tpu_torch as gt  # noqa: E402


def card_description():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(device="cuda", shape=(2400, 3600), iters=10):
    """Filter the synthetic SST ``iters`` times on ``device``; returns the
    input, the result after one apply, ms per filter, the rate and (on the
    card) the card's description."""
    ny, nx = shape
    device = torch.device(device)
    rng = np.random.default_rng(42)
    wet = np.ones((ny, nx))
    wet[0, :] = 0  # Antarctica row (required for tripolar grids)
    wet[: ny // 6, : nx // 5] = 0  # an idealized continent
    area = 0.9 + 0.2 * rng.random((ny, nx))
    sst = np.where(wet, rng.standard_normal((ny, nx)), np.nan).astype(np.float32)

    filt = gt.Filter(
        filter_scale=10.0,  # coarsen by a factor of 10
        dx_min=1.0,
        filter_shape=gt.FilterShape.GAUSSIAN,
        grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
        grid_vars={"area": area, "wet_mask": wet},
        dtype=torch.float32,
        device=device,
    )
    out = filt.apply(sst)  # builds the kernels and the operands on the first call
    first = out
    if device.type == "cuda":
        card = f"{torch.cuda.get_device_name(device)} ({card_description()})"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = filt.apply(out)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        card = "the CPU, plain PyTorch"
        t0 = time.perf_counter()
        for _ in range(iters):
            out = filt.apply(out)
        ms = 1e3 * (time.perf_counter() - t0) / iters
    rate = ny * nx * filt.n_steps / (ms * 1e-3)
    print(f"device={device.type}  n_steps={filt.n_steps}")
    print(f"{ms:.4f} ms per filter ({rate / 1e9:.2f} G grid-point-steps/s) on {card}")

    o = first.cpu().numpy()
    land_nan = bool(np.isnan(o[wet == 0]).all())
    ocean_finite = bool(np.isfinite(o[wet == 1]).all())
    print("land stays NaN:", land_nan)
    print("ocean is finite:", ocean_finite)
    return dict(sst=sst, wet=wet, area=area, out=o, n_steps=filt.n_steps, ms=ms, rate=rate,
                card=card, land_nan=land_nan, ocean_finite=ocean_finite)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)
