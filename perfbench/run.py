#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gcm_filters_tpu_torch`` on this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result, one JSON object; standard
error names the card and its power limit first and the numbers compared with
their limits last. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The program's only build cache is its nvcc libraries, which
    # ops/cuda/build.py keeps at <checkout>/build/kernels.
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import load_cell, log, run

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); torch finds {n}")
        return 2
    try:
        import gcm_filters_tpu_torch
    except ImportError as err:
        log(f"the program is not in this checkout: {err}")
        return 2
    if ROOT not in Path(gcm_filters_tpu_torch.__file__).resolve().parents:
        log(f"gcm_filters_tpu_torch comes from {gcm_filters_tpu_torch.__file__}, not this checkout")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
