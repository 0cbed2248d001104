#!/usr/bin/env python3
"""Read the numbers that the check compares, for the program or for its
control, on several seeds in one process; the readings the limits in
``configs/*.json`` ("checks") are set from.

    python3 perfbench/control.py --workload <cell> --side control --seeds 1 2 3 --seconds 2

``--side program`` drives the program as a run does; ``--side control`` puts
the reference in the program's place, computed in bfloat16 (the precision
next below the configuration's float32; the filter has no matrix products,
so TF32 would change nothing). Each seed gives one JSON line with the
compared numbers; the control has to fail the check. The benchmark's own
runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import ReferenceProgram, run

    make = None
    if args.side == "control":
        def make(cell, inputs, device):
            return ReferenceProgram(cell, inputs, device, torch.bfloat16)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run(args.workload, seed, args.seconds, False, args.device, make_program=make)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"], "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
