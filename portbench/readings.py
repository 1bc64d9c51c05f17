#!/usr/bin/env python3
"""The readings the output check's limits are set from, many seeds in one
process: the program's (the lower readings), the control's (the upper
ones: harness/control.py) or a fault's.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --side program|control|stale|half_left_out|altered

Each seed is a run of the cell as run.py makes it (its pool, warm-up,
closed loop of `seconds` and check), with the program's entry point
replaced on the control's and the faults' sides. One JSON line a seed:
the numbers compared. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

from harness import control, runner, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--side", default="program",
                    choices=("program", "control", *control.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = None
        if args.side == "control":
            entry = control.control_entry(
                runner.reference_entry(cell.config), args.device)
        elif args.side in control.FAULTS:
            entry = control.FAULTS[args.side](
                runner.program_entry(cell.config, args.device))
        t = time.perf_counter()
        result = runner.run(cell, seed, args.seconds, False, args.device,
                            t, entry=entry, warm=args.side != "control")
        if args.side in control.FAULTS:
            runner.release_program()
        w = result["window"]
        print(json.dumps(dict(
            workload=args.workload, side=args.side, seed=seed,
            mismatched_blocks=result["mismatched_blocks"],
            failed_requests=w.failed,
            blocks_compared=result["blocks_compared"],
            requests=len(w.served), seconds=time.perf_counter() - t)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
