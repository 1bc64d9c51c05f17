#!/usr/bin/env python3
"""The benchmark of convectionkernels_tpu_torch, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port, on a machine with the
CUDA card(s) the cell asks for. The cell, its configuration, its traffic
mix and its metrics are read from BENCHMARK.json and the files it names
(harness/spec.py). The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), device, with --trace 1
breakdown, and last `compared`: each number the output check compared,
with its limit. It exits nonzero, printing no result, without the card(s),
without the port in the checkout, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)

from harness import guard, runner, spec  # noqa: E402


def fail(message: str, code: int = 2):
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def csrc_kernels() -> list[str]:
    """The program's own __global__ kernels, by its sources' file names
    (csrc/<name>.cu holds <name>_kernel)."""
    return [os.path.basename(p)[:-3] + "_kernel" for p in glob.glob(
        os.path.join(ROOT, "convectionkernels_tpu_torch", "csrc", "*.cu"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = spec.find_cell(args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        fail(f"cannot read the cell: {e}")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    if not os.path.isdir(os.path.join(ROOT, "convectionkernels_tpu_torch")):
        fail("the port, convectionkernels_tpu_torch, is not in the checkout")
    sys.path.insert(1, ROOT)
    import convectionkernels_tpu_torch as ckt
    if not os.path.abspath(ckt.__file__).startswith(ROOT + os.sep):
        fail(f"the port was loaded from {ckt.__file__}, not the checkout")
    torch.set_num_threads(2)

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T0, csrc_kernels=csrc_kernels())
    line = runner.result_line(cell, result, torch.cuda.get_device_name(0))
    found = guard.forbidden_modules()
    if found:
        fail(f"JAX or the JAX package was loaded: {found}", 3)
    for k, v in line["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
