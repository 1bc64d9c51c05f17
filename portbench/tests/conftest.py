"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from the
repo root. They put portbench/ and the repo root on sys.path and run torch
on few threads."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

torch.set_num_threads(2)
