"""Nothing the benchmark runs is JAX or the JAX package, and without the
card the harness exits nonzero and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from harness import guard, spec


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(["convectionkernels_tpu_torch",
                                    "convectionkernels_tpu_torch.api",
                                    "numpy", "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["convectionkernels_tpu.api"]) == [
        "convectionkernels_tpu"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                    "numpy"]) == ["flax", "jax", "jaxlib"]


def test_the_harness_and_the_reference_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference, harness.runner, harness.control, harness.check\n"
        "from harness import spec, guard\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    cell = spec.find_cell(w['name'])\n"
        "    [spec.metric_reader(m['name']) for m in cell.per_layer]\n"
        "import convectionkernels_tpu_torch\n"
        "print(guard.forbidden_modules())\n" % (spec.BENCH_DIR, spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", "bc7_q50.tiles_128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd, env=env,
        timeout=120)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_without_a_card_the_harness_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0
    assert _no_result(out.stdout)
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_with_only_the_benchmark_the_harness_exits_nonzero(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: without one every run exits nonzero")
    import shutil
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "run.py"),
         "--workload", "bc7_q50.tiles_128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and _no_result(out.stdout)
