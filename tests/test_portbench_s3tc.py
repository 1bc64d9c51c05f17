"""The benchmark's BC3 configuration (`bc3_better`, Flags.BETTER) on the
CPU: its plain reference (portbench/reference/s3tc.py, written apart from
the program) against every stored BC1 and BC3 golden, against the JAX
package's single-colour tables and against the port at Flags.BETTER; the
flags without the exhaustive search and the output check's control, each
of which the exact check would find; the cell as the harness runs it; and
the reader of `s3tc_search_ms_per_mblock.first_call`.

The goldens are the JAX package's op-by-op bytes, stored in
convectionkernels_tpu_torch/testdata/s3tc_golden.npz and read here as
plain NumPy arrays. Tolerance 0 everywhere: bytes are compared as bytes.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from harness import control, inputs, runner, spec, trace  # noqa: E402
from reference import s3tc as ref  # noqa: E402
from reference.options import Flags  # noqa: E402

CELL = "bc3_better.bake_1k_mips"
METRIC = "s3tc_search_ms_per_mblock.first_call"
GOLDEN = os.path.join(ROOT, "convectionkernels_tpu_torch", "testdata",
                      "s3tc_golden.npz")
# every stored case of the entry points the reference gives
S3TC_GOLDENS = ("bc1_default", "bc1_flags0", "bc1_uniform", "bc1_better",
                "bc1_exhaustive", "bc1_light", "bc3_default", "bc3_iic1")
BETTER = Flags.S3TC_PARANOID | Flags.S3TC_EXHAUSTIVE
TEXTURE_SEED = 2**31 + 2201


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _options(row) -> dict:
    """The Options fields of a stored case's `options` row: flags,
    threshold, seed points, S3TC and interpolated-alpha refine rounds."""
    return dict(flags=int(row[0]), threshold=float(row[1]),
                seed_points=int(row[2]), refine_rounds_s3tc=int(row[3]),
                refine_rounds_iic=int(row[4]))


def _chain():
    """The blocks of each level of a seeded 32x32 texture's whole mip
    chain (64, 16, 4, 1, 1 and 1 blocks): an opaque, a gradient-alpha and
    a punch-through quarter."""
    image = inputs.make_texture_image(TEXTURE_SEED, 32)
    return [inputs.blockify(lv) for lv in inputs.mip_chain(image)]


def _alpha_blocks() -> np.ndarray:
    """48 blocks that reach both BC1 ranges under the alpha test: noise,
    two colours and a near-flat colour, 16 of each, each block's alpha
    opaque, cut out (0 or 255) or a noisy gradient."""
    rng = np.random.default_rng(2202)

    def colours():
        return rng.integers(0, 256, (16, 1, 3))
    noise = rng.integers(0, 256, (16, 16, 3))
    two = np.where(rng.random((16, 16, 1)) < 0.5, colours(), colours())
    near = np.clip(colours() + rng.integers(-4, 5, (16, 16, 3)), 0, 255)
    rgb = np.concatenate([noise, two, near])
    kind = np.arange(48) % 3
    cut = np.where(rng.random((48, 16)) < 0.4, 0, 255)
    ramp = np.clip(np.linspace(0, 255, 16)[None] + rng.integers(
        -20, 21, (48, 16)), 0, 255)
    alpha = np.where(kind[:, None] == 0, 255,
                     np.where(kind[:, None] == 1, cut, ramp))
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)


def _ranges(color_blocks: np.ndarray) -> set:
    """The BC1 ranges the colour blocks show: 4 colours where the first
    endpoint is the larger, 3 where it is the smaller (equal endpoints
    tell neither)."""
    ep = color_blocks[:, :4].astype(np.int32)
    ep0, ep1 = ep[:, 0] | (ep[:, 1] << 8), ep[:, 2] | (ep[:, 3] << 8)
    return ({4} if (ep0 > ep1).any() else set()) | \
        ({3} if (ep0 < ep1).any() else set())


def test_the_cases_are_every_stored_bc1_and_bc3_golden():
    z = _golden()
    named = sorted(k[:-len("_blocks")] for k in z if k.endswith("_blocks")
                   and not k.endswith("_api_blocks")
                   and k.split("_")[0] in ("bc1", "bc3"))
    assert named == sorted(S3TC_GOLDENS)


@pytest.mark.parametrize("device", ("cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)))
@pytest.mark.parametrize("case", S3TC_GOLDENS)
def test_the_reference_equals_the_stored_golden(case, device):
    """Each case at its stored Options through the reference's encode_bc1
    or encode_bc3. On a card (`-m cuda`, run with --noconftest) the
    reference runs there, as the output check runs it."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    z = _golden()
    px = torch.from_numpy(z[f"{case}_pixels"]).to(device)
    encode = ref.encode_bc1 if case.startswith("bc1") else ref.encode_bc3
    got = encode(px, **_options(z[f"{case}_options"]))
    assert got.device == px.device
    np.testing.assert_array_equal(got.cpu().numpy(), z[f"{case}_blocks"])


def test_the_reference_tables_equal_the_jax_packages():
    """The reference derives its single-colour tables itself; they equal
    the JAX package's, which the goldens were encoded with."""
    from convectionkernels_tpu.tables import make_tables
    for bits in (5, 6):
        for max_index in (2, 3):
            for paranoid in (False, True):
                np.testing.assert_array_equal(
                    ref.single_color_table(bits, max_index, paranoid),
                    make_tables.s3tc_single_color_table(
                        bits, max_index, 0.03 if paranoid else 0.0))


def test_the_port_equals_the_reference_on_a_mip_chain():
    """The port's encode_bc3 at Flags.BETTER on the CPU, through its
    program (each level padded to its bucket), byte for byte against the
    reference at every level of the chain; the chain's alpha takes both
    alpha ranges."""
    options = ckt.Options(flags=BETTER)
    levels = _chain()
    assert [lv.shape[0] for lv in levels] == [64, 16, 4, 1, 1, 1]
    alpha = []
    for lv in levels:
        got = ckt.encode_bc3(lv, options, device="cpu").numpy()
        want = ref.encode_bc3(torch.from_numpy(lv), flags=BETTER).numpy()
        np.testing.assert_array_equal(got, want)
        alpha.append(want[:, :2].astype(np.int32))
    alpha = np.concatenate(alpha)
    assert (alpha[:, 0] > alpha[:, 1]).any() and \
        (alpha[:, 0] < alpha[:, 1]).any()


def test_the_port_equals_the_reference_on_blocks_of_both_bc1_ranges():
    """Blocks with transparent pixels through BC1 (the alpha test, so the
    exhaustive search also fits the three-count partitions) and BC3 at
    Flags.BETTER: the BC1 bytes take both ranges, and the port equals the
    reference in both entry points."""
    blocks = _alpha_blocks()
    x = torch.from_numpy(blocks)
    options = ckt.Options(flags=BETTER)
    want = ref.encode_bc1(x, flags=BETTER).numpy()
    assert _ranges(want) == {3, 4}
    np.testing.assert_array_equal(
        ckt.encode_bc1(blocks, options, device="cpu").numpy(), want)
    np.testing.assert_array_equal(
        ckt.encode_bc3(blocks, options, device="cpu").numpy(),
        ref.encode_bc3(x, flags=BETTER).numpy())


def test_a_skipped_search_and_the_control_change_a_block():
    """The same blocks without S3TC_EXHAUSTIVE (the port at the flags
    Better has besides), and the reference under the check's control
    (divides, reciprocals and square roots in bfloat16), each give other
    bytes than Flags.BETTER in at least one block: the exact check would
    catch a skipped search and a lowered divide. Outside the control the
    reference is itself again."""
    blocks = np.concatenate(_chain() + [_alpha_blocks()])
    x = torch.from_numpy(blocks)
    better = ref.encode_bc3(x, flags=BETTER).numpy()
    paranoid_only = ckt.encode_bc3(
        blocks, ckt.Options(flags=Flags.S3TC_PARANOID), device="cpu").numpy()
    assert (paranoid_only != better).any(axis=1).sum() >= 1
    with control.lower_precision():
        lowered = ref.encode_bc3(x, flags=BETTER).numpy()
    assert (lowered != better).any(axis=1).sum() >= 1
    np.testing.assert_array_equal(
        ref.encode_bc3(x[:40], flags=BETTER).numpy(), better[:40])


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.s3tc; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'convectionkernels_tpu', "
            "'convectionkernels_tpu_torch')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code, BENCH_DIR],
                         capture_output=True, text=True, timeout=120,
                         cwd=BENCH_DIR, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_reference_shares_no_module_with_the_other_encoders():
    """The S3TC reference is one file on torch, numpy and the frozen
    Options: none of the frozen copies of the port's models, ops or tables
    that the BC7 and BC6H references run, and its divides and roots are
    its own, where the control finds them."""
    with open(os.path.join(BENCH_DIR, "reference", "s3tc.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names == {"__future__", "functools", "numpy", "torch", ".options"}
    assert all(callable(getattr(ref, name)) for name in control.EXACT)


def test_the_cell_sends_the_sizes_the_configuration_gives():
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["program"] == {"entry": "encode_bc3",
                                      "options": {"flags": 384}}
    assert BETTER == 384 == ckt.Flags.BETTER
    assert spec.resolve(cell.config["reference"]["function"]) \
        is ref.encode_bc3
    assert cell.config["reference"]["kwargs"] == {"flags": 384}
    assert cell.traffic_name == "bake_1k_mips"
    sizes = [65536, 16384, 4096, 1024, 256, 64, 16, 4, 1, 1, 1]
    assert sum(sizes) == 87383 and 16 * sum(sizes) == 1398128
    assert cell.mix["image_size"] == 1024 and cell.mix["mips"]
    assert (cell.mix["pool_images"], cell.mix["window_requests"],
            cell.mix["settle_s"], cell.mix["trace_requests"],
            cell.mix["check_sample"]) == (4, 128, 45, 1, 256)
    assert {m["name"] for m in cell.per_layer} == {
        "device_ops_per_request.tiles", "torch_ops_ms_per_mtexel.bake",
        "settle_slowdown", "build_s", METRIC}
    assert {m["name"] for m in cell.end_to_end} == {
        "texel_rate", "request_ms_p95", "device_reserved_gib", "setup_s"}


def test_a_small_run_of_the_cell_is_correct_on_the_cpu(monkeypatch):
    """The cell through runner.run on the CPU at a 16x16 texture (levels of
    16, 4, 1, 1 and 1 blocks): the configuration's entry point of the
    program at Flags.BETTER, the closed loop and the check against the
    reference, every block compared. The warm-up is left out: on the CPU
    it builds nothing."""
    calls = []
    encode = ckt.encode_bc3

    def counted(blocks, options, device):
        calls.append((blocks.shape[0], options.flags))
        return encode(blocks, options, device=device)

    monkeypatch.setattr(ckt, "encode_bc3", counted)
    cell = spec.find_cell(CELL)
    cell.mix = dict(cell.mix, image_size=16, pool_images=1, window_requests=2,
                    settle_s=0, check_full_max=16)
    result = runner.run(cell, 2**31 + 13, 0.01, False, "cpu",
                        time.perf_counter(), log=lambda m: None, warm=False)
    line = runner.result_line(cell, result, "cpu")
    served = len(result["window"].served)
    assert line["correct"] is True and line["failed"] == 0 and served >= 1
    assert result["mismatched_blocks"] == 0
    assert result["blocks_compared"] == served * 23
    assert calls == [(n, 384) for n in (16, 4, 1, 1, 1)] * served


# --- the reader of s3tc_search_ms_per_mblock.first_call ----------------------

def _view(start: int):
    spans = [trace.Span("request", start, start + 100)]
    return trace.view([], spans, texels=16, csrc_kernels=(), bound_ms=None)


def _records():
    """A 65,536-block first call (0-100 ms) holding the alpha half
    (10-30 ms) and the colour half (30-95 ms) with its search (40-80 ms),
    and a smaller bucket's first call after it."""
    ms = 10**6
    build = tracing.Build("first_call", 0, 100 * ms, {"bucket": 65536})
    small = tracing.Build("first_call", 100 * ms, 110 * ms, {"bucket": 256})
    stages = [
        tracing.Stage("s3tc.alpha", 10 * ms, 30 * ms, {"bucket": 65536}),
        tracing.Stage("s3tc.exhaustive", 40 * ms, 80 * ms,
                      {"blocks": 65536, "pairs": 65536 * 965,
                       "bucket": 65536}),
        tracing.Stage("s3tc.color", 30 * ms, 95 * ms, {"bucket": 65536}),
        tracing.Stage("s3tc.exhaustive", 102 * ms, 104 * ms,
                      {"blocks": 256, "pairs": 256 * 965, "bucket": 256})]
    return [build, small], stages


def test_the_reader_reads_the_largest_buckets_search(monkeypatch, capsys):
    """40 ms for 65,536 blocks is 610.3515625 ms a million blocks; the
    smaller bucket's search and a search after the profiled window's start
    are not read; the shares of the first call are logged."""
    builds, stages = _records()
    late = tracing.Stage("s3tc.exhaustive", 10**9, 2 * 10**9,
                         {"blocks": 2**17, "pairs": 0, "bucket": 2**17})
    monkeypatch.setattr(tracing, "builds", lambda: builds)
    monkeypatch.setattr(tracing, "stages", lambda: stages + [late])
    read = spec.metric_reader(METRIC)
    assert read(_view(200 * 10**6)) == pytest.approx(40 / 0.065536)
    err = capsys.readouterr().err
    assert "65536-block first call (100.000 ms)" in err
    assert "alpha half 20.000 ms (20.00%)" in err
    assert "exhaustive search 40.000 ms (40.00%)" in err
    assert "rest of the colour half 25.000 ms (25.00%)" in err


def test_the_reader_reads_nothing_without_records(monkeypatch):
    """No stage before the window, or a port whose tracer keeps no stages
    (the parent's), reads None."""
    read = spec.metric_reader(METRIC)
    builds, stages = _records()
    monkeypatch.setattr(tracing, "builds", lambda: builds)
    monkeypatch.setattr(tracing, "stages", lambda: stages)
    assert read(_view(50 * 10**6)) is None
    monkeypatch.setattr(tracing, "stages", lambda: [])
    assert read(_view(200 * 10**6)) is None
    monkeypatch.delattr(tracing, "stages")
    assert read(_view(200 * 10**6)) is None
