"""The benchmark's ETC2 RGBA configuration on the CPU: its plain reference
(portbench/reference/etc2.py, written apart from the program) against
every stored ETC2 golden, against the JAX package's tables and against the
port, the output check's control on it, the cell as the harness runs it,
and the existing readers on the new cells.

The goldens are the JAX package's op-by-op bytes, stored in
convectionkernels_tpu_torch/testdata/etc_golden.npz and read here as plain
NumPy arrays. Tolerance 0 everywhere: bytes are compared as bytes.
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
from convectionkernels_tpu_torch import api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from harness import control, inputs, runner, spec, trace  # noqa: E402
from reference import etc2 as ref  # noqa: E402
from reference.options import Flags, Options as RefOptions  # noqa: E402

CELL = "etc2_rgba.bake_1k_mips"
GOLDEN = os.path.join(ROOT, "convectionkernels_tpu_torch", "testdata",
                      "etc_golden.npz")
# every case of the golden file whose entry the configuration runs
ETC2_GOLDENS = ("etc2_alpha", "etc2_default", "etc2_uniform", "etc2_fake709",
                "etc2_fake709_accurate", "etc2_modes", "etc2_rgba")
ENTRIES = ("etc2", "etc2_alpha", "etc2_rgba")
TEXTURE_SEED = 12345
FLAG_SETS = {"default": Flags.DEFAULT,
             "uniform": Flags.DEFAULT | Flags.UNIFORM,
             "fake709": Flags.DEFAULT | Flags.ETC_USE_FAKE_BT709,
             "fake709_accurate": Flags.DEFAULT | Flags.ETC_USE_FAKE_BT709
             | Flags.ETC_FAKE_BT709_ACCURATE}


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


def _chain():
    """The blocks of each level of a seeded 64x64 texture's whole mip
    chain, 64x64 down to 1x1."""
    image = inputs.make_texture_image(TEXTURE_SEED, 64)
    return [inputs.blockify(lv) for lv in inputs.mip_chain(image)]


def _ref(blocks: np.ndarray, chunk: int = 2048) -> np.ndarray:
    return ref.encode_etc2_rgba(torch.from_numpy(blocks), chunk).numpy()


def _other_blocks() -> np.ndarray:
    """Blocks unlike the texture's, 24 of each kind: noise, one colour,
    two colours, and one colour with +-3 of noise."""
    rng = np.random.default_rng(7)

    def colours():
        return rng.integers(0, 256, (24, 1, 4))
    noise = rng.integers(0, 256, (24, 16, 4))
    solid = np.repeat(colours(), 16, 1)
    two = np.where(rng.random((24, 16, 1)) < 0.5, colours(), colours())
    near = np.clip(colours() + rng.integers(-3, 4, (24, 16, 4)), 0, 255)
    return np.concatenate([noise, solid, two, near]).astype(np.uint8)


def _modes(color_blocks: np.ndarray) -> set:
    """The ETC2 mode of each 8-byte colour block: T, H and planar hide
    behind a differential red, green or blue that overflows."""
    hi = color_blocks[:, :4].astype(np.int64)
    hi = (hi[:, 0] << 24) | (hi[:, 1] << 16) | (hi[:, 2] << 8) | hi[:, 3]
    out = set()
    for word in hi:
        if not word & 2:
            out.add("individual")
            continue
        for shift, mode in ((27, "T"), (19, "H"), (11, "planar")):
            base, delta = (word >> shift) & 31, (word >> (shift - 3)) & 7
            if not 0 <= base + (delta - 8 if delta > 3 else delta) <= 31:
                out.add(mode)
                break
        else:
            out.add("differential")
    return out


def test_the_cases_are_every_stored_etc2_golden():
    z = _golden()
    named = sorted(k[:-len("_entry")] for k in z if k.endswith("_entry")
                   and str(z[k]) in ENTRIES)
    assert named == sorted(ETC2_GOLDENS)


@pytest.mark.parametrize("device", ("cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)))
@pytest.mark.parametrize("case", ETC2_GOLDENS)
def test_the_reference_equals_the_stored_golden(case, device):
    """Each case at its stored flags and threshold, through the reference
    encoder the entry names; the default-Options RGBA case also through
    the entry the output check calls. On a card (`-m cuda`, run with
    --noconftest) the reference runs there, as the output check runs it."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    z = _golden()
    entry = str(z[f"{case}_entry"])
    px = torch.from_numpy(z[f"{case}_pixels"]).to(device)
    options = RefOptions(flags=int(z[f"{case}_flags"]),
                         threshold=float(z[f"{case}_threshold"]))
    alpha = lambda: ref.encode_etc2_alpha(px)  # noqa: E731
    color = lambda: ref.encode_etc2(px, options)  # noqa: E731
    got = {"etc2": color, "etc2_alpha": alpha,
           "etc2_rgba": lambda: torch.cat([alpha(), color()], -1)}[entry]()
    want = z[f"{case}_blocks"]
    assert got.device == px.device
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if entry == "etc2_rgba":
        assert options == RefOptions()
        np.testing.assert_array_equal(
            ref.encode_etc2_rgba(px, chunk=24).cpu().numpy(), want)


def test_the_reference_reaches_every_mode():
    """The goldens' mode case and the test texture's chain take the
    planar, T, H and differential stages of the reference, so each of them
    is held to bytes."""
    z = _golden()
    got = ref.encode_etc2(torch.from_numpy(z["etc2_modes_pixels"]),
                          RefOptions()).numpy()
    chain = np.concatenate([_ref(lv)[:, 8:] for lv in _chain()])
    assert _modes(np.concatenate([got, chain])) == {
        "planar", "T", "H", "differential"}


def test_the_reference_tables_equal_the_jax_packages():
    """The reference derives its tables itself; they equal the JAX
    package's, which the goldens were encoded with."""
    from convectionkernels_tpu.tables import etc_tables
    for t in range(8):
        offs = etc_tables.potential_offsets(t)
        row = ref.etc1_offsets()[t]
        np.testing.assert_array_equal(row[:len(offs)], offs)
        assert (row[len(offs):] == offs[-1]).all()
    np.testing.assert_array_equal(ref.alpha_rounding(),
                                  etc_tables.alpha_rounding_tables())
    np.testing.assert_array_equal(ref.fake_bt709_octants(),
                                  etc_tables.fake_bt709_rounding16())
    np.testing.assert_array_equal(np.array(ref.ALPHA_MODIFIERS),
                                  etc_tables.ALPHA_MODIFIER_TABLE_POSITIVE)
    np.testing.assert_array_equal(np.array(ref.ETC1_MODIFIERS),
                                  etc_tables.ETC1_MODIFIER_TABLES)
    np.testing.assert_array_equal(np.array(ref.TH_MODIFIERS),
                                  etc_tables.TH_MODIFIER_TABLE)


def test_the_port_equals_the_reference_on_a_mip_chain():
    """The port's encode_etc2_rgba on the CPU, through its program (each
    level padded to its bucket), byte for byte against the reference at
    every level of the chain."""
    levels = _chain()
    assert [lv.shape[0] for lv in levels] == [256, 64, 16, 4, 1, 1, 1]
    for lv in levels:
        got = ckt.encode_etc2_rgba(lv, ckt.Options(), device="cpu").numpy()
        np.testing.assert_array_equal(got, _ref(lv))
    program = api._etc_program("etc2_rgba", ckt.Options(),
                               torch.device("cpu"))
    assert sorted(program.buckets) == [(256, 16, 4)]


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_the_port_equals_the_reference_on_other_blocks(flags):
    """Noise, flat, two-colour and near-flat blocks, the colour encoder at
    each flag set the goldens hold and the alpha encoder beside it."""
    blocks = _other_blocks()
    x = torch.from_numpy(blocks)
    got = ckt.encode_etc2(blocks, ckt.Options(flags=FLAG_SETS[flags]),
                          device="cpu").numpy()
    want = ref.encode_etc2(x, RefOptions(flags=FLAG_SETS[flags])).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ckt.encode_etc2_alpha(blocks, ckt.Options(), device="cpu").numpy(),
        ref.encode_etc2_alpha(x).numpy())


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.etc2; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'convectionkernels_tpu', "
            "'convectionkernels_tpu_torch')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code, BENCH_DIR],
                         capture_output=True, text=True, timeout=120,
                         cwd=BENCH_DIR, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_reference_shares_no_module_with_the_other_encoders():
    """The ETC2 reference is one file on torch, numpy and the frozen
    Options: none of the frozen copies of the port's models, ops or
    tables that the BC7 and BC6H references run."""
    with open(os.path.join(BENCH_DIR, "reference", "etc2.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names == {"__future__", "functools", "numpy", "torch", ".options"}


def test_the_control_changes_a_block_of_the_chain():
    """The check's control (divides and square roots in bfloat16) gives
    other bytes than the reference on the test texture: the check would
    find it not correct."""
    changed = 0
    for lv in _chain():
        want = _ref(lv)
        with control.lower_precision():
            got = _ref(lv)
        changed += int((got != want).any(axis=1).sum())
    assert changed >= 1
    # and the reference is itself again outside the block
    lv = _chain()[0]
    np.testing.assert_array_equal(_ref(lv), _ref(lv, chunk=100))


def test_the_cell_sends_the_sizes_the_configuration_gives():
    cell = spec.find_cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["program"] == {"entry": "encode_etc2_rgba",
                                      "options": {}}
    assert spec.resolve(cell.config["reference"]["function"]) \
        is ref.encode_etc2_rgba
    sizes = [65536, 16384, 4096, 1024, 256, 64, 16, 4, 1, 1, 1]
    assert sum(sizes) == 87383 and 16 * sum(sizes) == 1398128
    assert cell.mix["image_size"] == 1024 and cell.mix["mips"]
    assert {m["name"] for m in cell.per_layer} == {
        "device_ops_per_request.tiles", "torch_ops_ms_per_mtexel.bake",
        "settle_slowdown", "build_s"}
    tiles = spec.find_cell("bc6hu.tiles_128")
    assert tiles.config["input"] == "hdr_rgba16f"
    assert {m["name"] for m in tiles.per_layer} == {
        "host_enqueue_ms_per_request.tiles", "device_ops_per_request.tiles",
        "settle_slowdown", "build_s"}


def test_a_small_run_of_the_cell_is_correct_on_the_cpu(monkeypatch):
    """The cell through runner.run on the CPU at a 16x16 texture (levels of
    16, 4, 1, 1 and 1 blocks): the configuration's entry point of the
    program, the closed loop and the check against the reference, every
    block compared. The warm-up is left out: on the CPU it builds nothing."""
    calls = []
    encode = ckt.encode_etc2_rgba

    def counted(blocks, options, device):
        calls.append(blocks.shape[0])
        return encode(blocks, options, device=device)

    monkeypatch.setattr(ckt, "encode_etc2_rgba", counted)
    cell = spec.find_cell(CELL)
    cell.mix = dict(cell.mix, image_size=16, pool_images=1, window_requests=2,
                    settle_s=0, check_full_max=16)
    result = runner.run(cell, 2**31 + 11, 0.01, False, "cpu",
                        time.perf_counter(), log=lambda m: None, warm=False)
    line = runner.result_line(cell, result, "cpu")
    served = len(result["window"].served)
    assert line["correct"] is True and line["failed"] == 0 and served >= 1
    assert result["mismatched_blocks"] == 0
    assert result["blocks_compared"] == served * 23
    assert calls == [16, 4, 1, 1, 1] * served


# --- the existing readers on the ETC2 cell -----------------------------------

OPS = [trace.Op("elementwise_kernel", "kernel", 10, 30),
       trace.Op("reduce_kernel", "kernel", 25, 40),
       trace.Op("Memcpy HtoD (Pageable -> Device)", "memcpy", 40, 45),
       trace.Op("Memset (Device)", "memset", 50, 52),
       trace.Op("index_kernel", "kernel", 85, 95)]
SPANS = [trace.Span("request", 0, 70), trace.Span("request", 80, 100)]


def _view():
    return trace.view(OPS, SPANS, texels=2_000_000, csrc_kernels=(),
                      bound_ms=None)


def test_torch_ops_ms_per_mtexel_counts_every_kernel_of_etc2():
    """ETC2 launches no kernel of csrc/, so its models layer is every
    kernel of the request, memcpys and memsets left out."""
    read = spec.metric_reader("torch_ops_ms_per_mtexel.bake")
    assert read(_view()) == pytest.approx((20 + 15 + 10) / 1e6 / 2.0)
    assert read(trace.view(OPS[2:4], SPANS, 2_000_000, (), None)) is None


def test_device_ops_per_request_counts_what_starts_inside():
    read = spec.metric_reader("device_ops_per_request.tiles")
    assert read(_view()) == (4 + 1) / 2
