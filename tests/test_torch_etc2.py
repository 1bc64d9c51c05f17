"""The port's ETC2 color slice (encode_etc2, encode_etc2_rgba,
encode_etc2_punchthrough) on the CPU against the JAX package.

The entry points are held to JAX bytes stored in
convectionkernels_tpu_torch/testdata/etc_golden.npz
(tests/test_torch_goldens.py re-derives them under `-m slow`). Every
function of the slice (the lane helpers, the T, H and planar searches and
emitters, the chroma split, the punchthrough stages) is held against its
JAX counterpart run op by op on the same seeded 24-block inputs.
Tolerance 0 everywhere: float32 results are compared as int32 bits,
integers as integers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu.models import etc as jax_etc
from convectionkernels_tpu.ops import lanes as jax_lanes
from convectionkernels_tpu.options import Options as JaxOptions
from convectionkernels_tpu_torch import api
from convectionkernels_tpu_torch.models import etc
from convectionkernels_tpu_torch.ops import lanes
from convectionkernels_tpu_torch.options import Flags
from tests.test_torch_etc import blocks24
from tests.test_torch_goldens import (ETC2_ENTRIES, ETC_CASES, load_etc,
                                      load_etc_case)
from tests.test_torch_ops import assert_same, both

FAKE = Flags.DEFAULT | Flags.ETC_USE_FAKE_BT709
FLAGS = (Flags.DEFAULT, Flags.DEFAULT | Flags.UNIFORM, FAKE,
         FAKE | Flags.ETC_FAKE_BT709_ACCURATE)
FLAG_IDS = ("weighted", "uniform", "fake709", "fake709_accurate")
ETC2_CASES = [c for c in ETC_CASES if c[1] in ETC2_ENTRIES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_encode(px, entry, flags, threshold, device="cpu"):
    return getattr(ckt, f"encode_{entry}")(
        px, ckt.Options(flags=flags, threshold=threshold), device=device)


def color_modes(blocks, punchthrough=False):
    """The ETC2 mode of each 8-byte color block, from its bits: "I"
    individual (opaque blocks only), "T", "H", "P" planar or "D"
    differential."""
    b = blocks.astype(np.int32)

    def overflows(byte):
        delta = byte & 7
        value = (byte >> 3) + np.where(delta >= 4, delta - 8, delta)
        return (value < 0) | (value > 31)

    mode = np.where(overflows(b[:, 0]), "T", np.where(
        overflows(b[:, 1]), "H", np.where(overflows(b[:, 2]), "P", "D")))
    if punchthrough:
        return mode
    return np.where((b[:, 3] >> 1) & 1, mode, "I")


# --- entry points against the goldens ---------------------------------------

@pytest.mark.parametrize("case", ETC2_CASES, ids=[c[0] for c in ETC2_CASES])
def test_encode_matches_jax_golden(case):
    """Each ETC2 case through its entry point with the stored flags and
    threshold: the JAX package's op-by-op bytes, 0 mismatched blocks."""
    name, entry, _, flags, threshold = case
    px, stored_flags, blocks, _ = load_etc(name)
    assert (stored_flags, load_etc_case(name)[:2]) == (flags,
                                                       (entry, threshold))
    got = port_encode(px, entry, flags, threshold)
    assert got.dtype == torch.uint8
    assert got.shape == (len(px), 16 if entry == "etc2_rgba" else 8)
    np.testing.assert_array_equal(got.numpy(), blocks)


def test_goldens_reach_every_mode():
    """The goldens hold planar, T, H and differential blocks, read from
    their mode bits (ETC2's ETC1 stage runs the differential mode only, so
    no ETC2 block is individual); FakeBT709 reaches no T block (its T line
    errors compare RGB against YUV, as the reference's do). The
    punchthrough goldens hold transparent-capable blocks (opaque bit 0)
    and opaque ones, T and H among them, and the threshold cases differ."""
    for name in ("etc2_default", "etc2_uniform", "etc2_modes"):
        assert set(color_modes(load_etc(name)[2])) == {"P", "T", "H", "D"}, \
            name
    for name in ("etc2_fake709", "etc2_fake709_accurate"):
        assert set(color_modes(load_etc(name)[2])) == {"P", "H", "D"}, name
    assert set(color_modes(load_etc("etc2_rgba")[2][:, 8:])) >= {"T", "H",
                                                                 "D"}
    pt = load_etc("etc2_punchthrough")[2]
    assert set((pt[:, 3] >> 1) & 1) == {0, 1}
    assert {"T", "H", "D"} <= set(color_modes(pt, punchthrough=True))
    px = load_etc("etc2_punchthrough_thr0")[0]
    outs = [load_etc(f"etc2_punchthrough_{t}")[2]
            for t in ("thr0", "thr1", "thr_off_grid")]
    assert not np.array_equal(outs[0], outs[1])
    assert (outs[1][:, 3] >> 1 & 1 == 0).all()    # every pixel transparent
    assert (px[:, :, 3] == 0).any() and (px[:, :, 3] == 77).any()


def test_dispatch_matches_the_one_program_encode():
    """The port's encode_etc2_punchthrough (the split) and its
    compress_etc2(..., True) (one program) against the JAX package's
    one-program compress_etc2(..., True) bytes stored with each
    punchthrough golden, on every block where the JAX package's split and
    one-program bytes agree (where they do not, ROADMAP C logs the first
    block)."""
    compared = 0
    for name, entry, _, flags, threshold in ETC2_CASES:
        if entry != "etc2_punchthrough":
            continue
        px, _, blocks, _ = load_etc(name)
        mono = load_etc_case(name)[2]
        agree = (blocks == mono).all(axis=1)
        got = port_encode(px, entry, flags, threshold).numpy()
        np.testing.assert_array_equal(got[agree], mono[agree], name)
        one = etc.compress_etc2(torch.as_tensor(px), ckt.Options(
            flags=flags, threshold=threshold), True).numpy()
        np.testing.assert_array_equal(one, mono, name)
        compared += int(agree.sum())
    assert compared >= 150


def test_encode_chunking_is_exact(monkeypatch):
    """Chunks of 5 blocks give the bytes of one chunk, both sides of the
    punchthrough split included."""
    monkeypatch.setattr(api, "CHUNK_ETC2", 5)
    for name in ("etc2_modes", "etc2_rgba", "etc2_punchthrough"):
        px, flags, blocks, _ = load_etc(name)
        entry, threshold, _ = load_etc_case(name)
        np.testing.assert_array_equal(
            port_encode(px[:23], entry, flags, threshold).numpy(),
            blocks[:23], name)


def test_tensor_list_and_int32_inputs_give_the_same_bytes():
    for name in ("etc2_default", "etc2_rgba", "etc2_punchthrough"):
        px, flags, blocks, _ = load_etc(name)
        entry, threshold, _ = load_etc_case(name)
        px, blocks = px[:6], blocks[:6]
        for form in (torch.as_tensor(px), px.tolist(), px.astype(np.int32),
                     px[:, :, :4].astype(np.float64) + 0.5):
            np.testing.assert_array_equal(
                port_encode(form, entry, flags, threshold).numpy(), blocks,
                name)
    px = np.zeros((0, 16, 4), dtype=np.uint8)
    assert ckt.encode_etc2_punchthrough(px, device="cpu").shape == (0, 8)
    assert ckt.encode_etc2_rgba(px, device="cpu").shape == (0, 16)
    with pytest.raises(ValueError):
        ckt.encode_etc2(px[:, :8], device="cpu")


def test_device_default_is_the_card():
    """device=None means the CUDA card and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    px = np.zeros((2, 16, 4), dtype=np.uint8)
    for entry in ETC2_ENTRIES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(ckt, f"encode_{entry}")(px)


# --- lane helpers and emitters -----------------------------------------------

def test_lane_helpers():
    """div_floor against the JAX package's _div_exact_int over its range
    (numerators below 2^24, divisors below 2^13, divisor 0 giving 0); the
    ceil and floor conversions; lex_min_with_index's tuple form against
    its compare chain and the JAX package's on tie-prone values."""
    rng = np.random.default_rng(801)
    numer = rng.integers(0, 1 << 24, 1 << 16).astype(np.int32)
    div = rng.integers(0, 1 << 13, 1 << 16).astype(np.int32)
    numer[:64], div[:64] = (1 << 24) - 1, np.arange(64)
    div[64:128] = (1 << 13) - 1
    numer[128:256] = div[128:256] * rng.integers(0, 2048, 128) - \
        rng.integers(0, 2, 128)
    numer = np.clip(numer, 0, (1 << 24) - 1)
    (tn, jn), (td, jd) = both(numer), both(div)
    assert_same(lanes.div_floor(tn, td), jax_etc._div_exact_int(jn, jd))
    assert_same(lanes.div_floor(tn, td),
                np.where(div == 0, 0, numer // np.maximum(div, 1)))
    v = np.concatenate([rng.uniform(-70, 200, 4096), np.arange(-3, 4),
                        [-0.0, 0.5, -0.5, 126.99999]]).astype(np.float32)
    t, j = both(v)
    assert_same(lanes.round_up_to_int(t), jax_lanes.round_up_to_int(j))
    assert_same(lanes.round_down_to_int(t), jax_lanes.round_down_to_int(j))
    x = rng.integers(0, 4, (64, 264)).astype(np.float32)
    x[:8] = 3.0
    t, j = both(x)
    got = lanes.lex_min_with_index(t, (1,))
    for g, w in zip(got, lanes.lex_min_with_index(t, 1)):
        assert_same(g, w)
    for g, w in zip(got, jax_lanes.lex_min_with_index(j, -1)):
        assert_same(g, w)


def test_emitters():
    """The T, H and planar emitters over their fields' whole ranges: the
    H emitter's equal-colors fallback and table-LSB swap, sign bits 31."""
    rng = np.random.default_rng(811)
    n = 512

    def r(hi, shape=(n,)):
        return rng.integers(0, hi, shape).astype(np.int32)

    line, iso, table, sel = r(16, (n, 3)), r(32, (n, 3)), r(8), \
        rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    for opaque in (True, False):
        got = etc._emit_tmode(*(torch.as_tensor(a) for a in
                                (line, iso, sel, table)), opaque)
        want = jax_etc._emit_tmode([jnp.asarray(c) for c in line.T],
                                   [jnp.asarray(c) for c in iso.T],
                                   jnp.asarray(sel), jnp.asarray(table),
                                   opaque, n)
        assert_same(got[0], want[0], "t hi")
        assert_same(got[1], want[1], "t lo")
        colors = r(1 << 12, (n, 2))
        colors[: n // 4, 1] = colors[: n // 4, 0]
        sector, sign = r(1 << 16), r(1 << 16)
        got = etc._emit_hmode(*(torch.as_tensor(a) for a in
                                (colors, sector, sign, table)), opaque)
        want = jax_etc._emit_hmode(
            [jnp.asarray(c) for c in colors.T], jnp.asarray(sector),
            jnp.asarray(sign), jnp.asarray(table), opaque, n)
        assert_same(got[0], want[0], "h hi")
        assert_same(got[1], want[1], "h lo")
        assert (got[0] < 0).any() and (got[1] < 0).any()
    coeffs = np.stack([r(64, (n, 3)), r(128, (n, 3)), r(64, (n, 3))], 1)
    got = etc._emit_planar(torch.as_tensor(coeffs))
    want = jax_etc._emit_planar(
        [[jnp.asarray(coeffs[:, ch, c]) for c in range(3)]
         for ch in range(3)], n)
    assert_same(got[0], want[0], "planar hi")
    assert_same(got[1], want[1], "planar lo")
    assert (got[0] < 0).any() and (got[1] < 0).any()
    dec = etc._decode_planar_coeff(torch.as_tensor(coeffs))
    for ch in range(3):
        assert_same(dec[:, ch], jax_etc._decode_planar_coeff(
            jnp.asarray(coeffs[:, ch]), ch))


def test_resolve_th_fake_bt709():
    """The octant correction of quantized T/H colors, on the iso ([N, 3])
    and line ([N, 3, K]) shapes."""
    rng = np.random.default_rng(821)
    gran = rng.integers(0, 17, 256).astype(np.int32)
    q = rng.integers(0, 16, (256, 3, 5)).astype(np.int32)
    targets = (q * 34 + rng.integers(-17, 18, q.shape)) * gran[:, None, None]
    targets = np.maximum(targets, 0).astype(np.int32)
    for shape_q, shape_t, g in ((q, targets, gran[:, None, None]),
                                (q[:, :, 0], targets[:, :, 0],
                                 gran[:, None])):
        got = etc._resolve_th_fake_bt709(*(
            torch.as_tensor(np.ascontiguousarray(a))
            for a in (shape_q, shape_t, g)))
        want = jax_etc._resolve_th_fake_bt709(
            [jnp.asarray(shape_q[:, ch]) for ch in range(3)],
            [jnp.asarray(shape_t[:, ch]) for ch in range(3)],
            jnp.asarray(g[:, 0]))
        for ch in range(3):
            assert_same(got[:, ch], want[ch], f"channel {ch}")


# --- the searches ------------------------------------------------------------

def inputs(px, flags, threshold=None):
    """(port pixels, pw, options, transparent, num_opaque) and (JAX pixels,
    pw, options, transparent, num_opaque), transparent pixels zeroed when
    `threshold` is given (as compress_etc2_punchthrough_only zeroes
    them), None for transparency otherwise."""
    o_p = ckt.Options(flags=flags, threshold=threshold or 0.5)
    o_j = JaxOptions(flags=flags, threshold=threshold or 0.5)
    pix, pw = etc.extract_blocks(torch.as_tensor(px), o_p)
    jpix, jpw = jax_etc.extract_blocks(px, o_j)
    if threshold is None:
        return (pix, pw, o_p, None, None), (jpix, jpw, o_j, None, None)
    tr, pix, pw, num_opaque = etc._zero_transparent(torch.as_tensor(px), pix,
                                                    pw, o_p)
    thr = etc.punchthrough_threshold(threshold)
    jtr = [jnp.asarray(px[:, p, 3] < thr) for p in range(16)]
    jpix = [[jnp.where(jtr[p], 0, c) for c in jpix[p]] for p in range(16)]
    jpw = [[jnp.where(jtr[p], np.float32(0.0), c) for c in jpw[p]]
           for p in range(16)]
    jnum = 16 - sum(t.astype(jnp.int32) for t in jtr)
    assert_same(pix, np.stack([np.stack(r, -1) for r in jpix], 1))
    assert_same(pw, np.stack([np.stack(r, -1) for r in jpw], 1))
    assert_same(tr, np.stack(jtr, 1))
    assert_same(num_opaque, jnum)
    return (pix, pw, o_p, tr, num_opaque), (jpix, jpw, o_j, jtr, jnum)


def transparent_blocks(seed):
    """blocks24's shape with a random share of transparent pixels, one
    block without any and one all transparent."""
    px = blocks24(seed)
    rng = np.random.default_rng(seed + 1)
    px[:, :, 3] = np.where(rng.random((24, 16)) < rng.random((24, 1)), 0, 255)
    px[0, :, 3], px[1, :, 3] = 255, 0
    px[2, :8, 3] = 127
    return px


def stages_equal(port_fn, jax_fn, n, rank_base):
    """Run a stage function on both sides from the same entering errors
    and compare the stages."""
    start = np.linspace(0, 4000, n, dtype=np.float32)
    start[::3] = etc.FLT_MAX
    stage = etc.StageBest(n, "cpu")
    stage.error = torch.as_tensor(start)
    port_fn(stage)
    jstage = jax_etc.StageBest(n)
    jstage.error = jnp.asarray(start)
    with jax.disable_jit():
        jax_fn(jstage)
    for name in ("error", "rank", "hi", "lo"):
        assert_same(getattr(stage, name), getattr(jstage, name), name)
    updated = stage.rank == rank_base
    assert updated.any() and not updated.all()


def jax_list(t):
    """[N, 16] tensor -> the JAX functions' 16 [N] arrays."""
    return [jnp.asarray(c) for c in t.numpy().T]


@pytest.mark.parametrize("flags", FLAGS[:3], ids=FLAG_IDS[:3])
def test_encode_planar(flags):
    px = blocks24(831)
    (pix, pw, o_p, _, _), (jpix, jpw, o_j, _, _) = inputs(px, flags)
    stages_equal(lambda s: etc.encode_planar(s, 0, pix, pw, o_p),
                 lambda s: jax_etc.encode_planar(s, 0, jpix, jpw, o_j),
                 len(px), 0)


@pytest.mark.parametrize("punchthrough", [False, True])
def test_sector_assignments(punchthrough):
    """Weighted and uniform, with and without punchthrough's opaque-count
    scaling, and the chroma axes of other weights."""
    px = transparent_blocks(841) if punchthrough else blocks24(841)
    for flags in FLAGS[:3]:
        (pix, pw, o_p, _, num), (jpix, jpw, o_j, jtr, jnum) = inputs(
            px, flags, 0.5 if punchthrough else None)
        got = etc._sector_assignments(pix, pw, o_p, num)
        with jax.disable_jit():
            want = jax_etc._sector_assignments(
                jpix, jpw, o_j, jtr, jnum if punchthrough else None,
                punchthrough)
        assert_same(got, np.stack(want, 1), hex(flags))
        assert got.any() and not got.all()
    o = ckt.Options(red_weight=0.7, green_weight=0.2, blue_weight=1.3)
    jo = JaxOptions(red_weight=0.7, green_weight=0.2, blue_weight=1.3)
    for p, j in zip(etc.chroma_side_axes(o), jax_etc.chroma_side_axes(jo)):
        assert_same(np.float32(p), np.float32(j))


@pytest.mark.parametrize("flags", FLAGS[:3], ids=FLAG_IDS[:3])
def test_encode_tmode_and_hmode(flags):
    """Both T stages and the H stage of compress_etc2 on its own sector
    split."""
    px = blocks24(851)
    (pix, pw, o_p, _, _), (jpix, jpw, o_j, _, _) = inputs(px, flags)
    sectors = etc._sector_assignments(pix, pw, o_p)
    for rank, split in ((1, sectors), (2, ~sectors)):
        stages_equal(
            lambda s: etc.encode_tmode(s, rank, split, pix, pw, o_p),
            lambda s: jax_etc.encode_tmode(s, rank, jax_list(split), jpix,
                                           jpw, o_j), len(px), rank)
    stages_equal(
        lambda s: etc.encode_hmode(s, 3, ~sectors, pix, pw, o_p),
        lambda s: jax_etc.encode_hmode(s, 3, jax_list(~sectors), jpix, jpw,
                                       o_j), len(px), 3)


@pytest.mark.parametrize("flags", FLAGS[:3], ids=FLAG_IDS[:3])
def test_punchthrough_stages(flags):
    """The virtual T mode on both splits and punchthrough ETC1 (with its
    half-block scan) on blocks with transparent pixels, then
    compress_etc2_punchthrough_only as a whole."""
    px = transparent_blocks(861)
    (pix, pw, o_p, tr, num), (jpix, jpw, o_j, jtr, _) = inputs(px, flags,
                                                               0.5)
    sectors = etc._sector_assignments(pix, pw, o_p, num)
    for rank, split in ((10, sectors), (11, ~sectors)):
        stages_equal(
            lambda s: etc.encode_virtual_tmode_punchthrough(
                s, rank, split, pix, pw, tr, o_p),
            lambda s: jax_etc.encode_virtual_tmode_punchthrough(
                s, rank, jax_list(split), jpix, jpw, jtr, o_j), len(px),
            rank)
    stages_equal(
        lambda s: etc.compress_etc1_punchthrough(s, 12, pix, pw, tr, o_p),
        lambda s: jax_etc.compress_etc1_punchthrough(s, 12, jpix, jpw, jtr,
                                                     o_j), len(px), 12)
    got = etc.compress_etc2_punchthrough_only(torch.as_tensor(px), o_p)
    with jax.disable_jit():
        want = jax_etc.compress_etc2_punchthrough_only(px, o_j)
    assert_same(got, want)


def test_test_half_block_punchthrough():
    """Random packed colors on the 136-wide axis, a sector with transparent
    pixels (selector 1, error 0)."""
    px = transparent_blocks(871)
    (pix, pw, o_p, tr, _), (jpix, jpw, o_j, jtr, _) = inputs(
        px, Flags.DEFAULT, 0.5)
    rng = np.random.default_rng(873)
    packed = rng.integers(0, 1 << 15, (24, 136)).astype(np.int32)
    mod_k = np.repeat(etc.PUNCHTHROUGH_MODIFIERS, 17)
    src = [int(s) for s in etc.FLIP_TABLES[0][1]]
    idx = torch.as_tensor(etc.FLIP_TABLES[0][1])
    got = etc._test_half_block_punchthrough(
        torch.as_tensor(packed), pw.index_select(1, idx),
        tr.index_select(1, idx), torch.as_tensor(mod_k), o_p)
    with jax.disable_jit():
        want = jax_etc._test_half_block_punchthrough(
            jnp.asarray(packed), [jpix[s] for s in src], [jpw[s] for s in src],
            [jtr[s] for s in src], jnp.asarray(mod_k)[None, :], o_j)
    assert_same(got[0], want[0], "error")
    assert_same(got[1], want[1], "selectors")
