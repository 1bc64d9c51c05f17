"""The port's ETC slice (ETC1, ETC2 alpha, EAC11) on the CPU against the JAX
package.

encode_etc1, encode_etc2_alpha and encode_eac11 are held to JAX bytes
stored in convectionkernels_tpu_torch/testdata/etc_golden.npz (the JAX
package's op-by-op ETC1 takes tens of seconds for 64 blocks on a CPU;
tests/test_torch_goldens.py re-derives the stored bytes under `-m slow`).
The tables, the ETC1 candidate sets, the half-block error scans, the
FakeBT709 quantizer, the alpha search and the ETC1 emitter are held
against the JAX package's functions run op by op on the same seeded
inputs, and the differential resolve against the sequential transcription
of the reference scan in tests/test_etc_resolve_semantics.py. Tolerance 0
everywhere: float32 results are compared as int32 bits, integers as
integers.
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
from convectionkernels_tpu.tables import etc_tables as jax_tables
from convectionkernels_tpu_torch import api
from convectionkernels_tpu_torch.models import etc
from convectionkernels_tpu_torch.ops import lanes
from convectionkernels_tpu_torch.options import Flags
from convectionkernels_tpu_torch.tables import etc_tables
from tests import blockgen
from tests import test_etc_resolve_semantics as seq
from tests.test_torch_goldens import (ETC2_ENTRIES, ETC_CASES,
                                      ETC_NOT_JITTED, eac_blocks, load_etc)
from tests.test_torch_ops import assert_same, both

FAKE = Flags.DEFAULT | Flags.ETC_USE_FAKE_BT709
ERROR_FLAGS = (Flags.DEFAULT, Flags.DEFAULT | Flags.UNIFORM, FAKE)
ERROR_IDS = ("weighted", "uniform", "fake709")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_encode(px, entry, flags, device="cpu"):
    if entry.startswith("eac11"):
        return ckt.encode_eac11(px, signed=entry == "eac11s", device=device)
    return getattr(ckt, f"encode_{entry}")(px, ckt.Options(flags=flags),
                                           device=device)


def blocks24(seed):
    """24 blocks: random, gradient, flat and alpha, six of each (the
    shape of the op-by-op runs of test_inputs_jax_accepts_give_its_bytes,
    whose compiled JAX ops the other tests then reuse)."""
    return blockgen.mixed_blocks(32, seed)[np.arange(32) % 4 != 3]


# --- entry points against the goldens ------------------------------------------

# the cases of this slice's entry points (tests/test_torch_etc2.py holds the
# ETC2 color ones)
ETC1_CASES = [c for c in ETC_CASES if c[1] not in ETC2_ENTRIES]


@pytest.mark.parametrize("case", ETC1_CASES, ids=[c[0] for c in ETC1_CASES])
def test_encode_matches_jax_golden(case):
    """Every entry point: ETC1 weighted, uniform, FakeBT709 fast and
    accurate, on tie-prone blocks; ETC2 alpha; EAC11 unsigned and signed
    past their clamps."""
    name, entry, _, flags, _ = case
    px, stored_flags, blocks, _ = load_etc(name)
    assert stored_flags == flags
    got = port_encode(px, entry, flags)
    assert got.dtype == torch.uint8 and got.shape == (len(px), 8)
    np.testing.assert_array_equal(got.numpy(), blocks)


def test_goldens_reach_every_path():
    """The ETC1 goldens hold both flips and both modes (individual and
    differential), every table and differ between options; the alpha and
    EAC goldens several tables and multipliers, and the EAC inputs pass
    their clamps."""
    for name in ("etc1_default", "etc1_uniform", "etc1_fake709",
                 "etc1_fake709_accurate"):
        blocks = load_etc(name)[2]
        flip, diff = blocks[:, 3] & 1, (blocks[:, 3] >> 1) & 1
        assert set(flip.tolist()) == {0, 1}, name
        assert set(diff.tolist()) == {0, 1}, name
        assert len(set((blocks[:, 3] >> 5).tolist())) >= 6, name
        if name != "etc1_default":
            assert not np.array_equal(load_etc("etc1_default")[2], blocks)
    for name in ("etc2_alpha", "eac_r11", "eac_r11s"):
        blocks = load_etc(name)[2]
        assert len(set((blocks[:, 1] & 15).tolist())) >= 4, name
        assert len(set((blocks[:, 1] >> 4).tolist())) >= 3, name
    for name, lo, hi in (("eac_r11", 0, 2047), ("eac_r11s", -1024, 1023)):
        px = load_etc(name)[0]
        assert (px < lo).any() and (px > hi).any(), name


def test_jitted_goldens_equal_op_by_op():
    """The JAX package's jitted encoders give its op-by-op bytes in every
    case (the port is held to the op-by-op bytes)."""
    for name, *_ in ETC_CASES:
        _, _, blocks, api_blocks = load_etc(name)
        assert (api_blocks is None) == (name in ETC_NOT_JITTED), name
        if api_blocks is not None:
            np.testing.assert_array_equal(api_blocks, blocks, name)


def test_encode_chunking_is_exact(monkeypatch):
    """Chunks of 5 blocks give the bytes of one chunk."""
    monkeypatch.setattr(api, "CHUNK_ETC", 5)
    monkeypatch.setattr(api, "CHUNK_EAC", 5)
    for name, entry in (("etc1_fake709", "etc1"), ("etc1_default", "etc1"),
                        ("etc2_alpha", "etc2_alpha"), ("eac_r11s", "eac11s")):
        px, flags, blocks, _ = load_etc(name)
        np.testing.assert_array_equal(
            port_encode(px[:23], entry, flags).numpy(), blocks[:23], name)


def test_tensor_list_and_int32_inputs_give_the_same_bytes():
    px, flags, blocks, _ = load_etc("etc1_default")
    px = px[:6]
    for form in (torch.as_tensor(px), px.tolist(), px.astype(np.int32),
                 torch.as_tensor(px.astype(np.int32))):
        np.testing.assert_array_equal(
            port_encode(form, "etc1", flags).numpy(), blocks[:6])
    px, _, blocks, _ = load_etc("eac_r11")
    for form in (torch.as_tensor(px), px.tolist(), px.astype(np.int32)):
        np.testing.assert_array_equal(port_encode(form, "eac11", 0).numpy(),
                                      blocks)


def test_device_default_is_the_card():
    """device=None means the CUDA card and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    px = np.zeros((2, 16, 4), dtype=np.uint8)
    for call in (lambda: ckt.encode_etc1(px),
                 lambda: ckt.encode_etc2_alpha(px),
                 lambda: ckt.encode_eac11(px[:, :, 0].astype(np.int16),
                                          signed=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_inputs_jax_accepts_give_its_bytes():
    """[N, 16, C] for C = 1..5 (JAX reads a missing channel as the last
    one), int32 values that wrap, float values that truncate: the JAX
    entry points' cast and check, then their models run op by op."""
    from convectionkernels_tpu import api as jax_api
    base = blocks24(621)[::6]
    rng = np.random.default_rng(623)
    cases = [base[:, :, :c] for c in (1, 2, 3)]
    cases += [np.concatenate([base, base[:, :, :1]], axis=2),
              base.astype(np.int32) + 256 * rng.integers(-2, 3, base.shape),
              base.astype(np.float32) + np.float32(0.75)]
    o = JaxOptions()
    arrs = [jax_api._as_block_array(px) for px in cases]
    for px, arr in zip(cases, arrs):
        with jax.disable_jit():
            want = np.asarray(jax_etc.compress_etc2_alpha(arr, o))
        np.testing.assert_array_equal(
            ckt.encode_etc2_alpha(px, device="cpu").numpy(), want)
    # one ETC1 run for all cases: the channels compress_etc1 reads, taken
    # with its own static indexing, side by side
    arr = jnp.concatenate([jnp.stack([a[:, :, ch] for ch in range(4)], -1)
                           for a in arrs])
    with jax.disable_jit():
        want = np.asarray(jax_etc.compress_etc1(arr, o))
    got = torch.cat([ckt.encode_etc1(px, device="cpu") for px in cases])
    np.testing.assert_array_equal(got.numpy(), want)
    values = eac_blocks(8, seed=625, signed=True)[:4].astype(np.int32)
    values[1] += 65536                                  # wraps to itself
    # JAX casts EAC11 input without a check, so [N, 8] and [N, 20] encode,
    # the pixel index clamped by its static indexing
    wide = np.concatenate([values, values[:, :4] + 7], axis=1)
    for px in (values, values.astype(np.float64) - 0.5, values[:, :8],
               wide):
        with jax.disable_jit():
            want = np.asarray(jax_etc.compress_eac11(
                jnp.asarray(px, dtype=jnp.int16), True, o))
        np.testing.assert_array_equal(
            ckt.encode_eac11(px, signed=True, device="cpu").numpy(), want)


def test_tensors_cast_as_numpy():
    """A tensor of another dtype is converted as the JAX entry points
    convert it (jnp.asarray calls np.asarray): floats truncate through
    int32 (NaN, infinities and values outside int32 give INT32_MIN),
    integers wrap; the card's counterpart is in test_torch_cuda.py."""
    f = torch.tensor([-1.5, 300.7, 255.9, 3.7, -0.5, float("nan"), 1e10,
                      -1e10, 3e9, 2.0**31 + 256, 70000.5, float("inf"),
                      -float("inf"), 2.0**31 - 0.5])
    i = torch.tensor([-1, 300, 255, -129, 70000, 2**40 + 5])
    for t in (f, f.double(), f.half(), i, i.int(), i > 0):
        for dtype, jnp_dtype in ((torch.uint8, jnp.uint8),
                                 (torch.int8, jnp.int8),
                                 (torch.int16, jnp.int16)):
            got = api._cast(t, dtype)
            assert got.dtype == dtype
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jnp.asarray(t.numpy(), jnp_dtype)))


def test_inputs_jax_refuses_are_refused():
    """A wrong rank or a second axis other than 16 raises, as in JAX; so
    does a list value that does not fit the entry point's dtype. EAC11
    refuses a rank other than 2 and a second axis of 0, as the JAX entry
    point does (test_eac11_bad_ranks_raise_in_both)."""
    from convectionkernels_tpu import api as jax_api
    px = np.zeros((2, 16, 4), dtype=np.uint8)
    for bad in (px[:, :, 0], px[:, :8], px[:, :, :0]):
        with pytest.raises((ValueError, IndexError)):
            jax_etc.compress_etc1(jax_api._as_block_array(bad), JaxOptions())
        with pytest.raises(ValueError):
            ckt.encode_etc1(bad, device="cpu")
    with pytest.raises(OverflowError):
        jax_api._as_block_array([[[300] * 4] * 16])
    with pytest.raises(OverflowError):
        ckt.encode_etc1([[[300] * 4] * 16], device="cpu")
    for bad in (px.astype(np.int16), px[:, :0, 0].astype(np.int16)):
        with pytest.raises(ValueError):
            ckt.encode_eac11(bad, device="cpu")
    assert ckt.encode_eac11(px[:0, :, 0], device="cpu").shape == (0, 8)
    assert ckt.encode_etc1(px[:0], device="cpu").shape == (0, 8)


def test_eac11_bad_ranks_raise_in_both():
    """[N, 16, 1] and [N, 0] int16: the JAX entry point raises (TypeError
    while it traces [N, 16, 1], IndexError on [N, 0]) and so does the
    port's (ValueError)."""
    from convectionkernels_tpu import api as jax_api
    for bad, jax_error in ((np.zeros((4, 16, 1), np.int16), TypeError),
                           (np.zeros((4, 0), np.int16), IndexError)):
        with pytest.raises(jax_error):
            jax_api.encode_eac11(bad)
        with pytest.raises(ValueError):
            ckt.encode_eac11(bad, device="cpu")


# --- tables and helpers --------------------------------------------------------

def test_tables_match_jax():
    for name in ("ETC1_MODIFIER_TABLES", "TH_MODIFIER_TABLE",
                 "ALPHA_MODIFIER_TABLE_POSITIVE"):
        np.testing.assert_array_equal(getattr(etc_tables, name),
                                      getattr(jax_tables, name), name)
    assert etc_tables.MAX_POTENTIAL_OFFSETS == \
        jax_tables.MAX_POTENTIAL_OFFSETS
    assert etc_tables.ALPHA_ROUNDING_TABLE_WIDTH == \
        jax_tables.ALPHA_ROUNDING_TABLE_WIDTH
    for t in range(8):
        np.testing.assert_array_equal(etc_tables.potential_offsets(t),
                                      jax_tables.potential_offsets(t))
    np.testing.assert_array_equal(etc_tables.alpha_rounding_tables(),
                                  jax_tables.alpha_rounding_tables())
    np.testing.assert_array_equal(etc_tables.fake_bt709_rounding16(),
                                  jax_tables.fake_bt709_rounding16())
    for name in ("FLIP_TABLES", "PIXEL_SELECTOR_ORDER", "MODIFIER_CODES"):
        np.testing.assert_array_equal(getattr(etc, name),
                                      getattr(jax_etc, name), name)
    assert etc.ETC1_RUN_BOUNDS == jax_etc.ETC1_RUN_BOUNDS
    for diff in (True, False):
        for p, j in zip(etc._slot_layout(diff), jax_etc._slot_layout(diff)):
            np.testing.assert_array_equal(p, j)
        cu = np.arange(0, 2041, dtype=np.int32)
        t, jv = both(cu)
        assert_same(etc._quantize_etc1_base(t, diff),
                    jax_etc._quantize_etc1_base(jv, diff))
    for p, j in zip(etc._padded_offsets(), jax_etc._padded_offsets()):
        np.testing.assert_array_equal(p, j)


def test_take_winner():
    rng = np.random.default_rng(631)
    x = rng.uniform(0, 9, (40, 17)).astype(np.float32)
    x[:, 3] = np.inf
    win = rng.integers(0, 17, 40).astype(np.int32)
    win[:4] = 3
    (tx, jx), (tw, jw) = both(x), both(win)
    assert_same(lanes.take_winner(tx, tw), jax_lanes.take_winner(jx, jw))
    xi = rng.integers(-2**31, 2**31, (17, 40), dtype=np.int64).astype(
        np.int32)
    (ti, ji) = both(xi)
    assert_same(lanes.take_winner_t(ti, tw), jax_lanes.take_winner_t(ji, jw))
    b = ti > 0
    assert_same(lanes.take_winner(b.T.contiguous(), tw),
                jax_lanes.take_winner(jnp.asarray(b.numpy().T), jw))


@pytest.mark.parametrize("flags", ERROR_FLAGS, ids=ERROR_IDS)
def test_extract_blocks_and_compute_error(flags):
    px = blocks24(641)
    o_p, o_j = ckt.Options(flags=flags), JaxOptions(flags=flags)
    pix, pw = etc.extract_blocks(torch.as_tensor(px), o_p)
    jpix, jpw = jax_etc.extract_blocks(px, o_j)
    assert pix.dtype == torch.int32 and pw.dtype == torch.float32
    assert_same(pix, np.stack([np.stack(r, -1) for r in jpix], 1))
    assert_same(pw, np.stack([np.stack(r, -1) for r in jpw], 1))
    rng = np.random.default_rng(643)
    recon = rng.integers(0, 256, (24, 3, 4, 16)).astype(np.int32)
    got = etc.compute_error(torch.as_tensor(recon)[..., None],
                            pw.transpose(1, 2)[:, :, None, :, None], o_p)
    want = jax_etc.compute_error(
        [jnp.asarray(recon[:, ch])[..., None] for ch in range(3)],
        [jnp.stack([jpix[p][ch] for p in range(16)], 1)[:, None, :, None]
         for ch in range(3)],
        [jnp.stack([jpw[p][ch] for p in range(16)], 1)[:, None, :, None]
         for ch in range(3)], o_j)
    assert_same(got, want)


def test_fake_bt709_conversions():
    rng = np.random.default_rng(651)
    rgb = rng.uniform(-300, 2100, (3, 4096)).astype(np.float32)
    rgb[:, :256] = rng.integers(0, 256, (3, 256))
    t = torch.as_tensor(rgb.T.copy())[:, :, None]          # [N, 3, 1]
    j = [jnp.asarray(c) for c in rgb]
    for port_fn, jax_fn in ((etc.convert_to_fake_bt709,
                             jax_etc.convert_to_fake_bt709),
                            (etc.convert_from_fake_bt709,
                             jax_etc.convert_from_fake_bt709)):
        got = port_fn(t)
        want = jax_fn(j)
        for ch in range(3):
            assert_same(got[:, ch, 0], want[ch], f"{port_fn.__name__} {ch}")


def test_stage_best_and_bytes():
    """The (error, rank) update keeps the earlier rank on equal errors,
    and to_bytes writes words whose bit 31 is set."""
    rng = np.random.default_rng(661)
    n = 64
    p, j = etc.StageBest(n, "cpu"), jax_etc.StageBest(n)
    for rank in (3, 1, 2, 0):
        err = rng.integers(0, 3, n).astype(np.float32)
        hi = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        lo = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        valid = rng.random(n) < 0.8
        for obj, cast in ((p, torch.as_tensor), (j, jnp.asarray)):
            obj.update(cast(err), rank, cast(hi), cast(lo), cast(valid))
    for name in ("error", "rank", "hi", "lo"):
        assert_same(getattr(p, name), getattr(j, name), name)
    assert (p.hi < 0).any()
    assert_same(p.to_bytes(), j.to_bytes())
    mask = rng.random(n) < 0.5
    p.reset_where(torch.as_tensor(mask))
    j.reset_where(jnp.asarray(mask))
    p.lane_mask, j.lane_mask = torch.as_tensor(~mask), jnp.asarray(~mask)
    for obj, cast in ((p, torch.as_tensor), (j, jnp.asarray)):
        obj.update(cast(np.ones(n, np.float32)), 5, cast(lo), cast(hi))
    for name in ("error", "rank", "hi", "lo"):
        assert_same(getattr(p, name), getattr(j, name), name)


# --- the ETC1 search -----------------------------------------------------------

def sector_inputs(px, flags, flip, sector):
    """One sector's pixels, preweighted pixels and channel sums, both
    sides."""
    o_p, o_j = ckt.Options(flags=flags), JaxOptions(flags=flags)
    pix, pw = etc.extract_blocks(torch.as_tensor(px), o_p)
    spw, cum = etc._sector_data(pix, pw, flip)[sector]
    jpix, jpw = jax_etc.extract_blocks(px, o_j)
    src = [int(s) for s in etc.FLIP_TABLES[flip][sector]]
    jsp = [jpix[s] for s in src]
    jspw = [jpw[s] for s in src]
    jcum = [sum(jpix[s][ch] for s in src) for ch in range(3)]
    return (spw, cum, o_p), (jsp, jspw, jcum, o_j)


@pytest.mark.parametrize("flags", ERROR_FLAGS[:2], ids=ERROR_IDS[:2])
@pytest.mark.parametrize("differential", [True, False])
def test_etc1_candidates_dedup(flags, differential):
    px = blocks24(671)
    (spw, cum, o_p), (jsp, jspw, jcum, o_j) = sector_inputs(
        px, flags, 0, 1)
    got = etc._etc1_candidates_dedup(cum, spw, differential, o_p)
    with jax.disable_jit():
        want = jax_etc._etc1_candidates_dedup(jcum, jsp, jspw, differential,
                                              o_j)
    for g, w, what in zip(got, want, ("error", "color", "selectors",
                                      "table")):
        assert_same(g, w, what)


@pytest.mark.parametrize("flags", ERROR_FLAGS, ids=ERROR_IDS)
def test_test_half_block_flat(flags):
    """Random packed colors on the slot axis, per-slot modifier rows."""
    px = blocks24(681)
    (spw, _, o_p), (jsp, jspw, _, o_j) = sector_inputs(px, flags, 1, 0)
    rng = np.random.default_rng(683)
    _, _, mods_a = etc._slot_layout(True)
    packed = rng.integers(0, 1 << 15, (24, len(mods_a))).astype(np.int32)
    tp, jp = both(packed)
    for diff in (True, False):
        got = etc._test_half_block_flat(tp, spw, mods_a, diff, o_p)
        with jax.disable_jit():
            want = jax_etc._test_half_block_flat(jp, jsp, jspw, mods_a, diff,
                                                 o_j)
        assert_same(got[0], want[0], "error")
        assert_same(got[1], want[1], "selectors")


@pytest.mark.parametrize("accurate", [False, True])
def test_fake_bt709_candidates(accurate):
    """The FakeBT709 dense axis: the octant-corrected quantizer over every
    cum value and the dense half-block scan and unique ranks on one
    sector's candidates."""
    cu = np.arange(0, 2041, dtype=np.int32)
    cu3 = np.stack([cu, cu[::-1].copy(), (cu * 7) % 2041], 0)
    for diff in (True, False):
        got = etc._resolve_fake_bt709_rounding(
            [torch.as_tensor(c) for c in cu3], diff, accurate)
        with jax.disable_jit():
            want = jax_etc._resolve_fake_bt709_rounding(
                [jnp.asarray(c) for c in cu3], diff, accurate)
        for ch in range(3):
            assert_same(got[ch], want[ch], f"channel {ch}")
    flags = FAKE | (Flags.ETC_FAKE_BT709_ACCURATE if accurate else 0)
    px = blocks24(691)
    (spw, cum, o_p), (jsp, jspw, jcum, o_j) = sector_inputs(
        px, flags, 0, 0)
    packed = etc._candidate_colors(
        cum, lambda c: etc._resolve_fake_bt709_rounding(c.unbind(1), True,
                                                        accurate))
    mods = np.asarray(etc_tables.ETC1_MODIFIER_TABLES)
    got = etc._test_half_block(packed, spw, mods, True, o_p)
    with jax.disable_jit():
        want = jax_etc._test_half_block(jnp.asarray(packed.numpy()), jsp,
                                        jspw, mods, True, o_j)
        want_rank = jax_etc._unique_rank(
            jnp.asarray(packed.reshape(24, -1).numpy()), 8, 81)
    assert_same(got[0], want[0], "error")
    assert_same(got[1], want[1], "selectors")
    assert_same(etc._unique_rank(packed.reshape(24, -1), 8, 81), want_rank)


@pytest.mark.parametrize("flip", [0, 1])
@pytest.mark.parametrize("d", [0, 1])
def test_emit_etc1(flip, d):
    """Colors whose differential delta is negative (the & 7), tables and
    selectors over their whole ranges, opaque and transparent."""
    rng = np.random.default_rng(701 + 2 * flip + d)
    n = 256
    bits = 5 if d else 4
    win = []
    for sector in range(2):
        c = rng.integers(0, 1 << bits, (n, 3))
        win.append(dict(
            color=(c[:, 0] | (c[:, 1] << 5) | (c[:, 2] << 10)).astype(
                np.int32),
            selectors=rng.integers(0, 1 << 16, n).astype(np.int32),
            table=rng.integers(0, 8, n).astype(np.int32)))
    for transparent in (False, True):
        got = etc._emit_etc1(flip, d, [{k: torch.as_tensor(v)
                                        for k, v in w.items()} for w in win],
                             n, transparent)
        want = jax_etc._emit_etc1(flip, d, [{k: jnp.asarray(v)
                                             for k, v in w.items()}
                                            for w in win], n, transparent)
        assert_same(got[0], want[0], "hi")
        assert_same(got[1], want[1], "lo")
        assert (got[0] < 0).any() and (got[1] < 0).any()


def test_compress_etc1_internal_punchthrough_min_d():
    """The differential-only pass (A.10c's punchthrough ETC1 passes
    punchthrough_min_d=True) after a stage that holds other winners."""
    px = blocks24(721)
    o_p, o_j = ckt.Options(), JaxOptions()
    pix, pw = etc.extract_blocks(torch.as_tensor(px), o_p)
    n = len(px)
    start = np.linspace(0, 3000, n, dtype=np.float32)
    stage = etc.StageBest(n, "cpu")
    stage.error = torch.as_tensor(start)
    etc.compress_etc1_internal(stage, 4, pix, pw, o_p, True)
    jpix, jpw = jax_etc.extract_blocks(px, o_j)
    jstage = jax_etc.StageBest(n)
    jstage.error = jnp.asarray(start)
    with jax.disable_jit():
        jax_etc.compress_etc1_internal(jstage, 4, jpix, jpw, o_j, True)
    for name in ("error", "rank", "hi", "lo"):
        assert_same(getattr(stage, name), getattr(jstage, name), name)
    assert len(set(stage.rank.tolist())) > 1


def test_resolve_differential_matches_jax():
    """The resolve on real candidate sets, with and without can_ignore
    (A.10c's punchthrough passes it), against the JAX package's."""
    px = blocks24(731)
    o_p, o_j = ckt.Options(), JaxOptions()
    data_p, data_j = [], []
    for sector in range(2):
        (spw, cum, _), _ = sector_inputs(px, Flags.DEFAULT, 1, sector)
        e, c, sel, t = etc._etc1_candidates_dedup(cum, spw, True, o_p)
        kb = etc.ETC1_RUN_BOUNDS[True]
        rows = tuple((int(a), int(a + k))
                     for a, k in zip(np.cumsum((0,) + kb[:-1]), kb))
        urank = torch.arange(e.shape[1], dtype=torch.int32).expand(24, -1)
        data_p.append(dict(error=e, color=c, selectors=sel, table=t,
                           urank=urank, row_chunks=rows))
        data_j.append({k: (v if k == "row_chunks" else jnp.asarray(v.numpy()))
                       for k, v in data_p[-1].items()})
    best_in = np.tile(np.float32([1e9, 50, 200, 0, 1e4, 300, 3e3, 100]), 3)
    rng = np.random.default_rng(733)
    for ignore in (None, rng.random((2, 24)) < 0.4):
        got = etc._resolve_differential(
            data_p, 24, torch.as_tensor(best_in),
            None if ignore is None else [torch.as_tensor(m) for m in ignore])
        with jax.disable_jit():
            want = jax_etc._resolve_differential(
                data_j, 24, jnp.asarray(best_in),
                None if ignore is None else [jnp.asarray(m) for m in ignore])
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert_same(g[k], w[k], k)


def padded_attempts(blocks):
    """gen_attempts of each flip-0 sector of each block, padded to one slot
    axis with INF errors (empty slots), as [N, A] arrays."""
    att = [[seq.gen_attempts(b[seq.FLIP0[s]]) for s in range(2)]
           for b in blocks]
    a = max(len(x[0]) for pair in att for x in pair)
    out = []
    for s in range(2):
        e = np.full((len(blocks), a), np.inf, np.float32)
        c = np.zeros((len(blocks), a), np.int32)
        t = np.zeros((len(blocks), a), np.int32)
        for i, pair in enumerate(att):
            k = len(pair[s][0])
            e[i, :k], c[i, :k], t[i, :k] = pair[s]
        out.append((e, c, t))
    return att, out


def test_resolve_differential_matches_sequential_scan():
    """The port's resolve commits the sequential scan's pair (colors,
    tables and the f32 total) on the tie-prone corpora of
    tests/test_etc_resolve_semantics.py (two-color, grayish and midrange
    noise blocks), or no pair below best_in where the scan commits none;
    CORPUS_BLOCK_9 takes the re-acceptance."""
    rng = np.random.default_rng(2026)
    blocks = []
    for _ in range(12):
        pal = rng.integers(0, 256, (2, 3))
        blocks.append(pal[rng.integers(0, 2, 16)].astype(np.uint8))
    for _ in range(12):
        g = rng.integers(0, 256, (16, 1))
        blocks.append(np.clip(g + rng.integers(-3, 4, (16, 3)),
                              0, 255).astype(np.uint8))
    for _ in range(12):
        base = rng.integers(100, 140, (1, 3))
        blocks.append(np.clip(base + rng.integers(-40, 41, (16, 3)),
                              0, 255).astype(np.uint8))
    # every other block of each corpus: the reference's attempts are
    # generated in Python, 0.3 s a block
    blocks = [seq.CORPUS_BLOCK_9] + blocks[::2]
    att, ((e0, c0, t0), (e1, c1, t1)) = padded_attempts(blocks)
    best_in = np.float32([np.float32(np.float32(x[0][0].min() + x[1][0].min())
                                     * np.float32(1.5) + np.float32(1.0))
                          for x in att])
    best_in[0] = np.float32(81.27302)  # the individual total of block 9
    n, a = e0.shape
    urank = torch.arange(a, dtype=torch.int32).expand(n, -1)
    bounds = np.flatnonzero(np.diff(t0[0])) + 1
    rows = tuple(zip([0, *bounds], [*bounds, a]))
    diff_data = [dict(error=torch.as_tensor(e), color=torch.as_tensor(c),
                      selectors=torch.zeros((n, a), dtype=torch.int32),
                      table=torch.as_tensor(t), urank=urank, row_chunks=rows)
                 for e, c, t in ((e0, c0, t0), (e1, c1, t1))]
    win = etc._resolve_differential(diff_data, n, torch.as_tensor(best_in))
    fired = 0
    for i in range(n):
        (ea, ca, ta), (eb, cb, tb) = att[i]
        want = seq.sequential_scan(ea, ca, eb, cb, best_in[i])
        total = np.float32(win[0]["total"][i])
        if want is None:
            assert not total < best_in[i], i
            continue
        wi, wj, wt = want
        assert (int(win[0]["color"][i]), int(win[0]["table"][i]),
                int(win[1]["color"][i]), int(win[1]["table"][i])) == \
            (int(ca[wi]), int(ta[wi]), int(cb[wj]), int(tb[wj])), i
        assert total.view(np.int32) == np.float32(wt).view(np.int32), i
        fired += 1
    assert fired >= n // 2
    assert int(win[0]["table"][0]) == 3, "re-acceptance must commit table 3"


# --- ETC2 alpha and EAC11 ------------------------------------------------------

@pytest.mark.parametrize("mode", ["alpha8", "eac_unsigned", "eac_signed"])
def test_compress_alpha_internal(mode):
    """The 320-candidate search on values that reach its edges: flat,
    narrow and wide blocks, and the clamps' limits."""
    rng = np.random.default_rng(711)
    if mode == "alpha8":
        v = blockgen.alpha_blocks(16, seed=713)[:, :, 3].astype(np.int32)
        v[0], v[1] = 0, 255
        v[2] = np.tile([0, 255], 8)
        args = (False, False)
    else:
        signed = mode == "eac_signed"
        raw = eac_blocks(16, seed=715, signed=signed).astype(np.int32)
        if signed:
            v = np.maximum(1, np.minimum(raw, 1023) + 1024)
        else:
            v = np.clip(raw, 0, 2047)
        v[3] = rng.integers(0, 2048, 16)
        args = (True, signed)
    got = etc._compress_alpha_internal(torch.as_tensor(v), *args)
    with jax.disable_jit():
        want = jax_etc._compress_alpha_internal(
            [jnp.asarray(v[:, p]) for p in range(16)], *args)
    assert_same(got, want)
