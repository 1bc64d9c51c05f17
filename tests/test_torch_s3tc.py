"""The port's S3TC slice (BC1-BC5) on the CPU against the JAX package.

encode_bc1 ... encode_bc5s are held to JAX bytes stored in
convectionkernels_tpu_torch/testdata/s3tc_golden.npz (a cold JAX compile
of one configuration takes minutes; tests/test_torch_goldens.py re-derives
the stored bytes under `-m slow`). The tables, the helpers, the packers and
pack_rgb / pack_interpolated_alpha are held against the JAX package's
functions run op by op on the same seeded inputs. Tolerance 0 everywhere:
float32 results are compared as int32 bits, integers as integers.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu.models import s3tc as jax_s3tc
from convectionkernels_tpu.ops import index_select as jax_index
from convectionkernels_tpu.tables import s3tc_single_color as jax_tables
from convectionkernels_tpu_torch import api, cuda_lib
from convectionkernels_tpu_torch.models import s3tc
from convectionkernels_tpu_torch.ops import index_select, lanes
from convectionkernels_tpu_torch.ops.refine import EndpointRefiner
from convectionkernels_tpu_torch.options import Flags
from convectionkernels_tpu_torch.tables import s3tc_single_color
from tests import blockgen, scalar_emu
from tests.test_torch_goldens import (S3TC_CASES, S3TC_NOT_JITTED,
                                      alpha_blocks_with_edges,
                                      alpha_edge_values, clipping_outcome,
                                      jax_s3tc_op_by_op, load_s3tc,
                                      signed_blocks)
from tests.test_torch_ops import assert_lists_same, assert_same, both

CW = [np.float32(w) for w in ckt.Options().channel_weights()]
CW_SQ = [w * w for w in CW]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores, where the intra-op threads of
    several workers oversubscribe them (a 64-block exhaustive encode took
    0.12 s on one thread and 12 s on eight beside a busy neighbour)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_encode(px, fmt, fields):
    return getattr(ckt, f"encode_{fmt}")(px, ckt.Options(**fields),
                                         device="cpu")


@pytest.mark.parametrize("case", S3TC_CASES, ids=[c[0] for c in S3TC_CASES])
def test_encode_matches_jax_golden(case):
    """Every entry point: paranoid and not, uniform weights, exhaustive
    with and without the paranoid error, the alpha test at another
    threshold, fewer rounds, signed input with its edge values."""
    name, fmt, _, fields = case
    px, blocks, _ = load_s3tc(name)
    got = port_encode(px, fmt, fields)
    width = 16 if fmt in ("bc2", "bc3", "bc5u", "bc5s") else 8
    assert got.dtype == torch.uint8 and got.shape == (len(px), width)
    np.testing.assert_array_equal(got.numpy(), blocks)


def test_goldens_reach_every_path():
    """The stored cases exercise both BC1 ranges (3 colors only with a
    transparent pixel), both alpha ranges, and differ from one another."""
    for name in ("bc1_default", "bc1_better", "bc1_exhaustive"):
        blocks = load_s3tc(name)[1]
        ep0 = blocks[:, 0].astype(np.int32) | (blocks[:, 1].astype(np.int32)
                                               << 8)
        ep1 = blocks[:, 2].astype(np.int32) | (blocks[:, 3].astype(np.int32)
                                               << 8)
        assert (ep0 <= ep1).any() and (ep0 > ep1).any(), name
    alpha = load_s3tc("bc3_default")[1][:, :2].astype(np.int32)
    assert (alpha[:, 0] > alpha[:, 1]).any()       # 8-value (full range)
    assert (alpha[:, 0] < alpha[:, 1]).any()       # 6-value (reduced range)
    for other in ("bc1_flags0", "bc1_uniform", "bc1_exhaustive"):
        assert not np.array_equal(load_s3tc("bc1_default")[1],
                                  load_s3tc(other)[1]), other


def test_jitted_goldens_equal_op_by_op():
    """The JAX package's jitted encoders give its op-by-op bytes in every
    case whose jitted encoder could be compiled (the port is held to the
    op-by-op bytes, which every case has)."""
    for name, *_ in S3TC_CASES:
        _, blocks, api_blocks = load_s3tc(name)
        assert (api_blocks is None) == (name in S3TC_NOT_JITTED), name
        if api_blocks is not None:
            np.testing.assert_array_equal(api_blocks, blocks, name)


def test_entry_points_check_input_dtype():
    """Inputs the JAX entry points accept give their bytes: [N, 16, C] with
    C = 1, 3 and 5 (JAX reads a missing channel as the last one), int32
    that wraps, int8 for an unsigned format and uint8 for a signed one
    (both wrap), floats (truncated), lists and tensors; the JAX entry
    points' own cast and check, then its models run op by op. The inputs
    JAX refuses are refused, and empty batches give empty outputs."""
    from convectionkernels_tpu import api as jax_api
    light = dict(seed_points=1, refine_rounds_s3tc=1, refine_rounds_iic=1)
    base = blockgen.alpha_blocks(8, seed=99)[:3]
    wide = base.astype(np.int32) + 256 * np.random.default_rng(99).integers(
        -2, 3, base.shape)
    for fmt, dtype, forms in (
            ("bc4u", jnp.uint8, (base[:, :, :1], wide, base.tolist(),
                                 base.astype(np.float32) + 0.5)),
            ("bc4s", jnp.int8, (base, wide, torch.as_tensor(base))),
            ("bc1", jnp.uint8, (base[:, :, :3], base.view(np.int8),
                                np.concatenate([base, base[:, :, :1]], 2),
                                torch.as_tensor(wide))),
            ("bc5u", jnp.uint8, (base[:, :, :1], base[:, :, :3]))):
        for px in forms:
            arr = jax_api._as_block_array(
                px.numpy() if torch.is_tensor(px) else px, dtype)
            want = jax_s3tc_op_by_op(arr, fmt, light)
            np.testing.assert_array_equal(
                port_encode(px, fmt, light).numpy(), want,
                f"{fmt} {np.shape(px)}")
    px = np.zeros((2, 16, 4), dtype=np.uint8)
    for bad in (px[:, :, 0], px[:, :8], px[:, :, :0]):
        with pytest.raises((ValueError, IndexError)):
            jax_s3tc_op_by_op(jax_api._as_block_array(bad), "bc4u", light)
        for fmt in ("bc1", "bc4s"):
            with pytest.raises(ValueError):
                port_encode(bad, fmt, light)
    with pytest.raises(OverflowError):
        jax_api._as_block_array([[[300] * 4] * 16])
    with pytest.raises(OverflowError):
        ckt.encode_bc1([[[300] * 4] * 16], device="cpu")
    for fmt, width in (("bc1", 8), ("bc3", 16), ("bc5u", 16)):
        out = getattr(ckt, f"encode_{fmt}")(px[:0], device="cpu")
        assert out.shape == (0, width)


def test_encode_chunking_is_exact(monkeypatch):
    """Chunks of 5 blocks give the bytes of one chunk, exhaustive too."""
    px, blocks, _ = load_s3tc("bc1_exhaustive")
    monkeypatch.setattr(api, "CHUNK_S3TC_EXHAUSTIVE", 5)
    monkeypatch.setattr(api, "CHUNK_S3TC", 5)
    got = port_encode(px[:23], "bc1", dict(flags=Flags.S3TC_EXHAUSTIVE))
    np.testing.assert_array_equal(got.numpy(), blocks[:23])
    px, blocks, _ = load_s3tc("bc5s_default")
    np.testing.assert_array_equal(
        port_encode(px[:23], "bc5s", {}).numpy(), blocks[:23])


# --- tables and helpers ------------------------------------------------------

def test_single_color_tables_match_jax():
    port = s3tc_single_color.load_tables()
    ref = jax_tables.load_tables()
    assert sorted(port) == sorted(ref) and len(port) == 8
    for name in ref:
        assert port[name].dtype == torch.int32
        assert_same(port[name], ref[name], name)


def test_quantize_and_paranoid_helpers():
    v, vj = both(np.arange(256, dtype=np.int32))
    assert_lists_same(s3tc.quantize_to_565([v, v, v]),
                      jax_s3tc.quantize_to_565([vj, vj, vj]), "565")
    rng = np.random.default_rng(21)
    span = rng.integers(-255, 256, size=4096).astype(np.int32)
    a = rng.integers(0, 256, size=4096).astype(np.int32)
    b = rng.integers(0, 256, size=4096).astype(np.int32)
    d = (rng.uniform(0, 8, size=4096).astype(np.float32))
    (span_t, span_j), (a_t, a_j), (b_t, b_j), (d_t, d_j) = map(
        both, (span, a, b, d))
    assert_same(s3tc.paranoid_factor_for_span(span_t),
                jax_s3tc.paranoid_factor_for_span(span_j), "factor")
    assert_same(s3tc.paranoid_diff(a_t, b_t, d_t),
                jax_s3tc.paranoid_diff(a_j, b_j, d_j), "diff")
    assert_same(s3tc.paranoid_diff(a_t, b_t, s3tc.paranoid_factor_for_span(
        span_t)), jax_s3tc.paranoid_diff(
            a_j, b_j, jax_s3tc.paranoid_factor_for_span(span_j)), "both")
    s, s_j = both(np.arange(-128, 128, dtype=np.int8))
    out = s3tc.bias_signed_input(s)
    assert out.dtype == torch.int32
    assert_same(out, jax_s3tc.bias_signed_input(s_j), "bias")


@pytest.mark.parametrize("range_", [3, 4, 6, 8])
def test_reconstruct_ldr_precise(range_):
    rng = np.random.default_rng(range_)
    nch = 3 if range_ < 6 else 1
    eps = [[rng.integers(0, 256, size=512).astype(np.int32)
            for _ in range(nch)] for _ in range(2)]
    index = rng.integers(0, range_, size=512).astype(np.int32)
    cw = CW[:nch] if nch == 3 else [1.0]
    port = index_select.IndexSelector(
        cw, [[both(e)[0] for e in ep] for ep in eps], range_, nch)
    ref = jax_index.IndexSelector(
        cw, [[both(e)[1] for e in ep] for ep in eps], range_, nch)
    i_t, i_j = both(index)
    assert_lists_same(port.reconstruct_ldr_precise(i_t),
                      ref.reconstruct_ldr_precise(i_j), f"range {range_}")


@pytest.mark.parametrize("uniform", [True, False])
def test_aggregated_error_finalize(uniform):
    rng = np.random.default_rng(31)
    agg = [rng.integers(0, 16 * 65025, size=1024).astype(np.int32)
           for _ in range(3)]
    got = index_select.aggregated_error_finalize(
        [both(a)[0] for a in agg], uniform, CW_SQ)
    want = jax_index.aggregated_error_finalize(
        [both(a)[1] for a in agg], uniform, CW_SQ)
    assert got.dtype == torch.float32
    assert_same(got, want)


def test_tweak_rounds_and_count_partitions():
    from convectionkernels_tpu.ops import lanes as jax_lanes
    for r in range(2, 17):
        assert lanes.tweak_rounds_for_range(r) == \
            jax_lanes.tweak_rounds_for_range(r)
    for n_counts, total in ((4, 965), (3, 150)):
        counts = s3tc._count_partitions(n_counts)
        assert counts.shape == (total, n_counts)
        assert (counts.sum(axis=1) == 16).all() and (counts < 16).all()
        assert len({tuple(c) for c in counts.tolist()}) == total
        # visitation order: lexicographic in (n0, n1, ...)
        assert counts.tolist() == sorted(counts.tolist())


def test_refiner_pixel_axis_equals_per_pixel_calls():
    """contribute_unweighted_pw_pixels gives the totals of 16 calls of
    contribute_unweighted_pw, masked and not."""
    rng = np.random.default_rng(41)
    pw = torch.as_tensor(rng.uniform(0, 255, size=(64, 16, 3)).astype(
        np.float32)) * torch.tensor(CW[:3], dtype=torch.float32)
    index = torch.as_tensor(rng.integers(0, 4, size=(64, 16)).astype(
        np.int32))
    mask = torch.as_tensor(rng.random((64, 16)) < 0.6)
    zero = torch.zeros(64)
    for m in (None, mask):
        one = EndpointRefiner(zero, 3, 4, CW)
        one.contribute_unweighted_pw_pixels([pw[..., ch] for ch in range(3)],
                                            index, mask=m)
        each = EndpointRefiner(zero, 3, 4, CW)
        for px in range(16):
            each.contribute_unweighted_pw(
                [pw[:, px, ch] for ch in range(3)], index[:, px],
                mask=None if m is None else m[:, px])
        assert_lists_same([*one.tv, *one.v, one.tt, one.t, one.wu],
                          [*each.tv, *each.v, each.tt, each.t, each.wu])


def test_sorts_equal_the_comparator_networks():
    """torch.sort gives the order of the reference's insertion network on
    the exhaustive sort keys (ties in the 11-bit bin, transparent pixels)
    and of its bubble sort on alpha values with ties."""
    rng = np.random.default_rng(51)
    n = 512
    bins = rng.integers(0, 4, size=(n, 16)).astype(np.int32)   # many ties
    bins[: n // 4] = 7                                          # flat blocks
    keys = bins << 4
    transparent = rng.random((n, 16)) < 0.3
    transparent[n // 4: n // 4 + 8] = True                      # all clear
    keys = np.where(transparent, -16, keys) + np.arange(16, dtype=np.int32)
    net = [torch.as_tensor(keys[:, px]) for px in range(16)]
    for sort_end in range(1, 16):                 # S3TC.cpp:830-843
        for loc in range(sort_end, 0, -1):
            a, b = net[loc], net[loc - 1]
            net[loc], net[loc - 1] = torch.maximum(a, b), torch.minimum(a, b)
    assert torch.equal(torch.stack(net, 1),
                       torch.sort(torch.as_tensor(keys), dim=1).values)

    values = rng.integers(0, 6, size=(n, 16)).astype(np.int32) * 51
    net = [torch.as_tensor(values[:, px]) for px in range(16)]
    for sort_end in range(15, 0, -1):             # S3TC.cpp:372-385
        for off in range(sort_end):
            a, b = net[off], net[off + 1]
            net[off], net[off + 1] = torch.minimum(a, b), torch.maximum(a, b)
    assert torch.equal(torch.stack(net, 1),
                       torch.sort(torch.as_tensor(values), dim=1).values)


# --- packers -----------------------------------------------------------------

def test_pack_bc1_blocks_every_index_order():
    """Random best states in both ranges, with equal, ascending and
    descending packed endpoints: all 5 index-order cases."""
    rng = np.random.default_rng(61)
    n = 400
    eps = rng.integers(0, 256, size=(n, 2, 3)).astype(np.int32)
    eps[: n // 4, 1] = eps[: n // 4, 0]                 # equal endpoints
    rng_ = np.where(rng.random(n) < 0.5, 3, 4).astype(np.int32)
    idx = rng.integers(0, 4, size=(n, 16)).astype(np.int32)
    idx[rng_ == 3] %= 3

    best = s3tc._Best(n, "cpu")
    best.endpoints, best.indexes = torch.as_tensor(eps), torch.as_tensor(idx)
    best.range = torch.as_tensor(rng_)
    got = s3tc._pack_bc1_blocks(best)

    class JaxBest:
        endpoints = [[jnp.asarray(eps[:, e, ch]) for ch in range(3)]
                     for e in range(2)]
        indexes = [jnp.asarray(idx[:, px]) for px in range(16)]
        range = jnp.asarray(rng_)
    want = np.asarray(jax_s3tc._pack_bc1_blocks(JaxBest))
    assert_same(got, want)
    cep = [(eps[:, e, 0] & 0xF8) << 8 | (eps[:, e, 1] & 0xFC) << 3
           | (eps[:, e, 2] & 0xF8) >> 3 for e in range(2)]
    cases = np.where(rng_ == 4, np.where(cep[0] == cep[1], 0,
                                         np.where(cep[0] < cep[1], 1, 2)),
                     np.where(cep[0] > cep[1], 3, 4))
    assert set(cases.tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("signed", [False, True])
def test_pack_interpolated_alpha_blocks(signed):
    rng = np.random.default_rng(71 + signed)
    n = 256
    ep = rng.integers(0, 255 if signed else 256, size=(n, 2)).astype(np.int32)
    ep[: n // 8, 1] = ep[: n // 8, 0]
    full = (rng.random(n) < 0.5).astype(np.int32)
    idx = rng.integers(0, 8, size=(n, 16)).astype(np.int32)
    got = s3tc._pack_interpolated_alpha_blocks(
        torch.as_tensor(ep), torch.as_tensor(full), torch.as_tensor(idx),
        signed)
    want = jax_s3tc._pack_interpolated_alpha_blocks(
        [jnp.asarray(ep[:, 0]), jnp.asarray(ep[:, 1])], jnp.asarray(full),
        [jnp.asarray(idx[:, px]) for px in range(16)], signed)
    assert_same(got, want)


def test_pack_explicit_alpha():
    px = blockgen.alpha_blocks(64, seed=81)
    px[:4, :, 3] = np.arange(0, 256, 4, dtype=np.uint8).reshape(4, 16)
    assert_same(s3tc.pack_explicit_alpha(torch.as_tensor(px), 3),
                jax_s3tc.pack_explicit_alpha(jnp.asarray(px), 3))


# --- the encoders against the JAX functions called directly ------------------

def rgb_blocks():
    return np.concatenate([blockgen.mixed_blocks(32, seed=91)[::4],
                           blockgen.alpha_blocks(8, seed=93)])


@pytest.mark.parametrize("flags,alpha_test", [
    (Flags.DEFAULT, True), (0, False), (Flags.UNIFORM, True),
    (Flags.S3TC_PARANOID | Flags.UNIFORM, False)],
    ids=["default_alpha", "flags0", "uniform_alpha", "paranoid_uniform"])
def test_pack_rgb_matches_jax(flags, alpha_test):
    """The exhaustive search is held by the goldens (bc1_better,
    bc1_exhaustive): op by op, JAX takes 10-25 s to run it here."""
    px = rgb_blocks()
    cw = ckt.Options(flags=flags).channel_weights()
    exhaustive = bool(flags & Flags.S3TC_EXHAUSTIVE)
    got = s3tc.pack_rgb(torch.as_tensor(px), flags, cw, alpha_test, 0.5,
                        exhaustive, 3, 2)
    want = jax_s3tc.pack_rgb(px, flags, cw, alpha_test, 0.5, exhaustive, 3,
                             2, jax_tables.load_tables() if exhaustive
                             else None)
    assert_same(got, want)


@pytest.mark.parametrize("signed", [False, True])
def test_pack_interpolated_alpha_matches_jax(signed):
    px = rgb_blocks()
    if signed:
        px = signed_blocks(32, seed=95)[:16]
        p_t = s3tc.bias_signed_input(torch.as_tensor(px))
        p_j = jax_s3tc.bias_signed_input(jnp.asarray(px))
    else:
        p_t, p_j = torch.as_tensor(px), jnp.asarray(px)
    for channel in (0, 3):
        got = s3tc.pack_interpolated_alpha(p_t, channel, signed, 2, 3)
        want = jax_s3tc.pack_interpolated_alpha(p_j, channel, signed, 2, 3)
        assert_same(got, want, f"channel {channel}")


# --- the interpolated-alpha chain: the edge blocks, and the card's kernel ----

def test_alpha_edge_values_reach_every_branch():
    """The card tests' edge blocks (alpha_edge_values) try the clipping
    heuristic and not, with a passing candidate and with none, at both
    high terminals; hold flat blocks and blocks of 0 and 255 only; and
    tie rounds in update_best (the scalar emulation's trace)."""
    values = alpha_edge_values()
    for high_terminal in (255, 254):
        assert {clipping_outcome(v, high_terminal) for v in values} == {
            "not_tried", "passes", "fails"}
    assert any((v == v[0]).all() for v in values)
    assert any(set(v.tolist()) == {0, 255} for v in values)
    ties = 0
    for v in values[[7, 8]]:             # flat 255; 0 and 255 alternating
        trace, best = [], np.inf
        scalar_emu.pack_interpolated_alpha_block([int(x) for x in v],
                                                 max_tweak=2, refine_rounds=2,
                                                 trace=trace)
        for _, err, *_ in trace:
            ties += err == best
            best = min(best, err)
    assert ties > 0


@pytest.mark.parametrize("signed", [False, True])
def test_pack_interpolated_alpha_edge_blocks_match_jax(signed):
    """The plain version, the CPU path, on the edge blocks against the
    JAX package's function run op by op, in two channels."""
    px = alpha_blocks_with_edges(len(alpha_edge_values()), seed=2320)
    if signed:
        px = (px.astype(np.int16) - 128).astype(np.int8)
        p_t = s3tc.bias_signed_input(torch.as_tensor(px))
        p_j = jax_s3tc.bias_signed_input(jnp.asarray(px))
    else:
        p_t, p_j = torch.as_tensor(px), jnp.asarray(px)
    for channel in (0, 3):
        got = s3tc.pack_interpolated_alpha(p_t, channel, signed, 2, 2)
        want = jax_s3tc.pack_interpolated_alpha(p_j, channel, signed, 2, 2)
        assert_same(got, want, f"channel {channel}")


def test_s3tc_alpha_source_follows_the_kernel_rule():
    """csrc/s3tc_alpha.cu holds s3tc_alpha_kernel (the name the benchmark
    and csrc_launches find it by) and ck_s3tc_alpha, whose parameters
    cuda_lib.SIGNATURES declares one for one."""
    assert s3tc.LIBRARIES == ("s3tc_alpha",)
    assert "s3tc_alpha" in cuda_lib.SOURCES
    symbol, argtypes = cuda_lib.SIGNATURES["s3tc_alpha"]
    assert symbol == "ck_s3tc_alpha"
    with open(os.path.join(cuda_lib.CSRC, "s3tc_alpha.cu")) as f:
        source = f.read()
    assert re.search(r"__global__ void[^;{]*\bs3tc_alpha_kernel\(", source)
    (params,) = re.findall(r'extern "C" int ck_s3tc_alpha\(([^)]*)\)', source)
    assert len(params.split(",")) == len(argtypes)
    assert params.split(",")[-1].split() == ["void*", "stream"]


def test_pack_interpolated_alpha_on_the_cpu_launches_nothing(monkeypatch):
    """A CPU tensor takes the plain version and launches no kernel."""
    def no_launch(*args):
        raise AssertionError(f"launched {args[0]} on the CPU path")

    monkeypatch.setattr(cuda_lib, "launch", no_launch)
    blocks = torch.as_tensor(alpha_blocks_with_edges(40, seed=2321))
    got = s3tc.pack_interpolated_alpha(blocks, 3, False, 2, 2)
    assert torch.equal(got, s3tc.s3tc_alpha_plain(blocks, 3, False, 2, 2))
    with pytest.raises(ValueError):
        s3tc.s3tc_alpha(blocks.to("meta"), 3, False, 2, 2)
