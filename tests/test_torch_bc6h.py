"""The port's BC6H slice on the CPU against the JAX package.

encode_bc6hu / encode_bc6hs are held to JAX bytes stored in
convectionkernels_tpu_torch/testdata/bc6h_golden.npz (a cold JAX compile of
one BC6H configuration takes about a minute; tests/test_torch_goldens.py
re-derives the stored bytes under `-m slow`). The bit packing and the
decoder are held against the JAX package's functions directly. Tolerance 0
everywhere: the contract is bytes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu.models import bc6h as jax_bc6h
from convectionkernels_tpu.models import bc7 as jax_bc7
from convectionkernels_tpu.models import decode as jax_decode
from convectionkernels_tpu_torch import api
from convectionkernels_tpu_torch.models import bc6h, bc6h_common, decode
from convectionkernels_tpu_torch.ops.lanes import LexBest
from tests.test_torch_goldens import BC6H_CASES, hdr_blocks, load_bc6h


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    machine's cores, where the intra-op threads of several workers
    oversubscribe them (the port's encodes pad small batches to 256-block
    buckets, so each call here does a bucket's work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_encode(px, case):
    _, _, signed, flags, seed_points, refine_rounds = case
    encode = ckt.encode_bc6hs if signed else ckt.encode_bc6hu
    return encode(px, ckt.Options(flags=flags, seed_points=seed_points,
                                  refine_rounds_bc6h=refine_rounds),
                  device="cpu")


def mode_index(blocks):
    """The HDR_MODES index each encoded block uses."""
    b0 = blocks[:, 0].astype(np.int64)
    mode_bits = np.where((b0 & 3) < 2, b0 & 3, b0 & 0x1F)
    ids = [m[0] for m in bc6h_common.HDR_MODES]
    return np.array([ids.index(v) for v in mode_bits])


@pytest.mark.parametrize("case", BC6H_CASES, ids=[c[0] for c in BC6H_CASES])
def test_encode_matches_jax_golden(case):
    """LIGHT options, 2 x 2 rounds, signed + fast indexing, uniform weights,
    blocks of negative, denormal, zero and out-of-range halves, and the
    default Options (4 x 3 rounds)."""
    px, blocks, _ = load_bc6h(case[0])
    got = port_encode(px, case)
    assert got.dtype == torch.uint8 and got.shape == (len(px), 16)
    np.testing.assert_array_equal(got.numpy(), blocks)


def test_goldens_use_partitioned_and_single_modes():
    """The stored cases are not all won by one kind of mode, so both the
    kernel's groups and the single-mode groups decide bytes."""
    modes = np.concatenate([mode_index(load_bc6h(c[0])[1])
                            for c in BC6H_CASES])
    partitioned = np.array([bc6h_common.HDR_MODES[m][1] for m in modes])
    assert partitioned.any() and not partitioned.all()
    assert len(set(modes.tolist())) >= 6


def test_jitted_golden_differs_from_op_by_op_in_one_block():
    """The port is held to the JAX package's op-by-op bytes; its jitted
    encode departs from them in block 27 of `edge_signed` only."""
    for case in BC6H_CASES:
        _, blocks, api_blocks = load_bc6h(case[0])
        differ = np.flatnonzero((blocks != api_blocks).any(axis=1)).tolist()
        assert differ == ([27] if case[0] == "edge_signed" else [])


@pytest.mark.slow
def test_encode_matches_jax_live():
    """encode_bc6hu against ck.encode_bc6hu run now with the default
    Options (4 x 3 meta rounds), on blocks no golden holds."""
    import convectionkernels_tpu as ck
    px = hdr_blocks(24, seed=61)
    want = np.asarray(ck.encode_bc6hu(px))
    got = ckt.encode_bc6hu(px, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


# --- bit packing -----------------------------------------------------------------

def test_pack_bits_every_mode_matches_jax():
    """Random winners of every mode, every partition and both kinds of
    fixup, through the port's packer and the JAX package's."""
    rng = np.random.default_rng(71)
    n = 14 * 32
    mode = np.repeat(np.arange(14), 32).astype(np.int32)
    partition = np.tile(np.arange(32), 14).astype(np.int32)
    ep = np.zeros((n, 2, 2, 3), dtype=np.int32)
    for i in range(n):
        _, _, transformed, aprec, bprec = bc6h_common.HDR_MODES[mode[i]]
        ep[i, 0, 0] = rng.integers(0, 1 << aprec, size=3)
        for ch in range(3):
            bits = bprec[ch] if transformed else aprec
            lo = -(1 << (bits - 1)) if transformed else 0
            hi = (1 << (bits - 1)) if transformed else (1 << bits)
            ep[i, :, :, ch].reshape(-1)[1:] = rng.integers(lo, hi, size=3)
    idx = rng.integers(0, 16, size=(n, 16)).astype(np.int32)
    partitioned = np.array([bc6h_common.HDR_MODES[m][1] for m in mode])
    idx[partitioned] &= 7
    idx[:, 0] &= 7                      # the fixup pixels' top bit is 0
    idx[partitioned, 0] &= 3
    from convectionkernels_tpu_torch.tables import bc7_geometry as geom
    for i in np.flatnonzero(partitioned):
        idx[i, geom.FIXUP_INDEXES_2[partition[i]]] &= 3
    payload = {"mode": mode, "partition": partition, "ep": ep, "idx": idx}

    port_best = LexBest(None, None,
                        {k: torch.as_tensor(v) for k, v in payload.items()})
    got = bc6h._pack_bits(port_best, n).numpy()
    jax_best = jax_bc7.LexBest(None, None,
                               {k: jnp.asarray(v) for k, v in payload.items()})
    want = np.asarray(jax_bc6h._pack_bits(jax_best, n))
    np.testing.assert_array_equal(got, want)
    # and the port's decoder reads the fields back
    np.testing.assert_array_equal(mode_index(got), mode)


# --- decode ----------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_decode_matches_jax(signed):
    """On the goldens' bytes and on random bytes (every mode, the reserved
    mode values included)."""
    rng = np.random.default_rng(73)
    blocks = np.concatenate(
        [load_bc6h(c[0])[1] for c in BC6H_CASES if c[2] == signed]
        + [rng.integers(0, 256, size=(512, 16), dtype=np.uint8)])
    want = jax_decode.decode_bc6h(blocks, signed)
    got = decode.decode_bc6h(blocks, signed)
    assert got.dtype == np.int16 and got.shape == (len(blocks), 16, 4)
    np.testing.assert_array_equal(got, want)
    entry = ckt.decode_bc6hs if signed else ckt.decode_bc6hu
    via_api = entry(torch.as_tensor(blocks), device="cpu")
    assert via_api.dtype == torch.int16
    np.testing.assert_array_equal(via_api.numpy(), want)


def test_round_trip_is_close_on_smooth_blocks():
    """Smooth blocks survive encode + decode within a few percent."""
    px = hdr_blocks(32, seed=75)[:8]            # the smooth quarter
    out = ckt.encode_bc6hu(px, ckt.Options(seed_points=2,
                                           refine_rounds_bc6h=2),
                           device="cpu")
    back = ckt.decode_bc6hu(out, device="cpu").numpy()
    src = px.view(np.float16)[..., :3].astype(np.float64)
    dec = back.view(np.float16)[..., :3].astype(np.float64)
    assert np.abs(dec - src).max() <= 0.05 * src.max()
    assert (back[..., 3] == 0x3C00).all()


# --- the entry points ------------------------------------------------------------

def test_entry_points_are_exported():
    for name in ("encode_bc6hu", "encode_bc6hs", "decode_bc6hu",
                 "decode_bc6hs"):
        assert name in ckt.__all__ and callable(getattr(ckt, name))


def test_device_default_is_the_card():
    """device=None means the CUDA card and raises where there is none; the
    CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    px = hdr_blocks(4, seed=77)
    for entry in (ckt.encode_bc6hu, ckt.encode_bc6hs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(px)
    blocks = np.zeros((4, 16), dtype=np.uint8)
    for entry in (ckt.decode_bc6hu, ckt.decode_bc6hs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(blocks)


def test_encode_checks_its_input():
    """Inputs the JAX entry points accept give their bytes: [N, 16, 3] and
    [N, 16, 1] (JAX reads a missing channel as the last one), [N, 8, 4]
    and [N, 20, 4] (JAX casts without a check and reads pixel p with a
    static index, which clamps), float16 input (cast by value, as JAX
    casts it), uint8 and int32 that wraps; the JAX entry point's cast,
    then its pack run op by op, once for all forms (the pixels and
    channels pack reads, taken with its own static indexing, side by
    side). A wrong rank, no pixel and no channel are refused; an empty
    batch gives an empty output."""
    import jax

    from convectionkernels_tpu.options import Options as JaxOptions
    px = hdr_blocks(4, seed=79)[:2]
    forms = (px[:, :, :3], px[:, :, :1], px.view(np.float16),
             px.astype(np.uint8), px.astype(np.int32) + 65536, px[:, :8],
             np.concatenate([px, px[:, :4] ^ 0x1234], axis=1))
    arrs = [jnp.asarray(f, dtype=jnp.int16) for f in forms]
    arr = jnp.concatenate([jnp.stack([jnp.stack([a[:, p, ch]
                                                 for ch in range(4)], -1)
                                      for p in range(16)], 1)
                           for a in arrs])
    o = JaxOptions(seed_points=1, refine_rounds_bc6h=1)
    with jax.disable_jit():
        want = np.asarray(jax_bc6h.pack(arr, o.flags, o.channel_weights(),
                                        False, 1, 1))
    got = torch.cat([ckt.encode_bc6hu(f, ckt.Options(
        seed_points=1, refine_rounds_bc6h=1), device="cpu") for f in forms])
    np.testing.assert_array_equal(got.numpy(), want)
    for bad in (px[:, :, 0], px[:, :0], px[:, :, :0]):
        with pytest.raises(ValueError):
            ckt.encode_bc6hu(bad, device="cpu")
    with pytest.raises(IndexError):
        jax_bc6h.pack(jnp.asarray(px[:, :, 0]), o.flags, o.channel_weights(),
                      False, 1, 1)
    empty = ckt.encode_bc6hu(px[:0], device="cpu")
    assert empty.shape == (0, 16) and empty.dtype == torch.uint8


def test_chunks_and_tensor_input_give_the_same_bytes(monkeypatch):
    """Blocks are independent: any chunk size gives the same bytes."""
    px, blocks, _ = load_bc6h("uniform")
    case = [c for c in BC6H_CASES if c[0] == "uniform"][0]
    monkeypatch.setattr(api, "CHUNK_BC6H", 5)
    got = port_encode(torch.as_tensor(px), case)
    np.testing.assert_array_equal(got.numpy(), blocks)


def test_rounds_are_clamped_like_the_reference():
    """seed_points / refine_rounds_bc6h outside 1..4 / 1..3 are clamped
    (BC6HComputer::Pack), so they give the in-range bytes."""
    px = hdr_blocks(8, seed=81)

    def run(seed_points, refine_rounds):
        return ckt.encode_bc6hu(px, ckt.Options(
            seed_points=seed_points, refine_rounds_bc6h=refine_rounds),
            device="cpu").numpy()

    np.testing.assert_array_equal(run(0, 0), run(1, 1))
    np.testing.assert_array_equal(run(9, 7), run(4, 3))
    assert bc6h_common.clamp_rounds(9, 0) == (4, 1)
