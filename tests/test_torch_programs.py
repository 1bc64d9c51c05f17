"""The port's program layer (convectionkernels_tpu_torch/programs.py) on the
CPU: the JAX package's bucket policy case for case, padded encodes that
give the unpadded bytes and the stored goldens, one program per
(configuration, bucket), the bounded caches and release_programs, and no
host copy in a program body once it has run (the CPU's stand-in for "a
CUDA graph can capture it": a graph cannot capture a copy from host
memory or a read of device data on the host).

On the CPU a program runs its body op by op on the padded blocks; the
CUDA graphs themselves are held against the eager bytes and the stored
goldens on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import convectionkernels_tpu as ck
import convectionkernels_tpu.api as jax_api
import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import api, programs
from tests import blockgen
from tests.test_torch_goldens import (BC6H_PATH, DEFAULT, LIGHT, PUNCH,
                                      load_bc6h, load_etc, load_etc_case,
                                      load_light, load_s3tc)

CHUNKS = ("CHUNK_S3TC", "CHUNK_S3TC_EXHAUSTIVE", "CHUNK_BC7", "CHUNK_BC6H",
          "CHUNK_ETC", "CHUNK_ETC2", "CHUNK_EAC")
SINGLE_COLOR = 0x010   # Flags.BC7_TRY_SINGLE_COLOR
FAKE_BT709 = 0x400     # Flags.ETC_USE_FAKE_BT709
EXHAUSTIVE = 0x080     # Flags.S3TC_EXHAUSTIVE


@pytest.fixture(autouse=True)
def fresh_programs():
    """One intra-op thread (the tensors are small, and the test workers
    share the cores), and every test starts and ends without programs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    programs.release_programs()
    yield
    programs.release_programs()
    torch.set_num_threads(threads)


def set_chunks(monkeypatch, chunk):
    for attr in CHUNKS:
        monkeypatch.setattr(api, attr, chunk)


def buckets():
    return sum(len(p.buckets) for p in programs.programs())


def eight_blocks(seed):
    """8 mixed blocks (2 random, 2 gradient, 2 flat, 2 with random alpha),
    the first made opaque: blocks on both sides of ETC2 punchthrough's
    split."""
    px = blockgen.mixed_blocks(32, seed=seed)[::4].copy()
    px[0, :, 3] = 255
    return px


# --- the bucket policy ------------------------------------------------------

BUCKET_GRID = sorted(
    # every case of tests/test_bucketing.py::test_bucket_size_policy
    {(1, 4096), (256, 4096), (257, 4096), (3000, 4096), (4096, 4096),
     (4097, 4096), (9000, 4096), (20, 24), (5, 24)}
    # and a grid over both sides of BUCKET_MIN and of the chunk
    | {(n, chunk) for n in (0, 1, 255, 256, 257, 65535, 65536, 65537, 70000)
       for chunk in (1, 24, 300, 4096, 65536)})


@pytest.mark.parametrize("n,chunk", BUCKET_GRID)
def test_bucket_size_matches_jax(n, chunk):
    assert programs.bucket_size(n, chunk) == jax_api._bucket_size(n, chunk)
    assert programs.BUCKET_MIN == jax_api._BUCKET_MIN
    assert programs.PROGRAM_CACHE_SIZE == jax_api._PROGRAM_CACHE_SIZE


# --- padded encodes ---------------------------------------------------------

def _etc_case(name):
    px, flags, blocks, _ = load_etc(name)
    entry, threshold, _ = load_etc_case(name)
    options = ckt.Options(flags=flags, threshold=threshold)
    if entry.startswith("eac11"):
        return px, blocks, lambda p: ckt.encode_eac11(
            p, entry == "eac11s", options, device="cpu")
    encode = getattr(ckt, f"encode_{entry}")
    return px, blocks, lambda p: encode(p, options, device="cpu")


def _bc6h_light():
    px, blocks, _ = load_bc6h("light")
    with np.load(BC6H_PATH) as z:
        flags, seed_points, rounds, signed = (int(v)
                                              for v in z["light_config"])
    options = ckt.Options(flags=flags, seed_points=seed_points,
                          refine_rounds_bc6h=rounds)
    encode = ckt.encode_bc6hs if signed else ckt.encode_bc6hu
    return px, blocks, lambda p: encode(p, options, device="cpu")


def _bc7_q5():
    px, blocks, flags = load_light("alpha")
    options = ckt.Options(flags=flags, **LIGHT)
    return px, blocks, lambda p: ckt.encode_bc7(p, options, quality=5,
                                                device="cpu")


def _s3tc_case(name, fmt):
    px, blocks, _ = load_s3tc(name)
    encode = getattr(ckt, f"encode_{fmt}")
    return px, blocks, lambda p: encode(p, device="cpu")


# name -> (pixels, golden bytes, encode on the CPU) of a stored golden
PADDED_CASES = {
    "bc1": lambda: _s3tc_case("bc1_default", "bc1"),
    "bc3": lambda: _s3tc_case("bc3_default", "bc3"),
    "bc7_q5": _bc7_q5,
    "bc6hu_light": _bc6h_light,
    "etc1": lambda: _etc_case("etc1_default"),
    "etc2": lambda: _etc_case("etc2_default"),
    "etc2_punchthrough": lambda: _etc_case("etc2_punchthrough"),
    "eac11": lambda: _etc_case("eac_r11"),
}
PAD_CHUNK = 32


@pytest.mark.parametrize("n", (1, 40, 255, 257))
@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_encode_gives_unpadded_and_golden_bytes(monkeypatch, case, n):
    """The golden's blocks repeated to n, encoded with every chunk size at
    32 blocks (n padded to 32, 64, 256 and 288 by repeating block 0, then
    run a chunk at a time), give the bytes of the same blocks encoded with
    the chunk size at n (no pad) and the stored goldens repeated alike.
    bc1 is also held against the JAX package's jitted encode_bc1 (its own
    padding to the 256-block bucket; light options, whose program the
    primed XLA compile cache holds) for n up to 255: at 257 JAX would
    compile its 512-block bucket, minutes on XLA:CPU."""
    px, golden, encode = PADDED_CASES[case]()
    px, golden = np.resize(px, (n,) + px.shape[1:]), np.resize(
        golden, (n,) + golden.shape[1:])
    set_chunks(monkeypatch, PAD_CHUNK)
    padded = encode(px).numpy()
    assert programs.bucket_size(n, PAD_CHUNK) > n or n == 256
    set_chunks(monkeypatch, n)
    unpadded = encode(px).numpy()
    np.testing.assert_array_equal(padded, unpadded)
    np.testing.assert_array_equal(padded, golden)
    if case == "bc1" and n <= programs.BUCKET_MIN:
        set_chunks(monkeypatch, PAD_CHUNK)
        got = ckt.encode_bc1(px, ckt.Options(**LIGHT), device="cpu").numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ck.encode_bc1(px, ck.Options(**LIGHT))))


# --- programs and their caches ------------------------------------------------

def test_one_program_per_bucket(monkeypatch):
    """40 and 72 blocks pad to one 256-block program; 257 builds a second,
    of 512 blocks; 1,024 blocks run the 512-block chunk program twice."""
    monkeypatch.setattr(api, "CHUNK_S3TC", 512)
    px = blockgen.mixed_blocks(1024, seed=7)
    ckt.encode_bc1(px[:40], device="cpu")
    assert buckets() == 1
    ckt.encode_bc1(px[:72], device="cpu")
    assert buckets() == 1
    ckt.encode_bc1(px[:257], device="cpu")
    assert buckets() == 2
    ckt.encode_bc1(px, device="cpu")
    (program,) = programs.programs()
    assert sorted(program.buckets) == [(256, 16, 4), (512, 16, 4)]


def test_cache_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(programs, "PROGRAM_CACHE_SIZE", 2)
    set_chunks(monkeypatch, 8)
    px = eight_blocks(8)

    def encode(threshold):
        ckt.encode_bc1(px, ckt.Options(threshold=threshold), device="cpu")

    def cached():
        return [key[1].threshold for key in api._s3tc_program.programs]

    encode(0.1)
    encode(0.2)
    assert cached() == [0.1, 0.2]
    encode(0.3)
    assert cached() == [0.2, 0.3]
    encode(0.2)
    encode(0.4)
    assert cached() == [0.2, 0.4]


def test_release_programs_empties_every_cache(monkeypatch):
    set_chunks(monkeypatch, 8)
    px = eight_blocks(9)
    ckt.encode_bc1(px, device="cpu")
    ckt.encode_bc7(px, ckt.Options(**LIGHT), quality=5, device="cpu")
    ckt.encode_etc1(px, device="cpu")
    ckt.encode_eac11(px[:, :, 0].astype(np.int16), device="cpu")
    assert len(programs.programs()) == 4 and programs._CONSTANTS
    api.release_programs()
    assert programs.programs() == [] and not programs._CONSTANTS
    assert all(not cache.programs for cache in programs._CACHES)


def test_program_key_tells_configurations_apart():
    """Options, the BC7 plan, signedness and the device each make their own
    program; equal values share one. Making a program touches no device,
    so a card's key is taken here without a card."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    opts, q5, q50 = ckt.Options(), ckt.plan_from_quality(5), \
        ckt.plan_from_quality(50)
    a = api._bc7_program(opts, q5, cpu)
    assert api._bc7_program(ckt.Options(), ckt.plan_from_quality(5),
                            torch.device("cpu")) is a
    assert api._bc7_program(ckt.Options(threshold=0.25), q5, cpu) is not a
    assert api._bc7_program(opts, q50, cpu) is not a
    assert api._bc7_program(opts, q5, card) is not a
    assert api._bc6h_program(opts, False, cpu) is not \
        api._bc6h_program(opts, True, cpu)
    assert api._s3tc_program("bc4u", opts, cpu) is not \
        api._s3tc_program("bc4s", opts, cpu)
    assert api._etc_program("eac11", None, cpu) is not \
        api._etc_program("eac11s", None, cpu)
    assert api._etc_program("etc2", opts, cpu) is not \
        api._etc_program("etc2", ckt.Options(flags=FAKE_BT709), cpu)


def test_constants_are_kept_by_value_type_and_device():
    cpu = torch.device("cpu")
    a = programs.constant([1, 2, 3], cpu, np.int32)
    assert programs.constant(np.arange(1, 4), "cpu", np.int32) is a
    assert programs.constant([1, 2, 4], cpu, np.int32) is not a
    assert programs.constant([1, 2, 3], cpu, np.int64) is not a
    assert a.dtype == torch.int32 and a.tolist() == [1, 2, 3]


def test_eager_mode_nests():
    assert programs._eager_depth == 0
    with programs.eager():
        with programs.eager():
            assert programs._eager_depth == 2
        assert programs._eager_depth == 1
    assert programs._eager_depth == 0


# --- no host copy once a body has run ------------------------------------------

_HOST_READS = {"cpu", "numpy", "item", "tolist", "__bool__", "__int__",
               "__float__", "__index__", "nonzero", "masked_select",
               "unique", "bincount", "argwhere"}


def _bool_tensor_in(index):
    items = index if isinstance(index, tuple) else (index,)
    return any(torch.is_tensor(i) and i.dtype == torch.bool for i in items)


class HostCalls(TorchFunctionMode):
    """Records, while a program body runs, what a CUDA graph cannot
    capture: a tensor made from host data, a read of tensor data on the
    host, and an op whose output shape depends on tensor data (a boolean
    index, one-argument where). torch.from_numpy takes no tensor, so the
    test wraps it and asks `active`."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.active = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        data = args[0] if args else kwargs.get("data")
        if name in ("as_tensor", "tensor") and not torch.is_tensor(data):
            self.calls.append(name)
        elif name in _HOST_READS:
            self.calls.append(name)
        elif name == "where" and len(args) + len(kwargs) == 1:
            self.calls.append("where(condition)")
        elif name in ("__getitem__", "__setitem__") and _bool_tensor_in(
                args[1]):
            self.calls.append(f"{name} with a boolean index")
        elif name == "repeat_interleave" and len(args) > 1 and \
                torch.is_tensor(args[1]):
            self.calls.append("repeat_interleave by a tensor")
        return func(*args, **kwargs)

    def watch(self, program, ran):
        """Run `program`'s body under this mode from now on."""
        body = program.body

        def watched(blocks):
            ran.append(program)
            self.active = True
            try:
                with self:
                    return body(blocks)
            finally:
                self.active = False

        program.body = watched


# name -> an encode on the CPU of blocks [8, 16, 4] (uint8, int8 for the
# signed S3TC formats, half-float bits for BC6H, int16 [8, 16] for EAC)
HOST_COPY_CASES = {
    "bc1": lambda p: ckt.encode_bc1(p, device="cpu"),
    "bc1_exhaustive": lambda p: ckt.encode_bc1(
        p, ckt.Options(flags=DEFAULT | EXHAUSTIVE), device="cpu"),
    "bc2": lambda p: ckt.encode_bc2(p, device="cpu"),
    "bc3": lambda p: ckt.encode_bc3(p, device="cpu"),
    "bc4u": lambda p: ckt.encode_bc4u(p, device="cpu"),
    "bc4s": lambda p: ckt.encode_bc4s(p.view(np.int8), device="cpu"),
    "bc5u": lambda p: ckt.encode_bc5u(p, device="cpu"),
    "bc5s": lambda p: ckt.encode_bc5s(p.view(np.int8), device="cpu"),
    "bc7_q50": lambda p: ckt.encode_bc7(p, quality=50, device="cpu"),
    "bc7_q5_single_color_punch": lambda p: ckt.encode_bc7(
        p, ckt.Options(flags=DEFAULT | SINGLE_COLOR | PUNCH, **LIGHT),
        quality=5, device="cpu"),
    "bc6hu": lambda p: ckt.encode_bc6hu(
        (p.astype(np.int16) * 60), ckt.Options(**LIGHT), device="cpu"),
    "bc6hs": lambda p: ckt.encode_bc6hs(
        (p.astype(np.int16) * 60 - 7000), ckt.Options(**LIGHT),
        device="cpu"),
    "etc1": lambda p: ckt.encode_etc1(p, device="cpu"),
    "etc1_fake709": lambda p: ckt.encode_etc1(
        p, ckt.Options(flags=DEFAULT | FAKE_BT709), device="cpu"),
    "etc2": lambda p: ckt.encode_etc2(p, device="cpu"),
    "etc2_fake709": lambda p: ckt.encode_etc2(
        p, ckt.Options(flags=DEFAULT | FAKE_BT709), device="cpu"),
    "etc2_rgba": lambda p: ckt.encode_etc2_rgba(p, device="cpu"),
    "etc2_punchthrough": lambda p: ckt.encode_etc2_punchthrough(
        p, device="cpu"),
    "etc2_alpha": lambda p: ckt.encode_etc2_alpha(p, device="cpu"),
    "eac11": lambda p: ckt.encode_eac11(
        p[:, :, 0].astype(np.int16) * 8, device="cpu"),
    "eac11s": lambda p: ckt.encode_eac11(
        p[:, :, 0].astype(np.int16) * 8 - 1023, True, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(HOST_COPY_CASES))
def test_no_host_copy_after_warm_up(monkeypatch, case):
    """The second call of each program body makes no tensor of host data
    and reads no tensor data on the host."""
    set_chunks(monkeypatch, 8)
    px = eight_blocks(12)
    assert 0 < (px[:, :, 3] < 128).any(axis=1).sum() < 8
    encode = HOST_COPY_CASES[case]
    first = encode(px).numpy()
    record, ran = HostCalls(), []
    for program in programs.programs():
        record.watch(program, ran)
    from_numpy = torch.from_numpy

    def watched_from_numpy(a):
        if record.active:
            record.calls.append("from_numpy")
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", watched_from_numpy)
    second = encode(px).numpy()
    assert ran, "no program body ran"
    assert record.calls == []
    np.testing.assert_array_equal(first, second)
