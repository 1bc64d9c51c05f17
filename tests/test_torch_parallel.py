"""The port's block axis split on the CPU: encode_sharded over several
devices and encode_image_distributed over two gloo processes give the
bytes of one call; blockify_local_slice gives the JAX package's slices.
tests/test_torch_cuda.py runs the two processes on one card as well.

Tolerance 0: bytes are compared as bytes. The two-process test starts this
file as its worker:

    python -m tests.test_torch_parallel <init_method> <world> <rank> \
        <outdir> <device>
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import api
from convectionkernels_tpu_torch.parallel import distributed, sharding
from convectionkernels_tpu_torch.utils import image
from tests import blockgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT = ckt.Options(seed_points=1, refine_rounds_bc7=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def punchthrough_mix(n=203, seed=811):
    """n blocks: the first 70 without a transparent pixel, the last 70 all
    transparent, a random share of transparent pixels between, so that
    each third of the block axis splits differently."""
    rng = np.random.default_rng(seed)
    px = blockgen.mixed_blocks(n, seed=seed + 1)
    alpha = np.where(rng.random((n, 16)) < rng.random((n, 1)), 0, 255)
    alpha[:70] = rng.integers(128, 256, (70, 16))
    alpha[-70:] = rng.integers(0, 128, (70, 16))
    px[:, :, 3] = alpha
    return px


# (name, entry point with its options, CHUNK_* attribute, pixels)
SHARDED = (
    ("bc1", ckt.encode_bc1, "CHUNK_S3TC",
     lambda: blockgen.mixed_blocks(203, seed=801)),
    ("bc7_light", functools.partial(ckt.encode_bc7, options=LIGHT, quality=5),
     "CHUNK_BC7", lambda: blockgen.mixed_blocks(203, seed=803)),
    ("etc2_punchthrough", ckt.encode_etc2_punchthrough, "CHUNK_ETC2",
     punchthrough_mix),
)


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
def test_encode_sharded_equals_one_call(case, monkeypatch):
    """203 blocks over three CPU slices (68, 68, 67), each encoded in
    chunks of 16, equal one call at the default chunk."""
    _, encode, chunk_attr, make = case
    px = make()
    want = encode(px, device="cpu").numpy()
    monkeypatch.setattr(api, chunk_attr, 16)
    got = sharding.encode_sharded(encode, px, ["cpu"] * 3)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_encode_sharded_slices():
    """Contiguous slices, none empty, in device order; a tensor input and
    fewer blocks than devices."""
    seen = []

    def encode(px, device):
        seen.append((px.shape[0], str(device)))
        return ckt.encode_bc1(px, device=device)

    px = blockgen.random_blocks(10, seed=805)
    want = ckt.encode_bc1(px, device="cpu").numpy()
    np.testing.assert_array_equal(
        sharding.encode_sharded(encode, torch.as_tensor(px),
                                ["cpu", torch.device("cpu"), "cpu"]), want)
    assert seen == [(4, "cpu"), (4, "cpu"), (2, "cpu")]
    seen.clear()
    np.testing.assert_array_equal(
        sharding.encode_sharded(encode, px[:2], ["cpu"] * 3), want[:2])
    assert seen == [(1, "cpu"), (1, "cpu")]
    seen.clear()
    assert sharding.encode_sharded(encode, px[:0], ["cpu"] * 3).shape == (0, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            sharding.encode_sharded(encode, px)


IMAGES = ((1, 1), (5, 7), (17, 30), (33, 13), (40, 44))


@pytest.mark.parametrize("world", (1, 2, 3, 4))
def test_blockify_local_slice_matches_jax(world):
    """Every rank's slice (padding included) equals the JAX function's for
    the same start, end and n_blocks, and the ranks' real blocks put
    together are the image's blocks."""
    from convectionkernels_tpu.parallel import distributed as jax_dist
    for h, w in IMAGES:
        img = np.random.default_rng(h * 64 + w).integers(
            0, 256, (h, w, 4), dtype=np.uint8)
        n_blocks = ((h + 3) // 4) * ((w + 3) // 4)
        n_pad = sharding.pad_to_multiple(n_blocks, world)
        per = n_pad // world
        real = []
        for rank in range(world):
            start, end = rank * per, (rank + 1) * per
            got = distributed.blockify_local_slice(img, start, end, n_blocks)
            np.testing.assert_array_equal(
                got, jax_dist.blockify_local_slice(img, start, end, n_blocks))
            assert got.shape == (per, 16, 4)
            real.append(got[: max(0, min(end, n_blocks) - start)])
        np.testing.assert_array_equal(np.concatenate(real),
                                      image.blockify(img))


def test_without_a_group_one_process_owns_everything():
    assert distributed.local_block_range(99, 99) == (0, 99)
    img = worker_image()
    want = ckt.encode_bc1(image.blockify(img), device="cpu").numpy()
    local, start, n_blocks = distributed.encode_image_distributed(
        ckt.encode_bc1, img, device="cpu")
    assert (start, n_blocks) == (0, 99)
    np.testing.assert_array_equal(local, want)
    np.testing.assert_array_equal(distributed.encode_image_distributed(
        ckt.encode_bc1, img, device="cpu", assemble=True), want)


def worker_image():
    """36 x 44 pixels: 9 x 11 = 99 blocks, so two ranks need one pad
    block."""
    return np.random.default_rng(7).integers(0, 256, (36, 44, 4),
                                             dtype=np.uint8)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_encode(tmp_path):
    """Two gloo processes on the CPU: each rank's local bytes are its slice
    of one call's bytes, and the assembled bytes on each rank are all of
    them."""
    check_two_gloo_processes(tmp_path, "cpu")


def check_two_gloo_processes(tmp_path, device):
    """Two gloo worker processes encoding worker_image() with encode_bc1 on
    `device` (tests/test_torch_cuda.py runs them on one card): each rank's
    local bytes are its slice of one call's, and each rank's assembled
    bytes are all of them."""
    init_method = f"tcp://localhost:{free_port()}"
    workers = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_parallel", init_method, "2",
         str(rank), str(tmp_path), device], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [w.communicate(timeout=240)[0] for w in workers]
    finally:
        for w in workers:
            w.kill()
            w.wait()
    for rank, w in enumerate(workers):
        assert w.returncode == 0, f"rank {rank}:\n{outs[rank]}"
    want = ckt.encode_bc1(image.blockify(worker_image()),
                          device=device).cpu().numpy()
    locals_ = []
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            assert int(z["n_blocks"]) == 99
            assert int(z["start"]) == 50 * rank
            locals_.append(z["local"])
            np.testing.assert_array_equal(z["full"], want)
    assert [len(x) for x in locals_] == [50, 49]
    np.testing.assert_array_equal(np.concatenate(locals_), want)


def _worker(init_method, world, rank, outdir, device):
    torch.set_num_threads(1)
    distributed.initialize("gloo", init_method, int(world), int(rank))
    try:
        img = worker_image()
        local, start, n_blocks = distributed.encode_image_distributed(
            ckt.encode_bc1, img, device=device)
        full = distributed.encode_image_distributed(
            ckt.encode_bc1, img, device=device, assemble=True)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), local=local,
                 start=start, n_blocks=n_blocks, full=full)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(*sys.argv[1:])
