"""The port's host-side utils against the JAX package's, on the CPU.

blockify, unblockify and mip_chain (through the native C++ blockify and
through the NumPy path), the KTX and DDS writers and their tables, and the
metrics. Inputs come from seeded numpy generators; every comparison is of
bytes or of exact floats, so the tolerance is 0.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from convectionkernels_tpu.utils import containers as jax_containers
from convectionkernels_tpu.utils import image as jax_image
from convectionkernels_tpu.utils import metrics as jax_metrics
from convectionkernels_tpu_torch.utils import containers, image, metrics, native

SIZES = ((1, 1), (3, 5), (17, 30), (64, 64))


@pytest.fixture(params=("native", "numpy"))
def blockify_path(request, monkeypatch):
    """Run image.blockify through the C++ library or through NumPy."""
    if request.param == "native":
        assert native.available(), "g++ could not build native/blockify.cpp"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def seeded_image(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("channels", (3, 4), ids=("rgb", "rgba"))
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_image_matches_jax(size, channels, blockify_path):
    h, w = size
    img = seeded_image(h, w, channels, seed=h * 100 + w + channels)
    blocks = image.blockify(img)
    assert blocks.dtype == np.uint8 and blocks.flags.c_contiguous
    np.testing.assert_array_equal(blocks, jax_image.blockify(img))
    np.testing.assert_array_equal(image.unblockify(blocks, h, w),
                                  jax_image.unblockify(blocks, h, w))
    if blockify_path == "native":
        np.testing.assert_array_equal(native.unblockify(blocks, h, w),
                                      jax_image.unblockify(blocks, h, w))
    chain, jax_chain = image.mip_chain(img), jax_image.mip_chain(img)
    assert len(chain) == len(jax_chain)
    for level, jax_level in zip(chain, jax_chain):
        np.testing.assert_array_equal(level, jax_level)
        np.testing.assert_array_equal(image.blockify(level),
                                      jax_image.blockify(jax_level))


def test_blockify_refuses_what_jax_refuses():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 2), np.uint8)):
        with pytest.raises(ValueError):
            jax_image.blockify(bad)
        with pytest.raises(ValueError):
            image.blockify(bad)
    with pytest.raises(ValueError):
        native.blockify(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        native.unblockify(np.zeros((2, 16, 4), np.uint8), 4, 4)


def test_native_builds_concurrently(tmp_path, monkeypatch):
    """Builds that run at once (parallel test workers) each write a
    temporary file and rename it, so the library is always whole and no
    temporary file is left behind."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    path = native.library_path()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        builds = [pool.submit(native._build, path) for _ in range(6)]
        for build in builds:
            build.result(timeout=300)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    native._lib.cache_clear()
    try:
        img = seeded_image(9, 7, 4, seed=5)
        np.testing.assert_array_equal(native.blockify(img),
                                      jax_image.blockify(img))
    finally:
        native._lib.cache_clear()


def test_native_missing_source_falls_back(monkeypatch):
    monkeypatch.setattr(native, "SOURCE", "/nonexistent/blockify.cpp")
    native._lib.cache_clear()
    try:
        assert not native.available()
        img = seeded_image(6, 10, 4, seed=6)
        np.testing.assert_array_equal(image.blockify(img),
                                      jax_image.blockify(img))
    finally:
        native._lib.cache_clear()


# --- containers ----------------------------------------------------------------

def test_container_tables_match_jax():
    for name in ("GL_INTERNAL_FORMATS", "GL_BASE_FORMATS", "BLOCK_BYTES",
                 "DXGI_FORMATS"):
        assert getattr(containers, name) == getattr(jax_containers, name), \
            name
    assert containers._KTX_MAGIC == jax_containers._KTX_MAGIC


def mip_levels(fmt, width, height, seed):
    """(blocks, w, h) of every mip level of a width x height texture, with
    seeded bytes of the format's block size."""
    rng = np.random.default_rng(seed)
    levels = []
    while True:
        n = ((width + 3) // 4) * ((height + 3) // 4)
        levels.append((rng.integers(0, 256, (n, containers.BLOCK_BYTES[fmt]),
                                    dtype=np.uint8), width, height))
        if width == 1 and height == 1:
            return levels
        width, height = max(1, width // 2), max(1, height // 2)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", sorted(containers.GL_INTERNAL_FORMATS))
def test_containers_match_jax(fmt, tmp_path):
    """KTX and DDS files of one level and of a mip chain, byte for byte; on
    a format without a DXGI code both DDS writers raise ValueError."""
    levels = mip_levels(fmt, 37, 22, seed=len(fmt))
    single = levels[0]
    for name, args, kwargs in (
            ("one", (single[0], single[1], single[2]), {}),
            ("mips", (levels,), {})):
        for kind in ("ktx", "dds"):
            port = str(tmp_path / f"port_{name}.{kind}")
            ref = str(tmp_path / f"jax_{name}.{kind}")
            write = getattr(containers, f"write_{kind}")
            jax_write = getattr(jax_containers, f"write_{kind}")
            if kind == "dds" and fmt not in containers.DXGI_FORMATS:
                with pytest.raises(ValueError) as got:
                    write(port, *args, fmt=fmt, **kwargs)
                with pytest.raises(ValueError) as want:
                    jax_write(ref, *args, fmt=fmt, **kwargs)
                assert str(got.value) == str(want.value)
                continue
            write(port, *args, fmt=fmt, **kwargs)
            jax_write(ref, *args, fmt=fmt, **kwargs)
            assert read(port) == read(ref), (name, kind)


# --- metrics -------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(31)
    a = rng.integers(0, 256, (64, 16, 4), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    for x, y in ((a, b), (a, a), (a[:, :, :3], b[:, :, :3])):
        for peak in (255.0, 1.0):
            assert metrics.psnr(x, y, peak) == jax_metrics.psnr(x, y, peak)
        assert metrics.rmse(x, y) == jax_metrics.rmse(x, y)
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.psnr(torch.as_tensor(a), b) == jax_metrics.psnr(a, b)
    ea = rng.integers(0, 256, (100, 16), dtype=np.uint8)
    eb = ea.copy()
    eb[rng.permutation(100)[:37], rng.integers(0, 16, 37)] ^= 1
    assert metrics.match_rate(ea, eb) == jax_metrics.match_rate(ea, eb) \
        == 0.63


def test_throughput_and_profile_encode_on_cpu(tmp_path):
    pixels = torch.zeros((64, 16, 4), dtype=torch.uint8)
    calls = []

    def encode(px):
        calls.append(px.shape[0])
        return px.reshape(px.shape[0], -1)[:, :8].clone()

    t = metrics.Throughput()
    assert t.mtexels_per_s == 0.0
    for _ in range(2):
        with t:
            encode(pixels)
        t.add_blocks(pixels.shape[0])
    assert t.texels == 2 * 64 * 16 and t.elapsed > 0
    assert t.mtexels_per_s == t.texels / t.elapsed / 1e6

    calls.clear()
    result = metrics.profile_encode(encode, pixels, iters=2)
    assert set(result) == {"seconds", "mtexels_per_s"}
    assert result["seconds"] > 0 and calls == [64, 64, 64]
    assert result["mtexels_per_s"] == 64 * 16 / result["seconds"] / 1e6

    calls.clear()
    trace = tmp_path / "trace"
    metrics.profile_encode(encode, pixels, trace_dir=str(trace), iters=1)
    assert calls == [64, 64, 64]        # warm-up, traced call, timed call
    assert (trace / "trace.json").stat().st_size > 0
