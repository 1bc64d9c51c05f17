"""Texture generators, the mip chain and blockify, frozen.

make_texture_image is chip_smoke.py:494-514 (make_texture) at commit
9895176, returning the image before it is cut into blocks; blockify and
mip_chain are convectionkernels_tpu_torch/utils/image.py:17-41 (the NumPy
path) and :42-63 at the same commit. make_hdr_image and mip_chain_half are
the benchmark's own: the HDR generator stands for lightmaps and
environment maps, and its mips are the 2x2 box filter in float32, rounded
to half.
"""

from __future__ import annotations

import numpy as np


def make_texture_image(seed: int, size: int) -> np.ndarray:
    """A size x size RGBA8 texture from a seed: smooth color fields with
    noise and edges, an opaque region, a region of gradient alpha and a
    punch-through (0/255 alpha) region."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.empty((size, size, 4), dtype=np.float32)
    img[..., 0] = 128 + 100 * np.sin(2 * np.pi * (3 * x + 1.5 * y))
    img[..., 1] = 128 + 90 * np.cos(2 * np.pi * (2 * y - x))
    img[..., 2] = 255 * x * y + 40 * ((x * 16).astype(int) % 2)
    img[..., :3] += rng.normal(0, 6, (size, size, 3))
    img[..., 3] = 255
    img[: size // 2, size // 2:, 3] = 255 * y[: size // 2, size // 2:] * 2
    checker = ((x * 64).astype(int) + (y * 64).astype(int)) % 2
    img[size // 2:, : size // 2, 3] = 255 * checker[size // 2:, : size // 2]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# The HDR generator's shape: a smooth luminance field with a log-normal
# spread (log2 sigma), a few bright spots, a tint per channel, all below
# HDR_MAX so every value is a finite half float.
HDR_SIGMA = 1.5
HDR_SPOTS = 6
HDR_MAX = 1000.0


def make_hdr_image(seed: int, size: int) -> np.ndarray:
    """A size x size RGBA16F texture from a seed as float16 [H, W, 4]: a
    smooth luminance field exp2(N(0, HDR_SIGMA)) built from a few low
    frequencies, HDR_SPOTS bright Gaussian spots (lamps, the sun), a
    smooth tint per channel and a little noise; values in [0, HDR_MAX),
    alpha 1.0."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    field = np.zeros((size, size), dtype=np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.5, 4.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        field += np.sin(2 * np.pi * (fx * x + fy * y) + phase,
                        dtype=np.float32)
    field *= np.float32(HDR_SIGMA / 2.0)   # 4 unit sines: sd sqrt(2)
    lum = np.exp2(field)
    for _ in range(HDR_SPOTS):
        cx, cy = rng.uniform(0, 1, 2)
        radius = rng.uniform(0.005, 0.04)
        peak = rng.uniform(50.0, 600.0)
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        lum += np.float32(peak) * np.exp(-d2 / np.float32(2 * radius ** 2))
    img = np.empty((size, size, 4), dtype=np.float32)
    for ch in range(3):
        tint = 0.6 + 0.4 * np.cos(2 * np.pi * (x * rng.uniform(0.2, 1.0)
                                               + y * rng.uniform(0.2, 1.0))
                                  + rng.uniform(0, 2 * np.pi))
        img[..., ch] = lum * tint * (1.0 + rng.normal(0, 0.02, (size, size)))
    img[..., 3] = 1.0
    img = np.clip(img, 0.0, HDR_MAX)
    return img.astype(np.float16)


def blockify(image: np.ndarray) -> np.ndarray:
    """[H, W, 4] image -> [ceil(H/4)*ceil(W/4), 16, 4] blocks (raster
    order, edge-clamped)."""
    h, w, ch = image.shape
    if ch != 4:
        raise ValueError(f"expected 4 channels, got {ch}")
    bh = (h + 3) // 4
    bw = (w + 3) // 4
    padded = np.pad(image, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)),
                    mode="edge")
    blocks = padded.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(blocks.reshape(-1, 16, 4))


def mip_chain(image: np.ndarray) -> list[np.ndarray]:
    """Full uint8 mip chain [level0, level1, ...] down to 1x1 by 2x2 box
    filter (rounded; next_dim = max(1, dim // 2), an odd last row or
    column dropped)."""
    levels = [image]
    cur = image
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w, c = cur.shape
        nh, nw = max(1, h // 2), max(1, w // 2)
        src = cur[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
        if h > 1 and w > 1:
            f = src.reshape(nh, 2, nw, 2, c).astype(np.uint32)
            cur = ((f.sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)
        elif h > 1:
            f = src.reshape(nh, 2, 1, c).astype(np.uint32)
            cur = ((f.sum(axis=1) + 1) // 2).astype(np.uint8)
        else:
            f = src.reshape(1, nw, 2, c).astype(np.uint32)
            cur = ((f.sum(axis=2) + 1) // 2).astype(np.uint8)
        levels.append(cur)
    return levels


def mip_chain_half(image: np.ndarray) -> list[np.ndarray]:
    """Full float16 mip chain of a square power-of-two image: each level
    the 2x2 mean of the one above, in float32, rounded to half."""
    levels = [image]
    cur = image.astype(np.float32)
    while cur.shape[0] > 1:
        h, w, c = cur.shape
        cur = cur.reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3),
                                                         dtype=np.float32)
        levels.append(cur.astype(np.float16))
    return levels
