"""Image <-> 4x4 block conversion.

The counterpart of the JAX package's utils/image.py and of the reference
CLI's blockification loop (etc2packer.cpp:222-248): an image is split into
4x4 RGBA blocks in raster order with edge-clamp padding. NumPy on the
host; the C++ blockify of native/blockify.cpp (utils/native.py) is used
when it builds.
"""

from __future__ import annotations

import numpy as np

from . import native


def blockify(image: np.ndarray) -> np.ndarray:
    """[H, W, C] u8 image -> [ceil(H/4)*ceil(W/4), 16, 4] blocks (raster
    order, edge-clamped, alpha filled with 255 when C == 3)."""
    if image.ndim != 3:
        raise ValueError(f"expected [H, W, C], got {image.shape}")
    h, w, ch = image.shape
    if ch == 3:
        rgba = np.empty((h, w, 4), dtype=np.uint8)
        rgba[..., :3] = image
        rgba[..., 3] = 255
        image = rgba
    elif ch != 4:
        raise ValueError(f"expected 3 or 4 channels, got {ch}")

    if native.available():
        return native.blockify(np.ascontiguousarray(image, dtype=np.uint8))

    bh = (h + 3) // 4
    bw = (w + 3) // 4
    padded = np.pad(image, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)),
                    mode="edge")
    blocks = padded.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(blocks.reshape(-1, 16, 4))


def mip_chain(image: np.ndarray) -> list[np.ndarray]:
    """Full mip chain [level0, level1, ...] down to 1x1 by 2x2 box filter
    (rounded; next_dim = max(1, dim // 2), an odd last row or column
    dropped)."""
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


def unblockify(blocks: np.ndarray, height: int, width: int) -> np.ndarray:
    """[Nblocks, 16, 4] -> [H, W, 4] (inverse of blockify)."""
    bh = (height + 3) // 4
    bw = (width + 3) // 4
    img = blocks.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)
    return img[:height, :width]
