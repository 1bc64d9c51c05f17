"""BC7 and BC6H block decoders.

Vectorized NumPy equivalents of the reference's verification decoders
(BC7Computer::UnpackOne, ConvectionKernels_BC67.cpp:2206-2445, and
BC6HComputer::UnpackOne, :3053-3260). Pure
integer math on the host: a correctness oracle and round-trip tool, not a
hot path.
"""

from __future__ import annotations

import numpy as np

from ..tables import bc6h_layout
from ..tables import bc7_geometry as geom
from .bc6h_common import HDR_MODES
from .bc7_common import MODE_INFO

WEIGHTS = {
    2: np.array([0, 21, 43, 64], dtype=np.int64),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int64),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                 64], dtype=np.int64),
}


class _BitReader:
    """Little-endian 128-bit reader over [N, 16] byte blocks.

    Fully vectorized: blocks are expanded once to a [N, 128] bit matrix
    and every peek is a batched gather + weighted sum, so decoding a 4k
    texture runs at NumPy speed."""

    def __init__(self, blocks: np.ndarray):
        self.bits = np.unpackbits(
            np.ascontiguousarray(blocks, dtype=np.uint8), axis=1,
            bitorder="little").astype(np.int64)  # [N, 128]
        self.pos = 0

    def read(self, bits: int):
        out = self.peek(np.full(len(self.bits), self.pos, dtype=np.int64),
                        bits)
        self.pos += bits
        return out

    def peek(self, pos, bits):
        pos = np.asarray(pos, dtype=np.int64)
        if np.isscalar(bits) or isinstance(bits, int):
            wmax = int(bits)
            warr = None
        else:
            warr = np.asarray(bits, dtype=np.int64)
            wmax = int(warr.max()) if warr.size else 0
        n = len(self.bits)
        if wmax == 0:
            return np.zeros(n, dtype=np.int64)
        offs = np.arange(wmax, dtype=np.int64)[None, :]
        idx = pos[:, None] + offs
        valid = idx < 128
        got = np.take_along_axis(self.bits, np.minimum(idx, 127), axis=1)
        got = got & valid
        if warr is not None:
            got = got & (offs < warr[:, None])
        return (got << offs).sum(axis=1)


def decode_bc7(blocks) -> np.ndarray:
    """DecodeBC7: uint8 [N, 16] -> uint8 [N, 16, 4]."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    n = len(blocks)
    out = np.zeros((n, 16, 4), dtype=np.uint8)

    byte0 = blocks[:, 0].astype(np.int64)
    mode = np.full(n, 8, dtype=np.int64)
    for m in range(7, -1, -1):
        is_mode = (byte0 & ((1 << (m + 1)) - 1)) == (1 << m)
        mode = np.where(is_mode, m, mode)

    for m in range(8):
        sel = mode == m
        if not sel.any():
            continue
        out[sel] = _decode_bc7_mode(blocks[sel], m)
    return out


def _decode_bc7_mode(blocks: np.ndarray, mode: int) -> np.ndarray:
    info = MODE_INFO[mode]
    n = len(blocks)
    r = _BitReader(blocks)
    r.pos = mode + 1

    num_subsets = info["num_subsets"]
    partition = r.read(info["partition_bits"]) if info["partition_bits"] \
        else np.zeros(n, dtype=np.int64)
    rotation = r.read(2) if info["alpha"] == "separate" \
        else np.zeros(n, dtype=np.int64)
    index_selector = r.read(1) if info["has_index_selector"] \
        else np.zeros(n, dtype=np.int64)

    fixups = np.zeros((n, 3), dtype=np.int64)
    if info["alpha"] != "separate":
        if num_subsets == 2:
            fixups[:, 1] = geom.FIXUP_INDEXES_2[partition]
        elif num_subsets == 3:
            fixups[:, 1] = geom.FIXUP_INDEXES_3[partition, 0]
            fixups[:, 2] = geom.FIXUP_INDEXES_3[partition, 1]

    rgb_bits = info["rgb_bits"]
    alpha_bits = info["alpha_bits"]
    eps = np.zeros((n, 3, 2, 4), dtype=np.int64)
    for ch in range(3):
        for subset in range(num_subsets):
            for epi in range(2):
                eps[:, subset, epi, ch] = r.read(rgb_bits) << (8 - rgb_bits)
    if info["alpha"] != "none":
        for subset in range(num_subsets):
            for epi in range(2):
                eps[:, subset, epi, 3] = r.read(alpha_bits) \
                    << (8 - alpha_bits)
    else:
        eps[:, :, :, 3] = 255

    parity_bits = 0
    if info["pbit"] == "per_subset":
        for subset in range(num_subsets):
            p = r.read(1)
            for epi in range(2):
                for ch in range(3):
                    eps[:, subset, epi, ch] |= p << (7 - rgb_bits)
                if info["alpha"] != "none":
                    eps[:, subset, epi, 3] |= p << (7 - alpha_bits)
        parity_bits = 1
    elif info["pbit"] == "per_ep":
        for subset in range(num_subsets):
            for epi in range(2):
                p = r.read(1)
                for ch in range(3):
                    eps[:, subset, epi, ch] |= p << (7 - rgb_bits)
                if info["alpha"] != "none":
                    eps[:, subset, epi, 3] |= p << (7 - alpha_bits)
        parity_bits = 1

    for subset in range(num_subsets):
        for epi in range(2):
            for ch in range(3):
                eps[:, subset, epi, ch] |= \
                    eps[:, subset, epi, ch] >> (rgb_bits + parity_bits)
            if info["alpha"] != "none":
                eps[:, subset, epi, 3] |= \
                    eps[:, subset, epi, 3] >> (alpha_bits + parity_bits)

    ib = info["index_bits"]
    aib = info["alpha_index_bits"]
    indexes = np.zeros((n, 16), dtype=np.int64)
    pos = np.full(n, r.pos, dtype=np.int64)
    for px in range(16):
        width = np.full(n, ib, dtype=np.int64)
        is_anchor = (px == 0) | (px == fixups[:, 1]) | (px == fixups[:, 2])
        width -= is_anchor.astype(np.int64)
        indexes[:, px] = r.peek(pos, width)
        pos += width
    indexes2 = np.zeros((n, 16), dtype=np.int64)
    if info["alpha"] == "separate":
        for px in range(16):
            width = aib - (1 if px == 0 else 0)
            indexes2[:, px] = r.peek(pos, width)
            pos += width

    rgb_w = WEIGHTS[ib]
    alpha_w = WEIGHTS[aib] if aib else None

    out = np.zeros((n, 16, 4), dtype=np.uint8)
    for px in range(16):
        rgb_weight = rgb_w[indexes[:, px]]
        if info["alpha"] == "combined":
            alpha_weight = rgb_weight
        elif info["alpha"] == "separate":
            alpha_weight = alpha_w[indexes2[:, px]]
        else:
            alpha_weight = np.zeros(n, dtype=np.int64)
        if info["has_index_selector"]:
            swap = index_selector == 1
            rgb_weight, alpha_weight = (
                np.where(swap, alpha_weight, rgb_weight),
                np.where(swap, rgb_weight, alpha_weight))

        if num_subsets == 2:
            subset = (geom.PARTITION_MAP_2[partition] >> px) & 1
        elif num_subsets == 3:
            subset = (geom.PARTITION_MAP_3[partition] >> (2 * px)) & 3
        else:
            subset = np.zeros(n, dtype=np.int64)
        subset = np.asarray(subset, dtype=np.int64)

        pixel = np.zeros((n, 4), dtype=np.int64)
        pixel[:, 3] = 255
        ep = eps[np.arange(n), subset]  # [n, 2, 4]
        for ch in range(3):
            pixel[:, ch] = ((64 - rgb_weight) * ep[:, 0, ch]
                            + rgb_weight * ep[:, 1, ch] + 32) >> 6
        if info["alpha"] != "none":
            pixel[:, 3] = ((64 - alpha_weight) * ep[:, 0, 3]
                           + alpha_weight * ep[:, 1, 3] + 32) >> 6

        if info["alpha"] == "separate":
            for rot in range(1, 4):
                m = rotation == rot
                tmp = pixel[m, rot - 1].copy()
                pixel[m, rot - 1] = pixel[m, 3]
                pixel[m, 3] = tmp

        out[:, px] = pixel.astype(np.uint8)
    return out


def _sign_extend(v, bits):
    mask = np.int64(1) << (bits - 1)
    return (v ^ mask) - mask


def decode_bc6h(blocks, signed: bool = False) -> np.ndarray:
    """DecodeBC6HU/S: uint8 [N, 16] -> int16 [N, 16, 4] (half-float bits)."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    n = len(blocks)
    out = np.zeros((n, 16, 4), dtype=np.int16)
    out[:, :, 3] = 0x3C00

    b0 = blocks[:, 0].astype(np.int64)
    mode_bits = np.where((b0 & 3) < 2, b0 & 3, b0 & 0x1F)
    mode = np.full(n, -1, dtype=np.int64)
    for mi, (mode_id, *_rest) in enumerate(HDR_MODES):
        mode = np.where(mode_bits == mode_id, mi, mode)

    for mi in range(len(HDR_MODES)):
        sel = mode == mi
        if not sel.any():
            continue
        out[sel] = _decode_bc6h_mode(blocks[sel], mi, signed)
    return out


def _decode_bc6h_mode(blocks: np.ndarray, mode_idx: int,
                      signed: bool) -> np.ndarray:
    mode_id, partitioned, transformed, aprec, bprec = HDR_MODES[mode_idx]
    n = len(blocks)
    r = _BitReader(blocks)

    header_bits = 82 if partitioned else 65
    fields = {f: np.zeros(n, dtype=np.int64)
              for f in ("m", "d", "rw", "rx", "ry", "rz", "gw", "gx", "gy",
                        "gz", "bw", "bx", "by", "bz")}
    for (field, src, dst, length) in bc6h_layout.LAYOUTS[mode_idx]:
        chunk = r.peek(np.full(n, dst, dtype=np.int64), length)
        fields[field] |= chunk << src

    partition = fields["d"]
    eps = np.zeros((n, 2, 2, 3), dtype=np.int64)
    for ch, pre in enumerate("rgb"):
        eps[:, 0, 0, ch] = fields[pre + "w"]
        eps[:, 0, 1, ch] = fields[pre + "x"]
        eps[:, 1, 0, ch] = fields[pre + "y"]
        eps[:, 1, 1, ch] = fields[pre + "z"]

    num_subsets = 2 if partitioned else 1
    index_bits = 3 if partitioned else 4
    fixup1 = geom.FIXUP_INDEXES_2[partition] if partitioned \
        else np.zeros(n, dtype=np.int64)

    indexes = np.zeros((n, 16), dtype=np.int64)
    pos = np.full(n, header_bits, dtype=np.int64)
    for px in range(16):
        width = np.full(n, index_bits, dtype=np.int64)
        width -= ((px == 0) | (px == fixup1)).astype(np.int64)
        indexes[:, px] = r.peek(pos, width)
        pos += width

    for ch in range(3):
        if signed:
            eps[:, 0, 0, ch] = _sign_extend(eps[:, 0, 0, ch], aprec)
        if transformed or signed:
            eps[:, 0, 1, ch] = _sign_extend(eps[:, 0, 1, ch], bprec[ch])
            if partitioned:
                eps[:, 1, 0, ch] = _sign_extend(eps[:, 1, 0, ch], bprec[ch])
                eps[:, 1, 1, ch] = _sign_extend(eps[:, 1, 1, ch], bprec[ch])

    if transformed:
        wrap = (1 << aprec) - 1
        for ch in range(3):
            eps[:, 0, 1, ch] = (eps[:, 0, 0, ch] + eps[:, 0, 1, ch]) & wrap
            if signed:
                eps[:, 0, 1, ch] = _sign_extend(eps[:, 0, 1, ch], aprec)
            if partitioned:
                for s_epi in ((1, 0), (1, 1)):
                    v = (eps[:, 0, 0, ch]
                         + eps[:, s_epi[0], s_epi[1], ch]) & wrap
                    if signed:
                        v = _sign_extend(v, aprec)
                    eps[:, s_epi[0], s_epi[1], ch] = v

    # unquantize (BC67.cpp:3195-3244)
    for subset in range(num_subsets):
        for epi in range(2):
            for ch in range(3):
                v = eps[:, subset, epi, ch]
                if signed:
                    if aprec < 16:
                        s = v < 0
                        comp = np.abs(v)
                        unq = np.where(
                            comp == 0, 0,
                            np.where(comp >= (1 << (aprec - 1)) - 1, 0x7FFF,
                                     ((comp << 15) + 0x4000) >> (aprec - 1)))
                        v = np.where(s, -unq, unq)
                else:
                    if aprec < 15:
                        v = np.where(
                            v == 0, 0,
                            np.where(v == (1 << aprec) - 1, 0xFFFF,
                                     ((v << 16) + 0x8000) >> aprec))
                eps[:, subset, epi, ch] = v

    weights = WEIGHTS[index_bits]
    out = np.zeros((n, 16, 4), dtype=np.int16)
    out[:, :, 3] = 0x3C00
    for px in range(16):
        if partitioned:
            subset = np.asarray((geom.PARTITION_MAP_2[partition] >> px) & 1,
                                dtype=np.int64)
        else:
            subset = np.zeros(n, dtype=np.int64)
        w = weights[indexes[:, px]]
        ep = eps[np.arange(n), subset]
        for ch in range(3):
            comp = ((64 - w) * ep[:, 0, ch] + w * ep[:, 1, ch] + 32) >> 6
            if signed:
                comp = np.where(comp < 0, -((-comp * 31) >> 5),
                                (comp * 31) >> 5)
                sign = np.where(comp < 0, 0x8000, 0)
                comp = np.abs(comp) | sign
            else:
                comp = (comp * 31) >> 6
            out[:, px, ch] = comp.astype(np.uint16).astype(np.int16)
    return out
