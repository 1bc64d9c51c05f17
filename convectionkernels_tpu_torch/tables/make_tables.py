"""Offline table generation (S3TC and BC7 parts).

Python/NumPy reimplementation of the S3TC and BC7 halves of the reference's
MakeTables app (MakeTables/Program.cs): brute-force optimal single-color
tables.
Tables are computed on demand and cached in-process; they are tiny (KBs)
and generation takes milliseconds, so nothing is persisted to disk.
"""

from __future__ import annotations

import functools

import numpy as np


def bit_expand(v, bits: int):
    """BitExpand (Program.cs:9-13)."""
    v = v << (8 - bits)
    return v | (v >> bits)


def bit_expand_p(v, bits: int, parity_bit: int):
    """BitExpandP (Program.cs:15-21)."""
    v = v << (8 - bits)
    v = v | (parity_bit << (7 - bits))
    return v | (v >> (bits + 1))


@functools.lru_cache(maxsize=None)
def s3tc_single_color_table(bits: int, max_index: int, paranoia: float):
    """EmitTable (Program.cs:95-148): optimal single-color S3TC endpoints.

    Returns int32 [256, 4]: (min, max, actualColor, span) per target value.
    Candidate order and the (error, then smaller-span) tie-break match the
    C# loops exactly (double-precision error math as in C#).
    """
    ep_range = 1 << bits
    ep = np.arange(ep_range)
    expanded = bit_expand(ep, bits)
    mn = expanded[:, None]  # min-major iteration order
    mx = expanded[None, :]
    interpolated = (mn * (max_index - 1) + mx) // max_index
    span = np.abs(mn - mx)

    interp_flat = interpolated.reshape(-1)
    span_flat = span.reshape(-1)
    mn_flat = np.broadcast_to(mn, interpolated.shape).reshape(-1)
    mx_flat = np.broadcast_to(mx, interpolated.shape).reshape(-1)
    order = np.arange(interp_flat.size)

    out = np.zeros((256, 4), dtype=np.int32)
    for i in range(256):
        delta = np.abs(interp_flat - i).astype(np.float64) + span_flat * paranoia
        error = delta * delta
        # winner: first (iteration order) among min error, span tie-break
        best = np.lexsort((order, span_flat, error))[0]
        out[i] = (mn_flat[best], mx_flat[best], interp_flat[best],
                  span_flat[best])
    return out


# BC7 interpolation weights (Program.cs:23-25; also BC67.cpp:121-132)
BC7_WEIGHT2 = np.array([0, 21, 43, 64], dtype=np.int32)
BC7_WEIGHT3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int32)
BC7_WEIGHT4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def bc7_single_color_table(bits: int, parity_bits: int, parity_min: int,
                           parity_max: int, target_index: int, max_index: int):
    """EmitTableBC7 (Program.cs:27-93): optimal BC7 single-color endpoints.

    Returns int32 [256, 3]: (min, max, actualColor). First-strictly-better
    candidate wins (no span tie-break), matching the C# loop.
    """
    ep_range = 1 << bits
    ep = np.arange(ep_range)
    if parity_bits != 0:
        min_exp = bit_expand_p(ep, bits, parity_min)
        max_exp = bit_expand_p(ep, bits, parity_max)
    else:
        min_exp = bit_expand(ep, bits)
        max_exp = bit_expand(ep, bits)

    weights = {3: BC7_WEIGHT2, 7: BC7_WEIGHT3, 15: BC7_WEIGHT4}[max_index]
    w = int(weights[target_index])

    mn = min_exp[:, None]
    mx = max_exp[None, :]
    interpolated = ((64 - w) * mn + w * mx + 32) >> 6

    interp_flat = interpolated.reshape(-1)
    mn_flat = np.broadcast_to(mn, interpolated.shape).reshape(-1)
    mx_flat = np.broadcast_to(mx, interpolated.shape).reshape(-1)
    order = np.arange(interp_flat.size)

    out = np.zeros((256, 3), dtype=np.int32)
    for i in range(256):
        delta = (interp_flat - i).astype(np.float64)
        error = delta * delta
        best = np.lexsort((order, error))[0]
        out[i] = (mn_flat[best], mx_flat[best], interp_flat[best])
    return out
