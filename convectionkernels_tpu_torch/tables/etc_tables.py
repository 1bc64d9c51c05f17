"""ETC1/ETC2 constant tables.

A copy of the JAX package's tables/etc_tables.py (NumPy only): importing
that module would run the JAX package's __init__, which imports jax.

Modifier tables are ETC format constants; the potential-offset lists are
derived here the way the reference derived them offline (etc_notes.txt:3-7):
for each ETC1 modifier table, the unique achievable sums of 8 per-pixel
modifier picks (the offsets applied to an 8-pixel cumulative sum). The ETC2
alpha rounding tables and FakeBT709 octant table are regenerated with our
MakeTables reimplementation (Program.cs:150-301 equivalents).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

# ETC1 modifier tables (format constant; ETC.cpp:2663-2673)
ETC1_MODIFIER_TABLES = np.array([
    [-8, -2, 2, 8],
    [-17, -5, 5, 17],
    [-29, -9, 9, 29],
    [-42, -13, 13, 42],
    [-60, -18, 18, 60],
    [-80, -24, 24, 80],
    [-106, -33, 33, 106],
    [-183, -47, 47, 183],
], dtype=np.int32)

# T/H mode modifiers (format constant; ETC1.h:23-26)
TH_MODIFIER_TABLE = np.array([3, 6, 11, 16, 23, 32, 41, 64], dtype=np.int32)

# ETC2 alpha modifier tables, positive halves (format constant; ETC2.h:14-31)
ALPHA_MODIFIER_TABLE_POSITIVE = np.array([
    [2, 5, 8, 14], [2, 6, 9, 12], [1, 4, 7, 12], [1, 3, 5, 12],
    [2, 5, 7, 11], [2, 6, 8, 10], [3, 6, 7, 10], [2, 4, 7, 10],
    [1, 5, 7, 9], [1, 4, 7, 9], [1, 3, 7, 9], [1, 4, 6, 9],
    [2, 3, 6, 9], [0, 1, 2, 9], [3, 5, 7, 8], [2, 4, 6, 8],
], dtype=np.int32)

ALPHA_ROUNDING_TABLE_WIDTH = 13


@functools.lru_cache(maxsize=None)
def potential_offsets(table: int) -> np.ndarray:
    """Unique achievable 8-pick modifier sums for an ETC1 table, sorted.

    Equivalent to Tables::ETC1::g_potentialOffsets4 (ETC1.h:9-21).
    """
    mods = ETC1_MODIFIER_TABLES[table]
    sums = set()
    # counts (k0,k1,k2,k3) with sum 8 over the 4 modifiers
    for k0 in range(9):
        for k1 in range(9 - k0):
            for k2 in range(9 - k0 - k1):
                k3 = 8 - k0 - k1 - k2
                sums.add(int(k0 * mods[0] + k1 * mods[1] + k2 * mods[2]
                             + k3 * mods[3]))
    return np.array(sorted(sums), dtype=np.int32)


MAX_POTENTIAL_OFFSETS = 81


@functools.lru_cache(maxsize=None)
def alpha_rounding_tables() -> np.ndarray:
    """g_alphaRoundingTables[16][13] (MakeTables Program.cs:150-219):
    nearest-modifier index per rounder value."""
    out = np.zeros((16, ALPHA_ROUNDING_TABLE_WIDTH), dtype=np.int32)
    for table in range(16):
        for rounder in range(ALPHA_ROUNDING_TABLE_WIDTH):
            diffs = np.abs(rounder - ALPHA_MODIFIER_TABLE_POSITIVE[table])
            out[table, rounder] = int(np.argmin(diffs))  # first-min wins
    return out


def _fake_bt709(r, g, b):
    """double-precision FakeBT709 transform (Program.cs:222-231; note the
    float literal 0.5f in the u row, replicated)."""
    y = r * 0.368233989135369 + g * 1.23876274963149 + b * 0.125054068802017
    u = r * np.float32(0.5) - g * 0.4541529 - b * 0.04584709
    v = (r * -0.081014709086133 - g * 0.272538676238785
         + b * 0.353553390593274)
    return y, u, v


@functools.lru_cache(maxsize=None)
def fake_bt709_rounding16() -> np.ndarray:
    """FakeBT709::g_rounding16[16^3] best-octant LUT (Program.cs:233-301)."""
    res = 16
    out = np.zeros(res * res * res, dtype=np.int32)
    octants = []
    for octant in range(8):
        o_r = res if (octant & 1) else 0
        o_g = res if (octant & 2) else 0
        o_b = res if (octant & 4) else 0
        octants.append(_fake_bt709(float(o_r), float(o_g), float(o_b)))
    for r in range(res):
        for g in range(res):
            y, u, v = _fake_bt709(float(r), float(g), 0.0)
            for b in range(res):
                yb, ub, vb = _fake_bt709(float(r), float(g), float(b))
                best = float("inf")
                best_octant = 0
                for octant in range(8):
                    oy, ou, ov = octants[octant]
                    err = (oy - yb) ** 2 + (ou - ub) ** 2 + (ov - vb) ** 2
                    if err < best:
                        best = err
                        best_octant = octant
                out[(r * res + g) * res + b] = best_octant
    return out
