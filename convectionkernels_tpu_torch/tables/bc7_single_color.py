"""BC7 single-color tables (equivalent of ConvectionKernels_BC7_SingleColor.h,
regenerated by the MakeTables reimplementation; configurations from
Program.cs:346-408). Each entry: (table_index, p_bits_combined, [256,3] array
of (min, max, actualColor)).

The encoder's single-color candidate never commits a table entry (the
reference's gate is inert, see models/bc7.py _try_single_color), so these
tables are kept for parity and regression tests, not read at run time.
"""

from __future__ import annotations

import functools

from .make_tables import bc7_single_color_table

# (bits, parityBits, parityMin, parityMax, targetIndex, maxIndex) per table,
# in the reference's per-mode table-list order (BC67.cpp:1462-1523).
_MODE_TABLE_CONFIGS = {
    0: [(4, 2, 0, 0, 1, 7), (4, 2, 0, 0, 2, 7), (4, 2, 0, 0, 3, 7),
        (4, 2, 0, 1, 1, 7), (4, 2, 0, 1, 2, 7), (4, 2, 0, 1, 3, 7),
        (4, 2, 1, 0, 1, 7), (4, 2, 1, 0, 2, 7), (4, 2, 1, 1, 3, 7),
        (4, 2, 1, 1, 1, 7), (4, 2, 1, 1, 2, 7), (4, 2, 1, 1, 3, 7)],
    1: [(6, 1, 0, 0, 1, 7), (6, 1, 0, 0, 2, 7), (6, 1, 0, 0, 3, 7),
        (6, 1, 1, 1, 1, 7), (6, 1, 1, 1, 2, 7), (6, 1, 1, 1, 3, 7)],
    2: [(5, 0, 0, 0, 1, 3)],
    3: [(7, 1, 0, 0, 1, 3), (7, 1, 1, 1, 1, 3)],
    6: [(7, 1, 0, 0, 1, 15), (7, 1, 0, 0, 2, 15), (7, 1, 0, 0, 3, 15),
        (7, 1, 0, 0, 4, 15), (7, 1, 0, 0, 5, 15), (7, 1, 0, 0, 6, 15),
        (7, 1, 0, 0, 7, 15), (7, 1, 1, 1, 1, 15), (7, 1, 1, 1, 2, 15),
        (7, 1, 1, 1, 3, 15), (7, 1, 1, 1, 4, 15), (7, 1, 1, 1, 5, 15),
        (7, 1, 1, 1, 6, 15), (7, 1, 1, 1, 7, 15)],
    7: [(7, 2, 0, 0, 1, 3), (7, 2, 0, 1, 1, 3), (7, 2, 1, 0, 1, 3),
        (7, 2, 1, 1, 1, 3)],
}


@functools.lru_cache(maxsize=None)
def mode_tables(mode: int):
    """Returns list of (index, p_bits, np.int32 [256,3]) for a mode."""
    out = []
    for (bits, pbits, pmin, pmax, tidx, maxidx) in _MODE_TABLE_CONFIGS[mode]:
        p_combined = pmin
        if pbits == 2:
            p_combined += pmax << 1
        table = bc7_single_color_table(bits, pbits, pmin, pmax, tidx, maxidx)
        out.append((tidx, p_combined, table))
    return out
