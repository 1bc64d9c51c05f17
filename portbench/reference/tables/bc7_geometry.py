# Frozen copy of convectionkernels_tpu_torch/tables/bc7_geometry.py:1-161 at
# commit 9895176, the benchmark's plain reference: never edited to follow
# the program. Unchanged but for this header.
"""BC7 partition geometry and CVTT shape numbering.

The partition maps and fixup indexes are BC7 format constants (also at
ConvectionKernels_BC67.cpp:173-253). The shape-ID assignment
(which unique pixel-subset gets which ID, BC67.cpp:531-552) is CVTT's
numbering; it is load-bearing because BC7EncodingPlan seed counts and the
priority tables are indexed by shape ID. Shape pixel-sets themselves are
derived here from the partition maps + the assignment, replacing the
reference's g_fragments/g_shapeRanges flat tables.
"""

from __future__ import annotations

import functools

import numpy as np

# BC7 2-subset partition bitmaps (format constant; BC67.cpp:173-191)
PARTITION_MAP_2 = np.array([
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
], dtype=np.int64)

# BC7 3-subset partition 2-bit fields (format constant; BC67.cpp:193-211)
PARTITION_MAP_3 = np.array([
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8,
    0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050,
    0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090,
    0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250,
    0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0,
    0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
    0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200,
    0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424,
    0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
    0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0,
    0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
    0xAA444444, 0x54A854A8, 0x95809580, 0x96969600,
    0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254,
], dtype=np.int64)

# Fixup indexes (format constant; BC67.cpp:213-253)
FIXUP_INDEXES_2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
], dtype=np.int32)

FIXUP_INDEXES_3 = np.array([
    [3, 15], [3, 8], [15, 8], [15, 3], [8, 15], [3, 15], [15, 3], [15, 8],
    [8, 15], [8, 15], [6, 15], [6, 15], [6, 15], [5, 15], [3, 15], [3, 8],
    [3, 15], [3, 8], [8, 15], [15, 3], [3, 15], [3, 8], [6, 15], [10, 8],
    [5, 3], [8, 15], [8, 6], [6, 10], [8, 15], [5, 15], [15, 10], [15, 8],
    [8, 15], [15, 3], [3, 15], [5, 10], [6, 10], [10, 8], [8, 9], [15, 10],
    [15, 6], [3, 15], [15, 8], [5, 15], [15, 3], [15, 6], [15, 6], [15, 8],
    [3, 15], [15, 3], [5, 15], [5, 15], [5, 15], [8, 15], [5, 15], [10, 15],
    [5, 15], [10, 15], [8, 15], [13, 15], [15, 3], [12, 15], [3, 15], [3, 8],
], dtype=np.int32)

# CVTT shape-ID assignment: partition -> shape IDs per subset
# (BC67.cpp:531-552; the numbering plan seed counts / prio tables index by)
SHAPES_2 = np.array([
    [33, 96], [63, 66], [20, 109], [22, 107], [37, 92], [7, 122], [8, 121],
    [23, 106], [38, 91], [2, 127], [9, 120], [26, 103], [3, 126], [6, 123],
    [1, 128], [19, 110], [15, 114], [124, 5], [72, 57], [115, 14], [125, 4],
    [70, 59], [100, 29], [60, 69], [116, 13], [99, 30], [78, 51], [94, 35],
    [104, 25], [111, 18], [71, 58], [90, 39], [45, 84], [16, 113], [82, 47],
    [95, 34], [87, 42], [83, 46], [53, 76], [48, 81], [68, 61], [105, 24],
    [98, 31], [88, 41], [75, 54], [43, 86], [52, 77], [117, 12], [119, 10],
    [118, 11], [85, 44], [101, 28], [36, 93], [55, 74], [89, 40], [79, 50],
    [56, 73], [49, 80], [64, 65], [27, 102], [32, 97], [112, 17], [67, 62],
    [21, 108],
], dtype=np.int32)

SHAPES_3 = np.array([
    [148, 160, 240], [132, 212, 205], [136, 233, 187], [175, 237, 143],
    [6, 186, 232], [33, 142, 232], [131, 123, 142], [131, 96, 186],
    [6, 171, 110], [1, 18, 110], [1, 146, 123], [33, 195, 66],
    [20, 51, 66], [20, 178, 96], [2, 177, 106], [211, 4, 59],
    [8, 191, 91], [230, 14, 29], [1, 188, 234], [151, 110, 168],
    [20, 144, 238], [137, 66, 206], [173, 179, 232], [209, 194, 186],
    [239, 165, 142], [131, 152, 242], [214, 54, 12], [140, 219, 201],
    [190, 150, 231], [156, 135, 241], [185, 227, 167], [145, 210, 59],
    [138, 174, 106], [189, 229, 14], [176, 133, 106], [78, 178, 195],
    [111, 146, 171], [216, 180, 196], [217, 181, 193], [184, 228, 166],
    [192, 225, 153], [134, 141, 123], [6, 222, 198], [149, 183, 96],
    [33, 226, 164], [161, 215, 51], [197, 221, 18], [1, 223, 199],
    [154, 163, 110], [20, 236, 169], [157, 204, 66], [1, 202, 220],
    [20, 170, 235], [203, 158, 66], [162, 155, 110], [6, 201, 218],
    [139, 135, 123], [33, 167, 224], [182, 150, 96], [19, 200, 213],
    [63, 207, 159], [147, 172, 109], [129, 130, 128], [208, 14, 59],
], dtype=np.int32)

NUM_SHAPES = 243        # 1 full + 128 two-subset + 114 new three-subset

# 3-subset shape list for 16-partition mode 0 (BC67.cpp:617-623):
# shapes of partitions 0..15 of the 3-subset map, in CVTT's canonical order.
SHAPE_LIST_3_SHORT = np.array([
    1, 2, 4, 6, 18, 20, 33, 51, 59, 66, 96, 106, 110, 123, 131, 132, 136,
    142, 143, 146, 148, 160, 171, 175, 177, 178, 186, 187, 195, 205, 211,
    212, 232, 233, 237, 240,
], dtype=np.int32)

# 3-subset shape list for 64-partition modes (BC67.cpp:600-615)
SHAPE_LIST_3 = np.array([
    1, 2, 4, 6, 8, 12, 14, 18, 19, 20, 29, 33, 51, 54, 59, 63, 66, 78, 91,
    96, 106, 109, 110, 111, 123, 128] + list(range(129, 243)), dtype=np.int32)

SHAPE_LIST_2 = np.arange(1, 129, dtype=np.int32)    # BC67.cpp:586-598
SHAPE_LIST_1 = np.array([0], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def shape_pixel_sets() -> tuple[tuple[int, ...], ...]:
    """Derive every shape's pixel set (ascending) from the partition maps.

    Replaces the reference's g_fragments/g_shapeRanges flat arrays
    (BC67.cpp:255-529); validated equal in tests.
    """
    sets: list[tuple[int, ...] | None] = [None] * NUM_SHAPES
    sets[0] = tuple(range(16))
    for part in range(64):
        bits = int(PARTITION_MAP_2[part])
        for subset in range(2):  # subset = the partition-map bit value
            pxs = tuple(px for px in range(16) if ((bits >> px) & 1) == subset)
            sid = int(SHAPES_2[part][subset])
            if sets[sid] is None:
                sets[sid] = pxs
            else:
                assert sets[sid] == pxs, f"shape {sid} inconsistent"
    for part in range(64):
        bits = int(PARTITION_MAP_3[part])
        for subset in range(3):
            pxs = tuple(px for px in range(16)
                        if ((bits >> (2 * px)) & 3) == subset)
            sid = int(SHAPES_3[part][subset])
            if sets[sid] is None:
                sets[sid] = pxs
            else:
                assert sets[sid] == pxs, f"shape {sid} inconsistent"
    assert all(s is not None for s in sets)
    return tuple(sets)  # type: ignore[return-value]


@functools.lru_cache(maxsize=None)
def shape_masks() -> np.ndarray:
    """bool [243, 16]: shape-membership mask per pixel."""
    masks = np.zeros((NUM_SHAPES, 16), dtype=bool)
    for sid, pxs in enumerate(shape_pixel_sets()):
        masks[sid, list(pxs)] = True
    masks.setflags(write=False)     # one cached array serves every caller
    return masks
