"""JAX-produced BC7, BC6H, S3TC and ETC goldens for the torch port, and their
re-derivation.

The JAX package encodes a BC7 configuration on a CPU in 25-110 s (trace
plus compile), so the default tier holds the port against bytes the JAX
package produced once, stored in convectionkernels_tpu_torch/testdata.
The slow tests below re-derive every stored golden from the JAX package
and assert that it is unchanged.

The q50 golden holds two sets of bytes for the same 256 blocks:
`api_blocks` from the JAX package's jitted `encode_bc7`, and `blocks`
from its `models.bc7.pack` run op by op (not jitted), where every float32
operation rounds on its own as in the scalar reference. They differ in one
block (62): XLA's compiled program lands one ulp under a 0.5 boundary in a
refine solve that the op-by-op run and a float32 scalar emulation
(tests/test_torch_bc7.py) put above it. The port is held to `blocks`.

The BC6H golden (bc6h_golden.npz) holds, for each case of BC6H_CASES, the
int16 half-float pixels, the case's configuration (`config`: flags, seed
points, refine rounds, signed) and, as for q50, two sets of bytes: `api_blocks`
from the JAX package's jitted `encode_bc6hu` / `encode_bc6hs` under the
case's Options, and `blocks` from its `models.bc6h.pack` run op by op. They
differ in one block (27 of `edge_signed`), where the compiled program picks
another candidate of the aPrec-6 group; the port is held to `blocks`.

The S3TC golden (s3tc_golden.npz) holds, for each case of S3TC_CASES, the
pixels (uint8, or int8 for the signed formats), the case's Options
(`options`: flags, threshold, seed points, S3TC and interpolated-alpha
refine rounds), `blocks` from the JAX package's `models.s3tc` functions run
op by op, composed as its api.py composes them, and, except for the cases
of S3TC_NOT_JITTED, `api_blocks` from its jitted `encode_bc1` ...
`encode_bc5s`. The two agree in every case that has both.

The ETC golden (etc_golden.npz) holds, for each case of ETC_CASES, the
pixels (uint8 [N, 16, 4], or int16 [N, 16] for EAC11), the case's entry
point (`entry`), Options flags (`flags`) and threshold (`threshold`),
`blocks` from the JAX package's `models.etc` functions run op by op
(composed as its api.py composes them, the punchthrough split included),
and, except for the cases of ETC_NOT_JITTED, `api_blocks` from its jitted
entry point. A punchthrough case also holds `mono_blocks`, the JAX
package's one-program `compress_etc2(..., True)` run op by op.

Regenerate the files with:
    python -m tests.test_torch_goldens [bc7|bc6h|s3tc|etc]
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests import blockgen

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "convectionkernels_tpu_torch", "testdata")
Q50_PATH = os.path.join(TESTDATA, "bc7_q50_golden.npz")
LIGHT_PATH = os.path.join(TESTDATA, "bc7_light_golden.npz")
BC6H_PATH = os.path.join(TESTDATA, "bc6h_golden.npz")
S3TC_PATH = os.path.join(TESTDATA, "s3tc_golden.npz")
ETC_PATH = os.path.join(TESTDATA, "etc_golden.npz")

LIGHT = dict(seed_points=1, refine_rounds_s3tc=1, refine_rounds_iic=1,
             refine_rounds_bc7=1, refine_rounds_bc6h=1)

FAST = 0x008          # Flags.BC7_FAST_INDEXING
SINGLE_COLOR = 0x010  # Flags.BC7_TRY_SINGLE_COLOR
PUNCH = 0x020         # Flags.BC7_RESPECT_PUNCH_THROUGH
DEFAULT = 0x108       # Flags.DEFAULT

# (name, corpus, flags) of the quality-5 LIGHT goldens
LIGHT_CASES = (
    ("rgb", "rgb", DEFAULT),
    ("alpha", "alpha", DEFAULT),
    ("slow_indexing", "alpha", DEFAULT & ~FAST),
    ("single_color", "rgb", DEFAULT | SINGLE_COLOR),
    ("punch_through", "punch", DEFAULT | PUNCH),
)


BC6H_FAST = 0x040     # Flags.BC6H_FAST_INDEXING
UNIFORM = 0x200       # Flags.UNIFORM

# (name, corpus, signed, flags, seed_points, refine_rounds_bc6h) of the BC6H
# goldens; "default" is the 4 x 3 rounds of the default Options
BC6H_CASES = (
    ("light", "light", False, DEFAULT, 1, 1),
    ("rounds22", "hdr128", False, DEFAULT, 2, 2),
    ("signed_fast", "signed", True, DEFAULT | BC6H_FAST, 2, 2),
    ("uniform", "hdr32", False, DEFAULT | UNIFORM, 2, 2),
    ("edge_unsigned", "edge", False, DEFAULT, 2, 2),
    ("edge_signed", "edge", True, DEFAULT, 2, 2),
    ("default", "hdr16", False, DEFAULT, 4, 3),
)


S3TC_EXHAUSTIVE = 0x080  # Flags.S3TC_EXHAUSTIVE
BETTER = 0x180           # Flags.BETTER: paranoid + exhaustive

# (name, format, corpus, Options fields) of the S3TC goldens
S3TC_CASES = (
    ("bc1_default", "bc1", "mixed", {}),
    ("bc1_flags0", "bc1", "mixed", dict(flags=0)),
    ("bc1_uniform", "bc1", "mixed", dict(flags=UNIFORM)),
    ("bc1_better", "bc1", "alpha", dict(flags=BETTER)),
    ("bc1_exhaustive", "bc1", "mixed", dict(flags=S3TC_EXHAUSTIVE)),
    ("bc1_light", "bc1", "mixed2", dict(threshold=0.25, seed_points=1,
                                        refine_rounds_s3tc=1)),
    ("bc2_default", "bc2", "mixed", {}),
    ("bc3_default", "bc3", "mixed", {}),
    ("bc3_iic1", "bc3", "alpha", dict(refine_rounds_iic=1)),
    ("bc4u_default", "bc4u", "mixed", {}),
    ("bc5u_default", "bc5u", "mixed2", {}),
    ("bc4s_default", "bc4s", "signed", {}),
    ("bc5s_default", "bc5s", "signed", {}),
)
S3TC_SIGNED = ("bc4s", "bc5s")
# Cases whose jitted JAX encoder XLA:CPU cannot compile here: the default
# 8 interpolated-alpha refine rounds unroll into 160 rounds of 16 pixels,
# and compiling encode_bc4u alone took 55 GB of host memory after 20
# minutes, still growing. Their golden holds the op-by-op bytes only.
S3TC_NOT_JITTED = ("bc3_default", "bc4u_default", "bc5u_default",
                   "bc4s_default", "bc5s_default")


FAKE_BT709 = 0x400           # Flags.ETC_USE_FAKE_BT709
FAKE_BT709_ACCURATE = 0x800  # Flags.ETC_FAKE_BT709_ACCURATE

# (name, entry point, corpus, flags, Options.threshold) of the ETC goldens
ETC_CASES = (
    ("etc1_default", "etc1", "mixed1", DEFAULT, 0.5),
    ("etc1_uniform", "etc1", "mixed2", DEFAULT | UNIFORM, 0.5),
    ("etc1_fake709", "etc1", "mixed3", DEFAULT | FAKE_BT709, 0.5),
    ("etc1_fake709_accurate", "etc1", "mixed4",
     DEFAULT | FAKE_BT709 | FAKE_BT709_ACCURATE, 0.5),
    ("etc1_ties", "etc1", "ties", DEFAULT, 0.5),
    ("etc2_alpha", "etc2_alpha", "alpha", DEFAULT, 0.5),
    ("eac_r11", "eac11", "eac", DEFAULT, 0.5),
    ("eac_r11s", "eac11s", "eacs", DEFAULT, 0.5),
    ("etc2_default", "etc2", "mixed5", DEFAULT, 0.5),
    ("etc2_uniform", "etc2", "mixed6", DEFAULT | UNIFORM, 0.5),
    ("etc2_fake709", "etc2", "mixed7", DEFAULT | FAKE_BT709, 0.5),
    ("etc2_fake709_accurate", "etc2", "mixed8",
     DEFAULT | FAKE_BT709 | FAKE_BT709_ACCURATE, 0.5),
    ("etc2_modes", "etc2", "modes", DEFAULT, 0.5),
    ("etc2_rgba", "etc2_rgba", "alpha2", DEFAULT, 0.5),
    ("etc2_punchthrough", "etc2_punchthrough", "punch", DEFAULT, 0.5),
    ("etc2_punchthrough_thr0", "etc2_punchthrough", "thresholds", DEFAULT,
     0.0),
    ("etc2_punchthrough_thr1", "etc2_punchthrough", "thresholds", DEFAULT,
     1.0),
    ("etc2_punchthrough_thr_off_grid", "etc2_punchthrough", "thresholds",
     DEFAULT | UNIFORM, 0.3),
)
# the entry points of the ETC2 color slice
ETC2_ENTRIES = ("etc2", "etc2_rgba", "etc2_punchthrough")
# Cases whose jitted JAX encoder is not stored. XLA:CPU compiles every ETC
# case's encoder within minutes, but at threshold 1.0 the JAX package's
# punchthrough dispatch compares its uint8 alpha with 256 in NumPy
# (api.py:372-373), which crashes NumPy 2.0.2 with a segmentation fault.
ETC_NOT_JITTED = ("etc2_punchthrough_thr1",)


def eac_blocks(n, seed, signed):
    """int16 [n, 16] EAC11 values: a quarter narrow (a base plus a small
    spread), a quarter flat, the rest spread over the clamp range and past
    it ([0, 2047] or [-1024, 1023]), the first block the int16 extremes."""
    rng = np.random.default_rng(seed)
    lo, hi = (-1024, 1023) if signed else (0, 2047)
    vals = rng.integers(lo - 300, hi + 300, size=(n, 16))
    q = n // 4
    vals[:q] = rng.integers(lo, hi, size=(q, 1)) + rng.integers(
        -20, 21, size=(q, 16))
    vals[q:2 * q] = rng.integers(lo - 50, hi + 50, size=(q, 1))
    vals[0] = np.tile([-32768, 32767, lo, hi, lo - 1, hi + 1, 0, -1], 2)
    return vals.astype(np.int16)


def etc_ties_blocks():
    """32 blocks where ETC1's resolve meets equal totals: the quality
    corpus block that exposed the reference scan's re-acceptance
    (tests/test_etc_resolve_semantics.py), flat blocks, two-color blocks
    and grayish blocks with channel-coincident errors."""
    from tests.test_etc_resolve_semantics import CORPUS_BLOCK_9
    rng = np.random.default_rng(611)
    out = [np.concatenate([CORPUS_BLOCK_9, np.full((16, 1), 255, np.uint8)],
                          axis=1)]
    out += list(blockgen.flat_blocks(7, seed=613))
    for _ in range(12):
        pal = rng.integers(0, 256, (2, 4))
        pal[:, 3] = 255
        out.append(pal[rng.integers(0, 2, 16)].astype(np.uint8))
    for _ in range(12):
        g = rng.integers(0, 256, (16, 1))
        px = np.clip(g + rng.integers(-3, 4, (16, 4)), 0, 255)
        px[:, 3] = 255
        out.append(px.astype(np.uint8))
    return np.stack(out)


def etc2_mode_blocks():
    """64 blocks built to reach each ETC2 color mode: 16 smooth gradients
    (planar), 16 with one to three pixels of a far color beside a line of
    three colors (T), 16 of two clusters spread over the block (H), 8 of
    two unrelated halves and 8 near flat blocks (differential: ETC2's ETC1
    stage runs the differential mode only, as the JAX package's
    compress_etc2 passes punchthrough_min_d=True)."""
    rng = np.random.default_rng(641)
    out = []
    y, x = np.divmod(np.arange(16), 4)
    for _ in range(16):                                  # planar
        base = rng.integers(40, 200, 3)
        gx, gy = rng.integers(-12, 13, 3), rng.integers(-12, 13, 3)
        out.append(base + gx * x[:, None] + gy * y[:, None])
    for _ in range(16):                                  # T
        a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
        spread = rng.integers(6, 30)
        px = a + rng.choice([-spread, 0, spread], 16)[:, None]
        px[rng.choice(16, rng.integers(1, 4), replace=False)] = b
        out.append(px)
    for _ in range(16):                                  # H
        a, b = rng.integers(0, 256, 3), rng.integers(0, 256, 3)
        spread = rng.integers(3, 20)
        group = rng.permutation(np.arange(16) % 2).astype(bool)
        px = np.where(group[:, None], b, a) + rng.choice(
            [-spread, spread], 16)[:, None]
        out.append(px)
    for _ in range(8):                                   # two halves
        halves = rng.integers(0, 256, (2, 3))
        px = halves[(np.arange(16) % 4) // 2] + rng.integers(-4, 5, (16, 3))
        out.append(px)
    for _ in range(8):                                   # differential
        out.append(rng.integers(0, 256, 3) + rng.integers(-3, 4, (16, 3)))
    rgb = np.clip(np.stack(out), 0, 255)
    return np.concatenate([rgb, np.full((64, 16, 1), 255)], 2).astype(
        np.uint8)


def etc2_punchthrough_blocks():
    """64 blocks of mixed transparency at the default threshold (alpha
    below 128 is transparent): 8 all transparent, 8 without a transparent
    pixel, 8 with alpha only at 127 and 128, 8 with one transparent
    pixel, 8 with a whole half transparent (a sector ETC1 may ignore), the
    rest a random share of transparent pixels."""
    rng = np.random.default_rng(643)
    px = blockgen.mixed_blocks(64, seed=645)
    alpha = np.where(rng.random((64, 16)) < rng.random((64, 1)), 0, 255)
    alpha[:8] = rng.integers(0, 128, (8, 16))
    alpha[8:16] = rng.integers(128, 256, (8, 16))
    alpha[16:24] = rng.choice([127, 128], (8, 16))
    alpha[24:32] = 255
    alpha[24:32][np.arange(8), rng.integers(0, 16, 8)] = 0
    halves = ([0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15],
              list(range(8)), list(range(8, 16)))       # g_flipTables
    alpha[32:40] = 255
    for i in range(8):
        alpha[32 + i, halves[i % 4]] = 0
    px[:, :, 3] = alpha
    return px


def etc2_threshold_blocks():
    """32 blocks whose alpha straddles the thresholds 0.0 (transparent
    below 1), 1.0 (below 256: every pixel) and 0.3 (below 77): alpha
    values 0, 1, 76, 77, 255 and random ones."""
    rng = np.random.default_rng(647)
    px = blockgen.mixed_blocks(32, seed=649)
    px[:, :, 3] = rng.choice([0, 1, 76, 77, 255], (32, 16))
    px[24:, :, 3] = rng.integers(0, 256, (8, 16))
    return px


def etc_corpus(name):
    if name.startswith("mixed"):
        return blockgen.mixed_blocks(64, seed=600 + int(name[-1]))
    if name == "ties":
        return etc_ties_blocks()
    if name == "alpha":
        return blockgen.alpha_blocks(64, seed=605)
    if name == "alpha2":
        return blockgen.alpha_blocks(64, seed=651)
    if name == "modes":
        return etc2_mode_blocks()
    if name == "punch":
        return etc2_punchthrough_blocks()
    if name == "thresholds":
        return etc2_threshold_blocks()
    return eac_blocks(64, seed=607, signed=name == "eacs")


def s3tc_options_row(fields):
    """The stored form of a case's Options: flags, threshold, seed points,
    S3TC and interpolated-alpha refine rounds."""
    from convectionkernels_tpu_torch.options import Options
    o = Options(**fields)
    return np.float64([o.flags, o.threshold, o.seed_points,
                       o.refine_rounds_s3tc, o.refine_rounds_iic])


def signed_blocks(n, seed):
    """int8 blocks: mixed blocks shifted into signed space, the first four
    at the edge values (all -128, all 127, all -127, and a mix of the
    three)."""
    px = (blockgen.mixed_blocks(n, seed).astype(np.int16) - 128).astype(
        np.int8)
    px[0], px[1], px[2] = -128, 127, -127
    px[3] = np.random.default_rng(seed).choice(
        np.int8([-128, -127, 127]), size=(16, 4))
    return px


def alpha_edge_values():
    """uint8 [K, 16] alpha values that reach each branch of
    PackInterpolatedAlpha: flat blocks (ties in update_best: many rounds
    score 0), only 0 and 255, the values next to the reserved endpoints,
    narrow ramps far from both ends (the clipping heuristic is not tried),
    spreads with a pixel at an end (a clipping candidate passes), one
    outlier beside a cluster near the top (tried, no candidate passes), and
    blocks with two or three levels."""
    rng = np.random.default_rng(2301)
    rows = [np.full(16, c) for c in (0, 1, 2, 127, 128, 253, 254, 255)]
    rows += [np.tile([0, 255], 8), np.repeat([0, 255], 8)]
    rows += [rng.choice([0, 255], 16) for _ in range(8)]
    rows += [rng.choice([0, 1, 254, 255], 16) for _ in range(8)]
    rows += [100 + 2 * np.arange(16), 60 + rng.integers(0, 9, 16)]
    rows += [np.arange(16) * 17, np.arange(16) * 16, 255 - np.arange(16) * 15]
    rows += [np.r_[10, np.full(15, 240)], np.r_[np.full(15, 15), 245]]
    rows += [rng.choice(rng.integers(0, 256, k), 16) for k in (2, 3) * 6]
    for _ in range(8):
        a, b = np.sort(rng.integers(0, 256, 2))
        rows.append(rng.integers(a, b + 1, 16))
    return np.stack(rows).astype(np.uint8)


def alpha_blocks_with_edges(n, seed):
    """uint8 [n, 16, 4] blocks: the rows of alpha_edge_values in every
    channel first, then mixed blocks."""
    edges = alpha_edge_values()
    edge_blocks = np.repeat(edges[:, :, None], 4, axis=2)
    mixed = blockgen.mixed_blocks(max(32, -(-n // 8) * 8), seed)
    return np.concatenate([edge_blocks, mixed])[:n]


def clipping_outcome(values, high_terminal=255):
    """Whether PackInterpolatedAlpha's clipping heuristic (S3TC.cpp:489-538)
    is tried on 16 values and, if so, whether a candidate passes:
    "not_tried", "passes" or "fails"."""
    s = np.sort(np.minimum(np.asarray(values, dtype=np.int64),
                           high_terminal))
    if 20 * min(s[0], high_terminal - s[15]) >= s[15] - s[0]:
        return "not_tried"
    for first in range(16):
        for last in range(first, 16):
            if first + 15 - last == 0:
                continue
            low = 0 if first == 0 else s[first - 1]
            high = 0 if last == 15 else high_terminal - s[last + 1]
            if 20 * max(low, high) < s[last] - s[first]:
                return "passes"
    return "fails"


def s3tc_corpus(name):
    """64 blocks: mixed (random, gradient, flat, alpha), alpha or signed."""
    if name == "mixed":
        return blockgen.mixed_blocks(64, seed=401)
    if name == "mixed2":
        return blockgen.mixed_blocks(64, seed=402)
    if name == "alpha":
        return blockgen.alpha_blocks(64, seed=403)
    return signed_blocks(64, seed=405)


def hdr_blocks(n, seed):
    """Unsigned HDR blocks as int16 half-float bits: uniform values in
    [0, 16) with alpha 1.0, the first quarter smooth (a base colour plus a
    small spread) so that endpoint dedup and near-ties occur."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 16.0, size=(n, 16, 4)).astype(np.float16)
    vals[..., 3] = np.float16(1.0)
    base = rng.uniform(0, 8.0, size=(n // 4, 1, 4)).astype(np.float16)
    vals[: n // 4] = base + rng.uniform(
        0, 0.25, size=(n // 4, 16, 4)).astype(np.float16)
    return vals.view(np.int16)


def hdr_signed_blocks(n, seed):
    """HDR blocks with values of both signs, the first quarter smooth."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-8.0, 8.0, size=(n, 16, 4)).astype(np.float16)
    base = rng.uniform(-4.0, 4.0, size=(n // 4, 1, 4)).astype(np.float16)
    vals[: n // 4] = base + rng.uniform(
        -0.25, 0.25, size=(n // 4, 16, 4)).astype(np.float16)
    vals[..., 3] = np.float16(1.0)
    return vals.view(np.int16)


def hdr_edge_blocks(n, seed):
    """Blocks of negative, denormal, zero and above-31743-magnitude halves
    (infinities and NaN bit patterns included), mixed with ordinary ones."""
    rng = np.random.default_rng(seed)
    bits = hdr_signed_blocks(n, seed + 1).copy()
    q = n // 4
    sign = (rng.integers(0, 2, size=(q, 16, 3)) << 15)
    denormal = rng.integers(0, 0x400, size=(q, 16, 3)) | sign
    bits[:q, :, :3] = denormal.astype(np.uint16).view(np.int16)
    bits[q] = 0                                   # all +0.0
    bits[q + 1, :, :3] = np.int16(-32768)         # all -0.0
    big = rng.integers(0x7800, 0x8000, size=(q, 16, 3)) | (
        rng.integers(0, 2, size=(q, 16, 3)) << 15)
    hit = rng.random(size=(q, 16, 3)) < 0.3
    tail = bits[2 * q:3 * q, :, :3]
    bits[2 * q:3 * q, :, :3] = np.where(
        hit, big.astype(np.uint16).view(np.int16), tail)
    bits[..., 3] = np.float16(1.0).view(np.int16)
    return bits


def bc6h_corpus(name):
    if name == "light":       # tests/test_light_options.py::test_bc6h_light
        rng = np.random.default_rng(111)
        return rng.uniform(0, 8.0, size=(16, 16, 4)).astype(
            np.float16).view(np.int16)
    if name == "hdr128":      # tests/test_bc6h_kernel.py, interpret test
        return hdr_blocks(128, seed=11)
    if name == "hdr32":
        return hdr_blocks(32, seed=13)
    if name == "hdr16":
        return hdr_blocks(16, seed=17)
    if name == "signed":
        return hdr_signed_blocks(32, seed=15)
    return hdr_edge_blocks(32, seed=19)


def punch_through_blocks(n, seed):
    """Alpha blocks whose alpha is only 0 or 255 (BC7 punch-through)."""
    px = blockgen.alpha_blocks(n, seed)
    px[..., 3] = np.where(px[..., 3] < 128, 0, 255).astype(np.uint8)
    return px


# BC7's modes as its bit packer reads them: partitions the mode has, index
# bits, alpha index bits (0 without a separate alpha plane), whether it has
# a rotation and an index selector
BC7_PACK_MODES = {0: (16, 3, 0, False, False), 1: (64, 3, 0, False, False),
                  2: (64, 2, 0, False, False), 3: (64, 2, 0, False, False),
                  4: (1, 2, 3, True, True), 5: (1, 2, 2, True, False),
                  6: (1, 4, 0, False, False), 7: (64, 2, 0, False, False)}


def bc7_pack_work(n, mode=None, seed=0):
    """A legal merged work of BC7's bit packer for n blocks, as the port's
    `pack` hands it over: each block's mode (`mode`, or drawn from 0-7);
    the mode's partitions in turn from a drawn start; rotations and index
    selectors in turn where the mode has them (else 0); endpoints drawn
    from 0-255 and indexes within the mode's ranges, so anchors come with
    their high bit set and clear. int32 arrays: mode, partition, rotation,
    isel [n]; ep[subset][endpoint][channel] [n]; indexes, indexes2: 16 of
    [n] each."""
    rng = np.random.default_rng(seed)
    modes = (np.full(n, mode) if mode is not None
             else rng.integers(0, 8, n))
    info = np.array([BC7_PACK_MODES[m] for m in range(8)], dtype=np.int64)
    parts, ib, aib, rot, isel = (info[modes, k] for k in range(5))
    i = np.arange(n)
    ep = rng.integers(0, 256, (3, 2, 4, n))
    indexes = rng.integers(0, 1 << ib, (16, n))
    indexes2 = rng.integers(0, 1 << aib, (16, n))
    work = dict(
        mode=modes, partition=(i + rng.integers(0, 64)) % parts,
        rotation=rot * ((i + rng.integers(0, 4)) % 4),
        isel=isel * ((i // 4 + rng.integers(0, 2)) % 2),
        ep=[[[ep[s, e, ch] for ch in range(4)] for e in range(2)]
            for s in range(3)],
        indexes=list(indexes), indexes2=list(indexes2))
    return map_work(lambda a: np.ascontiguousarray(a, dtype=np.int32), work)


def map_work(fn, work):
    """`work` (bc7_pack_work's form) with fn applied to each array."""
    def each(v):
        return [each(x) for x in v] if isinstance(v, list) else fn(v)
    return {k: each(v) for k, v in work.items()}


def q50_corpus():
    """256 blocks: mixed (random, gradient, flat, alpha), alpha and
    punch-through."""
    return np.concatenate([blockgen.mixed_blocks(128, seed=201),
                           blockgen.alpha_blocks(64, seed=203),
                           punch_through_blocks(64, seed=205)], axis=0)


def light_corpus(name):
    """The corpora of tests/test_light_options.py (24 blocks each)."""
    if name == "rgb":
        px = blockgen.gradient_blocks(24, seed=107)
        px[..., 3] = 255
        return px
    if name == "alpha":
        return blockgen.alpha_blocks(24, seed=109)
    return punch_through_blocks(24, seed=111)


def jax_q50_bytes(px):
    import convectionkernels_tpu as ck
    return np.asarray(ck.encode_bc7(px, quality=50))


def jax_q50_op_by_op(px):
    from convectionkernels_tpu.bc7_plan import plan_from_quality
    from convectionkernels_tpu.models import bc7
    from convectionkernels_tpu.options import Options
    o = Options()
    return np.asarray(bc7.pack(px, o.flags, o.channel_weights(),
                               plan_from_quality(50), o.refine_rounds_bc7))


def jax_light_bytes(px, flags):
    import convectionkernels_tpu as ck
    return np.asarray(ck.encode_bc7(px, ck.Options(flags=flags, **LIGHT),
                                    quality=5))


def jax_bc6h_bytes(px, signed, flags, seed_points, refine_rounds):
    import convectionkernels_tpu as ck
    opts = ck.Options(flags=flags, seed_points=seed_points,
                      refine_rounds_bc6h=refine_rounds)
    fn = ck.encode_bc6hs if signed else ck.encode_bc6hu
    return np.asarray(fn(px, opts))


def jax_bc6h_op_by_op(px, signed, flags, seed_points, refine_rounds):
    from convectionkernels_tpu.models import bc6h
    from convectionkernels_tpu.options import Options
    o = Options(flags=flags)
    return np.asarray(bc6h.pack(px, flags, o.channel_weights(), signed,
                                seed_points, refine_rounds))


def jax_s3tc_bytes(px, fmt, fields):
    import convectionkernels_tpu as ck
    return np.asarray(getattr(ck, f"encode_{fmt}")(px, ck.Options(**fields)))


def jax_s3tc_op_by_op(px, fmt, fields):
    """The JAX package's models.s3tc functions, not jitted, composed as
    its api.py composes them for `fmt`."""
    import jax.numpy as jnp

    from convectionkernels_tpu.models import s3tc
    from convectionkernels_tpu.options import Flags, Options
    from convectionkernels_tpu.tables import s3tc_single_color
    o = Options(**fields)
    exhaustive = bool(o.flags & Flags.S3TC_EXHAUSTIVE)

    def rgb(alpha_test):
        return s3tc.pack_rgb(
            px, o.flags, o.channel_weights(), alpha_test,
            o.threshold if alpha_test else 1.0, exhaustive, o.seed_points,
            o.refine_rounds_s3tc,
            s3tc_single_color.load_tables() if exhaustive else None)

    def interpolated(blocks, channel, signed):
        return s3tc.pack_interpolated_alpha(blocks, channel, signed,
                                            o.seed_points,
                                            o.refine_rounds_iic)

    if fmt == "bc1":
        out = rgb(True)
    elif fmt == "bc2":
        out = jnp.concatenate([s3tc.pack_explicit_alpha(px, 3), rgb(False)],
                              axis=-1)
    elif fmt == "bc3":
        out = jnp.concatenate([interpolated(px, 3, False), rgb(False)],
                              axis=-1)
    else:
        signed = fmt in S3TC_SIGNED
        blocks = s3tc.bias_signed_input(px) if signed else px
        out = jnp.concatenate(
            [interpolated(blocks, ch, signed)
             for ch in range(2 if fmt.startswith("bc5") else 1)], axis=-1)
    return np.asarray(out)


def jax_etc_bytes(px, entry, flags, threshold):
    import convectionkernels_tpu as ck
    if entry.startswith("eac11"):
        return np.asarray(ck.encode_eac11(px, signed=entry == "eac11s"))
    return np.asarray(getattr(ck, f"encode_{entry}")(
        px, ck.Options(flags=flags, threshold=threshold)))


def jax_etc_op_by_op(px, entry, flags, threshold):
    """The JAX package's models.etc functions, not jitted, composed as its
    api.py composes them: ETC2 RGBA is the alpha block then the color
    block, and ETC2 punchthrough its host dispatch's split, blocks without
    a transparent pixel through compress_etc2, the others through
    compress_etc2_punchthrough_only."""
    import jax

    from convectionkernels_tpu.models import etc
    from convectionkernels_tpu.options import Options
    o = Options(flags=flags, threshold=threshold)
    with jax.disable_jit():
        if entry == "etc1":
            return np.asarray(etc.compress_etc1(px, o))
        if entry == "etc2_alpha":
            return np.asarray(etc.compress_etc2_alpha(px, o))
        if entry == "etc2":
            return np.asarray(etc.compress_etc2(px, o, False))
        if entry == "etc2_rgba":
            return np.concatenate([np.asarray(etc.compress_etc2_alpha(px, o)),
                                   np.asarray(etc.compress_etc2(px, o, False))],
                                  axis=-1)
        if entry == "etc2_punchthrough":
            f_thr = max(min(1.0, threshold), 0.0) * 255.0
            thr = int(np.floor(np.float32(f_thr) + 1.0))
            pt = (px[:, :, 3].astype(np.int32) < thr).any(axis=1)
            out = np.zeros((len(px), 8), dtype=np.uint8)
            if (~pt).any():
                out[~pt] = np.asarray(etc.compress_etc2(px[~pt], o, False))
            if pt.any():
                out[pt] = np.asarray(etc.compress_etc2_punchthrough_only(
                    px[pt], o))
            return out
        return np.asarray(etc.compress_eac11(px, entry == "eac11s", o))


def jax_etc2_monolithic(px, flags, threshold):
    """The JAX package's one-program ETC2 punchthrough encode,
    compress_etc2(..., True), op by op."""
    import jax

    from convectionkernels_tpu.models import etc
    from convectionkernels_tpu.options import Options
    with jax.disable_jit():
        return np.asarray(etc.compress_etc2(
            px, Options(flags=flags, threshold=threshold), True))


def load_etc(name):
    """(pixels, flags, bytes the port must give, bytes of the jitted JAX
    API, or None for a case of ETC_NOT_JITTED)."""
    with np.load(ETC_PATH) as z:
        api = z[f"{name}_api_blocks"] if f"{name}_api_blocks" in z else None
        return (z[f"{name}_pixels"], int(z[f"{name}_flags"]),
                z[f"{name}_blocks"], api)


def load_etc_case(name):
    """The stored entry point, Options.threshold and, for a punchthrough
    case, the bytes of the JAX package's one-program encode (None
    otherwise) of an ETC golden."""
    with np.load(ETC_PATH) as z:
        mono = z[f"{name}_mono_blocks"] if f"{name}_mono_blocks" in z \
            else None
        return str(z[f"{name}_entry"]), float(z[f"{name}_threshold"]), mono


def load_s3tc(name):
    """(pixels, bytes the port must give, bytes of the jitted JAX API, or
    None for a case of S3TC_NOT_JITTED)."""
    with np.load(S3TC_PATH) as z:
        api = z[f"{name}_api_blocks"] if f"{name}_api_blocks" in z else None
        return z[f"{name}_pixels"], z[f"{name}_blocks"], api


def load_bc6h(name):
    """(pixels, bytes the port must give, bytes of the jitted JAX API)."""
    with np.load(BC6H_PATH) as z:
        return (z[f"{name}_pixels"], z[f"{name}_blocks"],
                z[f"{name}_api_blocks"])


def load_q50():
    """(pixels, bytes the port must give, bytes of the jitted JAX API)."""
    with np.load(Q50_PATH) as z:
        return z["pixels"], z["blocks"], z["api_blocks"]


def load_light(name):
    with np.load(LIGHT_PATH) as z:
        return z[f"{name}_pixels"], z[f"{name}_blocks"], int(z[f"{name}_flags"])


@pytest.mark.slow
def test_q50_golden_matches_jax():
    px, blocks, api_blocks = load_q50()
    np.testing.assert_array_equal(px, q50_corpus())
    np.testing.assert_array_equal(jax_q50_bytes(px), api_blocks)
    np.testing.assert_array_equal(jax_q50_op_by_op(px), blocks)


@pytest.mark.slow
@pytest.mark.parametrize("case", LIGHT_CASES, ids=[c[0] for c in LIGHT_CASES])
def test_light_golden_matches_jax(case):
    name, corpus, flags = case
    px, blocks, stored_flags = load_light(name)
    assert stored_flags == flags
    np.testing.assert_array_equal(px, light_corpus(corpus))
    np.testing.assert_array_equal(jax_light_bytes(px, flags), blocks)


@pytest.mark.slow
@pytest.mark.parametrize("case", BC6H_CASES, ids=[c[0] for c in BC6H_CASES])
def test_bc6h_golden_matches_jax(case):
    name, corpus, signed, flags, seed_points, refine_rounds = case
    px, blocks, api_blocks = load_bc6h(name)
    np.testing.assert_array_equal(px, bc6h_corpus(corpus))
    with np.load(BC6H_PATH) as z:
        assert z[f"{name}_config"].tolist() == [flags, seed_points,
                                                refine_rounds, int(signed)]
    np.testing.assert_array_equal(
        jax_bc6h_bytes(px, signed, flags, seed_points, refine_rounds),
        api_blocks)
    np.testing.assert_array_equal(
        jax_bc6h_op_by_op(px, signed, flags, seed_points, refine_rounds),
        blocks)


@pytest.mark.slow
@pytest.mark.parametrize("case", S3TC_CASES, ids=[c[0] for c in S3TC_CASES])
def test_s3tc_golden_matches_jax(case):
    name, fmt, corpus, fields = case
    px, blocks, api_blocks = load_s3tc(name)
    np.testing.assert_array_equal(px, s3tc_corpus(corpus))
    with np.load(S3TC_PATH) as z:
        np.testing.assert_array_equal(z[f"{name}_options"],
                                      s3tc_options_row(fields))
    np.testing.assert_array_equal(jax_s3tc_op_by_op(px, fmt, fields), blocks)
    assert (api_blocks is None) == (name in S3TC_NOT_JITTED)
    if api_blocks is not None:
        np.testing.assert_array_equal(jax_s3tc_bytes(px, fmt, fields),
                                      api_blocks)


@pytest.mark.slow
@pytest.mark.parametrize("case", ETC_CASES, ids=[c[0] for c in ETC_CASES])
def test_etc_golden_matches_jax(case):
    name, entry, corpus, flags, threshold = case
    px, stored_flags, blocks, api_blocks = load_etc(name)
    np.testing.assert_array_equal(px, etc_corpus(corpus))
    assert stored_flags == flags
    assert load_etc_case(name)[:2] == (entry, threshold)
    np.testing.assert_array_equal(
        jax_etc_op_by_op(px, entry, flags, threshold), blocks)
    assert (api_blocks is None) == (name in ETC_NOT_JITTED)
    if api_blocks is not None:
        np.testing.assert_array_equal(
            jax_etc_bytes(px, entry, flags, threshold), api_blocks)
    mono = load_etc_case(name)[2]
    assert (mono is None) == (entry != "etc2_punchthrough")
    if mono is not None:
        np.testing.assert_array_equal(
            jax_etc2_monolithic(px, flags, threshold), mono)


def _write_etc():
    import time
    out = {}
    for name, entry, corpus, flags, threshold in ETC_CASES:
        px = etc_corpus(corpus)
        out[f"{name}_pixels"] = px
        out[f"{name}_flags"] = np.int32(flags)
        out[f"{name}_entry"] = np.str_(entry)
        out[f"{name}_threshold"] = np.float64(threshold)
        t0 = time.perf_counter()
        out[f"{name}_blocks"] = jax_etc_op_by_op(px, entry, flags, threshold)
        t1 = time.perf_counter()
        if name not in ETC_NOT_JITTED:
            out[f"{name}_api_blocks"] = jax_etc_bytes(px, entry, flags,
                                                      threshold)
        t2 = time.perf_counter()
        if entry == "etc2_punchthrough":
            out[f"{name}_mono_blocks"] = jax_etc2_monolithic(px, flags,
                                                             threshold)
        print("etc", name, f"op by op {t1 - t0:.1f} s, jitted "
              f"{t2 - t1:.1f} s, one program {time.perf_counter() - t2:.1f} "
              f"s", flush=True)
    np.savez_compressed(ETC_PATH, **out)


def _write_s3tc():
    out = {}
    for name, fmt, corpus, fields in S3TC_CASES:
        px = s3tc_corpus(corpus)
        out[f"{name}_pixels"] = px
        out[f"{name}_options"] = s3tc_options_row(fields)
        out[f"{name}_blocks"] = jax_s3tc_op_by_op(px, fmt, fields)
        if name not in S3TC_NOT_JITTED:
            out[f"{name}_api_blocks"] = jax_s3tc_bytes(px, fmt, fields)
        print("s3tc", name, flush=True)
    np.savez_compressed(S3TC_PATH, **out)


def _write_bc6h():
    out = {}
    for name, corpus, signed, flags, seed_points, refine_rounds in BC6H_CASES:
        px = bc6h_corpus(corpus)
        out[f"{name}_pixels"] = px
        out[f"{name}_config"] = np.int32([flags, seed_points, refine_rounds,
                                          signed])
        out[f"{name}_api_blocks"] = jax_bc6h_bytes(
            px, signed, flags, seed_points, refine_rounds)
        out[f"{name}_blocks"] = jax_bc6h_op_by_op(
            px, signed, flags, seed_points, refine_rounds)
        print("bc6h", name, flush=True)
    np.savez_compressed(BC6H_PATH, **out)


def _write_bc7():
    light = {}
    for name, corpus, flags in LIGHT_CASES:
        px = light_corpus(corpus)
        light[f"{name}_pixels"] = px
        light[f"{name}_blocks"] = jax_light_bytes(px, flags)
        light[f"{name}_flags"] = np.int32(flags)
        print("light", name, flush=True)
    np.savez_compressed(LIGHT_PATH, **light)
    px = q50_corpus()
    np.savez_compressed(Q50_PATH, pixels=px, blocks=jax_q50_op_by_op(px),
                        api_blocks=jax_q50_bytes(px))
    print("q50", flush=True)


def _write(which=("bc7", "bc6h", "s3tc", "etc")):
    import tests.conftest  # noqa: F401  (exactness XLA flags, CPU platform)

    os.makedirs(TESTDATA, exist_ok=True)
    if "bc7" in which:
        _write_bc7()
    if "bc6h" in which:
        _write_bc6h()
    if "s3tc" in which:
        _write_s3tc()
    if "etc" in which:
        _write_etc()


if __name__ == "__main__":
    import sys
    _write(tuple(sys.argv[1:]) or ("bc7", "bc6h", "s3tc", "etc"))
