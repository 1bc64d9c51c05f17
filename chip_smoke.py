#!/usr/bin/env python3
"""The port's table of CUDA kernels on one card: each kernel of csrc/ timed
alone on the full-width inputs an encode gives it, against its bound and
its plain PyTorch version.

    python3 chip_smoke.py              # build, time, compare, print the table
    python3 chip_smoke.py --out DIR    # chip_smoke.json goes to DIR
                                       # (default build/chip_smoke)

Steps, each printed as a JSON line; a failed check prints
{"ok": false, "error": ...} as the last line and exits nonzero:
  1. build every library of csrc/ with nvcc (one process a source, in
     parallel) and read ptxas's registers, stack and spills of each kernel
     (`build`);
  2. one encode of each of the benchmark's configurations, op by op under
     programs.eager(), of a 1024x1024 texture (65,536 blocks): encode_bc7
     at quality 50, encode_etc2_rgba and encode_bc3 at Flags.BETTER of an
     RGBA8 texture, encode_bc6hu of an RGBA16F one, the other Options
     default, each after one op-by-op encode that fills the allocator's
     cache; every kernel wrapper's call is timed with CUDA events and its
     arguments kept, and every kernel launch is counted where it happens,
     at cuda_lib.launch (`encode`);
  3. each configuration through its program, as the benchmark runs it:
     the first call, the capture and two replays, each byte-equal to the
     op-by-op encode, each bucket captured once; one replay timed with
     CUDA events, and the csrc/ kernels of another read by name from a
     torch.profiler trace (csrc_launches), which must equal the op-by-op
     launches and CHUNK_LAUNCHES (`replay`);
  4. each of the eight kernels on every launch's arguments: BACK_TO_BACK
     (20) launches in a row after a warm-up, the work model's bound, and
     its outputs against the plain version's on the same inputs (every
     PLAIN_STRIDE-th block; outputs compared as int32 bits, so the
     tolerance is 0) (`kernel`);
  5. one JSON line describing every kernel (the table of PERF.md), the
     card's name and power limit, and {"ok": true, ...}.

The work model counts the bytes each launch must move and the operations
it must do; a bound is the larger of the two times at the H100's rates
below. tests/test_torch_work_model.py checks it on the CPU, and the
benchmark's frozen copy (portbench/harness/workmodel.py) is held equal to
it. make_texture and the other input makers, and csrc_launches, are shared
with the card tests (tests/test_torch_cuda.py) and the benchmark's tests.

Needs the CUDA toolkit (nvcc) and a card; imports nothing of JAX, and
nothing of torch or the port at import time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# The most lane operations the card can issue: each of an SM's 4 schedulers
# issues one 32-lane warp instruction a clock, 132 SMs x 4 x 32 x 1.98 GHz
# = 33.45e12 a second. The kernels are built with -fmad=false and the work
# model counts every add and every multiply as one operation, so this, not
# the data sheet's 67e12 float32 rate (which counts an FMA as two), is the
# rate the operations bound is taken at.
H100_ISSUE_LANE_OPS_PER_S = 132 * 4 * 32 * 1.98e9

# each kernel wrapper: its module of models/, its library of csrc/ (which
# holds <library>_kernel) and what it replaces
KERNELS = {
    "shape_pca": dict(
        module="bc7_kernel", library="shape_pca",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:246"),
    "single_plane_mode_best": dict(
        module="bc7_kernel", library="single_plane",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:302"),
    "dual_plane_best": dict(
        module="bc7_kernel", library="dual_plane",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:629"),
    "partitioned_group_meta_rounds": dict(
        module="bc6h_kernel", library="bc6h_group",
        replaces="convectionkernels_tpu/models/bc6h_kernel.py:302"),
    "single_group_meta_rounds": dict(
        module="bc6h_kernel", library="bc6h_single",
        replaces="XLA ops of convectionkernels_tpu/models/bc6h.py "
                 "(BC67.cpp:2794-2911)"),
    "combine": dict(
        module="bc6h_kernel", library="bc6h_combine",
        replaces="XLA ops of convectionkernels_tpu/models/bc6h.py "
                 "(BC67.cpp:2914-2986)"),
    "bc7_pack": dict(
        module="bc7_kernel", library="bc7_pack",
        replaces="XLA ops of convectionkernels_tpu/models/bc7.py:1303-1459 "
                 "(_pack_mode_bits, _pack_bits)"),
    "s3tc_alpha": dict(
        module="s3tc", library="s3tc_alpha",
        replaces="XLA ops of convectionkernels_tpu/models/s3tc.py "
                 "pack_interpolated_alpha (S3TC.cpp:343-715)"),
}
BACK_TO_BACK = 20

# each configuration's launches of each csrc/ library in one 65,536-block
# chunk, op by op and replayed alike
CHUNK_LAUNCHES = {
    "bc7_q50": {"shape_pca": 2, "single_plane": 6, "dual_plane": 1,
                "bc7_pack": 1},
    "bc6hu": {"bc6h_group": 6, "bc6h_single": 4, "bc6h_combine": 10},
    "etc2_rgba": {},
    "bc3_better": {"s3tc_alpha": 1}}

# positions of each wrapper's arguments that have a block axis (every
# output's leading axis is the block axis), and that axis where it is not
# the leading one
ROW_ARGS = {"shape_pca": (0,), "single_plane_mode_best": (1, 2, 3, 4, 5),
            "dual_plane_best": (0,),
            "partitioned_group_meta_rounds": (0, 1, 2),
            "single_group_meta_rounds": (0, 1, 2),
            "combine": (0, 1, 2, 3), "bc7_pack": (0,), "s3tc_alpha": (0,)}
ROW_AXIS = {"bc7_pack": 1}      # pack_fields' [fields, N]
# the plain versions run on every PLAIN_STRIDE-th block of a launch: the
# BC7 kernels' and the partitioned chain's plain versions hold [N, lanes]
# tensors of every pixel and channel, too large at 65,536 blocks
PLAIN_STRIDE = {"shape_pca": 64, "single_plane_mode_best": 64,
                "dual_plane_best": 64, "partitioned_group_meta_rounds": 64,
                "single_group_meta_rounds": 1, "combine": 1, "bc7_pack": 1,
                "s3tc_alpha": 1}
# what tells one launch of a kernel from another: (label, argument position)
LAUNCH_TAG = {"shape_pca": ("nch", 2), "single_plane_mode_best": ("mode", 0),
              "partitioned_group_meta_rounds": ("aprec", 3),
              "single_group_meta_rounds": ("aprec", 3),
              "combine": ("aprec", 4)}


# --- work model: bytes each launch must move, operations it must do --------
# Operations are counted from the sources' arithmetic per lane (every
# add, multiply, compare, select, shift and conversion is one operation),
# over the lanes and member pixels these inputs need: a lane whose result
# is fixed before it starts (an invalid slot, a punch-through parity, a
# dead dual-plane tweak) needs none.

def _popcount(x):
    import numpy as np
    x = np.asarray(x, dtype=np.int64)
    return sum(((x >> i) & 1) for i in range(16))


def _host(t):
    import numpy as np
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def work_shape_pca(args):
    """csrc/shape_pca.cu per (block, shape) pair: the centroid, covariance,
    projection and alpha terms of each member pixel of the shape (the
    popcount of its mask, summed over the S shapes; a pixel outside the
    shape needs none), and per pair the centroid's divides, 8 power
    iterations, the direction and the endpoints. A member's weight is
    exactly 1, so no multiply by it is charged. A power iteration is nch^2
    multiplies, nch * (nch - 1) adds (a row's sum starts from its first
    term), nch - 1 maxima, safe_denom's test and select, and nch divides."""
    pix, mask_bits, nch = args[0], args[1], args[2]
    with_alpha = args[5]
    n, s = pix.shape[0], mask_bits.shape[0]
    ncov = nch * (nch + 1) // 2
    members = int(_popcount(_host(mask_bits)).sum())
    per_member = (nch                            # centroid: an add a channel
                  + nch + 2 * ncov               # covariance
                  + 3 * nch + 1                  # projection, min and max
                  + (3 if with_alpha else 0))    # alpha: 255 - a, square, sum
    per_shape = (nch + 3                         # centroid: count, divides
                 + 8 * (2 * nch * nch + nch + 1)  # power iteration
                 + 3 * nch + 2                   # length, direction
                 + 7 * nch                       # endpoints
                 + (2 if with_alpha else 0))     # alpha: conversion, weight
    nbytes = n * 64 * 4 + s * 4 + n * s * 16 * 2 + (n * s * 4
                                                     if with_alpha else 0)
    return nbytes, n * (s * per_shape + members * per_member)


def select_ops(nch):
    """ck::Selector::select over nch channels: a subtract and a multiply a
    channel, the adds between them, then the clamp's min and max, the
    rounding's add and floor, and the conversion."""
    return 3 * nch + 4


def selector_init_ops(nch):
    """ck::Selector::init over nch channels: two conversions, a subtract
    and three multiplies a channel, the squared length's multiply a channel
    and the adds between them, the zero test, its select and the divide."""
    return 8 * nch + 2


def work_single_plane(args):
    """csrc/single_plane.cu: per lane the seeds, rounds and the winner
    reduce; per member pixel the selection, error and refit terms, over
    the mode's nrc channels (an RGB mode selects over 3). Only the lanes
    whose slot is valid (lane_i[2] != 0) in the blocks whose punch-through
    flag leaves their parity valid (pti == 0) are counted."""
    import numpy as np
    mode, pix, base, pti = args[0], args[1], args[2], args[5]
    lane_i, cpow, cfg, rounds = args[6], args[8], args[9], args[11]
    n, s = pix.shape[0], base.shape[1]
    k = lane_i.shape[1]
    rounds = max(rounds, 1)
    nrc = cfg["num_real_channels"]
    lanes = _host(lane_i).astype(np.int64)
    blocks_ok = (_host(pti) == 0).sum(axis=0)          # [4] per parity
    weight = np.where(lanes[2] != 0, blocks_ok[lanes[1]], 0)
    members = _popcount(lanes[3])
    if cfg["fast_indexing"]:
        per_px = select_ops(nrc) + 3 + 9 * nrc
        finish = 8
    else:
        per_px = select_ops(nrc) + 3 * (4 + 11 * nrc) + 10
        finish = 0
    per_px_refine = 5 + 3 * nrc
    per_lane = (12 * nrc
                + rounds * (56 + selector_init_ops(nrc) + finish + 6)
                + (rounds - 1) * (12 + 16 * nrc)
                + 6 * int(np.log2(cpow)))
    per_member = rounds * per_px + (rounds - 1) * per_px_refine
    ops = int((weight * (per_lane + members * per_member)).sum())
    nbytes = (n * 64 * 4 + n * s * (32 + 4) + n * 16 + k * 28
              + n * k * 16)
    return nbytes, ops


def single_plane_slot_efficiency(launches):
    """The member-pixel work the lanes of single_plane_mode_best launches
    need (valid slots only), over the lane slots csrc/single_plane.cu's
    warps spend on it: a warp is one shape's segment of slots and walks
    that shape's member pixels on every lane, an invalid slot's too."""
    import numpy as np
    need = spent = 0
    for args in launches:
        lanes = _host(args[6]).astype(np.int64)
        members = _popcount(lanes[3])
        need += int((members * (lanes[2] != 0)).sum())
        spent += int(members.sum())
    return need / spent if spent else 1.0


def work_dual_plane(args):
    """csrc/dual_plane.cu: the live lanes, and each distinct rotation's
    pixels, PCA line and alpha range once per block, as the lanes of one
    rotation share them (bc7_kernel.dual_plane_order, the kernel's own
    work order, counts both)."""
    from convectionkernels_tpu_torch.models import bc7_kernel
    pix, ci, cf, rounds, fast = args[0], args[1], args[2], args[3], args[5]
    n, lanes = pix.shape[0], ci.shape[1]
    rounds = max(rounds, 1)
    _, n_live, n_rot = bc7_kernel.dual_plane_order(_host(ci), _host(cf))
    pca3 = (16 * 7 + 5 + 16 * 21 + 8 * 22 + 11 + 16 * 12 + 21)
    per_rotation = 16 * 12 + pca3
    per_px = 12 + 7 + ((3 + 27) + 11 if fast else 3 * (3 + 33 + 11) + 16)
    per_lane = (40
                + rounds * (48 + 30 + 16 * per_px + 60)
                + (rounds - 1) * (16 * 22 + 60))
    nbytes = n * 64 * 4 + lanes * (33 + 3) * 4 + n * lanes * 176
    return nbytes, n * (n_rot * per_rotation + n_live * per_lane)


def work_bc6h_group(args):
    """csrc/bc6h_group.cu per (block, row q): the body's operations per
    round, per pixel and per interpolant; the masked terms are computed
    for all 16 pixels."""
    pix, is_signed, fast, uniform = args[0], args[4], args[5], args[6]
    tweaks, refines = args[8], args[9]
    n, rounds = pix.shape[0], tweaks * refines
    unscale = 6 if is_signed else 2
    recon = 6 + unscale                  # interpolate, round, shift, unscale
    weigh = 0 if uniform else 1
    if fast:
        setup = 6 + 5 + 2 + 6            # origin, diff, len_sq, divide, axis
        per_px = (8 + 4 + 3              # project, clamp and round, weight
                  + 3 * (recon + 3 + weigh) + 2)
    else:
        setup = 8 * 3 * (recon + 12 + 1)  # interpolants: TwosCL, times cw
        per_px = 8 * (8 + 1 + 5) + 3 * (2 + weigh) + 2
    per_px += 2 + 2 + 6                  # subset error; pack; invert, repack
    per_round = (6 * 14                  # quantize, unquantize
                 + setup + 16 * per_px + 8 + 3)
    seed = 6 * 7                         # tweak-seeded endpoints
    solve = 12 + 3 * 14                  # refined endpoints
    contribute = 16 * 26                 # refiner totals of 16 pixels
    dedup = 7 * rounds * (rounds - 1) // 2
    per_row = (rounds * per_round + tweaks * seed
               + tweaks * (refines - 1) * (solve + contribute) + dedup)
    nbytes = n * (48 * 4 + 2 * 3 * 64 * 4) + n * rounds * 64 * 40
    return nbytes, n * 64 * per_row


def work_bc6h_single(args):
    """csrc/bc6h_single.cu per texture block: the chain's operations for
    its one row of 16 pixels and 16 interpolants, each counted once a
    block. The kernel's 16 lanes repeat the endpoints, the dedup and the
    refiner's totals of their block; those repeats are not counted."""
    pix, is_signed, fast, uniform = args[0], args[4], args[5], args[6]
    tweaks, refines = args[8], args[9]
    n, rounds = pix.shape[0], tweaks * refines
    unscale = 6 if is_signed else 2
    recon = 6 + unscale                  # interpolate, round, shift, unscale
    weigh = 0 if uniform else 1
    if fast:
        setup = 6 + 5 + 2 + 6            # origin, diff, len_sq, divide, axis
        per_px = (8 + 4 + 3              # project, clamp and round, weight
                  + 3 * (recon + 3 + weigh) + 2)
    else:
        setup = 16 * 3 * (recon + 12 + 1)  # interpolants: TwosCL, times cw
        per_px = 16 * (8 + 1 + 5) + 3 * (2 + weigh) + 2
    per_px += 1 + 3                      # subset error; invert
    per_round = (6 * 14                  # quantize, unquantize
                 + setup + 16 * per_px + 8 + 3)
    seed = 6 * 7                         # tweak-seeded endpoints
    solve = 12 + 3 * 14                  # refined endpoints
    contribute = 16 * 26                 # refiner totals of 16 pixels
    dedup = 7 * rounds * (rounds - 1) // 2
    per_block = (rounds * per_round + tweaks * seed
                 + tweaks * (refines - 1) * (solve + contribute) + dedup)
    nbytes = n * (48 * 4 + 2 * 3 * 4) + n * rounds * (1 + 1 + 6 + 16) * 4
    return nbytes, n * per_block


def work_bc6h_combine(args):
    """csrc/bc6h_combine.cu: every chain output it must read once (err,
    valid and the 6 endpoint words of each row and round; the winning rows'
    index words) and its outputs; per (partition, meta0, meta1) candidate
    the valid test, the float add and the compare. The legality tests run
    only for a candidate that improves its lane's best, and are not
    counted."""
    n, rounds, q = args[0].shape
    partitioned = q == 64
    nbytes = n * rounds * q * 8 * 4 + n * (4 if partitioned else 16) * 4 \
        + n * (4 + 12 + 16) * 4
    candidates = 32 * rounds * rounds if partitioned else rounds
    return nbytes, n * candidates * 3


def work_bc7_pack(args):
    """csrc/bc7_pack.cu, per block the fields of its own mode: its rows of
    pack_fields' int32 [60, N] read once (the mode; the partition in a
    multi-subset mode; the rotation and index selector where the mode has
    them; 3 channels an endpoint, 4 with alpha; 16 indexes, 16 more with
    separate alpha), 16 bytes written once, and the lookup tables read
    once; 3 operations a static field (the value's shift, the place's
    shift and the or) and 12 an index field at a per-block offset (its
    flip's test and select, the 4 words' range tests, shifts and ors for
    the words it touches, the offset's update). A block outside modes 0-7
    reads its mode and writes zeros."""
    import numpy as np

    from convectionkernels_tpu_torch.models import bc7_kernel
    from convectionkernels_tpu_torch.models.bc7_common import MODE_INFO
    fields = args[0]
    rows, ops = [1] * 9, [0] * 9          # 8: outside modes 0-7
    for m in range(8):
        info = MODE_INFO[m]
        ns, separate = info["num_subsets"], info["alpha"] == "separate"
        channels = 3 if info["alpha"] == "none" else 4
        rows[m] = (1 + (ns > 1) + separate + info["has_index_selector"]
                   + 2 * ns * channels + (32 if separate else 16))
        static = (1 + (info["partition_bits"] > 0) + separate
                  + info["has_index_selector"] + 6 * ns
                  + (2 * ns if info["alpha_bits"] else 0)
                  + {"none": 0, "per_subset": ns, "per_ep": 2 * ns}[
                      info["pbit"]])
        ops[m] = 3 * static + 12 * (32 if separate else 16)
    mode = _host(fields[bc7_kernel.FIELD_MODE]).astype(np.int64)
    blocks = np.bincount(np.where((mode >= 0) & (mode < 8), mode, 8),
                         minlength=9)
    nbytes = (int((blocks * (4 * np.array(rows) + 16)).sum())
              + bc7_kernel.PACK_TABLES.nbytes)
    return nbytes, int((blocks * np.array(ops)).sum())


def work_s3tc_alpha(args):
    """csrc/s3tc_alpha.cu per texture block: the channel's 16 values read
    once and 8 bytes written; the chain's operations counted once a block.
    A round: the selector (2 conversions, a subtract, a multiply, the zero
    test and select, a divide, a multiply; the signed clamp's 2 minima),
    per pixel the selection (conversion, subtract, multiply, min, max, add,
    floor, conversion), the reconstruction (9 integer operations), the
    error (subtract, square, add) and the index's shift and or; a
    reduced-range round adds the reserved endpoints' compare, select and
    min a pixel; then the error's conversion, compare and the best's 5
    selects. A round that refits adds the refiner's terms of every pixel
    (conversion, 2 multiplies, 4 adds, a count) and its solve (30). Per
    block: the sort's 120 exchanges (a min and a max each), 135 clipping
    candidates of 8 operations, 4 a pixel for the simple minimum and
    maximum, 18 a tweak for FinishLDR's factors and endpoints, and 8 a
    pixel for the final packing."""
    pixels, is_signed, tweaks, refines = args[0], args[2], args[3], args[4]
    n = pixels.shape[0]
    tweaks, refines = min(max(tweaks, 1), 4), max(refines, 1)
    chains = 5 * tweaks                  # the full range, 4 reduced seeds
    selector = 8 + (2 if is_signed else 0)
    full_round = selector + 16 * (8 + 9 + 3 + 2) + 7
    reduced_round = full_round + 16 * 3
    refit = 16 * 8 + 30
    per_block = (tweaks * refines * (full_round + 4 * reduced_round)
                 + chains * (refines - 1) * refit + chains * 18
                 + 120 * 2 + 135 * 8 + 16 * 4 + 16 * 8)
    nbytes = n * (16 * pixels.element_size() + 8)
    return nbytes, n * per_block


def bound_ms(nbytes, ops):
    """The least time in ms the card could take to move `nbytes` and do
    `ops` operations, and which of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_ISSUE_LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"



WORK = {"shape_pca": work_shape_pca,
        "single_plane_mode_best": work_single_plane,
        "dual_plane_best": work_dual_plane,
        "partitioned_group_meta_rounds": work_bc6h_group,
        "single_group_meta_rounds": work_bc6h_single,
        "combine": work_bc6h_combine,
        "bc7_pack": work_bc7_pack,
        "s3tc_alpha": work_s3tc_alpha}


# --- inputs, shared with the card tests and the benchmark's tests ------------

def make_texture(seed=0, size=1024):
    """A 1024x1024 RGBA texture from a seed: smooth color fields with
    noise and edges, an opaque region, a region of gradient alpha and a
    punch-through (0/255 alpha) region."""
    import numpy as np
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
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    blocks = img.reshape(size // 4, 4, size // 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return blocks.reshape(-1, 16, 4).copy()


def make_hdr_texture(seed=43, n_blocks=65536):
    """A 1024x1024 RGBA16F texture as int16 half-float bits [65536, 16, 4]:
    values uniform in [0, 16) from a seed, alpha 1.0 (the generator of the
    JAX bench's bc6hu row)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 16.0, size=(n_blocks, 16, 4)).astype(np.float16)
    vals[..., 3] = np.float16(1.0)
    return vals.view(np.int16)


def bench_rng44_draws(n_blocks=65536):
    """The JAX bench's four draws from default_rng(44) (bench.py:203-212):
    the eac_r11 values (int16 [n, 16] in [0, 2048)), the eac_r11s values
    (in [-1024, 1024)), the bc4s / bc5s blocks (int8 [n, 16, 4]) and the
    etc2_punchthrough alpha (uint8 [n, 16])."""
    import numpy as np
    rng = np.random.default_rng(44)
    eac_u = rng.integers(0, 2048, size=(n_blocks, 16), dtype=np.int16)
    eac_s = rng.integers(-1024, 1024, size=(n_blocks, 16), dtype=np.int16)
    signed = rng.integers(-128, 128, size=(n_blocks, 16, 4)).astype(np.int8)
    alpha = rng.integers(0, 256, size=(n_blocks, 16)).astype(np.uint8)
    return eac_u, eac_s, signed, alpha


def with_alpha(blocks, alpha):
    """uint8 [n, 16, 4] blocks with their alpha replaced (the JAX bench's
    punchthrough input, bench.py:211-212)."""
    out = blocks.copy()
    out[..., 3] = alpha
    return out


# --- timing and comparison -----------------------------------------------------

def flat_outputs(out):
    """Every output tensor of a wrapper call, a dict's in key order."""
    import torch
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in flat_outputs(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out] if torch.is_tensor(out) else []


def compare(kernel_out, plain_out):
    """(bit-equal, max |kernel - plain|) over every output tensor, each a
    flat_outputs list."""
    import torch
    if len(kernel_out) != len(plain_out):
        return False, float("inf")
    equal, max_err = True, 0.0
    for a, b in zip(kernel_out, plain_out):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            same = torch.equal(a, b)
        equal &= same
        if not same:
            diff = (a.double() - b.double()).abs()
            diff = torch.where(torch.isnan(diff), torch.full_like(diff, 1e30),
                               diff)
            max_err = max(max_err, float(diff.max()))
    return equal, max_err


def time_alone(fn, args, count=BACK_TO_BACK):
    """ms per launch of `count` back-to-back calls of fn(*args) after one
    warm-up call, CUDA events around the whole run."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def timed(fn):
    """(CUDA-event ms of one call of fn, its result)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class Capture:
    """While in the block, wrap each kernel wrapper of KERNELS (found in
    `modules`, {module name: module}) to time its calls with CUDA events and
    keep their arguments (calls[name] = [(args, start, end)]), and count
    every kernel launch at cuda_lib.launch, where each csrc/ kernel is
    launched (launched[library])."""

    def __init__(self, modules):
        from convectionkernels_tpu_torch import cuda_lib
        self.modules = modules
        self.calls = {name: [] for name in KERNELS}
        self.launched = dict.fromkeys(cuda_lib.SOURCES, 0)
        self.saved = []

    def _patch(self, owner, attr, fn):
        self.saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def __enter__(self):
        import torch

        from convectionkernels_tpu_torch import cuda_lib
        for name, meta in KERNELS.items():
            module = self.modules[meta["module"]]

            def wrapper(*args, _name=name, _fn=getattr(module, name)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.calls[_name].append((args, start, end))
                return out

            self._patch(module, name, wrapper)

        def counted(library, what, *args, _launch=cuda_lib.launch):
            _launch(library, what, *args)
            self.launched[library] += 1

        self._patch(cuda_lib, "launch", counted)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        return False


# small kernels launched ahead of run() in each trace of csrc_launches: once
# a process has run long traces, torch 2.11's trace on an H100 leaves out
# the first kernels of each later one (2 to 12 in most, 300 in one seen)
PAD_KERNELS = 1024


def csrc_launches(run):
    """(run(), {library: launches}) of every csrc/ library's kernel on the
    card during run(), read from torch.profiler's trace by the benchmark's
    rule: csrc/<name>.cu holds <name>_kernel, which the trace names
    demangled or mangled. The kernels of a replayed graph count too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from convectionkernels_tpu_torch import cuda_lib
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if str(e.device_type()).endswith("CUDA")]
    launched = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.name() == "cudaLaunchKernel")
    # what the trace leaves out is a prefix: if the last pad kernel is in
    # it, so is every kernel of run()
    if launched[PAD_KERNELS - 1][1] not in {e.correlation_id()
                                            for e in on_card}:
        raise RuntimeError(f"the trace lost more than its first "
                           f"{PAD_KERNELS} kernels")
    counts = dict.fromkeys(cuda_lib.SOURCES, 0)
    for e in on_card:
        for name in counts:
            kernel = name + "_kernel"
            if re.search(rf"(^|\W){kernel}(\W|$)", e.name()) or \
                    f"{len(kernel)}{kernel}" in e.name():
                counts[name] += 1
    return out, counts


def launch_row(name, kernel, plain, args, ms_in_encode):
    """One launch of kernel `name` at the full width: its time in the
    encode and alone, its work and bound, and its outputs against the plain
    version's on every PLAIN_STRIDE[name]-th block."""
    import torch
    ms_alone = time_alone(kernel, args)
    got = flat_outputs(kernel(*args))
    axis = ROW_AXIS.get(name, 0)
    n = args[ROW_ARGS[name][0]].shape[axis]
    rows = torch.arange(0, n, PLAIN_STRIDE[name], device=got[0].device)
    sub = [a.index_select(axis, rows) if i in ROW_ARGS[name] else a
           for i, a in enumerate(args)]
    plain_ms, want = timed(lambda: plain(*sub))
    same, max_err = compare([t.index_select(0, rows) for t in got],
                            flat_outputs(want))
    del got, want
    nbytes, ops = WORK[name](args)
    bound, bound_by = bound_ms(nbytes, ops)
    row = dict(blocks=n, ms=ms_in_encode, ms_alone=ms_alone, bound_ms=bound,
               bound_by=bound_by, share_alone=bound / ms_alone,
               plain_ms=plain_ms, plain_blocks=len(rows), equal=same,
               max_abs_err=max_err, bytes=nbytes, ops=ops)
    if name in LAUNCH_TAG:
        label, position = LAUNCH_TAG[name]
        row = {label: args[position], **row}
    return row


def kernel_alone_phase(name, kernel, plain, calls, usage, launched,
                       replayed):
    """Kernel `name` on each of its wrapper's calls `calls` [(args, start
    event, end event)] of the op-by-op encodes (launch_row), and its row of
    the table: sums over the launches, the bound from the summed work,
    ptxas's usage of its entry functions, and its library's launches in the
    op-by-op encodes (`launched`, counted at cuda_lib.launch) and in their
    replayed programs (`replayed`, read from a trace), {library: count}
    each. Returns (the row, the launches' rows)."""
    meta = KERNELS[name]
    rows = [launch_row(name, kernel, plain, args, start.elapsed_time(end))
            for args, start, end in calls]
    nbytes = sum(r["bytes"] for r in rows)
    ops = sum(r["ops"] for r in rows)
    bound, bound_by = bound_ms(nbytes, ops)
    ms_alone = sum(r["ms_alone"] for r in rows)
    summary = dict(
        name=name, route="cuda",
        source=f"convectionkernels_tpu_torch/csrc/{meta['library']}.cu",
        replaces=meta["replaces"], launches=launched[meta["library"]],
        launches_replayed=replayed[meta["library"]],
        ms=sum(r["ms"] for r in rows), ms_alone=ms_alone,
        bound_ms=bound, bound_by=bound_by, share_alone=bound / ms_alone,
        plain_ms=sum(r["plain_ms"] for r in rows),
        plain_blocks=rows[0]["plain_blocks"],
        equal=all(r["equal"] for r in rows),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        bytes=nbytes, ops=ops,
        ptxas={k: v for k, v in usage.items()
               if k.split("<")[0] == meta["library"] + "_kernel"},
        per_launch=[{k: r[k] for k in r if k in (
            "nch", "mode", "aprec", "ms_alone", "bound_ms")} for r in rows])
    if name == "single_plane_mode_best":
        summary["slot_efficiency"] = single_plane_slot_efficiency(
            [args for args, _, _ in calls])
    return summary, rows


# --- ptxas -----------------------------------------------------------------------

def kernel_entry_name(symbol):
    """The kernel's name and template arguments from its mangled symbol:
    `<length><name>_kernel` followed, for a template, by I(L[ib]<n>E)+E."""
    end = symbol.find("_kernel")
    if end < 0:
        return None
    end += len("_kernel")
    name = None
    for length in range(len("_kernel") + 1, end + 1):   # innermost name first
        start = end - length
        if start >= len(str(length)) and \
                symbol[start - len(str(length)):start] == str(length):
            name = symbol[start:end]
            break
    if name is None:
        return None
    m = re.match(r"I((?:L[ib]\d+E)+)E", symbol[end:])
    args = re.findall(r"L[ib](\d+)E", m.group(1)) if m else []
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_usage(log_text):
    """{kernel<template args>: "N registers, S bytes stack, X bytes spill
    stores, Y bytes spill loads"} from the -Xptxas -v output nvcc gave when
    it built a library."""
    usage, entry, spills = {}, None, "0 bytes spill stores, 0 bytes spill loads"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_entry_name(m.group(1))
            spills = "0 bytes spill stores, 0 bytes spill loads"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (f"{m.group(1)} bytes spill stores, "
                      f"{m.group(2)} bytes spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            usage[entry] = (f"{m.group(1)} registers, "
                            f"{stack.group(1) if stack else 0} bytes stack, "
                            f"{spills}")
    return usage


def phase(step, **fields):
    print(json.dumps(dict(phase=step, **fields)), flush=True)


# --- main ------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for chip_smoke.json (every launch's "
                         "times, work and comparison)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from convectionkernels_tpu_torch import api, cuda_lib, programs
    from convectionkernels_tpu_torch.models import (bc6h_kernel, bc7_kernel,
                                                    s3tc)
    from convectionkernels_tpu_torch.options import Flags, Options

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    os.makedirs(args.out, exist_ok=True)
    detail = {}

    # 1. build
    t0 = time.perf_counter()
    cuda_lib.build_all()
    usage = {}
    for n in cuda_lib.SOURCES:
        with open(cuda_lib.log_path(n)) as f:
            usage.update(ptxas_usage(f.read()))
    detail["ptxas"] = usage
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries=[os.path.basename(cuda_lib.library_path(n))
                     for n in cuda_lib.SOURCES], ptxas=usage)

    # 2. one op-by-op encode of each configuration, every kernel wrapper's
    # call timed and its arguments kept, every launch counted
    modules = {"bc7_kernel": bc7_kernel, "bc6h_kernel": bc6h_kernel,
               "s3tc": s3tc}
    tex = torch.as_tensor(make_texture(seed=0), device=dev)
    hdr = torch.as_tensor(make_hdr_texture(), device=dev)
    encodes = {
        "bc7_q50": (tex, lambda: api.encode_bc7(tex, quality=50, device=dev)),
        "bc6hu": (hdr, lambda: api.encode_bc6hu(hdr, device=dev)),
        "etc2_rgba": (tex, lambda: api.encode_etc2_rgba(tex, device=dev)),
        "bc3_better": (tex, lambda: api.encode_bc3(
            tex, Options(flags=Flags.BETTER), device=dev))}
    calls = {name: [] for name in KERNELS}
    eager, launched = {}, {}
    for config, (blocks, encode) in encodes.items():
        with programs.eager():
            # the first encode fills the allocator's cache: a cudaMalloc of
            # a launch's outputs would fall inside its events
            encode()
            torch.cuda.synchronize()
            with Capture(modules) as capture:
                eager[config] = encode()
                torch.cuda.synchronize()
        for name, made in capture.calls.items():
            calls[name] += made
        launched[config] = capture.launched
        phase("encode", config=config, blocks=blocks.shape[0],
              calls={k: len(v) for k, v in capture.calls.items() if v},
              launches=capture.launched)
    missing = [k for k, v in calls.items() if not v]
    if missing:
        raise SystemExit(f"no launch of {missing} in the encodes")
    del capture

    # 3. each configuration through its program: first call, capture and
    # replays, each byte-equal to the op-by-op encode
    replayed = {}
    for config, (blocks, encode) in encodes.items():
        api.release_programs()
        equal = [torch.equal(encode(), eager[config]) for _ in range(2)]
        replay_ms, out = timed(encode)
        equal.append(torch.equal(out, eager[config]))
        out, replayed[config] = csrc_launches(encode)
        equal.append(torch.equal(out, eager[config]))
        captures = [b.captures for p in programs.programs()
                    for b in p.buckets.values()]
        phase("replay", config=config, blocks=blocks.shape[0], equal=equal,
              captures=captures, replay_ms=replay_ms,
              launches=launched[config], launches_replayed=replayed[config])
        if not all(equal) or set(captures) != {1}:
            raise SystemExit(f"{config}: a program's call differs from the "
                             f"op-by-op encode, or a bucket was captured "
                             f"other than once")
        if replayed[config] != launched[config]:
            raise SystemExit(f"{config}: the replayed graphs launch "
                             f"{replayed[config]}, the op-by-op encode "
                             f"{launched[config]}")
        if {k: v for k, v in launched[config].items() if v} != \
                CHUNK_LAUNCHES[config]:
            raise SystemExit(f"{config}: a chunk launches "
                             f"{launched[config]}, not "
                             f"{CHUNK_LAUNCHES[config]}")
    api.release_programs()
    del tex, hdr, eager, out
    total = {when: {lib: sum(c[lib] for c in counts.values())
                    for lib in cuda_lib.SOURCES}
             for when, counts in (("eager", launched),
                                  ("replayed", replayed))}

    # 4. each kernel alone, against its bound and its plain version
    kernels, detail["launches"] = [], {}
    for name, meta in KERNELS.items():
        module = modules[meta["module"]]
        summary, rows = kernel_alone_phase(
            name, getattr(module, name), getattr(module, name + "_plain"),
            calls.pop(name), usage, total["eager"], total["replayed"])
        torch.cuda.empty_cache()
        detail["launches"][name] = rows
        kernels.append(summary)
        phase("kernel", **{k: v for k, v in summary.items()
                           if k != "per_launch"})
    bad = [k["name"] for k in kernels if not k["equal"]]
    if bad:
        raise SystemExit(f"{bad} disagree with their plain versions at the "
                         f"full width")
    bad = [k["name"] for k in kernels if k["launches"] != len(k["per_launch"])]
    if bad:
        raise SystemExit(f"a call of {bad} launched other than one kernel")

    # 5. the table, the card, and the result
    detail["kernels"] = kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    detail["card"] = smi
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit as failure:
        if isinstance(failure.code, str):     # a check failed
            print(json.dumps({"ok": False, "error": failure.code}),
                  flush=True)
        raise
