#!/usr/bin/env python3
"""Drive the torch port's main paths (BC7 q50, BC6H, S3TC, ETC1, ETC2 and
EAC11 encode, the image-to-file CLI and the block axis split over devices
and processes) on one CUDA card and check them.

    python3 chip_smoke.py                  # the check, on one card
    python3 chip_smoke.py --chunks 8192,16384,32768,65536
                                           # also time encode_bc7 per chunk size
    python3 chip_smoke.py --chunks-bc6h 4096,8192,16384,32768
                                           # also time encode_bc6hu per chunk size
    python3 chip_smoke.py --chunks-s3tc 4096,16384,65536
                                           # also time encode_bc1 and
                                           # encode_bc3 per chunk size
    python3 chip_smoke.py --chunks-s3tc-exhaustive 4096,16384,65536
                                           # also time the exhaustive
                                           # encode_bc1 per chunk size
    python3 chip_smoke.py --chunks-etc 4096,16384,65536
                                           # also time encode_etc1 (default
                                           # and FakeBT709) per chunk size
    python3 chip_smoke.py --chunks-eac 16384,65536
                                           # also time encode_etc2_alpha and
                                           # encode_eac11 per chunk size
    python3 chip_smoke.py --chunks-etc2 16384,65536
                                           # also time encode_etc2 and
                                           # encode_etc2_punchthrough per
                                           # chunk size
    python3 chip_smoke.py --profile        # also profile one full-width encode
                                           # of each path op by op (BC7,
                                           # BC6H, BC1, BC3, exhaustive BC1,
                                           # ETC1, ETC2 and ETC2
                                           # punchthrough) and the replayed
                                           # programs of BC7, BC6H, BC1, BC3
    python3 chip_smoke.py --pca-chunks 81,192,243
                                           # also time shape_pca alone for lists
                                           # of these lengths, each chunk forced
    python3 chip_smoke.py --out DIR        # chip_smoke.json and profile_*.txt
                                           # go to DIR (default build/chip_smoke)

Phases, each printed on its own line; a failed check prints
{"ok": false, "error": ...} as the last line and exits nonzero:
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. exact_probe: divide/sqrt/round/clamp/FMA/int chains, card vs CPU bits;
  3. each kernel against its plain PyTorch version on the card: the BC7
     kernels on the inputs a 256-block q50 encode gives them (every mode's
     launch), the BC6H kernel on the blocks of the stored BC6H goldens at
     12 rounds (unsigned/slow/aPrec 10, signed/fast/aPrec 6, uniform
     weights): f32 outputs compared as int32 bits, so the tolerance is 0;
  4. encode_bc7, encode_bc6hu, encode_bc6hs, the S3TC entry points (every
     case of the stored S3TC goldens) and the ETC entry points (every case
     of the stored ETC goldens, each through its stored entry point and
     Options: ETC1 weighted, uniform, FakeBT709 fast and accurate,
     tie-prone blocks; ETC2 alpha; EAC11 unsigned and signed; ETC2
     weighted, uniform, FakeBT709, blocks built for each mode, RGBA,
     punchthrough at four thresholds) on the card against the JAX
     package's golden bytes;
  5. the full-width runs, each timed with CUDA events (median of 3 after a
     warm-up) with its kernels' launches counted over the main path, and
     then each kernel, launched at the full width, against its plain
     version on 1,024 of its blocks. An entry point runs a program of its
     configuration and bucket (convectionkernels_tpu_torch/programs.py):
     the warm-up call runs it op by op, the first timed call captures it
     into a CUDA graph and replays it, the others replay it; the per-launch
     kernel timings run op by op, under programs.eager():
       - BC7: a 1024x1024 RGBA texture (65,536 blocks) through encode_bc7
         at quality 50 with default Options, decoded back; then
         shape_pca (its RGB and RGBA launches), single_plane_mode_best
         (each mode's launch) and dual_plane_best timed alone, 20
         back-to-back launches on the inputs captured from the encode;
       - BC6H: a 1024x1024 RGBA16F texture (65,536 blocks of half floats
         uniform in [0, 16), alpha 1.0) through encode_bc6hu with default
         Options (4 x 3 meta rounds, slow indexing), decoded back; then
         the combine's 10 launches (`bc6h_combine`) and the single-mode
         groups' 4 chain launches (`bc6h_single`), each timed alone (20
         back-to-back launches on the inputs captured from the encode) and
         against its plain version, compared on every block;
       - S3TC: eight configurations at 65,536 blocks with default Options,
         bc1, bc2, bc3, bc4u, bc5u and the exhaustive bc1 on the BC7
         texture, bc4s and bc5s on the JAX bench's int8 blocks; each
         timed, its peak device memory read, and 1,024 of its blocks held
         byte-equal to the port's CPU bytes for the same blocks (S3TC has
         no kernel: this is its card-versus-plain check);
       - ETC: nine configurations at 65,536 blocks with default Options,
         etc1, etc1 with FakeBT709, etc2_alpha, etc2, etc2_rgba and etc2
         with FakeBT709 on the BC7 texture, eac_r11 and eac_r11s on the
         JAX bench's int16 values, etc2_punchthrough on the texture with
         the JAX bench's random alpha (its share of blocks with a
         transparent pixel recorded); each timed, its peak device memory
         read, and 1,024 of its blocks held byte-equal to the port's CPU
         bytes (no kernel either);
  6. the program layer (`programs`): each full-width configuration above
     op by op and replayed, bytes equal and no new capture, median of 3
     CUDA-event timings and the peak memory of each; a replayed BC7 q50
     and BC6H encode counting their kernels' launches, which their graphs
     hold (`programs_kernels`); every golden of phase 4 twice more through
     its program, captured and replayed (`programs_goldens`); BC7 q50 at
     40, 72 and 70,000 blocks, one capture of each bucket
     (`programs_reuse`); under --profile the device-busy share of the
     replayed BC7 q50, BC6H, BC1 and BC3 encodes; and, after the other
     phases, `programs_memory`: BC7 q50 and BC6H captured afresh into one
     pool and replayed out of capture order, then release_programs()
     giving the pool back;
  7. the CLI (`cli`): the BC7 texture saved as .npy goes through
     convectionkernels_tpu_torch.cli on the card: -f bc7 -q 50 to .dds,
     once as `python -m convectionkernels_tpu_torch.cli` in a process of
     its own and once in this one, -f bc6h to .dds, -f etc2 -mips to .ktx
     (11 levels), -f eac_rg11 to .ktx; each run timed from image load to
     file written, the BC7 and BC6H kernels' launches counted over it
     (all three BC7 kernels must launch for bc7, the BC6H kernel for
     bc6h), each file's header checked against its format's layout, each
     level's payload held against the entry points on the card for that
     level's blocks, and 1,024 blocks against the port on the CPU;
  8. the split over devices (`sharded`): encode_sharded of BC7 q50 and
     of ETC2 punchthrough on the texture over three slices of card 0
     (and over every card when there are several), each byte-equal to
     one call;
  9. the split over processes (`distributed`): two gloo processes
     sharing card 0 and one NCCL process, encode_image_distributed of
     encode_bc1 on the texture, each rank's slice and the gathered whole
     held against one call;
 10. ptxas's registers, stack and spills of the three redesigned BC7
     kernels, one JSON line describing every kernel (bounds from the work
     model below, at the FMA-free issue rate; `launches` from the
     full-width runs, `cli_launches` from each CLI run), the card's name
     and power limit, and the final {"ok": true, ...} line.

Needs the CUDA toolkit (nvcc) and a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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

KERNELS = {
    "shape_pca": dict(
        module="bc7_kernel",
        source="convectionkernels_tpu_torch/csrc/shape_pca.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:246"),
    "single_plane_mode_best": dict(
        module="bc7_kernel",
        source="convectionkernels_tpu_torch/csrc/single_plane.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:302"),
    "dual_plane_best": dict(
        module="bc7_kernel",
        source="convectionkernels_tpu_torch/csrc/dual_plane.cu",
        replaces="convectionkernels_tpu/models/bc7_kernel.py:629"),
    "partitioned_group_meta_rounds": dict(
        module="bc6h_kernel",
        source="convectionkernels_tpu_torch/csrc/bc6h_group.cu",
        replaces="convectionkernels_tpu/models/bc6h_kernel.py:302"),
}
BC7_KERNELS = tuple(k for k, v in KERNELS.items()
                    if v["module"] == "bc7_kernel")
BC6H_KERNEL = "partitioned_group_meta_rounds"
# kernels also timed alone, on the full-width inputs captured from the encode
ALONE_KERNELS = ("shape_pca", "single_plane_mode_best", "dual_plane_best")
ALONE_LAUNCHES = 20


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


def bound_ms(nbytes, ops):
    """The least time in ms the card could take to move `nbytes` and do
    `ops` operations, and which of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_ISSUE_LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


WORK = {"shape_pca": work_shape_pca,
        "single_plane_mode_best": work_single_plane,
        "dual_plane_best": work_dual_plane,
        "partitioned_group_meta_rounds": work_bc6h_group}

# positions of each wrapper's arguments whose leading axis is the block axis
ROW_ARGS = {"shape_pca": (0,), "single_plane_mode_best": (1, 2, 3, 4, 5),
            "dual_plane_best": (0,),
            "partitioned_group_meta_rounds": (0, 1, 2)}

# what tells one launch of a kernel from another: (label, argument position)
LAUNCH_TAG = {"shape_pca": ("nch", 2), "single_plane_mode_best": ("mode", 0),
              "partitioned_group_meta_rounds": ("aprec", 3)}


# --- helpers -----------------------------------------------------------------

def flat_outputs(out):
    import torch
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for t in out if torch.is_tensor(t)]


def out_device(out):
    return flat_outputs(out)[0].device


def take_rows(out, rows):
    """The kernel outputs of the blocks `rows` (every output's leading axis
    is the block axis)."""
    import torch
    if isinstance(out, dict):
        return {k: v.index_select(0, rows) for k, v in out.items()}
    return tuple(t.index_select(0, rows) if torch.is_tensor(t) else t
                 for t in out)


def compare(kernel_out, plain_out):
    """(bit-equal, max |kernel - plain|) over every output tensor."""
    import torch
    equal, max_err = True, 0.0
    for a, b in zip(flat_outputs(kernel_out), flat_outputs(plain_out)):
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


class Instrument:
    """Wrap the kernel wrappers `names` of one module of models/ for one
    run: time each launch with CUDA events, add up its work model, and
    (when `with_plain`) run its plain version on the same inputs and
    compare, on every block or on every `plain_stride`-th block only; keep
    the arguments of the kernels named in `capture`."""

    def __init__(self, module, names, with_plain, plain_stride=None,
                 capture=()):
        self.mod = module
        self.names = tuple(names)
        self.with_plain = with_plain
        self.plain_stride = plain_stride
        self.captured = {k: [] for k in capture}
        self.events = {k: [] for k in self.names}
        self.plain_events = {k: [] for k in self.names}
        self.work = {k: [0, 0] for k in self.names}
        self.equal = {k: True for k in self.names}
        self.max_err = {k: 0.0 for k in self.names}
        self.blocks_compared = {k: 0 for k in self.names}
        self.detail = []
        self.saved = {}

    def __enter__(self):
        import torch
        plain = {name: getattr(self.mod, name + "_plain")
                 for name in self.names}
        for name in self.names:
            fn = getattr(self.mod, name)
            self.saved[name] = fn

            def wrapper(*args, _name=name, _fn=fn):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.events[_name].append((start, end))
                nbytes, ops = WORK[_name](args)
                self.work[_name][0] += nbytes
                self.work[_name][1] += ops
                entry = dict(kernel=_name, bytes=nbytes, ops=ops,
                             bound_ms=bound_ms(nbytes, ops)[0],
                             event=len(self.events[_name]) - 1)
                if _name in LAUNCH_TAG:
                    label, position = LAUNCH_TAG[_name]
                    entry[label] = args[position]
                self.detail.append(entry)
                if _name in self.captured:
                    self.captured[_name].append(args)
                if self.with_plain:
                    rows = None
                    n_rows = args[ROW_ARGS[_name][0]].shape[0]
                    if self.plain_stride is not None:
                        rows = torch.arange(0, n_rows, self.plain_stride,
                                            device=out_device(out))
                        args = [a.index_select(0, rows)
                                if i in ROW_ARGS[_name] else a
                                for i, a in enumerate(args)]
                    self.blocks_compared[_name] += (
                        n_rows if rows is None else len(rows))
                    ps = torch.cuda.Event(enable_timing=True)
                    pe = torch.cuda.Event(enable_timing=True)
                    ps.record()
                    ref = plain[_name](*args)
                    pe.record()
                    self.plain_events[_name].append((ps, pe))
                    eq, err = compare(
                        out if rows is None else take_rows(out, rows), ref)
                    self.equal[_name] &= eq
                    self.max_err[_name] = max(self.max_err[_name], err)
                return out

            setattr(self.mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        return False

    @staticmethod
    def total_ms(pairs):
        return sum(s.elapsed_time(e) for s, e in pairs)

    def detail_ms(self):
        for d in self.detail:
            s, e = self.events[d["kernel"]][d["event"]]
            d["ms"] = s.elapsed_time(e)
        return self.detail


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


# the S3TC full-width configurations: (name, entry point, flags added to
# the default Options, input)
S3TC_CONFIGS = (
    ("bc1", "encode_bc1", 0, "texture"),
    ("bc2", "encode_bc2", 0, "texture"),
    ("bc3", "encode_bc3", 0, "texture"),
    ("bc4u", "encode_bc4u", 0, "texture"),
    ("bc4s", "encode_bc4s", 0, "signed"),
    ("bc5u", "encode_bc5u", 0, "texture"),
    ("bc5s", "encode_bc5s", 0, "signed"),
    ("bc1_exhaustive", "encode_bc1", 0x080, "texture"),  # S3TC_EXHAUSTIVE
)
S3TC_PROFILED = ("bc1", "bc3", "bc1_exhaustive")
CPU_CHECK_BLOCKS = 1024


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


# the ETC full-width configurations: (name, entry point, flags added to the
# default Options, input)
ETC_CONFIGS = (
    ("etc1", "encode_etc1", 0, "texture"),                    # bench.py:249
    ("etc1_fake709", "encode_etc1", 0x400, "texture"),  # ETC_USE_FAKE_BT709
    ("etc2_alpha", "encode_etc2_alpha", 0, "texture"),        # bench.py:252
    ("eac_r11", "encode_eac11", 0, "eac_unsigned"),           # bench.py:245
    ("eac_r11s", "encode_eac11", 0, "eac_signed"),            # bench.py:246
    ("etc2", "encode_etc2", 0, "texture"),                    # bench.py:237
    ("etc2_rgba", "encode_etc2_rgba", 0, "texture"),          # bench.py:250
    ("etc2_fake709", "encode_etc2", 0x400, "texture"),        # bench.py:264
    ("etc2_punchthrough", "encode_etc2_punchthrough", 0,      # bench.py:243
     "texture_random_alpha"),
)
ETC_PROFILED = ("etc1", "etc2", "etc2_punchthrough")


def etc_encoder(api, entry, blocks, options, dev, signed=False):
    """A no-argument call of the ETC entry point `entry` on `blocks`."""
    fn = getattr(api, entry)
    if entry == "encode_eac11":
        return lambda: fn(blocks, signed, options, device=dev)
    return lambda: fn(blocks, options, device=dev)


def etc_chunk_attr(entry):
    """The api module's chunk size that `entry` encodes in."""
    if entry == "encode_etc1":
        return "CHUNK_ETC"
    if entry in ("encode_etc2", "encode_etc2_rgba",
                 "encode_etc2_punchthrough"):
        return "CHUNK_ETC2"
    return "CHUNK_EAC"


def mismatched(got, want) -> int:
    """Blocks of the card's bytes `got` that differ from `want` (NumPy)."""
    got = got.cpu().numpy()
    if got.shape != want.shape:
        return len(want)
    return int((got != want).any(axis=1).sum())


def golden_cases(api, ckt, testdata, dev, golden_px, golden_blocks,
                 bc6h_golden):
    """{family: [(case, a no-argument encode on the card, the stored JAX
    bytes)]} of every stored golden: the BC7 q50 one, the BC6H, S3TC and
    ETC ones, each through its entry point and its stored Options."""
    import numpy as np
    cases = {"q50": [("q50", lambda: api.encode_bc7(
        golden_px, quality=50, device=dev), golden_blocks)]}
    cases["bc6h"] = []
    for name in sorted(k[:-len("_pixels")] for k in bc6h_golden
                       if k.endswith("_pixels")):
        flags, seed_points, refine_rounds, signed = (
            int(v) for v in bc6h_golden[f"{name}_config"])
        encode = api.encode_bc6hs if signed else api.encode_bc6hu
        options = ckt.Options(flags=flags, seed_points=seed_points,
                              refine_rounds_bc6h=refine_rounds)
        cases["bc6h"].append((name, functools.partial(
            encode, bc6h_golden[f"{name}_pixels"], options, device=dev),
            bc6h_golden[f"{name}_blocks"]))
    with np.load(os.path.join(testdata, "s3tc_golden.npz")) as z:
        s3tc_golden = {k: z[k] for k in z.files}
    cases["s3tc"] = []
    for name in sorted(k[:-len("_pixels")] for k in s3tc_golden
                       if k.endswith("_pixels")):
        flags, threshold, seed_points, rounds_s3tc, rounds_iic = (
            s3tc_golden[f"{name}_options"].tolist())
        options = ckt.Options(
            flags=int(flags), threshold=threshold,
            seed_points=int(seed_points),
            refine_rounds_s3tc=int(rounds_s3tc),
            refine_rounds_iic=int(rounds_iic))
        cases["s3tc"].append((name, functools.partial(
            getattr(api, "encode_" + name.split("_")[0]),
            s3tc_golden[f"{name}_pixels"], options, device=dev),
            s3tc_golden[f"{name}_blocks"]))
    with np.load(os.path.join(testdata, "etc_golden.npz")) as z:
        etc_golden = {k: z[k] for k in z.files}
    cases["etc"] = []
    for name in sorted(k[:-len("_pixels")] for k in etc_golden
                       if k.endswith("_pixels")):
        entry = str(etc_golden[f"{name}_entry"])
        cases["etc"].append((name, etc_encoder(
            api, "encode_eac11" if entry.startswith("eac11")
            else f"encode_{entry}", etc_golden[f"{name}_pixels"],
            ckt.Options(flags=int(etc_golden[f"{name}_flags"]),
                        threshold=float(etc_golden[f"{name}_threshold"])),
            dev, signed=entry == "eac11s"), etc_golden[f"{name}_blocks"]))
    return cases


def profile_encode(encode, out_path):
    """One full-width encode under torch.profiler: the device's busy time
    by kernel name against the host's wall time for the same encode."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = []
    for e in averages:
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    with open(out_path, "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=80))
    return dict(wall_ms=wall_ms, device_busy_ms=sum(r[1] for r in rows),
                device_launches=sum(r[2] for r in rows),
                top=[dict(name=k[:100], ms=ms, count=c)
                     for k, ms, c in rows[:30]])


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


def phase(name, **fields):
    print(json.dumps(dict(phase=name, **fields)), flush=True)


def kernel_alone_phase(module, name, programs, encode, work, fields,
                       flatten):
    """A kernel of `module` at the full width: the launches of its wrapper
    `name` in one op-by-op encode, each then timed alone (ALONE_LAUNCHES
    back to back), its plain version (`name`_plain) timed once on the same
    inputs, and the two compared on every block. fields(args) gives a
    launch's own fields, flatten(out) the output tensors to compare."""
    import torch
    captured, real = [], getattr(module, name)
    plain = getattr(module, name + "_plain")

    def keep(*args):
        captured.append(args)
        return real(*args)

    setattr(module, name, keep)
    try:
        with programs.eager():
            encode()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, real)
    rows = []
    for args in captured:
        ms_alone = time_alone(real, args)
        plain_ms, want = timed(lambda: plain(*args), 1)
        got = real(*args)
        same, max_err = compare(flatten(got), flatten(want))
        nbytes, ops = work(args)
        bound, bound_by = bound_ms(nbytes, ops)
        rows.append(dict(**fields(args), ms_alone=ms_alone,
                         plain_ms=plain_ms[0], bound_ms=bound,
                         bound_by=bound_by, share_alone=bound / ms_alone,
                         equal=same, max_abs_err=max_err, bytes=nbytes,
                         ops=ops))
        del want, got
    torch.cuda.empty_cache()
    return rows


def bc6h_combine_phase(bc6h_kernel, programs, encode):
    """csrc/bc6h_combine.cu at the full width (kernel_alone_phase)."""
    return kernel_alone_phase(
        bc6h_kernel, "combine", programs, encode, work_bc6h_combine,
        lambda a: dict(aprec=a[4], partitioned=a[0].shape[2] == 64,
                       blocks=a[0].shape[0], rounds=a[0].shape[1]),
        lambda out: [out[0], out[1], *[out[2][k] for k in sorted(out[2])]])


def bc6h_single_phase(bc6h_kernel, programs, encode):
    """csrc/bc6h_single.cu at the full width (kernel_alone_phase): the 4
    single-mode groups' launches of one chunk."""
    return kernel_alone_phase(
        bc6h_kernel, "single_group_meta_rounds", programs, encode,
        work_bc6h_single,
        lambda a: dict(aprec=a[3], signed=a[4], fast=a[5],
                       blocks=a[0].shape[0], rounds=a[8] * a[9]),
        list)


def time_alone(fn, args, count=ALONE_LAUNCHES):
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


def timed(fn, repeats=3):
    """CUDA-event times in ms of `repeats` calls of fn, and the last
    result."""
    import torch
    times, out = [], None
    for _ in range(repeats):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return times, out


def pca_chunk_sweep(pix, cw, uniform, lengths):
    """csrc/shape_pca.cu alone on the full-width pixels for the first S of
    the 243 BC7 shapes, S in `lengths`, with each chunk (1, 2 or 4 shapes
    a warp takes at once) through the C entry point: {nch: {S: {chunk: ms per launch}}}. The RGB lists sum the
    alpha error, as the encode's do. These launches bypass the wrapper and
    its count."""
    import torch
    from convectionkernels_tpu_torch import cuda_lib
    from convectionkernels_tpu_torch.models import bc7_kernel
    from convectionkernels_tpu_torch.tables import bc7_geometry
    fn = cuda_lib.function("shape_pca")
    all_bits = bc7_kernel.shape_mask_bits(bc7_geometry.shape_masks())
    n = pix.shape[0]
    sweep = {}
    for nch, with_alpha in ((3, True), (4, False)):
        sweep[nch] = {}
        for s_count in lengths:
            bits = torch.as_tensor(all_bits[:s_count], device=pix.device)
            base = torch.empty((n, s_count, 4), dtype=torch.float32,
                               device=pix.device)
            offset = torch.empty_like(base)
            alpha = torch.empty((n, s_count), dtype=torch.float32,
                                device=pix.device)

            def launch(chunk):
                cuda_lib.check(fn(
                    pix.data_ptr(), bits.data_ptr(), n, s_count, nch,
                    bc7_kernel._cw_array(cw), int(uniform), int(with_alpha),
                    chunk, base.data_ptr(), offset.data_ptr(),
                    alpha.data_ptr() if with_alpha else None,
                    bc7_kernel._stream()), "shape_pca")
            sweep[nch][s_count] = {chunk: time_alone(launch, (chunk,))
                                   for chunk in (1, 2, 4)}
    return sweep


def chunk_sweep(api, attr, chunks, encode, dev):
    """Encode times and peak device memory for each value of the api
    module's chunk size `attr`."""
    import torch
    sweep = {}
    default_chunk = getattr(api, attr)
    try:
        for chunk in chunks:
            setattr(api, attr, chunk)
            encode()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            runs, _ = timed(encode)
            sweep[chunk] = dict(
                encode_ms=runs,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    finally:
        setattr(api, attr, default_chunk)
    return sweep


# --- the CLI and the block axis split over devices and over processes --------

# the CLI runs of the `cli` phase: (label, flags, output file, container
# format); the first also runs as `python -m convectionkernels_tpu_torch.cli`
CLI_RUNS = (
    ("bc7", ["-f", "bc7", "-q", "50"], "bc7.dds", "bc7"),
    ("bc6h", ["-f", "bc6h"], "bc6h.dds", "bc6h_uf"),
    ("etc2_mips", ["-f", "etc2", "-mips"], "etc2.ktx", "etc2"),
    ("eac_rg11", ["-f", "eac_rg11"], "eac_rg11.ktx", "eac_rg11"),
)
# blocks a chunk of a BC7 or BC6H encode on the CPU: the plain versions run
# one chunk of 1,024 blocks far slower than 16 chunks of 64 (their
# per-candidate tensors leave the caches); the bytes are the same
CPU_CHUNK = 64


def cli_bytes(api, cli, label, blocks, dev):
    """What the CLI run `label` must write for the blocks of one level, from
    the API's entry points on `dev`, through the CLI's input transforms."""
    import torch
    if label == "bc7":
        return api.encode_bc7(blocks, quality=50, device=dev)
    if label == "bc6h":
        return api.encode_bc6hu(cli._u8_to_half_bits(blocks), device=dev)
    if label == "etc2_mips":
        return api.encode_etc2(blocks, device=dev)
    return torch.cat([api.encode_eac11(cli._eac_channel(blocks, ch),
                                       device=dev) for ch in (0, 1)], dim=1)


def container_levels(path, fmt, sizes):
    """Each level's payload, uint8 [blocks, bytes], of the KTX or DDS file
    `path`, after checking its header against the layout of `fmt` with the
    level sizes `sizes` [(width, height), ...]; raises SystemExit naming
    the first field that is off."""
    import struct

    import numpy as np

    from convectionkernels_tpu_torch.utils import containers as ct
    with open(path, "rb") as f:
        data = f.read()
    width = ct.BLOCK_BYTES[fmt]
    nbytes = [((w + 3) // 4) * ((h + 3) // 4) * width for w, h in sizes]
    (w0, h0), mips = sizes[0], len(sizes)
    if path.endswith(".dds"):
        flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x80000 | (0x20000 if mips > 1
                                                       else 0)
        fields = {
            "magic": (data[:4], b"DDS "),
            "size, flags, height, width, pitch, depth, mips": (
                struct.unpack_from("<7I", data, 4),
                (124, flags, h0, w0, max(1, (w0 + 3) // 4) * width, 0, mips)),
            "pixel format size, flags, fourCC": (
                struct.unpack_from("<2I4s", data, 76), (32, 0x4, b"DX10")),
            "caps": (struct.unpack_from("<I", data, 108)[0],
                     0x1000 | (0x400008 if mips > 1 else 0)),
            "dxgi format, dimension, misc, array size, misc2": (
                struct.unpack_from("<5I", data, 128),
                (ct.DXGI_FORMATS[fmt], 3, 0, 1, 0)),
            "length": (len(data), 148 + sum(nbytes)),
        }
        offsets, pos = [], 148
        for n in nbytes:
            offsets.append(pos)
            pos += n
    else:
        fields = {
            "magic": (data[:12], ct._KTX_MAGIC),
            "header": (struct.unpack_from("<13I", data, 12),
                       (0x04030201, 0, 1, 0, ct.GL_INTERNAL_FORMATS[fmt],
                        ct.GL_BASE_FORMATS[fmt], w0, h0, 0, 0, 1, mips, 0)),
        }
        offsets, pos = [], 64
        for i, n in enumerate(nbytes):
            fields[f"level {i} size"] = (
                struct.unpack_from("<I", data, pos)[0] if pos + 4 <= len(data)
                else None, n)
            offsets.append(pos + 4)
            pos += 4 + n + (-n) % 4
        fields["length"] = (len(data), pos)
    for name, (got, want) in fields.items():
        if got != want:
            raise SystemExit(f"{os.path.basename(path)}: {name} is {got}, "
                             f"not {want}")
    return [np.frombuffer(data, np.uint8, n, off).reshape(-1, width)
            for off, n in zip(offsets, nbytes)]


def cli_phase(api, dev, img_path, img, work):
    """The `cli` phase: each CLI_RUNS run on the card, in this process (the
    kernels' counts set to 0 just before it and read just after), and the
    first also as `python -m convectionkernels_tpu_torch.cli` in a process
    of its own. Each file's header is checked, each level's payload held
    against the API's entry points on the card for that level's blocks,
    and 1,024 blocks of level 0 against the port on the CPU. Returns the
    launches of each run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from convectionkernels_tpu_torch import cli
    from convectionkernels_tpu_torch.models import bc6h_kernel, bc7_kernel
    from convectionkernels_tpu_torch.utils import image as image_util
    from convectionkernels_tpu_torch.utils import native
    label, flags, name, _ = CLI_RUNS[0]
    module_out = os.path.join(work, "module_" + name)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "convectionkernels_tpu_torch.cli", *flags,
         img_path, module_out], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    module_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"python -m convectionkernels_tpu_torch.cli "
                         f"{' '.join(flags)} exited {proc.returncode}: "
                         f"{proc.stderr[-2000:]}")
    phase("cli_module", run=label, flags=flags, wall_s=module_s,
          said=proc.stdout.strip(), native_blockify=native.available())
    launched = {}
    for label, flags, name, fmt in CLI_RUNS:
        path = os.path.join(work, name)
        torch.cuda.synchronize()
        bc7_kernel.LAUNCHES.clear()
        bc6h_kernel.LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main(flags + [img_path, path])
        wall_s = time.perf_counter() - t0
        launches = {**{k: bc7_kernel.LAUNCHES[k] for k in BC7_KERNELS},
                    BC6H_KERNEL: bc6h_kernel.LAUNCHES[BC6H_KERNEL],
                    "single_group_meta_rounds":
                        bc6h_kernel.LAUNCHES["single_group_meta_rounds"],
                    "combine": bc6h_kernel.LAUNCHES["combine"]}
        launched[label] = launches
        if rc != 0:
            raise SystemExit(f"the CLI {' '.join(flags)} returned {rc}")
        images = image_util.mip_chain(img) if "-mips" in flags else [img]
        payloads = container_levels(path, fmt, [(level.shape[1],
                                                 level.shape[0])
                                                for level in images])
        bad_levels = [i for i, (level, got) in enumerate(zip(images,
                                                             payloads))
                      if not np.array_equal(got, cli_bytes(
                          api, cli, label, image_util.blockify(level),
                          dev).cpu().numpy())]
        rows = np.arange(0, len(payloads[0]),
                         max(1, len(payloads[0]) // CPU_CHECK_BLOCKS))
        chunks = (api.CHUNK_BC7, api.CHUNK_BC6H)
        t0 = time.perf_counter()
        try:
            api.CHUNK_BC7 = api.CHUNK_BC6H = CPU_CHUNK
            cpu = cli_bytes(api, cli, label, image_util.blockify(img)[rows],
                            "cpu").numpy()
        finally:
            api.CHUNK_BC7, api.CHUNK_BC6H = chunks
        cpu_s = time.perf_counter() - t0
        cpu_bad = int((payloads[0][rows] != cpu).any(axis=1).sum())
        module_equal = None
        if label == CLI_RUNS[0][0]:
            with open(path, "rb") as a, open(module_out, "rb") as b:
                module_equal = a.read() == b.read()
        phase("cli", run=label, flags=flags, wall_s=wall_s,
              levels=len(payloads), file_bytes=os.path.getsize(path),
              launches=launches, api_mismatched_levels=bad_levels,
              cpu_blocks_compared=len(rows), cpu_mismatched_blocks=cpu_bad,
              cpu_seconds=cpu_s, module_file_equal=module_equal,
              said=said.getvalue().strip())
        if bad_levels or cpu_bad or module_equal is False:
            raise SystemExit(f"the CLI's {name} differs from the API's bytes "
                             f"on the card (levels {bad_levels}), from the "
                             f"CPU's ({cpu_bad} blocks) or from the module "
                             f"run's file")
    need = {"bc7": BC7_KERNELS, "bc6h": (BC6H_KERNEL,
                                         "single_group_meta_rounds",
                                         "combine")}
    for label, names in need.items():
        if not all(launched[label][k] for k in names):
            raise SystemExit(f"the CLI's {label} run did not launch every "
                             f"kernel of its path: {launched[label]}")
    return launched


def sharded_phase(api, dev, tex):
    """The `sharded` phase: encode_sharded of BC7 q50 and of ETC2
    punchthrough over three slices of one card (65,536 blocks, not a
    multiple of 3), and over every card when there is more than one, each
    byte-equal to one call."""
    import torch

    from convectionkernels_tpu_torch.parallel import sharding
    splits = [("cuda0_x3", [dev] * 3)]
    if torch.cuda.device_count() > 1:
        splits.append(("every_card", None))
    for name, encode in (
            ("bc7_q50", functools.partial(api.encode_bc7, quality=50)),
            ("etc2_punchthrough", api.encode_etc2_punchthrough)):
        t0 = time.perf_counter()
        want = encode(tex, device=dev).cpu().numpy()
        one_s = time.perf_counter() - t0
        for split, devices in splits:
            t0 = time.perf_counter()
            got = sharding.encode_sharded(encode, tex, devices)
            split_s = time.perf_counter() - t0
            bad = (int((got != want).any(axis=1).sum())
                   if got.shape == want.shape else len(want))
            phase("sharded", config=name, split=split, blocks=len(tex),
                  seconds=split_s, one_call_seconds=one_s,
                  mismatched_blocks=bad)
            if bad:
                raise SystemExit(f"encode_sharded of {name} over {split}: "
                                 f"{bad} blocks differ from one call")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_worker(backend, init_method, world, rank, image_path,
                       out_path):
    """One process of the `distributed` phase: encode_image_distributed of
    encode_bc1 on card 0, each rank's own slice and then the whole output
    gathered, saved to `out_path` (.npz)."""
    import numpy as np
    import torch

    from convectionkernels_tpu_torch import api
    from convectionkernels_tpu_torch.parallel import distributed
    torch.cuda.set_device(0)
    distributed.initialize(backend, init_method, world, rank)
    try:
        img = np.load(image_path)
        # gloo ranks name the card; the NCCL rank takes the default one
        dev = "cuda:0" if backend == "gloo" else None
        local, start, n_blocks = distributed.encode_image_distributed(
            api.encode_bc1, img, device=dev)
        full = distributed.encode_image_distributed(
            api.encode_bc1, img, device=dev, assemble=True)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(out_path, local=local, start=start, n_blocks=n_blocks,
             full=full)


def distributed_phase(api, dev, img_path, img, work):
    """The `distributed` phase: two gloo processes sharing card 0 (NCCL
    refuses two ranks on one card) and one NCCL process, all started at
    once, each encode_image_distributed of encode_bc1 on the texture, with
    and without assembly, held against one call."""
    import numpy as np

    from convectionkernels_tpu_torch.utils import image as image_util
    groups = (("gloo", f"tcp://localhost:{free_port()}", 2),
              ("nccl", f"tcp://localhost:{free_port()}", 1))
    runs = [(backend, init, world, rank,
             os.path.join(work, f"{backend}{rank}.npz"))
            for backend, init, world in groups for rank in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"distributed_worker({b!r}, {i!r}, {w}, {r}, {img_path!r}, {o!r})"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for b, i, w, r, o in runs]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for (backend, _, world, rank, _), p, out in zip(runs, procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"distributed {backend} rank {rank} of {world} "
                             f"exited {p.returncode}: {out[-2000:]}")
    want = api.encode_bc1(image_util.blockify(img), device=dev).cpu().numpy()
    for backend, _, world in groups:
        parts = []
        assembled_bad = []
        for b, _, _, rank, out_path in runs:
            if b != backend:
                continue
            with np.load(out_path) as z:
                parts.append((int(z["start"]), z["local"]))
                n_blocks = int(z["n_blocks"])
                full = z["full"]
            assembled_bad.append(
                int((full != want).any(axis=1).sum())
                if full.shape == want.shape else len(want))
        parts.sort(key=lambda part: part[0])
        local = np.concatenate([p for _, p in parts])
        local_bad = (int((local != want).any(axis=1).sum())
                     if local.shape == want.shape else len(want))
        phase("distributed", backend=backend, world=world,
              blocks=n_blocks, starts=[s for s, _ in parts],
              local_blocks=[len(p) for _, p in parts],
              local_mismatched_blocks=local_bad,
              assembled_mismatched_blocks=assembled_bad,
              seconds_all_processes=seconds)
        if n_blocks != len(want) or local_bad or any(assembled_bad):
            raise SystemExit(f"encode_image_distributed over {world} {backend} "
                             f"process(es) differs from one call")


# --- the program layer: CUDA graphs of each configuration and bucket ----------

# the kernel launches a replayed one-chunk encode must count, and must have
# been captured into its graph
GRAPH_LAUNCHES = {"bc7_q50": ("bc7_kernel", {"shape_pca": 2,
                                             "single_plane_mode_best": 6,
                                             "dual_plane_best": 1}),
                  "bc6hu": ("bc6h_kernel", {BC6H_KERNEL: 6,
                                            "single_group_meta_rounds": 4,
                                            "combine": 10})}
PROFILED_REPLAYS = ("bc7_q50", "bc6hu", "bc1", "bc3")


def captures(programs):
    """The captures of each bucket of every program the caches hold."""
    return [b.captures for p in programs.programs() for b in p.buckets.values()]


def programs_phase(api, ckt, programs, dev, encoders, goldens, tex_dev,
                   kernel_modules, profile, out_dir):
    """The `programs` phase. Every full-width configuration, whose program
    the full-width phases captured (their second call), op by op under
    programs.eager() and replayed: bytes equal, no new capture, median of 3
    CUDA-event timings and peak memory each; the kernels' launches counted
    on a replay and held by the graph; every golden through its program
    twice more (a capture where the golden phase left only the eager first
    call, then a replay), each call equal to the golden; one capture of
    bc7_q50 across 40 and 72 blocks (one bucket) and across 65,536 and
    70,000 blocks (the chunk program, run twice for 70,000). Returns the
    eager bytes of bc7_q50 and bc6hu."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase("programs_pool", programs=len(programs.programs()),
          buckets=len(captures(programs)), captured=sum(captures(programs)),
          allocated_gib=torch.cuda.memory_allocated(dev) / 2**30,
          reserved_gib=torch.cuda.memory_reserved(dev) / 2**30)
    eager_bytes = {}
    for name, encode in encoders.items():
        torch.cuda.synchronize()
        with programs.eager():
            torch.cuda.reset_peak_memory_stats(dev)
            eager_ms, eager_out = timed(encode)
            eager_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        # the op-by-op runs' cached blocks, which no graph needs
        torch.cuda.empty_cache()
        before = captures(programs)
        torch.cuda.reset_peak_memory_stats(dev)
        replay_ms, replay_out = timed(encode)
        replay_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        equal = torch.equal(eager_out, replay_out)
        new = sum(captures(programs)) - sum(before)
        e, r = statistics.median(eager_ms), statistics.median(replay_ms)
        phase("programs", config=name, eager_ms=eager_ms, replayed_ms=replay_ms,
              eager_ms_median=e, replayed_ms_median=r, eager_over_replayed=e / r,
              eager_peak_gib=eager_peak, replayed_peak_gib=replay_peak,
              reserved_gib=torch.cuda.memory_reserved(dev) / 2**30,
              new_captures=new, bytes_equal=equal)
        if not equal or new:
            raise SystemExit(f"programs: {name}'s replayed bytes differ from "
                             f"its eager bytes ({not equal}) or its replays "
                             f"captured again ({new})")
        if name in GRAPH_LAUNCHES:
            eager_bytes[name] = eager_out
        del eager_out, replay_out

    in_graphs = {}
    graph_programs = {
        "bc7_q50": api._bc7_program(ckt.Options(), ckt.plan_from_quality(50),
                                    tex_dev.device),
        "bc6hu": api._bc6h_program(ckt.Options(), False, tex_dev.device)}
    for name, (module, need) in GRAPH_LAUNCHES.items():
        counter = kernel_modules[module].LAUNCHES
        torch.cuda.synchronize()
        counter.clear()
        encoders[name]()
        torch.cuda.synchronize()
        counted = {k: counter[k] for k in need}
        (bucket,) = [b for key, b in graph_programs[name].buckets.items()
                     if key[0] == tex_dev.shape[0]]
        held = {k: n[k] for c, n in bucket.launched if c is counter
                for k in need}
        in_graphs[name] = dict(counted=counted, held_by_graph=held)
        if counted != need or held != need:
            raise SystemExit(f"programs: a replayed {name} encode counted "
                             f"{counted} launches and its graphs hold {held}, "
                             f"not {need}")
    phase("programs_kernels", launches=in_graphs)

    bad, calls = {}, 0
    for family, cases in goldens.items():
        for name, call, want in cases:
            for run in ("second", "third"):
                calls += 1
                m = mismatched(call(), want)
                if m:
                    bad[f"{family}/{name}/{run}"] = m
    most = max(captures(programs))
    phase("programs_goldens", cases=sum(len(c) for c in goldens.values()),
          calls=calls, mismatched_blocks=bad,
          programs=len(programs.programs()), buckets=len(captures(programs)),
          most_captures_of_a_bucket=most)
    if bad or most != 1:
        raise SystemExit(f"programs: goldens through captured programs differ "
                         f"({bad}) or a bucket was captured {most} times")

    program = api._bc7_program(ckt.Options(), ckt.plan_from_quality(50),
                               tex_dev.device)
    reuse = {}
    with programs.eager():
        want = api.encode_bc7(tex_dev[:72], quality=50, device=dev)
    for n in (40, 72, 40, 72):
        got = api.encode_bc7(tex_dev[:n], quality=50, device=dev)
        reuse[f"{n}_equal"] = reuse.get(f"{n}_equal", True) and \
            torch.equal(got, want[:n])
    wide = torch.cat([tex_dev, tex_dev[:70000 - tex_dev.shape[0]]])
    got = api.encode_bc7(wide, quality=50, device=dev)
    full = eager_bytes["bc7_q50"]
    reuse["70000_equal"] = torch.equal(got, torch.cat(
        [full, full[:70000 - full.shape[0]]]))
    reuse["captures"] = {str(k[0]): b.captures
                         for k, b in program.buckets.items()}
    phase("programs_reuse", **reuse)
    if not all(v for k, v in reuse.items() if k.endswith("_equal")) or \
            reuse["captures"].get("256") != 1 or \
            reuse["captures"].get(str(tex_dev.shape[0])) != 1:
        raise SystemExit(f"programs: bc7_q50 at 40, 72 and 70,000 blocks: "
                         f"{reuse}")

    if profile:
        for name in PROFILED_REPLAYS:
            prof = profile_encode(encoders[name], os.path.join(
                out_dir, f"profile_replayed_{name}.txt"))
            phase(f"profile_replayed_{name}", wall_ms=prof["wall_ms"],
                  device_busy_ms=prof["device_busy_ms"],
                  busy_share=prof["device_busy_ms"] / prof["wall_ms"],
                  device_launches=prof["device_launches"],
                  top=prof["top"][:8])
    return eager_bytes


def programs_memory_phase(programs, dev, encoders, eager_bytes):
    """The `programs_memory` phase: after release_programs(), bc7_q50 (A)
    and bc6hu (B) at the full width, each called once op by op and once
    captured (A before B, in the one shared pool), then replayed out of
    capture order (A, B, A, B, B, A), each call equal to its eager bytes;
    then release_programs() must give the pool back."""
    import torch
    programs.release_programs()
    order = ["bc7_q50", "bc6hu"] * 2 + ["bc7_q50", "bc6hu", "bc7_q50",
                                        "bc6hu", "bc6hu", "bc7_q50"]
    bad = [i for i, name in enumerate(order)
           if not torch.equal(encoders[name](), eager_bytes[name])]
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev)
    graphs = captures(programs)
    programs.release_programs()
    left = torch.cuda.memory_reserved(dev)
    phase("programs_memory", order=order, mismatched_calls=bad,
          captures=graphs, reserved_gib_with_programs=held / 2**30,
          reserved_gib_after_release=left / 2**30)
    if bad or graphs != [1, 1] or not left < held:
        raise SystemExit(f"programs_memory: calls {bad} differ from the "
                         f"eager bytes, captures {graphs}, or "
                         f"release_programs() kept the pool ({held} -> "
                         f"{left} bytes reserved)")


# --- main ----------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="",
                    help="comma-separated encode_bc7 chunk sizes to time")
    ap.add_argument("--chunks-bc6h", default="",
                    help="comma-separated encode_bc6hu chunk sizes to time")
    ap.add_argument("--chunks-s3tc", default="",
                    help="comma-separated CHUNK_S3TC sizes at which to "
                         "time encode_bc1 and encode_bc3")
    ap.add_argument("--chunks-s3tc-exhaustive", default="",
                    help="comma-separated CHUNK_S3TC_EXHAUSTIVE sizes at "
                         "which to time the exhaustive encode_bc1")
    ap.add_argument("--chunks-etc", default="",
                    help="comma-separated CHUNK_ETC sizes at which to time "
                         "encode_etc1 (default and FakeBT709)")
    ap.add_argument("--chunks-eac", default="",
                    help="comma-separated CHUNK_EAC sizes at which to time "
                         "encode_etc2_alpha and encode_eac11")
    ap.add_argument("--chunks-etc2", default="",
                    help="comma-separated CHUNK_ETC2 sizes at which to time "
                         "encode_etc2 and encode_etc2_punchthrough")
    ap.add_argument("--pca-chunks", default="",
                    help="comma-separated shape list lengths (at most 243) "
                         "at which to time shape_pca alone with each chunk")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width encode of each path "
                         "(profile_bc7.txt, profile_bc6h.txt, "
                         "profile_bc1.txt, profile_bc3.txt, "
                         "profile_bc1_exhaustive.txt, profile_etc1.txt, "
                         "profile_etc2.txt, profile_etc2_punchthrough.txt "
                         "in --out)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for chip_smoke.json (every launch's "
                         "time and work) and the profiles")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    import convectionkernels_tpu_torch as ckt
    from convectionkernels_tpu_torch import (api, cuda_lib, exact_probe,
                                             programs)
    from convectionkernels_tpu_torch.models import (bc6h, bc6h_kernel, bc7,
                                                    bc7_kernel, etc)
    from convectionkernels_tpu_torch.utils import metrics

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    os.makedirs(args.out, exist_ok=True)
    detail = {}
    testdata = os.path.join(REPO, "convectionkernels_tpu_torch", "testdata")

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

    # 2. exactness probe
    mism = exact_probe.check(dev)
    phase("exact_probe", mismatches=mism)
    if any(mism.values()):
        raise SystemExit(f"exact_probe: the card's results differ from the "
                         f"CPU's — check nvcc's flags: {mism}")

    # 3a. each BC7 kernel against its plain version, on a 256-block q50 encode
    with np.load(os.path.join(testdata, "bc7_q50_golden.npz")) as z:
        golden_px, golden_blocks = z["pixels"], z["blocks"]
    small = torch.as_tensor(golden_px, device=dev)
    opts = ckt.Options()
    plan = ckt.plan_from_quality(50)
    # twice: the first run also loads the kernels and PyTorch's own CUDA
    # code, so only the second one's times are kept
    for _ in range(2):
        with Instrument(bc7_kernel, BC7_KERNELS, with_plain=True) as small_run:
            bc7.pack(small, opts.flags, opts.channel_weights(), plan,
                     opts.refine_rounds_bc7)
            torch.cuda.synchronize()
        if not all(small_run.equal.values()):
            break
    equal = dict(small_run.equal)
    max_err = dict(small_run.max_err)
    plain_ms = {k: Instrument.total_ms(small_run.plain_events[k])
                for k in BC7_KERNELS}
    kernel_small_ms = {k: Instrument.total_ms(small_run.events[k])
                       for k in BC7_KERNELS}
    plain_blocks = {k: len(golden_px) for k in BC7_KERNELS}
    for name in BC7_KERNELS:
        phase("kernel_vs_plain", kernel=name,
              launches=len(small_run.events[name]), equal=equal[name],
              max_abs_err=max_err[name])

    # 3b. the BC6H kernel against its plain version on the blocks of the
    # stored BC6H goldens, 4 x 3 rounds
    with np.load(os.path.join(testdata, "bc6h_golden.npz")) as z:
        bc6h_golden = {k: z[k] for k in z.files}
    hdr_small = torch.as_tensor(np.concatenate(
        [v for k, v in sorted(bc6h_golden.items())
         if k.endswith("_pixels")]), device=dev)
    plain_ms[BC6H_KERNEL] = kernel_small_ms[BC6H_KERNEL] = 0.0
    plain_blocks[BC6H_KERNEL] = len(hdr_small)
    equal[BC6H_KERNEL], max_err[BC6H_KERNEL] = True, 0.0
    cols = torch.as_tensor([2 * p + s for s in range(2) for p in range(32)],
                           device=dev)
    for label, is_signed, fast, flags, aprec in (
            ("unsigned_slow_aprec10", False, False, 0, 10),
            ("signed_fast_aprec6", True, True, 0, 6),
            ("unsigned_slow_uniform_aprec8", False, False,
             ckt.Flags.UNIFORM, 8)):
        uniform = bool(flags & ckt.Flags.UNIFORM)
        cw = [float(np.float32(w))
              for w in ckt.Options(flags=flags).channel_weights()[:3]]
        pix = bc6h.prepare_pixels(hdr_small, is_signed)
        ufep_base, ufep_offset = bc6h.pca_lines(pix, cw)
        call = (pix,
                torch.stack([b[:, cols] for b in ufep_base], 1).contiguous(),
                torch.stack([o[:, cols] for o in ufep_offset],
                            1).contiguous(),
                aprec, is_signed, fast, uniform, cw, 4, 3)
        for _ in range(2):      # the second run's times are kept
            k_ms, got = timed(lambda: bc6h_kernel.
                              partitioned_group_meta_rounds(*call), 1)
            p_ms, want = timed(lambda: bc6h_kernel.
                               partitioned_group_meta_rounds_plain(*call), 1)
        same, err = compare(got, want)
        equal[BC6H_KERNEL] &= same
        max_err[BC6H_KERNEL] = max(max_err[BC6H_KERNEL], err)
        if label == "unsigned_slow_aprec10":    # the main path's variant
            plain_ms[BC6H_KERNEL] = p_ms[0]
            kernel_small_ms[BC6H_KERNEL] = k_ms[0]
        phase("kernel_vs_plain", kernel=BC6H_KERNEL, config=label,
              blocks=len(hdr_small), rounds=12, equal=same, max_abs_err=err,
              kernel_ms=k_ms[0], plain_ms=p_ms[0])
    if not all(equal.values()):
        raise SystemExit("a kernel disagrees with its plain version")

    # 4. the port's bytes against the JAX package's goldens
    goldens = golden_cases(api, ckt, testdata, dev, golden_px, golden_blocks,
                           bc6h_golden)
    for family, cases in goldens.items():
        bad_cases = {name: mismatched(call(), want)
                     for name, call, want in cases}
        n_golden = sum(len(want) for _, _, want in cases)
        if family == "q50":
            bad = bad_cases["q50"]
            phase("golden_q50", blocks=n_golden, mismatched_blocks=bad)
            if bad:
                raise SystemExit(f"{bad} of {n_golden} blocks differ from "
                                 f"the JAX package's q50 golden")
            continue
        fields = dict(blocks=n_golden)
        if family != "bc6h":
            fields["cases"] = len(bad_cases)
        phase(f"golden_{family}", **fields, mismatched_blocks=bad_cases)
        if any(bad_cases.values()):
            raise SystemExit(f"blocks differ from the JAX package's "
                             f"{family.upper()} goldens: {bad_cases}")

    # 5a. the BC7 full-width run: 65,536 blocks, q50, default options
    tex = make_texture(seed=0)
    tex_dev = torch.as_tensor(tex, device=dev)

    def encode_bc7_full():
        return api.encode_bc7(tex_dev, opts, quality=50, device=dev)

    torch.cuda.synchronize()
    bc7_kernel.LAUNCHES.clear()
    out = encode_bc7_full()
    torch.cuda.synchronize()
    launches = {k: bc7_kernel.LAUNCHES[k] for k in BC7_KERNELS}
    if out.shape != (tex.shape[0], 16) or out.dtype != torch.uint8:
        raise SystemExit(f"encode_bc7 returned {tuple(out.shape)} "
                         f"{out.dtype}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")
    times, again = timed(encode_bc7_full)
    if not torch.equal(again, out):
        raise SystemExit("encode_bc7 is not deterministic")
    ms = statistics.median(times)
    decoded = api.decode_bc7(out, device="cpu").numpy()
    quality_db = metrics.psnr(tex, decoded)
    if not np.isfinite(quality_db) or quality_db < 30.0:
        raise SystemExit(f"round-trip PSNR {quality_db:.2f} dB is too low")
    texels = tex.shape[0] * 16
    phase("full_width", blocks=tex.shape[0], chunk=api.CHUNK_BC7,
          encode_ms=times, encode_ms_median=ms,
          mtexels_per_s=texels / (ms * 1e-3) / 1e6, psnr_db=quality_db,
          launches=launches)

    # per-kernel device time at the full-width shapes (one more encode, op
    # by op: a replayed graph calls no wrapper), after one op-by-op encode
    # that refills the allocator's cache, which the capture emptied: a
    # cudaMalloc of a launch's outputs would fall inside its events
    with programs.eager():
        encode_bc7_full()
    with programs.eager(), Instrument(bc7_kernel, BC7_KERNELS,
                                      with_plain=False,
                                      capture=ALONE_KERNELS) as full_run:
        encode_bc7_full()
        torch.cuda.synchronize()
    detail["full_width_launches"] = full_run.detail_ms()
    by_mode = {d["mode"]: d["ms"] for d in detail["full_width_launches"]
               if d["kernel"] == "single_plane_mode_best"}
    pca_by_nch = {d["nch"]: d for d in detail["full_width_launches"]
                  if d["kernel"] == "shape_pca"}

    # the redesigned kernels alone: back-to-back launches on each launch's
    # full-width inputs, without the encode's host work between them
    alone = {}
    for name in ALONE_KERNELS:
        fn = getattr(bc7_kernel, name)
        alone[name] = [time_alone(fn, a) for a in full_run.captured[name]]
    alone_by_mode = {a[0]: ms for a, ms in zip(
        full_run.captured["single_plane_mode_best"],
        alone["single_plane_mode_best"])}
    pca_alone_by_nch = {a[2]: ms for a, ms in zip(
        full_run.captured["shape_pca"], alone["shape_pca"])}
    efficiency = single_plane_slot_efficiency(
        full_run.captured["single_plane_mode_best"])
    if args.pca_chunks:
        pix, _, _, cw, uniform, _ = full_run.captured["shape_pca"][0]
        sweep = pca_chunk_sweep(pix, cw, uniform,
                                [int(s) for s in args.pca_chunks.split(",")])
        phase("shape_pca_chunks", blocks=pix.shape[0], ms=sweep)
        detail["shape_pca_chunks"] = sweep
    del full_run.captured
    phase("kernels_alone", launches_each=ALONE_LAUNCHES,
          single_plane_ms_by_mode=alone_by_mode,
          single_plane_slot_efficiency=efficiency,
          single_plane_ms_by_mode_in_encode=by_mode,
          shape_pca_ms_by_nch=pca_alone_by_nch,
          shape_pca_ms_by_nch_in_encode={k: d["ms"]
                                         for k, d in pca_by_nch.items()},
          shape_pca_bound_ms_by_nch={k: d["bound_ms"]
                                     for k, d in pca_by_nch.items()},
          **{f"{k}_ms": sum(v) for k, v in alone.items()})
    detail["kernels_alone"] = alone

    # each kernel launched at the full width against its plain version on
    # the same inputs, for 1,024 blocks spread over the texture
    with programs.eager(), Instrument(bc7_kernel, BC7_KERNELS,
                                      with_plain=True,
                                      plain_stride=tex.shape[0] // 1024) \
            as wide:
        encode_bc7_full()
        torch.cuda.synchronize()
    detail["small_launches"] = small_run.detail_ms()
    del out, again

    # 5b. the BC6H full-width run: 65,536 blocks, unsigned, default options
    hdr = make_hdr_texture()
    hdr_dev = torch.as_tensor(hdr, device=dev)

    def encode_bc6h_full():
        return api.encode_bc6hu(hdr_dev, opts, device=dev)

    n_chunks = -(-hdr.shape[0] // api.CHUNK_BC6H)
    torch.cuda.synchronize()
    bc6h_kernel.LAUNCHES.clear()
    out = encode_bc6h_full()
    torch.cuda.synchronize()
    launches[BC6H_KERNEL] = bc6h_kernel.LAUNCHES[BC6H_KERNEL]
    if out.shape != (hdr.shape[0], 16) or out.dtype != torch.uint8:
        raise SystemExit(f"encode_bc6hu returned {tuple(out.shape)} "
                         f"{out.dtype}")
    if launches[BC6H_KERNEL] != 6 * n_chunks or \
            bc6h_kernel.LAUNCHES["single_group_meta_rounds"] \
            != 4 * n_chunks or \
            bc6h_kernel.LAUNCHES["combine"] != 10 * n_chunks:
        raise SystemExit(f"encode_bc6hu launched its kernels "
                         f"{dict(bc6h_kernel.LAUNCHES)} times, not 6, 4 and "
                         f"10 for each of its {n_chunks} chunks")
    torch.cuda.reset_peak_memory_stats(dev)
    times, again = timed(encode_bc6h_full)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not torch.equal(again, out):
        raise SystemExit("encode_bc6hu is not deterministic")
    ms = statistics.median(times)
    decoded = api.decode_bc6hu(out, device="cpu").numpy()
    if not (decoded[..., 3] == 0x3C00).all():
        raise SystemExit("decode_bc6hu: alpha is not 1.0")
    src = hdr.view(np.float16)[..., :3].astype(np.float64)
    back = decoded.view(np.float16)[..., :3].astype(np.float64)
    rmse = metrics.rmse(src, back)
    # the input is noise, which no 4x4 block format keeps: the bound only
    # says that the blocks decode to the texture they were made from
    if not np.isfinite(back).all() or not rmse < 0.8 * float(src.std()):
        raise SystemExit(f"BC6H round trip: RMSE {rmse} against a source "
                         f"spread of {src.std()}")
    with programs.eager():
        encode_bc6h_full()      # refills the allocator's cache, as for BC7
    with programs.eager(), Instrument(bc6h_kernel, (BC6H_KERNEL,),
                                      with_plain=False) as full_bc6h:
        encode_bc6h_full()
        torch.cuda.synchronize()
    per_group = {}
    for d in full_bc6h.detail_ms():
        per_group[d["aprec"]] = per_group.get(d["aprec"], 0.0) + d["ms"]
    kernel_ms = Instrument.total_ms(full_bc6h.events[BC6H_KERNEL])
    phase("full_width_bc6h", blocks=hdr.shape[0], chunk=api.CHUNK_BC6H,
          encode_ms=times, encode_ms_median=ms,
          mtexels_per_s=hdr.shape[0] * 16 / (ms * 1e-3) / 1e6,
          rmse=rmse, source_std=float(src.std()), peak_gib=peak_gib,
          launches=launches[BC6H_KERNEL], kernel_ms=kernel_ms,
          kernel_ms_per_launch=kernel_ms / launches[BC6H_KERNEL],
          kernel_ms_by_aprec=per_group)
    with programs.eager(), Instrument(bc6h_kernel, (BC6H_KERNEL,),
                                      with_plain=True,
                                      plain_stride=hdr.shape[0] // 1024) \
            as wide_bc6h:
        encode_bc6h_full()
        torch.cuda.synchronize()
    detail["full_width_bc6h_launches"] = full_bc6h.detail
    combine_rows = bc6h_combine_phase(bc6h_kernel, programs,
                                      encode_bc6h_full)
    detail["bc6h_combine"] = combine_rows
    phase("bc6h_combine", launches=combine_rows, ptxas={
        k: v for k, v in usage.items()
        if k.startswith("bc6h_combine_kernel")})
    if not all(r["equal"] for r in combine_rows):
        raise SystemExit("the BC6H combine disagrees with its plain version "
                         "at the full width")
    single_rows = bc6h_single_phase(bc6h_kernel, programs, encode_bc6h_full)
    detail["bc6h_single"] = single_rows
    phase("bc6h_single", launches=single_rows, ptxas={
        k: v for k, v in usage.items()
        if k.startswith(("bc6h_single_kernel", "bc6h_group_kernel"))})
    if len(single_rows) != 4 * n_chunks or \
            not all(r["equal"] for r in single_rows):
        raise SystemExit("the BC6H single-mode chain kernel disagrees with "
                         "its plain version at the full width, or did not "
                         "launch 4 times a chunk")
    del out, again

    # 5c. the S3TC full-width runs: 65,536 blocks each, default options
    eac_u, eac_s, signed, random_alpha = bench_rng44_draws(tex.shape[0])
    signed_dev = torch.as_tensor(signed, device=dev)
    rows = torch.arange(0, tex.shape[0], tex.shape[0] // CPU_CHECK_BLOCKS,
                        device=dev)
    s3tc_encoders = {}
    detail["full_width_s3tc"] = {}
    for name, entry, extra_flags, source in S3TC_CONFIGS:
        blocks = tex_dev if source == "texture" else signed_dev
        s3tc_opts = ckt.Options(flags=opts.flags | extra_flags)

        def encode_s3tc(_fn=getattr(api, entry), _blocks=blocks,
                        _opts=s3tc_opts):
            return _fn(_blocks, _opts, device=dev)

        s3tc_encoders[name] = encode_s3tc
        out = encode_s3tc()
        torch.cuda.synchronize()
        width = 16 if entry in ("encode_bc2", "encode_bc3", "encode_bc5u",
                                "encode_bc5s") else 8
        if out.shape != (blocks.shape[0], width) or out.dtype != torch.uint8:
            raise SystemExit(f"{name} returned {tuple(out.shape)} "
                             f"{out.dtype}")
        torch.cuda.reset_peak_memory_stats(dev)
        times, again = timed(encode_s3tc)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        if not torch.equal(again, out):
            raise SystemExit(f"{name} is not deterministic")
        t0 = time.perf_counter()
        cpu = getattr(api, entry)(blocks.index_select(0, rows).cpu(),
                                  s3tc_opts, device="cpu")
        cpu_s = time.perf_counter() - t0
        bad = int((out.index_select(0, rows).cpu() != cpu).any(dim=1).sum())
        ms = statistics.median(times)
        result = dict(
            config=name, blocks=blocks.shape[0],
            chunk=(api.CHUNK_S3TC_EXHAUSTIVE if extra_flags
                   else api.CHUNK_S3TC),
            encode_ms=times, encode_ms_median=ms,
            mtexels_per_s=blocks.shape[0] * 16 / (ms * 1e-3) / 1e6,
            peak_gib=peak_gib, cpu_blocks_compared=len(rows),
            cpu_mismatched_blocks=bad, cpu_seconds=cpu_s)
        phase("full_width_s3tc", **result)
        detail["full_width_s3tc"][name] = result
        if bad:
            raise SystemExit(f"{name}: {bad} of {len(rows)} blocks encoded "
                             f"on the card differ from the CPU's")
        del out, again

    # 5d. the ETC full-width runs: 65,536 blocks each, default options
    inputs = {"texture": tex_dev,
              "eac_unsigned": torch.as_tensor(eac_u, device=dev),
              "eac_signed": torch.as_tensor(eac_s, device=dev),
              "texture_random_alpha": torch.as_tensor(
                  with_alpha(tex, random_alpha), device=dev)}
    etc_encoders = {}
    detail["full_width_etc"] = {}
    for name, entry, extra_flags, source in ETC_CONFIGS:
        blocks = inputs[source]
        etc_opts = ckt.Options(flags=opts.flags | extra_flags)
        encode_etc = etc_encoder(api, entry, blocks, etc_opts, dev,
                                 signed=source == "eac_signed")
        etc_encoders[name] = encode_etc
        out = encode_etc()
        torch.cuda.synchronize()
        width = 16 if entry == "encode_etc2_rgba" else 8
        if out.shape != (blocks.shape[0], width) or out.dtype != torch.uint8:
            raise SystemExit(f"{name} returned {tuple(out.shape)} "
                             f"{out.dtype}")
        torch.cuda.reset_peak_memory_stats(dev)
        times, again = timed(encode_etc)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        if not torch.equal(again, out):
            raise SystemExit(f"{name} is not deterministic")
        t0 = time.perf_counter()
        cpu = etc_encoder(api, entry, blocks.index_select(0, rows).cpu(),
                          etc_opts, "cpu", signed=source == "eac_signed")()
        cpu_s = time.perf_counter() - t0
        bad = int((out.index_select(0, rows).cpu() != cpu).any(dim=1).sum())
        ms = statistics.median(times)
        result = dict(
            config=name, blocks=blocks.shape[0],
            chunk=getattr(api, etc_chunk_attr(entry)),
            encode_ms=times, encode_ms_median=ms,
            mtexels_per_s=blocks.shape[0] * 16 / (ms * 1e-3) / 1e6,
            peak_gib=peak_gib, cpu_blocks_compared=len(rows),
            cpu_mismatched_blocks=bad, cpu_seconds=cpu_s)
        if entry == "encode_etc2_punchthrough":
            # the share of blocks the split sends to the punchthrough stages
            thr = etc.punchthrough_threshold(etc_opts.threshold)
            result["transparent_block_share"] = float(
                (blocks[:, :, 3].to(torch.int32) < thr).any(dim=1).float()
                .mean())
        phase("full_width_etc", **result)
        detail["full_width_etc"][name] = result
        if bad:
            raise SystemExit(f"{name}: {bad} of {len(rows)} blocks encoded "
                             f"on the card differ from the CPU's")
        del out, again

    full = {**{k: full_run for k in BC7_KERNELS}, BC6H_KERNEL: full_bc6h}
    wides = {**{k: wide for k in BC7_KERNELS}, BC6H_KERNEL: wide_bc6h}
    for name in KERNELS:
        w = wides[name]
        phase("kernel_vs_plain_full_width", kernel=name,
              launches=len(w.events[name]),
              blocks_compared=w.blocks_compared[name], equal=w.equal[name],
              max_abs_err=w.max_err[name])
        equal[name] &= w.equal[name]
        max_err[name] = max(max_err[name], w.max_err[name])
    if not all(equal.values()):
        raise SystemExit("a kernel disagrees with its plain version at the "
                         "full width")

    # 6b. the program layer: eager against replayed at the full width, the
    # goldens through captured programs, reuse of a bucket
    encoders = {"bc7_q50": encode_bc7_full, "bc6hu": encode_bc6h_full,
                **s3tc_encoders, **etc_encoders}
    eager_bytes = programs_phase(
        api, ckt, programs, dev, encoders, goldens, tex_dev,
        {"bc7_kernel": bc7_kernel, "bc6h_kernel": bc6h_kernel}, args.profile,
        args.out)

    # 7-9. the CLI on the BC7 cell's texture saved as .npy, the block axis
    # split over three slices of the card, and over processes
    from convectionkernels_tpu_torch.utils import image as image_util
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        img = image_util.unblockify(tex, 1024, 1024)
        img_path = os.path.join(work, "texture.npy")
        np.save(img_path, img)
        cli_launched = cli_phase(api, dev, img_path, img, work)
        sharded_phase(api, dev, tex)
        distributed_phase(api, dev, img_path, img, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if args.profile:
        for label, encode in (("bc7", encode_bc7_full),
                              ("bc6h", encode_bc6h_full),
                              *((k, s3tc_encoders[k]) for k in S3TC_PROFILED),
                              *((k, etc_encoders[k]) for k in ETC_PROFILED)):
            with programs.eager():
                prof = profile_encode(encode, os.path.join(
                    args.out, f"profile_{label}.txt"))
            detail[f"profile_{label}"] = prof
            phase(f"profile_{label}", wall_ms=prof["wall_ms"],
                  device_busy_ms=prof["device_busy_ms"],
                  device_launches=prof["device_launches"],
                  top=prof["top"][:8])

    # optional chunk sweeps
    if args.chunks:
        sweep = chunk_sweep(api, "CHUNK_BC7",
                            [int(c) for c in args.chunks.split(",")],
                            encode_bc7_full, dev)
        phase("chunk_sweep", results=sweep)
        detail["chunk_sweep"] = sweep
    if args.chunks_bc6h:
        sweep = chunk_sweep(api, "CHUNK_BC6H",
                            [int(c) for c in args.chunks_bc6h.split(",")],
                            encode_bc6h_full, dev)
        phase("chunk_sweep_bc6h", results=sweep)
        detail["chunk_sweep_bc6h"] = sweep
    for attr, option, phase_name, names in (
            ("CHUNK_S3TC", args.chunks_s3tc, "chunk_sweep_s3tc",
             ("bc1", "bc3")),
            ("CHUNK_S3TC_EXHAUSTIVE", args.chunks_s3tc_exhaustive,
             "chunk_sweep_s3tc", ("bc1_exhaustive",)),
            ("CHUNK_ETC", args.chunks_etc, "chunk_sweep_etc",
             ("etc1", "etc1_fake709")),
            ("CHUNK_EAC", args.chunks_eac, "chunk_sweep_etc",
             ("etc2_alpha", "eac_r11")),
            ("CHUNK_ETC2", args.chunks_etc2, "chunk_sweep_etc",
             ("etc2", "etc2_punchthrough"))):
        for name in names if option else ():
            sweep = chunk_sweep(api, attr,
                                [int(c) for c in option.split(",")],
                                encoders[name], dev)
            phase(phase_name, config=name, results=sweep)
            detail[f"chunk_sweep_{name}"] = sweep

    # the two kernels' programs replayed out of capture order, and the pool
    # given back
    programs_memory_phase(programs, dev, encoders, eager_bytes)

    # 6. the kernels line, the card, and the result
    kernels = []
    for name, meta in KERNELS.items():
        nbytes, ops = full[name].work[name]
        bound, bound_by = bound_ms(nbytes, ops)
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max_err[name],
            ms=Instrument.total_ms(full[name].events[name]),
            plain_ms=plain_ms[name],
            bound_ms=bound, bound_by=bound_by,
            library_ms=None,
            cli_launches={k: v[name] for k, v in cli_launched.items()},
            ms_alone=sum(alone[name]) if name in alone else None,
            equal=equal[name],
            plain_blocks=plain_blocks[name],
            ms_at_plain_blocks=kernel_small_ms[name],
            bytes=nbytes, ops=ops))
    detail["kernels"] = kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    detail["card"] = smi
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"ptxas_redesigned": {
        k: v for k, v in usage.items()
        if k.startswith(("shape_pca_kernel", "single_plane_kernel",
                         "dual_plane_kernel"))}}),
        flush=True)
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
