"""The kernels' work model, frozen: bytes each launch must move and
operations it must do, and the least time the card could take.

chip_smoke.py:141-148 (the peaks) and :176-347 (the work of each kernel
from its launch arguments, bound_ms, WORK) at commit 9895176, unchanged
but for work_dual_plane taking dual_plane_order from the frozen reference
(reference/models/bc7_kernel.py) instead of the program, and without
single_plane_slot_efficiency (:271-283), which nothing here reads. The
arguments it reads are those the frozen reference's own stages pass to
its kernel functions (Recorder, below), never the program's launches: a
change to the program's launches leaves this yardstick where it is.

Peaks of one NVIDIA H100 SXM at its 700 W power limit: 3.35 TB/s of HBM3
(data sheet) and 33.45e12 lane operations a second (the FMA-free issue
rate: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz boost; the kernels are
built with -fmad=false and every add and multiply counts as one).
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# The most lane operations the card can issue: each of an SM's 4 schedulers
# issues one 32-lane warp instruction a clock, 132 SMs x 4 x 32 x 1.98 GHz
# = 33.45e12 a second. The kernels are built with -fmad=false and the work
# model counts every add and every multiply as one operation, so this, not
# the data sheet's 67e12 float32 rate (which counts an FMA as two), is the
# rate the operations bound is taken at.
H100_ISSUE_LANE_OPS_PER_S = 132 * 4 * 32 * 1.98e9

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


def work_dual_plane(args):
    """csrc/dual_plane.cu: the live lanes, and each distinct rotation's
    pixels, PCA line and alpha range once per block, as the lanes of one
    rotation share them (bc7_kernel.dual_plane_order, the kernel's own
    work order, counts both)."""
    from reference.models import bc7_kernel
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


class Recorder:
    """Inside `with Recorder() as r:`, every call of the frozen reference's
    kernel functions adds its work to r.work[kernel] = [bytes, ops]."""

    def __init__(self):
        self.work = {k: [0, 0] for k in WORK}
        self._saved = []

    def __enter__(self):
        from reference.models import bc6h_kernel, bc7_kernel
        for module in (bc7_kernel, bc6h_kernel):
            for name in WORK:
                fn = getattr(module, name, None)
                if fn is None:
                    continue
                self._saved.append((module, name, fn))

                def wrapper(*args, _name=name, _fn=fn):
                    nbytes, ops = WORK[_name](args)
                    self.work[_name][0] += nbytes
                    self.work[_name][1] += ops
                    return _fn(*args)

                setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self._saved.clear()
        return False
