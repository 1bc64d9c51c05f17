"""BC6H HDR encoder.

Batched reimplementation of the reference's BC6HComputer
(ConvectionKernels_BC67.cpp:2447-3051): partitions and subsets are tensor
axes; the meta-round chain (tweak x refine, BC67.cpp:2794-2911) stays
sequential because the endpoint dedup couples rounds in visitation order;
the meta0 x meta1 x mode legality cross-product (BC67.cpp:2914-2986) is
reduced to its least (error, visitation rank) candidate.

Every precision group runs its chain in a CUDA kernel of
models/bc6h_kernel.py (its plain version on the CPU), chosen by the group's
shape: the six partitioned groups (64 rows, 8 index values) in one, the
four single-mode groups (one row, 16 index values) in another. Every
group's combine is the third kernel there. The rest runs as PyTorch ops on
the tensors' device: pixel preparation, the PCA over the 65 pixel sets and
the bit packing.

All float math follows the scalar reference build (ops/lanes.py); HDR
values use the internal two's-complement half representation (2CL) with
the scalar build's magnitude-only linearization.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib, programs
from ..ops import lanes, pca
from ..ops.lanes import F32, I32, LexBest
from ..options import Flags
from ..programs import i32, lut
from ..tables import bc6h_layout
from ..tables import bc7_geometry as geom
from . import bc6h_common, bc6h_kernel
from .bc6h_common import HDR_MODES, MAX_REFINE_ROUNDS
from .bc6h_kernel import MAX_META

_FIELDS = ("m", "d", "rw", "rx", "ry", "rz", "gw", "gx", "gy", "gz",
           "bw", "bx", "by", "bz")


def precision_groups():
    """(partitioned, aPrec, mode indexes) in visitation order: single modes
    first, aPrec descending (BC67.cpp:2776-2784)."""
    groups = []
    for partitioned in (False, True):
        precs = sorted({m[3] for m in HDR_MODES if m[1] == partitioned},
                       reverse=True)
        for aprec in precs:
            groups.append((partitioned, aprec, [
                i for i, m in enumerate(HDR_MODES)
                if m[1] == partitioned and m[3] == aprec]))
    return groups


def prepare_pixels(pixels_f16bits, is_signed: bool):
    """int16 half bits [N, 16, 4] -> [N, 48] int32 clamped 2CL pixels
    (px*3 + ch; sign+magnitude -> 2CL, BC67.cpp:2691-2715)."""
    v = pixels_f16bits[:, :, :3].to(I32)
    if is_signed:
        v = torch.where(v < 0, -(v & 32767), v)
        v = torch.clamp_min(v, -31743)
    else:
        v = torch.clamp_min(v, 0)
    return torch.clamp_max(v, 31743).reshape(v.shape[0], 48).contiguous()


def pca_lines(pix, cw):
    """The PCA line of each of the 65 pixel sets (32 partitions x 2
    subsets, then the whole block; BC67.cpp:2736-2774): base and offset,
    each a list of 3 float32 [N, 65] tensors."""
    dev = pix.device
    masks = np.zeros((65, 16), dtype=bool)
    for part in range(32):
        bits = int(geom.PARTITION_MAP_2[part])
        for px in range(16):
            masks[part * 2 + ((bits >> px) & 1), px] = True
    masks[64, :] = True
    member = [programs.constant(masks[:, px][None, :], dev)
              for px in range(16)]
    weights = [m.to(F32) for m in member]
    pw = [[lanes.to_float(pix[:, px * 3 + ch]).unsqueeze(1) * cw[ch]
           for ch in range(3)] for px in range(16)]
    cen, dirn, mn_d, mx_d = pca.endpoint_selector(pw, weights, 3,
                                                  member_mask=member)
    return pca.get_endpoints(cen, dirn, mn_d, mx_d, cw, 3)


def pack(pixels_f16bits, flags: int, channel_weights, is_signed: bool,
         num_tweak_rounds: int, num_refine_rounds: int):
    """BC6HComputer::Pack (BC67.cpp:2665-3051): int16 half bits [N, 16, 4]
    (alpha ignored) on any device -> uint8 [N, 16] on that device."""
    num_tweak_rounds, num_refine_rounds = bc6h_common.clamp_rounds(
        num_tweak_rounds, num_refine_rounds)
    fast_indexing = bool(flags & Flags.BC6H_FAST_INDEXING)
    uniform = bool(flags & Flags.UNIFORM)
    cw = [float(np.float32(w)) for w in channel_weights[:3]]

    pix = prepare_pixels(pixels_f16bits, is_signed)
    n, dev = pix.shape[0], pix.device
    if dev.type == "cuda":
        cuda_lib.build_all(bc6h_kernel.LIBRARIES)   # the nvcc runs at once
    ufep_base, ufep_offset = pca_lines(pix, cw)
    # the whole block's line (column 64), [N, 3], for the single-mode groups
    block_base = torch.stack([b[:, 64] for b in ufep_base], dim=1)
    block_offset = torch.stack([o[:, 64] for o in ufep_offset], dim=1)

    best = LexBest.empty((n,), {
        "mode": (), "partition": (),
        "ep": (2, 2, 3),     # [subset][epi][ch] encoded values
        "idx": (16,),
    }, dev)
    # meta round ids of the rounds that run, in visitation order
    meta_ids = [t * MAX_REFINE_ROUNDS + r for t in range(num_tweak_rounds)
                for r in range(num_refine_rounds)]

    rank_base = 0
    for partitioned, aprec, mode_list in precision_groups():
        num_parts = 32 if partitioned else 1
        if partitioned:
            # rows are subset-major (q = s*32 + p): columns 2p, then 2p+1
            cols = programs.constant(
                [2 * p + s for s in range(2) for p in range(32)], dev)
            base = torch.stack([b[:, cols] for b in ufep_base], dim=1)
            offset = torch.stack([o[:, cols] for o in ufep_offset], dim=1)
            err, valid, eps, idx = bc6h_kernel.partitioned_group_meta_rounds(
                pix, base.contiguous(), offset.contiguous(), aprec,
                is_signed, fast_indexing, uniform, cw, num_tweak_rounds,
                num_refine_rounds)
            del base, offset
        else:
            err, valid, eps, idx = bc6h_kernel.single_group_meta_rounds(
                pix, block_base, block_offset, aprec, is_signed,
                fast_indexing, uniform, cw, num_tweak_rounds,
                num_refine_rounds)
        win_err, win_rank, payload = bc6h_kernel.combine(
            err, valid, eps, idx, aprec, mode_list, meta_ids, rank_base)
        del err, valid, eps, idx
        best.update(win_err, win_rank, payload,
                    extra_valid=torch.isfinite(win_err))
        rank_base += num_parts * MAX_META * MAX_META

    return _pack_bits(best, n)


def _layout_tables():
    """bc6h_layout.LAYOUTS as [14, E] int arrays (field, src, dst, length),
    rows padded with zero-length runs."""
    width = max(len(v) for v in bc6h_layout.LAYOUTS.values())
    table = np.zeros((4, len(HDR_MODES), width), dtype=np.int32)
    for mode_idx in range(len(HDR_MODES)):
        for e, (field, src, dst, length) in enumerate(
                bc6h_layout.LAYOUTS[mode_idx]):
            table[:, mode_idx, e] = (_FIELDS.index(field), src, dst, length)
    return table


_LAYOUT = _layout_tables()


def _scatter_bits(values, offsets, widths):
    """OR `values` [N, E] (each `widths` bits wide, non-negative) into 4
    int32 words [N, 4] at the bit positions `offsets` [N, E] of a 128-bit
    block. The runs do not overlap, so the sum over E is their OR."""
    words = []
    for j in range(4):
        sh = offsets - 32 * j
        lo = torch.where((sh >= 0) & (sh < 32), values << sh.clamp(0, 31), 0)
        hi = torch.where((sh < 0) & (sh > -widths),
                         values >> (-sh).clamp(0, 31), 0)
        words.append((lo | hi).sum(dim=1).to(I32))
    return torch.stack(words, dim=1)


def _pack_bits(best, n):
    """Final bit packing (BC67.cpp:2992-3050): the mode's header through
    the layout table, then the 63 or 64 index bits."""
    mode = best.payload["mode"]
    partition = best.payload["partition"]
    eps = best.payload["ep"]                                # [N,2,2,3]
    indexes = best.payload["idx"]                           # [N,16]
    dev = mode.device
    mode_l = mode.long()

    mode_ids = i32([m[0] for m in HDR_MODES], dev)[mode_l]
    # fields in _FIELDS order: m, d, then per channel w, x, y, z =
    # (subset 0 ep 0), (subset 0 ep 1), (subset 1 ep 0), (subset 1 ep 1)
    fields = torch.cat([mode_ids[:, None], partition[:, None],
                        eps.permute(0, 3, 1, 2).reshape(n, 12)], dim=1)
    fld, src, dst, length = (programs.constant(_LAYOUT[k], dev)[mode_l]
                             for k in range(4))             # [N,E]
    chunk = ((fields.gather(1, fld.long()) >> src)
             & ((torch.ones_like(length) << length) - 1))
    words = _scatter_bits(chunk, dst, length)

    partitioned = programs.constant([m[1] for m in HDR_MODES],
                                    dev)[mode_l]
    header_bits = torch.where(partitioned, bc6h_layout.HEADER_BITS_PARTITIONED,
                              bc6h_layout.HEADER_BITS_SINGLE).to(I32)[:, None]
    index_bits = torch.where(partitioned, 3, 4).to(I32)[:, None]
    fix1 = torch.where(partitioned, lut(geom.FIXUP_INDEXES_2, partition),
                       0).to(I32)[:, None]
    # pixel 0 and the second subset's fixup pixel store one bit less
    px = torch.arange(16, dtype=I32, device=dev)[None, :]
    offsets = (header_bits + index_bits * px - (px >= 1).to(I32)
               - ((fix1 >= 1) & (fix1 < px)).to(I32))
    words = words | _scatter_bits(indexes, offsets,
                                  index_bits.expand(n, 16))

    shifts = torch.arange(0, 32, 8, dtype=I32, device=dev)
    return ((words[:, :, None] >> shifts) & 0xFF).reshape(n, 16).to(
        torch.uint8)
