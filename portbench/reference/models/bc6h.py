# Frozen copy of convectionkernels_tpu_torch/models/bc6h.py:1-341 at commit
# 9895176, the benchmark's plain reference: never edited to follow the
# program. Unchanged but for this header.
"""BC6H HDR encoder.

Batched reimplementation of the reference's BC6HComputer
(ConvectionKernels_BC67.cpp:2447-3051): partitions and subsets are tensor
axes; the meta-round chain (tweak x refine, BC67.cpp:2794-2911) stays
sequential because the endpoint dedup couples rounds in visitation order;
the meta0 x meta1 x mode legality cross-product (BC67.cpp:2914-2986) is a
candidate grid resolved by a lexicographic (error, visitation-rank) minimum.

The six partitioned precision groups run their chain in the CUDA kernel of
models/bc6h_kernel.py (its plain version on the CPU); the four single-mode
groups (one row, 16 index values) run the same chain as tensor code. The
rest runs as PyTorch ops on the tensors' device: pixel preparation, the PCA
over the 65 pixel sets, the combine and the bit packing.

All float math follows the scalar reference build (ops/lanes.py); HDR
values use the internal two's-complement half representation (2CL) with
the scalar build's magnitude-only linearization.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import programs
from ..ops import lanes, pca
from ..options import Flags
from ..tables import bc6h_layout
from ..tables import bc7_geometry as geom
from . import bc6h_common, bc6h_kernel
from .bc6h_common import HDR_MODES, MAX_REFINE_ROUNDS, MAX_TWEAK_ROUNDS
from .bc7 import INF, LexBest, _i32, _lut

I32, F32 = torch.int32, torch.float32
MAX_META = MAX_TWEAK_ROUNDS * MAX_REFINE_ROUNDS

_FIELDS = ("m", "d", "rw", "rx", "ry", "rz", "gw", "gx", "gy", "gz",
           "bw", "bx", "by", "bz")


def _truncate_signed(v, precision):
    """Scalar TruncateToPrecisionSigned (ParallelMath.h:1410-1414);
    `precision` is an int or an int32 tensor broadcastable against v."""
    shift = 32 - precision
    return (v << shift) >> shift


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
    ufep_base, ufep_offset = pca_lines(pix, cw)

    best = LexBest.empty((n,), {
        "mode": (), "partition": (),
        "ep": (2, 2, 3),     # [subset][epi][ch] encoded values
        "idx": (16,),
    }, dev)
    # meta round ids of the rounds that run, in visitation order
    meta_ids = [t * MAX_REFINE_ROUNDS + r for t in range(num_tweak_rounds)
                for r in range(num_refine_rounds)]
    rows = torch.arange(n, device=dev)

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
            err, valid, eps, idx = bc6h_common.meta_round_chain(
                pix, [b[:, 64:65] for b in ufep_base],
                [o[:, 64:65] for o in ufep_offset], aprec, is_signed,
                fast_indexing, uniform, cw, num_tweak_rounds,
                num_refine_rounds, 16,
                torch.ones((1, 16), dtype=torch.bool, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev))
        win_err, win_rank, payload = _combine(
            err, valid != 0, eps, idx, partitioned, aprec, mode_list,
            meta_ids, rank_base, rows)
        del err, valid, eps, idx
        best.update(win_err, win_rank, payload,
                    extra_valid=torch.isfinite(win_err))
        rank_base += num_parts * MAX_META * MAX_META

    return _pack_bits(best, n)


def _combine(err, valid, eps, idx, partitioned, aprec, mode_list, meta_ids,
             rank_base, rows):
    """meta0 x meta1 x first-legal-mode of one group (BC67.cpp:2914-2986).

    err, valid [N, M, Q], eps [N, M, 6, Q] and idx ([N, M, 2, Q] packed for
    a partitioned group, [N, M, 16, 1] for a single one) are the chain's
    outputs over the M rounds `meta_ids`. The (partition, meta0, meta1)
    grid is reduced to its least (error, visitation rank) candidate among
    the valid pairs some mode of the group can encode; the winner's mode,
    encoded endpoints and indexes are then worked out on [N].

    Returns (error [N], rank [N], payload dict for LexBest).
    """
    n, m_count = err.shape[:2]
    dev = err.device
    num_parts = 32 if partitioned else 1
    m1_count = m_count if partitioned else 1
    # subset 0 along meta0 (axis 1), subset 1 along meta1 (axis 2)
    ep0 = eps[:, :, :, :num_parts].unsqueeze(2)             # [N,M,1,6,P]
    if partitioned:
        ep1 = eps[:, :, :, num_parts:].unsqueeze(1)         # [N,1,M,6,P]
        totals = (err[:, :, None, :num_parts]
                  + err[:, None, :, num_parts:])            # [N,M0,M1,P]
        valid_pair = (valid[:, :, None, :num_parts]
                      & valid[:, None, :, num_parts:])
    else:
        totals = err[:, :, None, :]
        valid_pair = valid[:, :, None, :]

    # Delta legality of a transformed mode, one bit test per delta:
    # delta = TruncateToPrecisionSigned(v - ep00, b) reconstructs v under
    # the aPrec mask exactly when bits b..aPrec-1 of (v - ep00 + 2^(b-1))
    # are zero (EvaluatePartitioned/SingleLegality, BC67.cpp:2597-2663).
    ep00 = ep0[:, :, :, 0:3]
    deltas = [ep0[:, :, :, 3:6] - ep00]
    if partitioned:
        deltas += [ep1[:, :, :, 0:3] - ep00, ep1[:, :, :, 3:6] - ep00]
    any_legal = None
    for mode_idx in mode_list:
        _, _, transformed, _, bprec = HDR_MODES[mode_idx]
        if not transformed:
            any_legal = None
            break
        half = _i32([1 << (b - 1) for b in bprec], dev).view(3, 1)
        hi_mask = _i32([(1 << aprec) - (1 << b) for b in bprec],
                       dev).view(3, 1)
        legal = None
        for d in deltas:
            ok = (((d + half) & hi_mask) == 0).all(dim=3)
            legal = ok if legal is None else legal & ok
        any_legal = legal if any_legal is None else any_legal | legal
    del deltas
    if any_legal is not None:       # every mode of the group is transformed
        valid_pair = valid_pair & any_legal
    cand_err = torch.where(valid_pair, totals,
                           torch.full((), INF, dtype=F32, device=dev))
    del totals, valid_pair, any_legal

    # first least candidate in (P, M0, M1) visitation order
    win_err, win = lanes.lex_min_with_index(cand_err, (3, 1, 2))
    del cand_err
    win_part = win // (m_count * m1_count)
    win_m0_pos = (win // m1_count) % m_count
    win_m1_pos = win % m1_count
    ids = _i32(meta_ids, dev)
    win_m0 = ids[win_m0_pos.long()]
    win_m1 = ids[win_m1_pos.long()] if partitioned else torch.zeros_like(win)
    win_rank = rank_base + (win_part * (MAX_META * MAX_META)
                            + win_m0 * MAX_META + win_m1)

    # winner endpoints [subset][6] and first legal mode, on [N]
    part_l, m0_l, m1_l = win_part.long(), win_m0_pos.long(), win_m1_pos.long()
    w_ep = [eps[rows, m0_l, :, part_l]]
    w_ep.append(eps[rows, m1_l, :, num_parts + part_l] if partitioned
                else w_ep[0])
    a_mask = (1 << aprec) - 1
    chosen_mode = torch.full((n,), -1, dtype=I32, device=dev)
    enc = torch.zeros((n, 2, 2, 3), dtype=I32, device=dev)
    for mode_idx in mode_list:
        _, _, transformed, _, bprec = HDR_MODES[mode_idx]
        legal = torch.ones((n,), dtype=torch.bool, device=dev)
        cand = torch.stack([w.view(n, 2, 3) for w in w_ep], dim=1)
        if transformed:
            first = cand[:, 0, 0, :]                        # [N,3]
            delta = _truncate_signed(cand - first[:, None, None, :],
                                     _i32(bprec, dev))
            recon = (delta + first[:, None, None, :]) & a_mask
            same = (recon == (cand & a_mask)).view(n, 4, 3)
            # every endpoint but the first becomes a delta; a single mode
            # has no second subset
            used = 4 if partitioned else 2
            legal = same[:, 1:used].all(dim=2).all(dim=1)
            cand = torch.cat([first[:, None, :],
                              delta.view(n, 4, 3)[:, 1:used],
                              cand.view(n, 4, 3)[:, used:]],
                             dim=1).view(n, 2, 2, 3)
        take = (chosen_mode < 0) & legal
        chosen_mode = torch.where(take, torch.full_like(chosen_mode, mode_idx),
                                  chosen_mode)
        enc = torch.where(take[:, None, None, None], cand, enc)

    # winner indexes
    if partitioned:
        # each subset's winning round's two packed words at the winning
        # partition's row, unpacked per pixel by the partition map's bit
        words0 = idx[rows, m0_l, :, part_l]                 # [N,2]
        words1 = idx[rows, m1_l, :, num_parts + part_l]
        pmap = _lut(np.asarray(geom.PARTITION_MAP_2, dtype=np.int32),
                    win_part)
        px = torch.arange(16, dtype=I32, device=dev)
        in_subset1 = ((pmap[:, None] >> px) & 1) == 1       # [N,16]
        word_of_px = (px >= 10).long()[None, :].expand(n, 16)
        word = torch.where(in_subset1, words1.gather(1, word_of_px),
                           words0.gather(1, word_of_px))
        idx_px = (word >> (3 * torch.where(px >= 10, px - 10, px))) & 7
    else:
        idx_px = idx[rows, m0_l, :, 0]                      # [N,16]

    return win_err, win_rank, {"mode": chosen_mode, "partition": win_part,
                               "ep": enc, "idx": idx_px}


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

    mode_ids = _i32([m[0] for m in HDR_MODES], dev)[mode_l]
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
    fix1 = torch.where(partitioned, _lut(geom.FIXUP_INDEXES_2, partition),
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
