"""The BC6H kernels: the meta-round chain of one partitioned precision
group, the same chain of one single-mode precision group, and the combine
of one precision group's rounds.

  partitioned_group_meta_rounds  <- convectionkernels_tpu
                                    bc6h_kernel.partitioned_group_meta_rounds
  single_group_meta_rounds       <- no TPU kernel (XLA ops in the JAX
                                    package's models/bc6h.py)
  combine                        <- no TPU kernel (XLA ops in the JAX
                                    package's models/bc6h.py)

Each wrapper launches its kernel (csrc/bc6h_group.cu, csrc/bc6h_single.cu,
csrc/bc6h_combine.cu) for a CUDA tensor and takes its plain PyTorch version
for a CPU tensor; there is no other switch and no fallback.

partitioned_group_meta_rounds computes, for the 64 (partition, subset) rows
of a block (subset-major: q = subset * 32 + partition) and every tweak x
refine round:
tweak-seeded or refined endpoints, the HDR quantize/unquantize, index
selection (the strict-less scan over the 8 interpolants, or the fast
projection), the inversion at the row's fixup pixel with the endpoint swap,
the dedup against earlier rounds, the subset error summed in pixel order,
and the least-squares refit that seeds the next round.

Unlike the TPU kernel, tensors are block-major (a CUDA block of 64 threads
owns one texture block, so its stores are contiguous over q), any N is
taken, and the subset masks and fixup pixels, which the format fixes, are
module constants rather than arguments.

Bound on an H100: operations. A block reads 1.7 KB and writes 30 KB at 12
rounds, about 10 ns of memory time at 3.35 TB/s, against about 2.4 million
float32 and int32 operations, about 35 ns at 67 Tops/s (chip_smoke.py's
work model has the counts).

single_group_meta_rounds is the same chain for the one row of a
single-mode group: every pixel a member, fixup pixel 0, 16 index values.
The two groups' shapes conflict (64 rows of 3-bit indexes, a thread each;
one row of 16 interpolants, spread over 16 lanes), so they have separate
kernels over shared scalar helpers (csrc/bc6h_common.cuh), chosen by the
group's shape in models/bc6h.py. csrc/bc6h_single.cu says what bounds it.

combine takes the chain's outputs of one group and returns the group's
least (error, visitation rank) candidate over (partition, meta0, meta1)
among the valid pairs some mode of the group can encode, with that
candidate's mode, encoded endpoints and indexes. Its kernel scans the
candidates in visitation order and never writes the grid that the plain
version builds; csrc/bc6h_combine.cu says what bounds it.

Reference: ConvectionKernels_BC67.cpp:2776-2911 (the chain) and 2914-2986
(the combine).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib, programs
from ..cuda_lib import check_tensor
from ..ops import lanes
from ..ops.index_select import WEIGHT_RECIPROCALS
from ..ops.lanes import F32, I32, INF
from ..programs import i32, lut
from ..tables import bc7_geometry as geom
from . import bc6h_common
from .bc6h_common import HDR_MODES

Q = 64            # (partition, subset) rows of a partitioned group
INDEX_RANGE = 8   # 3-bit indexes
SINGLE_INDEX_RANGE = 16   # the 4-bit indexes of a single-mode group
SINGLE_APRECS = (10, 11, 12, 16)
MAX_META = bc6h_common.MAX_TWEAK_ROUNDS * bc6h_common.MAX_REFINE_ROUNDS

# The libraries of csrc/ that BC6H launches.
LIBRARIES = ("bc6h_group", "bc6h_single", "bc6h_combine")


def _subset_tables():
    """(member [64, 16] bool, fixups [64] int) of the subset-major rows."""
    member = np.zeros((Q, 16), dtype=bool)
    fixups = np.zeros(Q, dtype=np.int64)
    for part in range(32):
        bits = int(geom.PARTITION_MAP_2[part])
        for px in range(16):
            member[((bits >> px) & 1) * 32 + part, px] = True
        fixups[32 + part] = int(geom.FIXUP_INDEXES_2[part])
    return member, fixups


SUBSET_MEMBER, SUBSET_FIXUPS = _subset_tables()


def _launch_floats(cw, index_range):
    """The 18 floats of a chain kernel's launch (csrc/bc6h_group.cu and
    csrc/bc6h_single.cu, Params): cw, cw^2 and 1/cw per channel, the tweak
    factor pairs of the 4 tweaks at `index_range`, 1/(range-1)."""
    w = [np.float32(c) for c in cw[:3]]
    tweaks = [lanes.compute_tweak_factors(t, index_range)
              for t in range(bc6h_common.MAX_TWEAK_ROUNDS)]
    floats = (w + [c * c for c in w]
              + [np.float32(1.0) if c == 0.0 else np.float32(1.0) / c
                 for c in w]
              + [t[0] for t in tweaks] + [t[1] for t in tweaks]
              + [np.float32(1.0) / np.float32(index_range - 1)])
    return (ctypes.c_float * 18)(*[float(f) for f in floats])


def _launch_constants(cw):
    """The constants of a partitioned group's launch as C arrays: the 18
    floats at index range 8 and 128 ints (member bits, fixup pixel per q)."""
    bits = (SUBSET_MEMBER.astype(np.int64) << np.arange(16)).sum(axis=1)
    ints = [int(b) for b in bits] + [int(f) for f in SUBSET_FIXUPS]
    return _launch_floats(cw, INDEX_RANGE), (ctypes.c_int * (2 * Q))(*ints)


def _single_launch_constants(cw):
    """The constants of a single-mode group's launch: the 18 floats at
    index range 16 and the weight reciprocal of range 16."""
    return (_launch_floats(cw, SINGLE_INDEX_RANGE),
            int(WEIGHT_RECIPROCALS[SINGLE_INDEX_RANGE]))


def _check_rounds(num_tweak_rounds, num_refine_rounds):
    if not (1 <= num_tweak_rounds <= bc6h_common.MAX_TWEAK_ROUNDS
            and 1 <= num_refine_rounds <= bc6h_common.MAX_REFINE_ROUNDS):
        raise ValueError(f"rounds out of range: {num_tweak_rounds} x "
                         f"{num_refine_rounds}")


def partitioned_group_meta_rounds(pix, base, offset, aprec, is_signed,
                                  fast_indexing, uniform, cw,
                                  num_tweak_rounds, num_refine_rounds):
    """Every meta round of one partitioned precision group.

    Args:
      pix: [N, 48] int32 clamped 2CL pixels (px*3 + ch).
      base, offset: [N, 3, 64] float32 PCA lines (channel, subset-major q).
      aprec: the group's endpoint precision (6..11).
      cw: channel weights (the first 3 are used).
      num_tweak_rounds (1..4), num_refine_rounds (1..3): A = their product.

    Returns (err [N, A, 64] float32, valid [N, A, 64] int32, eps
    [N, A, 6, 64] int32 stored endpoints, idx [N, A, 2, 64] int32: the 16
    stored 3-bit indexes in two words, pixels 0-9 and 10-15), rounds in
    tweak-major order.
    """
    if pix.device.type == "cpu":
        return partitioned_group_meta_rounds_plain(
            pix, base, offset, aprec, is_signed, fast_indexing, uniform, cw,
            num_tweak_rounds, num_refine_rounds)
    n, dev = pix.shape[0], pix.device
    _check_rounds(num_tweak_rounds, num_refine_rounds)
    if not 6 <= aprec <= 11:
        raise ValueError(f"aprec {aprec} is not a partitioned group's")
    check_tensor("pix", pix, I32, (n, 48), dev)
    check_tensor("base", base, F32, (n, 3, Q), dev)
    check_tensor("offset", offset, F32, (n, 3, Q), dev)
    a_count = num_tweak_rounds * num_refine_rounds
    err = torch.empty((n, a_count, Q), dtype=F32, device=dev)
    valid = torch.empty((n, a_count, Q), dtype=I32, device=dev)
    eps = torch.empty((n, a_count, 6, Q), dtype=I32, device=dev)
    idx = torch.empty((n, a_count, 2, Q), dtype=I32, device=dev)
    if n == 0:
        return err, valid, eps, idx
    floats, ints = _launch_constants(cw)
    cuda_lib.launch("bc6h_group",
                    f"partitioned_group_meta_rounds(aprec {aprec})", pix,
                    base, offset, n, aprec, int(is_signed),
                    int(fast_indexing), int(uniform), num_tweak_rounds,
                    num_refine_rounds, floats, ints, err, valid, eps, idx)
    return err, valid, eps, idx


def pack_indexes(idx):
    """[..., 16, Q] 3-bit indexes -> [..., 2, Q] words (pixels 0-9 in the
    first, 10-15 in the second, 3 bits each from bit 0)."""
    lo = idx[..., 0, :]
    for px in range(1, 10):
        lo = lo | (idx[..., px, :] << (3 * px))
    hi = idx[..., 10, :]
    for px in range(11, 16):
        hi = hi | (idx[..., px, :] << (3 * (px - 10)))
    return torch.stack([lo, hi], dim=-2)


def partitioned_group_meta_rounds_plain(pix, base, offset, aprec, is_signed,
                                        fast_indexing, uniform, cw,
                                        num_tweak_rounds, num_refine_rounds):
    """Plain PyTorch version of partitioned_group_meta_rounds (same
    signature), on the device of its tensors."""
    dev = pix.device
    err, valid, eps, idx = bc6h_common.meta_round_chain(
        pix, [base[:, ch] for ch in range(3)],
        [offset[:, ch] for ch in range(3)], aprec, is_signed, fast_indexing,
        uniform, cw, num_tweak_rounds, num_refine_rounds, INDEX_RANGE,
        programs.constant(SUBSET_MEMBER, dev),
        programs.constant(SUBSET_FIXUPS, dev))
    return err, valid, eps, pack_indexes(idx)


def single_group_meta_rounds(pix, base, offset, aprec, is_signed,
                             fast_indexing, uniform, cw, num_tweak_rounds,
                             num_refine_rounds):
    """Every meta round of one single-mode precision group: its one row,
    every pixel a member, fixup pixel 0, 4-bit indexes.

    Args:
      pix: [N, 48] int32 clamped 2CL pixels (px*3 + ch).
      base, offset: [N, 3] float32, the PCA line of the whole block.
      aprec: the group's endpoint precision (10, 11, 12 or 16).
      cw: channel weights (the first 3 are used).
      num_tweak_rounds (1..4), num_refine_rounds (1..3): A = their product.

    Returns (err [N, A, 1] float32, valid [N, A, 1] int32, eps [N, A, 6, 1]
    int32 stored endpoints, idx [N, A, 16, 1] int32 stored indexes), rounds
    in tweak-major order: what combine takes for a single-mode group.
    """
    _check_rounds(num_tweak_rounds, num_refine_rounds)
    if aprec not in SINGLE_APRECS:
        raise ValueError(f"aprec {aprec} is not a single-mode group's")
    if pix.device.type == "cpu":
        return single_group_meta_rounds_plain(
            pix, base, offset, aprec, is_signed, fast_indexing, uniform, cw,
            num_tweak_rounds, num_refine_rounds)
    n, dev = pix.shape[0], pix.device
    check_tensor("pix", pix, I32, (n, 48), dev)
    check_tensor("base", base, F32, (n, 3), dev)
    check_tensor("offset", offset, F32, (n, 3), dev)
    a_count = num_tweak_rounds * num_refine_rounds
    err = torch.empty((n, a_count, 1), dtype=F32, device=dev)
    valid = torch.empty((n, a_count, 1), dtype=I32, device=dev)
    eps = torch.empty((n, a_count, 6, 1), dtype=I32, device=dev)
    idx = torch.empty((n, a_count, SINGLE_INDEX_RANGE, 1), dtype=I32,
                      device=dev)
    if n == 0:
        return err, valid, eps, idx
    floats, weight_reciprocal = _single_launch_constants(cw)
    cuda_lib.launch("bc6h_single", f"single_group_meta_rounds(aprec {aprec})",
                    pix, base, offset, n, aprec, int(is_signed),
                    int(fast_indexing), int(uniform), num_tweak_rounds,
                    num_refine_rounds, floats, weight_reciprocal, err, valid,
                    eps, idx)
    return err, valid, eps, idx


def single_group_meta_rounds_plain(pix, base, offset, aprec, is_signed,
                                   fast_indexing, uniform, cw,
                                   num_tweak_rounds, num_refine_rounds):
    """Plain PyTorch version of single_group_meta_rounds (same signature),
    on the device of its tensors: the chain with index range 16, every
    pixel a member and fixup pixel 0."""
    dev = pix.device
    return bc6h_common.meta_round_chain(
        pix, [base[:, ch:ch + 1] for ch in range(3)],
        [offset[:, ch:ch + 1] for ch in range(3)], aprec, is_signed,
        fast_indexing, uniform, cw, num_tweak_rounds, num_refine_rounds,
        SINGLE_INDEX_RANGE,
        torch.ones((1, 16), dtype=torch.bool, device=dev),
        torch.zeros((1,), dtype=torch.int64, device=dev))


def _truncate_signed(v, precision):
    """Scalar TruncateToPrecisionSigned (ParallelMath.h:1410-1414);
    `precision` is an int or an int32 tensor broadcastable against v."""
    shift = 32 - precision
    return (v << shift) >> shift


def _combine_constants(mode_list, meta_ids):
    """The host arrays of a combine launch (csrc/bc6h_combine.cu): the meta
    round ids, each mode as (index, transformed, bPrec r, g, b), and the
    32 two-subset partition maps."""
    ids = (ctypes.c_int * len(meta_ids))(*[int(m) for m in meta_ids])
    modes = []
    for mode_idx in mode_list:
        _, _, transformed, _, bprec = HDR_MODES[mode_idx]
        modes += [int(mode_idx), int(transformed), *[int(b) for b in bprec]]
    pmap = (ctypes.c_int * 32)(*[int(b) for b in geom.PARTITION_MAP_2[:32]])
    return ids, (ctypes.c_int * len(modes))(*modes), pmap


def combine(err, valid, eps, idx, aprec, mode_list, meta_ids, rank_base):
    """meta0 x meta1 x first-legal-mode of one precision group
    (BC67.cpp:2914-2986).

    Args:
      err [N, M, Q] float32, valid [N, M, Q] int32, eps [N, M, 6, Q] int32
        and idx: the chain's outputs over the M rounds `meta_ids` (in
        visitation order), Q = 64 for a partitioned group (idx [N, M, 2, 64]
        packed words, partitioned_group_meta_rounds) and Q = 1 for a
        single-mode group (idx [N, M, 16, 1], single_group_meta_rounds).
      aprec, mode_list: the group's endpoint precision and its modes
        (indexes into HDR_MODES).
      rank_base: the visitation rank of the group's first candidate.

    The (partition, meta0, meta1) candidates are reduced to their least
    (error, visitation rank) among the valid pairs some mode of the group
    can encode; a block without one gets error +inf and candidate 0.

    Returns (error [N] float32, rank [N] int32, payload {"mode" [N],
    "partition" [N], "ep" [N, 2, 2, 3] encoded endpoints, "idx" [N, 16]},
    all int32) for LexBest.
    """
    if err.device.type == "cpu":
        return combine_plain(err, valid, eps, idx, aprec, mode_list,
                             meta_ids, rank_base)
    if err.dim() != 3 or err.shape[2] not in (1, Q):
        raise ValueError(f"err: expected [N, M, {Q}] or [N, M, 1], got "
                         f"{tuple(err.shape)}")
    n, m_count, q_count = err.shape
    partitioned = q_count == Q
    dev = err.device
    if not 1 <= m_count <= MAX_META or len(meta_ids) != m_count or \
            not all(0 <= m < MAX_META for m in meta_ids):
        raise ValueError(f"meta_ids {list(meta_ids)} for {m_count} rounds")
    if not mode_list or len(mode_list) > 3 or any(
            HDR_MODES[m][1] != partitioned or HDR_MODES[m][3] != aprec
            for m in mode_list):
        raise ValueError(f"modes {list(mode_list)} are not one "
                         f"{'partitioned' if partitioned else 'single'} "
                         f"group of aprec {aprec}")
    check_tensor("err", err, F32, (n, m_count, q_count), dev)
    check_tensor("valid", valid, I32, (n, m_count, q_count), dev)
    check_tensor("eps", eps, I32, (n, m_count, 6, q_count), dev)
    check_tensor("idx", idx, I32, (n, m_count, 2, Q) if partitioned
                  else (n, m_count, 16, 1), dev)
    win_err = torch.empty((n,), dtype=F32, device=dev)
    win_rank = torch.empty((n,), dtype=I32, device=dev)
    payload = {"mode": torch.empty((n,), dtype=I32, device=dev),
               "partition": torch.empty((n,), dtype=I32, device=dev),
               "ep": torch.empty((n, 2, 2, 3), dtype=I32, device=dev),
               "idx": torch.empty((n, 16), dtype=I32, device=dev)}
    if n == 0:
        return win_err, win_rank, payload
    ids, modes, pmap = _combine_constants(mode_list, meta_ids)
    cuda_lib.launch("bc6h_combine", f"combine(aprec {aprec})", err, valid,
                    eps, idx, n, m_count, int(partitioned), aprec, rank_base,
                    ids, len(mode_list), modes, pmap, win_err, win_rank,
                    payload["mode"], payload["partition"], payload["ep"],
                    payload["idx"])
    return win_err, win_rank, payload


def combine_plain(err, valid, eps, idx, aprec, mode_list, meta_ids,
                  rank_base):
    """Plain PyTorch version of combine (same signature), on the device of
    its tensors: the (partition, meta0, meta1) grid materialised and
    reduced to its least (error, visitation rank) candidate, whose mode,
    encoded endpoints and indexes are then worked out on [N]."""
    n, m_count = err.shape[:2]
    dev = err.device
    partitioned = err.shape[2] == Q
    valid = valid != 0
    rows = torch.arange(n, device=dev)
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
        half = i32([1 << (b - 1) for b in bprec], dev).view(3, 1)
        hi_mask = i32([(1 << aprec) - (1 << b) for b in bprec],
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
    ids = i32(meta_ids, dev)
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
                                     i32(bprec, dev))
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
        pmap = lut(np.asarray(geom.PARTITION_MAP_2, dtype=np.int32),
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
