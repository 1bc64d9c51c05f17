"""BC6H pieces shared by the encoder (models/bc6h.py) and the plain version
of its kernel (models/bc6h_kernel.py): the mode table, the HDR endpoint
quantizer, and the meta-round chain of one precision group.

The chain is the tweak x refine loop of BC6HComputer::Pack
(ConvectionKernels_BC67.cpp:2794-2911) for every (partition, subset) row q
of a group at once. Rounds stay sequential because the endpoint dedup
couples them in visitation order; pixels and index values are tensor axes.
Every chained float32 sum keeps the reference's order, ties go to the first
index, and integers are int32 (their products may wrap, as in the
reference's scalar build).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lanes
from ..ops.exact_math import exact_divide
from ..ops.index_select import WEIGHT_RECIPROCALS
from ..ops.refine import EndpointRefiner

MAX_TWEAK_ROUNDS = 4   # BC67.h:86
MAX_REFINE_ROUNDS = 3  # BC67.h:87

F32, I32 = torch.float32, torch.int32

# g_hdrModes (BC67.cpp:151-167): (modeID, partitioned, transformed, aPrec,
# bPrec[3]) in table order; mode indexes match bc6h_layout.LAYOUTS.
HDR_MODES = (
    (0x00, True, True, 10, (5, 5, 5)),
    (0x01, True, True, 7, (6, 6, 6)),
    (0x02, True, True, 11, (5, 4, 4)),
    (0x06, True, True, 11, (4, 5, 4)),
    (0x0A, True, True, 11, (4, 4, 5)),
    (0x0E, True, True, 9, (5, 5, 5)),
    (0x12, True, True, 8, (6, 5, 5)),
    (0x16, True, True, 8, (5, 6, 5)),
    (0x1A, True, True, 8, (5, 5, 6)),
    (0x1E, True, False, 6, (6, 6, 6)),
    (0x03, False, False, 10, (10, 10, 10)),
    (0x07, False, True, 11, (9, 9, 9)),
    (0x0B, False, True, 12, (8, 8, 8)),
    (0x0F, False, True, 16, (4, 4, 4)),
)


def clamp_rounds(num_tweak_rounds: int, num_refine_rounds: int):
    """The round counts BC6HComputer::Pack runs for the given options."""
    return (min(max(num_tweak_rounds, 1), MAX_TWEAK_ROUNDS),
            min(max(num_refine_rounds, 1), MAX_REFINE_ROUNDS))


def unscale_hdr_signed(v):
    """UnscaleHDRValueSigned (BC67.cpp:765-781): |v|*31>>5 with 2CL sign."""
    negative = v < 0
    abs_v = torch.where(negative, -v, v)
    scaled = (abs_v * 31) >> 5
    return torch.where(negative, scaled | (-32768), scaled)


def unscale_hdr_unsigned(v):
    """UnscaleHDRValueUnsigned (BC67.cpp:783-786): v*31>>6."""
    return (v * 31) >> 6


def quantize_element(v2cl, precision: int, is_signed: bool):
    """QuantizeSingleEndpointElement{Signed,Unsigned} (BC67.cpp:2424-2445).

    The reference takes ceil(f32_div(v*32or64, 31)); the quotient is never
    within a float32 half-ulp of an integer unless it is one, so that ceil
    equals the exact rational ceil (v*k + 30) // 31. The dividends are
    non-negative by construction.
    """
    if is_signed:
        negative = v2cl < 0
        abs_elem = torch.where(negative, -v2cl, v2cl)
        q = ((abs_elem * 32 + 30) // 31) >> (16 - precision)
        return torch.where(negative, -q, q)
    q = torch.clamp_max((v2cl * 64 + 30) // 31, 65535)
    return q >> (16 - precision)


def unquantize_element(comp, precision: int, is_signed: bool):
    """UnquantizeSingleEndpointElement{Signed,Unsigned} (BC67.cpp:2447-2502).

    Returns (unquantized, finished) int32 tensors.
    """
    zero = torch.zeros_like(comp)
    if is_signed:
        negative = comp < 0
        abs_comp = torch.where(negative, -comp, comp)
        if precision >= 16:
            unq = comp
            abs_unq = abs_comp
        else:
            max_comp_m1 = (1 << (precision - 1)) - 2
            abs_unq = (abs_comp << (16 - precision)) + (0x4000
                                                        >> (precision - 1))
            abs_unq = torch.where(comp == 0, zero, abs_unq)
            abs_unq = torch.where(comp > max_comp_m1,
                                  torch.full_like(comp, 0x7FFF), abs_unq)
            unq = torch.where(negative, -abs_unq, abs_unq)
        funq = (abs_unq * 31) >> 5
        return unq, torch.where(negative, -funq, funq)
    unq = comp
    if precision < 15:
        max_comp_m1 = (1 << precision) - 2
        unq = (comp << (16 - precision)) + (0x8000 >> precision)
        unq = torch.where(comp == 0, zero, unq)
        unq = torch.where(comp > max_comp_m1,
                          torch.full_like(comp, 0xFFFF), unq)
    return unq, (unq * 31) >> 6


def reconstruct_uninverted(ep0, ep1, weight, is_signed: bool):
    """ReconstructHDR{Signed,Unsigned}Uninverted for one channel
    (IndexSelectorHDR.h:34-67): interpolate the unquantized endpoints with
    a 6-bit weight, then unscale to the 2CL half range."""
    px32 = ((64 - weight) * ep0 + weight * ep1 + 32) >> 6
    return (unscale_hdr_signed(px32) if is_signed
            else unscale_hdr_unsigned(px32))


def index_weight(index, index_range: int):
    """The 6-bit interpolation weight of `index` (int or int32 tensor)."""
    return (WEIGHT_RECIPROCALS[index_range] * index + 256) >> 9


def meta_round_chain(pix, base, offset, aprec, is_signed, fast_indexing,
                     uniform, cw, num_tweak_rounds, num_refine_rounds,
                     index_range, member, fixups):
    """All meta rounds (tweak-major) of one precision group.

    Args:
      pix: [N, 48] int32 clamped 2CL pixels (px*3 + ch).
      base, offset: 3 float32 [N, Q] tensors each, the PCA line of row q.
      cw: channel weights (the first 3 are used).
      num_tweak_rounds, num_refine_rounds: already clamped (clamp_rounds).
      index_range: 8 (partitioned groups) or 16 (single groups).
      member: [Q, 16] bool tensor, the pixels of row q's subset.
      fixups: [Q] int64 tensor, the pixel whose index keeps its top bit 0.

    Returns, with A = num_tweak_rounds * num_refine_rounds:
      err [N, A, Q] float32 subset errors, valid [N, A, Q] int32 (0 where
      the round's endpoints repeat an earlier round's), eps [N, A, 6, Q]
      int32 stored (swapped) endpoints ep0 rgb, ep1 rgb, and idx
      [N, A, 16, Q] int32 stored (inverted) indexes.
    """
    n, q_count = base[0].shape
    dev = pix.device
    cw = [float(np.float32(w)) for w in cw[:3]]
    cw_sq = [float(np.float32(w) * np.float32(w)) for w in cw]
    max_value = float(index_range - 1)
    half_range_m1 = index_range // 2 - 1
    lo = -31743.0 if is_signed else 0.0

    p2cl = [pix[:, ch::3].unsqueeze(-1) for ch in range(3)]     # [N,16,1]
    f2cl = [lanes.to_float(c) for c in p2cl]
    f2cl_unw = [lanes.twoscl_half_to_float(c) for c in p2cl]
    flinw = [f2cl_unw[ch] * cw[ch] for ch in range(3)]
    pw = [f2cl[ch] * cw[ch] for ch in range(3)]
    member_px = [member[:, px].unsqueeze(0) for px in range(16)]  # [1,Q]
    fix_col = fixups.view(1, 1, q_count).expand(n, 1, q_count)
    weights = torch.as_tensor(
        [index_weight(r, index_range) for r in range(index_range)],
        dtype=I32, device=dev).view(1, index_range, 1)
    zero_f = torch.zeros((n, q_count), dtype=F32, device=dev)
    zero_s = torch.zeros((), dtype=F32, device=dev)
    swap = torch.as_tensor([3, 4, 5, 0, 1, 2], device=dev)

    errs, valids, epss, idxs = [], [], [], []
    refiner = None
    for tweak in range(num_tweak_rounds):
        for refine_pass in range(num_refine_rounds):
            if refine_pass == 0:
                f0, f1 = lanes.compute_tweak_factors(tweak, index_range)
                eps_cs = [[lanes.round_and_convert_to_int_nearest(lanes.clamp(
                    base[ch] + offset[ch] * float(f), lo, 31743.0))
                    for ch in range(3)] for f in (f0, f1)]
            else:
                eps_cs = refiner.get_refined_endpoints_hdr(is_signed)
            refiner = EndpointRefiner(zero_f, 3, index_range, cw)

            # QuantizeEndpoints* (BC67.cpp:2503-2595) on all 6 elements
            q_st = quantize_element(torch.stack(eps_cs[0] + eps_cs[1], dim=1),
                                    aprec, is_signed)           # [N,6,Q]
            unq, fin = unquantize_element(q_st, aprec, is_signed)

            if fast_indexing:
                # IndexSelector Init on the finished endpoints, then
                # SelectIndexLDR: project, clamp, round
                origin = [lanes.to_float(fin[:, ch]) for ch in range(3)]
                diff_w = [(lanes.to_float(fin[:, 3 + ch]) - origin[ch])
                          * cw[ch] for ch in range(3)]
                len_sq = diff_w[0] * diff_w[0]
                for ch in range(1, 3):
                    len_sq = len_sq + diff_w[ch] * diff_w[ch]
                len_sq = lanes.make_safe_denominator(len_sq)
                mv = exact_divide(torch.full_like(len_sq, max_value), len_sq)
                axis = [diff_w[ch] * cw[ch] * mv for ch in range(3)]
                dist = None
                for ch in range(3):
                    t = ((f2cl[ch] - origin[ch].unsqueeze(1))
                         * axis[ch].unsqueeze(1))
                    dist = t if dist is None else dist + t
                idx_unv = lanes.round_and_convert_to_int_nearest(
                    lanes.clamp(dist, 0.0, max_value))          # [N,16,Q]
                # error of the uninverted reconstruction against the 2CL
                # pixels: integer squares converted to float
                w = index_weight(idx_unv, index_range)
                err = None
                for ch in range(3):
                    recon = reconstruct_uninverted(
                        unq[:, ch].unsqueeze(1), unq[:, 3 + ch].unsqueeze(1),
                        w, is_signed)
                    d = recon - p2cl[ch]
                    e = lanes.to_float(d * d)
                    if not uniform:
                        e = e * cw_sq[ch]
                    err = e if err is None else err + e
            else:
                # InitHDR: every interpolant in linear space; then
                # SelectIndexHDRSlow (first strict minimum over r) and
                # ComputeErrorHDRSlow at the selected interpolant
                interp = [lanes.twoscl_half_to_float(reconstruct_uninverted(
                    unq[:, ch].unsqueeze(1), unq[:, 3 + ch].unsqueeze(1),
                    weights, is_signed)) for ch in range(3)]    # [N,R,Q]
                err_r = None
                for ch in range(3):
                    d = (flinw[ch].unsqueeze(2)
                         - (interp[ch] * cw[ch]).unsqueeze(1))
                    e = d * d
                    err_r = e if err_r is None else err_r + e   # [N,16,R,Q]
                idx_unv = lanes.first_argmin(err_r, 2)          # [N,16,Q]
                gather_at = idx_unv.long().unsqueeze(2)
                err = None
                for ch in range(3):
                    sel = interp[ch].unsqueeze(1).expand(
                        n, 16, index_range, q_count).gather(
                            2, gather_at).squeeze(2)
                    d = sel - f2cl_unw[ch]
                    e = d * d
                    if not uniform:
                        e = e * cw_sq[ch]
                    err = e if err is None else err + e         # [N,16,Q]

            # inversion at the fixup pixel, endpoint swap
            invert = idx_unv.gather(1, fix_col).squeeze(1) > half_range_m1
            idx = torch.where(invert.unsqueeze(1),
                              (index_range - 1) - idx_unv, idx_unv)
            q_sw = torch.where(invert.unsqueeze(1), q_st[:, swap], q_st)

            # dedup against every earlier round (BC67.cpp:2853-2877)
            valid = torch.ones((n, q_count), dtype=torch.bool, device=dev)
            for prev in epss:
                valid = valid & ~(prev == q_sw).all(dim=1)

            # sequential per-pixel accumulation (reference f32 order)
            last_refine = refine_pass == num_refine_rounds - 1
            subset_error = zero_f
            for px in range(16):
                subset_error = subset_error + torch.where(
                    member_px[px], err[:, px], zero_s)
                if not last_refine:
                    refiner.contribute_unweighted_pw(
                        [pw[ch][:, px] for ch in range(3)], idx[:, px],
                        mask=member_px[px] & valid)

            errs.append(subset_error)
            valids.append(valid.to(I32))
            epss.append(q_sw)
            idxs.append(idx)

    return (torch.stack(errs, dim=1), torch.stack(valids, dim=1),
            torch.stack(epss, dim=1), torch.stack(idxs, dim=1))
