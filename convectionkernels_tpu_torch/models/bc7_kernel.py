"""The four BC7 kernels: CUDA wrappers, their plain PyTorch versions, and
the host-side packing of their per-lane inputs.

Each wrapper takes the kernel for a CUDA tensor and the plain version for
a CPU tensor; there is no other switch and no fallback. The plain version
is the torch translation of the TPU kernel body over the whole batch,
built from the same ops (ops/, bc7_common) the CUDA sources mirror, so
the two agree bit for bit (tests/test_torch_cuda.py checks that on the
card).

  shape_pca               <- convectionkernels_tpu bc7_kernel.shape_pca
  single_plane_mode_best  <- convectionkernels_tpu bc7_kernel.single_plane_mode_best
  dual_plane_best         <- convectionkernels_tpu bc7_kernel.dual_plane_best
  bc7_pack                <- XLA ops of convectionkernels_tpu models/bc7.py
                             (_pack_mode_bits, _pack_bits); its plain
                             version is _pack_bits, on pack_fields' rows

Unlike the TPU kernels, no candidate axis is padded to 128 lanes and the
single-plane kernel takes the per-shape [N, S, 4] PCA lines and expands
them to candidate lanes itself (through the lane table's shape row).

Reference: ConvectionKernels_BC67.cpp:1042-1965, 2003-2203.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib, programs
from ..cuda_lib import check_tensor
from ..ops import lanes, pca
from ..ops.index_select import WEIGHT_RECIPROCALS, IndexSelector
from ..ops.lanes import BIG_RANK, F32, I32, INF
from ..ops.refine import EndpointRefiner
from ..programs import i32, lut
from ..tables import bc7_geometry as geom
from . import bc7_common
from .bc7_common import MODE_INFO


def _cw_array(cw):
    """4 float32 channel weights as a C float[4]."""
    return (ctypes.c_float * 4)(*[float(np.float32(w)) for w in cw])


# --- shape_pca --------------------------------------------------------------

def shape_mask_bits(masks: np.ndarray) -> np.ndarray:
    """[S, 16] bool membership -> [S] int32 bit masks (bit px)."""
    weights = (1 << np.arange(16)).astype(np.int64)
    return (masks.astype(np.int64) * weights).sum(axis=1).astype(np.int32)


def shape_pca(pix, mask_bits, nch, cw, uniform, with_alpha):
    """Per-shape PCA endpoints (+ static alpha error for RGB lists).

    Args:
      pix: [N, 64] int32 pixels (px*4+ch).
      mask_bits: [S] int32 shape membership bits, on pix's device.
      nch: 3 (RGB shapes) or 4 (RGBA shapes).
      cw: 4 float32 channel weights.
      with_alpha: also return the weighted static alpha error [N, S].

    Returns (base, offset) [N, S, 4] f32 (channels >= nch are 0), and the
    alpha error [N, S] f32 or None.
    """
    if pix.device.type == "cpu":
        return shape_pca_plain(pix, mask_bits, nch, cw, uniform, with_alpha)
    n, s_count = pix.shape[0], mask_bits.shape[0]
    check_tensor("pix", pix, I32, (n, 64), pix.device)
    check_tensor("mask_bits", mask_bits, I32, (s_count,), pix.device)
    base = torch.empty((n, s_count, 4), dtype=F32, device=pix.device)
    offset = torch.empty_like(base)
    alpha = (torch.empty((n, s_count), dtype=F32, device=pix.device)
             if with_alpha else None)
    cuda_lib.launch("shape_pca", "shape_pca", pix, mask_bits, n, s_count,
                    nch, _cw_array(cw), int(uniform), int(with_alpha),
                    # shapes a warp takes at once: 4 gives the alpha errors
                    # (4 bytes each) longer row pieces, 2 balances the warps
                    # better; within 2% of the best chunk at every list
                    # length timed on an H100
                    4 if with_alpha else 2, base, offset, alpha)
    return base, offset, alpha


def _pixel_columns(pix):
    """[N, 64] int32 -> 16 x 4 int32 [N, 1] columns."""
    return [[pix[:, px * 4 + ch][:, None] for ch in range(4)]
            for px in range(16)]


def _member_rows(mask_bits):
    """[K] int32 bits -> 16 bool [1, K] rows."""
    return [(((mask_bits >> px) & 1) != 0)[None, :] for px in range(16)]


def shape_pca_plain(pix, mask_bits, nch, cw, uniform, with_alpha):
    """Plain PyTorch version of shape_pca (same signature)."""
    cw = [float(np.float32(w)) for w in cw]
    ips = _pixel_columns(pix)
    pws = [[lanes.to_float(ips[px][ch]) * cw[ch] for ch in range(4)]
           for px in range(16)]
    member = _member_rows(mask_bits)
    weights = [m.to(F32) for m in member]
    centroid, direction, min_d, max_d = pca.endpoint_selector(
        [[pws[px][ch] for ch in range(nch)] for px in range(16)], weights,
        nch, member_mask=member)
    base, offset = pca.get_endpoints(centroid, direction, min_d, max_d, cw,
                                     nch)
    zero = torch.zeros_like(base[0])
    base = torch.stack(base + [zero] * (4 - nch), dim=-1)
    offset = torch.stack(offset + [zero] * (4 - nch), dim=-1)
    alpha = None
    if with_alpha:
        agg = torch.zeros(zero.shape, dtype=I32, device=pix.device)
        for px in range(16):
            d = 255 - ips[px][3]
            agg = agg + torch.where(member[px], d * d, torch.zeros_like(d))
        cw3 = np.float32(cw[3])
        alpha = (lanes.to_float(agg) if uniform
                 else lanes.to_float(agg) * float(cw3 * cw3))
    return base, offset, alpha


# --- single_plane_mode_best -------------------------------------------------

def single_plane_lanes(seeds, parity_max, index_range, masks):
    """Packed candidate lanes of one mode (BC67.cpp:1265-1279 seed pruning).

    Shape-major with a uniform power-of-two slot count per shape
    (c_max = parity_max x the max seed count rounded up to a power of two):
    slot j of shape s is (p = j // t_pad, t = j % t_pad), invalid when
    t >= seeds[s]. Power-of-two segments keep the per-shape winner reduce
    segment-local.

    Returns (lane_i [5, K] int32: shape, parity, slot valid, member bits,
    rank; tweakf [2, K] float32; c_max).
    """
    t_count = bc7_common.MAX_TWEAK_ROUNDS
    s_count = len(seeds)
    t_max = max(1, min(int(seeds.max()) if s_count else 1, t_count))
    t_pad = 1 << (t_max - 1).bit_length()
    c_max = parity_max * t_pad
    ks = np.arange(s_count * c_max)
    s_of_k = ks // c_max
    p_of_k = (ks % c_max) // t_pad
    t_of_k = ks % t_pad
    valid = t_of_k < np.minimum(seeds.astype(np.int64), t_count)[s_of_k]
    lane_i = np.stack([s_of_k, p_of_k, valid,
                       shape_mask_bits(masks)[s_of_k],
                       p_of_k * t_count + t_of_k]).astype(np.int32)
    tweakf = np.zeros((2, len(ks)), dtype=np.float32)
    for t in range(t_count):
        ff0, ff1 = lanes.compute_tweak_factors(t, index_range)
        tweakf[0, t_of_k == t] = ff0
        tweakf[1, t_of_k == t] = ff1
    return lane_i, tweakf, c_max


def single_plane_mode_best(mode, pix, base, offset, alpha, pti, lane_i,
                           tweakf, cpow, cfg, cw, num_refine_rounds):
    """Run one mode's packed-candidate refine search.

    Args:
      pix: [N, 64] int32 pixels (px*4+ch).
      base/offset: [N, S, 4] float32 per-shape PCA lines of the mode's
        shapes (channel 3 is ignored by RGB modes).
      alpha: [N, S] float32 static alpha error (zeros for RGBA modes).
      pti: [N, 4] int32, nonzero where parity p is punch-through invalid.
      lane_i, tweakf: from single_plane_lanes, on pix's device.
      cpow: power-of-two segment length (the c_max of single_plane_lanes).
      cfg: accumulate_error config (fast_indexing, uniform, cw_sq,
        num_real_channels, index_range).

    Returns (err [N, K] f32, rank [N, K] i32, pk0, pk1 [N, K] i32 packed
    4x8-bit endpoints): per-candidate best over refine rounds, reduced so
    every lane of a cpow segment holds its shape's winner.
    """
    if pix.device.type == "cpu":
        return single_plane_mode_best_plain(
            mode, pix, base, offset, alpha, pti, lane_i, tweakf, cpow, cfg,
            cw, num_refine_rounds)
    n, s_count, k_len = pix.shape[0], base.shape[1], lane_i.shape[1]
    dev = pix.device
    check_tensor("pix", pix, I32, (n, 64), dev)
    check_tensor("base", base, F32, (n, s_count, 4), dev)
    check_tensor("offset", offset, F32, (n, s_count, 4), dev)
    check_tensor("alpha", alpha, F32, (n, s_count), dev)
    check_tensor("pti", pti, I32, (n, 4), dev)
    check_tensor("lane_i", lane_i, I32, (5, k_len), dev)
    check_tensor("tweakf", tweakf, F32, (2, k_len), dev)
    err = torch.empty((n, k_len), dtype=F32, device=dev)
    rank = torch.empty((n, k_len), dtype=I32, device=dev)
    pk0 = torch.empty_like(rank)
    pk1 = torch.empty_like(rank)
    cuda_lib.launch("single_plane", f"single_plane_mode_best(mode {mode})",
                    mode, pix, base, offset, alpha, pti, lane_i, tweakf, n,
                    s_count, k_len, cpow, max(num_refine_rounds, 1),
                    int(cfg["fast_indexing"]), int(cfg["uniform"]),
                    _cw_array(cw), err, rank, pk0, pk1)
    return err, rank, pk0, pk1


def _lex_better(e, r, be, br):
    return (e < be) | ((e == be) & (r < br))


def single_plane_mode_best_plain(mode, pix, base, offset, alpha, pti, lane_i,
                                 tweakf, cpow, cfg, cw, num_refine_rounds):
    """Plain PyTorch version of single_plane_mode_best (same signature)."""
    num_refine_rounds = max(num_refine_rounds, 1)
    n, k_len = pix.shape[0], lane_i.shape[1]
    dev = pix.device
    cw = [float(np.float32(w)) for w in cw]
    is_rgb = cfg["num_real_channels"] == 3
    nrc = cfg["num_real_channels"]
    s_of_k = lane_i[0].long()
    p_of_k = lane_i[1]
    slot_valid = lane_i[2] != 0
    rank_k = lane_i[4][None, :]
    f0k = tweakf[0][None, :]
    f1k = tweakf[1][None, :]

    full255 = torch.full((n, k_len), 255, dtype=I32, device=dev)
    ep = [[], []]
    for ch in range(4):
        if is_rgb and ch == 3:
            ep[0].append(full255)
            ep[1].append(full255)
        else:
            b = base[:, s_of_k, ch]
            o = offset[:, s_of_k, ch]
            ep[0].append(lanes.round_and_convert_to_int_nearest(
                lanes.clamp(b + o * f0k, 0.0, 255.0)))
            ep[1].append(lanes.round_and_convert_to_int_nearest(
                lanes.clamp(b + o * f1k, 0.0, 255.0)))

    invalid = ~slot_valid[None, :] | (pti[:, p_of_k.long()] != 0)
    alpha_k = torch.where(invalid, torch.full((), INF, device=dev),
                          alpha[:, s_of_k])
    p0k = (p_of_k & 1)[None, :]
    p1k = ((p_of_k >> 1) & 1)[None, :]
    members = _member_rows(lane_i[3])

    ips = _pixel_columns(pix)
    fps = [[lanes.to_float(v) for v in row] for row in ips]
    pwps = [[fps[px][ch] * cw[ch] for ch in range(4)] for px in range(16)]

    zero_nk = torch.zeros((n, k_len), dtype=F32, device=dev)
    best_err = torch.full((n, k_len), lanes.FLT_MAX, dtype=F32, device=dev)
    best_rank = torch.full((n, k_len), BIG_RANK, dtype=I32, device=dev)
    best_pk = [torch.zeros((n, k_len), dtype=I32, device=dev)
               for _ in range(2)]

    for refine in range(num_refine_rounds):
        compressed = bc7_common.compress_endpoints(mode, ep, p0k, p1k,
                                                   full255)
        selector = IndexSelector(cw, compressed, cfg["index_range"], 4)
        refiner = (EndpointRefiner(zero_nk, 4, cfg["index_range"], cw)
                   if refine != num_refine_rounds - 1 else None)
        shape_error, _ = bc7_common.accumulate_error(
            selector, zero_nk, members, fps, ips, cfg, with_refiner=refiner,
            pwps=pwps)

        err_r = shape_error + alpha_k
        rank_r = rank_k * num_refine_rounds + refine
        better = _lex_better(err_r, rank_r, best_err, best_rank)
        best_err = torch.where(better, err_r, best_err)
        best_rank = torch.where(better, rank_r, best_rank)
        for w in range(2):
            pk = compressed[w][0]
            for ch in range(1, 4):
                pk = pk | (compressed[w][ch] << (8 * ch))
            best_pk[w] = torch.where(better, pk, best_pk[w])

        if refiner is not None:
            r0, r1 = refiner.get_refined_endpoints_ldr(nrc)
            for ch in range(nrc):
                ep[0][ch] = r0[ch]
                ep[1][ch] = r1[ch]

    # per-shape winner: butterfly over each cpow-aligned segment (lane k
    # merges with lane k ^ step), leaving the winner on every lane
    iota = torch.arange(k_len, device=dev)
    step = 1
    while step < cpow:
        partner = iota ^ step
        pe, pr = best_err[:, partner], best_rank[:, partner]
        better = _lex_better(pe, pr, best_err, best_rank)
        best_err = torch.where(better, pe, best_err)
        best_rank = torch.where(better, pr, best_rank)
        best_pk = [torch.where(better, p[:, partner], p) for p in best_pk]
        step *= 2
    return best_err, best_rank, best_pk[0], best_pk[1]


# --- dual_plane_best --------------------------------------------------------

# ci rows
(_CI_CH0_IS3, _CI_CH1_IS3, _CI_CH2_IS3, _CI_A_SRC0, _CI_A_SRC1, _CI_A_SRC2,
 _CI_RANKT, _CI_A_RAW, _CI_RGB_BITS, _CI_A_BITS, _CI_RGB_MAXI,
 _CI_A_MAXI) = range(12)
_CI_ROWS = 12
# cf rows
(_CF_INV, _CF_RGB_MV, _CF_RGB_RECIP, _CF_A_MV, _CF_A_RECIP,
 _CF_RGB_RCPMAX, _CF_A_RCPMAX,
 _CF_CW0, _CF_CW1, _CF_CW2,
 _CF_CWSQ0, _CF_CWSQ1, _CF_CWSQ2, _CF_A_CWSQ,
 _CF_RCW0, _CF_RCW1, _CF_RCW2,
 _CF_RF0, _CF_RF1, _CF_AF0, _CF_AF1) = range(21)
_CF_ROWS = 21


def dual_plane_consts(combos, cw):
    """Per-lane constant rows for the live (combo, tweak) lanes.

    combos: plan-valid dicts with mode/rot/isel/num_tweak/seq in the
    reference's visitation order. Lane q*4+t holds combo q, tweak t.
    Returns (ci [12, L] int32, cf [21, L] float32), L = 4 * len(combos).
    """
    t_cap = bc7_common.MAX_TWEAK_ROUNDS
    k_len = len(combos) * t_cap
    ci = np.zeros((_CI_ROWS, k_len), dtype=np.int32)
    cf = np.zeros((_CF_ROWS, k_len), dtype=np.float32)
    for q, cb in enumerate(combos):
        mode, rot, isel = cb["mode"], cb["rot"], cb["isel"]
        if mode == 4:
            rgb_prec = 3 if isel else 2
            alpha_prec = 2 if isel else 3
            rgb_qbits, a_qbits, raw = 5, 6, 0
        else:
            rgb_prec = alpha_prec = 2
            rgb_qbits, a_qbits, raw = 7, 8, 1
        rgb_range = 1 << rgb_prec
        alpha_range = 1 << alpha_prec
        rgb_chs = (3 if rot == 1 else 0, 3 if rot == 2 else 1,
                   3 if rot == 3 else 2)
        alpha_ch = (rot + 3) & 3
        for t in range(t_cap):
            k = q * t_cap + t
            cf[_CF_INV, k] = 0.0 if t < cb["num_tweak"] else np.inf
            for c2 in range(3):
                ci[_CI_CH0_IS3 + c2, k] = 1 if rgb_chs[c2] == 3 else 0
                ci[_CI_A_SRC0 + c2, k] = 1 if alpha_ch == c2 else 0
            ci[_CI_RANKT, k] = t
            ci[_CI_A_RAW, k] = raw
            ci[_CI_RGB_BITS, k] = rgb_qbits
            ci[_CI_A_BITS, k] = a_qbits
            ci[_CI_RGB_MAXI, k] = rgb_range - 1
            ci[_CI_A_MAXI, k] = alpha_range - 1
            cf[_CF_RGB_MV, k] = np.float32(rgb_range - 1)
            cf[_CF_RGB_RECIP, k] = np.float32(WEIGHT_RECIPROCALS[rgb_range])
            cf[_CF_A_MV, k] = np.float32(alpha_range - 1)
            cf[_CF_A_RECIP, k] = np.float32(WEIGHT_RECIPROCALS[alpha_range])
            cf[_CF_RGB_RCPMAX, k] = (np.float32(1.0)
                                     / np.float32(rgb_range - 1))
            cf[_CF_A_RCPMAX, k] = (np.float32(1.0)
                                   / np.float32(alpha_range - 1))
            for c2 in range(3):
                w = np.float32(cw[rgb_chs[c2]])
                cf[_CF_CW0 + c2, k] = w
                cf[_CF_CWSQ0 + c2, k] = w * w
                cf[_CF_RCW0 + c2, k] = (np.float32(1.0) if w == 0.0
                                        else np.float32(1.0) / w)
            wa = np.float32(cw[alpha_ch])
            cf[_CF_A_CWSQ, k] = wa * wa
            rf = lanes.compute_tweak_factors(t, rgb_range)
            af = lanes.compute_tweak_factors(t, alpha_range)
            cf[_CF_RF0, k], cf[_CF_RF1, k] = rf
            cf[_CF_AF0, k], cf[_CF_AF1, k] = af
    return ci, cf


def dual_plane_order(ci, cf):
    """The dual-plane kernel's work order, from the lane constants.

    A lane is live unless its offset row (cf row 0) is +inf. A live lane's
    rotation is what its rotated pixels and PCA line depend on: which
    channels it rotates (ci rows 0-5) and its channel weights (cf rows
    7-9, bit for bit). Returns (order [3, L] int32, n_live, n_rot): row 0
    holds the live lanes in order, then the dead ones; row 1 each live
    lane's rotation slot (by row 0's position); row 2 each rotation's first
    live lane.
    """
    ci = np.asarray(ci)
    cf = np.asarray(cf, dtype=np.float32)
    k_len = ci.shape[1]
    live = ~np.isposinf(cf[_CF_INV])
    order = np.zeros((3, k_len), dtype=np.int32)
    order[0] = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
    slots = {}
    for i, k in enumerate(np.flatnonzero(live)):
        key = (tuple(ci[_CI_CH0_IS3:_CI_A_SRC2 + 1, k] != 0),
               cf[_CF_CW0:_CF_CW2 + 1, k].tobytes())
        if key not in slots:
            order[2, len(slots)] = k
            slots[key] = len(slots)
        order[1, i] = slots[key]
    return order, int(live.sum()), len(slots)


def dual_plane_work(ci, cf, device):
    """The kernel's work order of the host lane constants ci, cf
    (dual_plane_consts): (order on `device`, a programs.constant, n_live,
    n_rot), the trailing argument of dual_plane_best."""
    order, n_live, n_rot = dual_plane_order(ci, cf)
    return programs.constant(order, device), n_live, n_rot


_DUAL_KEYS = ("rgb_err", "rgb_rank", "rgb_ep", "rgb_idx", "a_err", "a_rank",
              "a_ep", "a_idx")


def dual_plane_best(pix, ci, cf, num_refine_rounds, uniform, fast_indexing,
                    work):
    """TryDualPlane for every live lane (see dual_plane_consts).

    `work` is dual_plane_work of the host constants that ci and cf were
    made from: the kernel's work order comes from the host, since reading
    ci and cf back would wait for the card (and a graph cannot capture
    it). The plain version ignores it.

    Returns a dict: rgb_err, a_err [N, L] f32; rgb_rank, a_rank [N, L]
    int32; rgb_ep [N, 6, L], a_ep [N, 2, L], rgb_idx, a_idx [N, 16, L]
    int32 — each plane's lexicographic (error, rank) best over rounds.
    """
    if pix.device.type == "cpu":
        return dual_plane_best_plain(pix, ci, cf, num_refine_rounds,
                                     uniform, fast_indexing, work)
    n, k_len = pix.shape[0], ci.shape[1]
    dev = pix.device
    check_tensor("pix", pix, I32, (n, 64), dev)
    check_tensor("ci", ci, I32, (_CI_ROWS, k_len), dev)
    check_tensor("cf", cf, F32, (_CF_ROWS, k_len), dev)
    out = dict(
        rgb_err=torch.empty((n, k_len), dtype=F32, device=dev),
        rgb_rank=torch.empty((n, k_len), dtype=I32, device=dev),
        rgb_ep=torch.empty((n, 6, k_len), dtype=I32, device=dev),
        rgb_idx=torch.empty((n, 16, k_len), dtype=I32, device=dev),
        a_err=torch.empty((n, k_len), dtype=F32, device=dev),
        a_rank=torch.empty((n, k_len), dtype=I32, device=dev),
        a_ep=torch.empty((n, 2, k_len), dtype=I32, device=dev),
        a_idx=torch.empty((n, 16, k_len), dtype=I32, device=dev))
    order, n_live, n_rot = work
    cuda_lib.launch("dual_plane", "dual_plane_best", pix, ci, cf, order, n,
                    k_len, n_live, n_rot, max(num_refine_rounds, 1),
                    int(uniform), int(fast_indexing),
                    *[out[k] for k in _DUAL_KEYS])
    return out


def dual_plane_best_plain(pix, ci, cf, num_refine_rounds, uniform,
                          fast_indexing, work):
    """Plain PyTorch version of dual_plane_best (same signature)."""
    num_refine_rounds = max(num_refine_rounds, 1)
    n, k_len = pix.shape[0], ci.shape[1]
    dev = pix.device

    def row_i(r):
        return ci[r][None, :]

    def row_f(r):
        return cf[r][None, :]

    inv = row_f(_CF_INV)
    rgb_mv, rgb_recip = row_f(_CF_RGB_MV), row_f(_CF_RGB_RECIP)
    a_mv, a_recip = row_f(_CF_A_MV), row_f(_CF_A_RECIP)
    cw_rows = [row_f(_CF_CW0 + c) for c in range(3)]
    cwsq_rows = [row_f(_CF_CWSQ0 + c) for c in range(3)]
    a_cwsq = row_f(_CF_A_CWSQ)
    rcw_rows = [row_f(_CF_RCW0 + c) for c in range(3)]
    rankt = row_i(_CI_RANKT)
    a_raw = row_i(_CI_A_RAW) != 0
    rgb_bits, a_bits = row_i(_CI_RGB_BITS), row_i(_CI_A_BITS)
    rgb_maxi, a_maxi = row_i(_CI_RGB_MAXI), row_i(_CI_A_MAXI)
    ch_is3 = [row_i(_CI_CH0_IS3 + c) != 0 for c in range(3)]
    a_src = [row_i(_CI_A_SRC0 + c) != 0 for c in range(3)]

    cols = _pixel_columns(pix)
    rgb_f, pw_rot, a_i, a_f = [], [], [], []
    for px in range(16):
        c = cols[px]
        fr = [lanes.to_float(torch.where(ch_is3[ch], c[3], c[ch]))
              for ch in range(3)]
        rgb_f.append(fr)
        pw_rot.append([fr[ch] * cw_rows[ch] for ch in range(3)])
        av = torch.where(a_src[0], c[0], torch.where(
            a_src[1], c[1], torch.where(a_src[2], c[2], c[3])))
        a_i.append(av)
        a_f.append(lanes.to_float(av))

    ones = torch.ones((n, k_len), dtype=F32, device=dev)
    cen, dirn, mn_d, mx_d = pca.endpoint_selector(pw_rot, [ones] * 16, 3)
    base, offset = pca.get_endpoints(cen, dirn, mn_d, mx_d, cw_rows, 3)
    amin = a_i[0]
    amax = a_i[0]
    for px in range(1, 16):
        amin = torch.minimum(a_i[px], amin)
        amax = torch.maximum(a_i[px], amax)

    rf0, rf1 = row_f(_CF_RF0), row_f(_CF_RF1)
    af0, af1 = row_f(_CF_AF0), row_f(_CF_AF1)

    def finish(b, o, f):
        return lanes.round_and_convert_to_int_nearest(
            lanes.clamp(b + o * f, 0.0, 255.0))

    rgb_ep = [[finish(base[ch], offset[ch], rf0) for ch in range(3)],
              [finish(base[ch], offset[ch], rf1) for ch in range(3)]]
    a_base = lanes.to_float(amin)
    a_offs = lanes.to_float(amax) - a_base
    alpha_ep = [finish(a_base, a_offs, af0), finish(a_base, a_offs, af1)]

    def qu(c, bits):
        q = ((c << bits) - c + (127 + (torch.ones_like(bits) << (7 - bits)))
             ) >> 8
        cc = q << (8 - bits)
        return cc | (cc >> bits)

    zero_i = torch.zeros((n, k_len), dtype=I32, device=dev)
    zero_nk = torch.zeros((n, k_len), dtype=F32, device=dev)
    big = torch.full((n, k_len), BIG_RANK, dtype=I32, device=dev)
    fmax = torch.full((n, k_len), lanes.FLT_MAX, dtype=F32, device=dev)
    rgb_best = dict(err=fmax, rank=big, ep=[zero_i] * 6, idx=[zero_i] * 16)
    a_best = dict(err=fmax, rank=big, ep=[zero_i] * 2, idx=[zero_i] * 16)

    for refine in range(num_refine_rounds):
        last = refine == num_refine_rounds - 1
        rgb_ep = [[qu(e, rgb_bits) for e in row] for row in rgb_ep]
        # mode 5 keeps raw alpha; its quantize runs on 6 bits and is dropped
        q_bits = torch.where(a_raw, torch.full_like(a_bits, 6), a_bits)
        alpha_ep = [torch.where(a_raw, a, qu(a, q_bits)) for a in alpha_ep]

        rgb_sel = IndexSelector(cw_rows, rgb_ep, (rgb_mv, rgb_recip), 3)
        a_sel = IndexSelector([1.0], [[alpha_ep[0]], [alpha_ep[1]]],
                              (a_mv, a_recip), 1)
        rgb_refiner = EndpointRefiner(zero_nk, 3, 2, cw_rows,
                                      rcp_max_index=row_f(_CF_RGB_RCPMAX),
                                      rcp_channel_weights=rcw_rows)
        a_refiner = EndpointRefiner(zero_nk, 1, 2, [1.0],
                                    rcp_max_index=row_f(_CF_A_RCPMAX))

        error_rgb = zero_nk
        error_a = zero_nk
        agg_rgb = [zero_nk] * 3
        agg_a = zero_nk
        rgb_idx, a_idx = [], []
        for px in range(16):
            ri = rgb_sel.select_index_ldr(rgb_f[px])
            ai = a_sel.select_index_ldr([a_f[px]])
            if fast_indexing:
                rr = rgb_sel.reconstruct_ldr_bc7_f32(ri)
                ra = a_sel.reconstruct_ldr_bc7_f32(ai)[0]
                for ch in range(3):
                    d = rr[ch] - rgb_f[px][ch]
                    agg_rgb[ch] = agg_rgb[ch] + d * d
                da = ra - a_f[px]
                agg_a = agg_a + da * da
            else:
                def rgb_err(iv, px=px):
                    rr = rgb_sel.reconstruct_ldr_bc7_f32(iv)
                    errs = []
                    for c2 in range(3):
                        d = rr[c2] - rgb_f[px][c2]
                        errs.append(d * d)
                    if uniform:
                        return errs[0] + errs[1] + errs[2]
                    t = errs[0] * cwsq_rows[0]
                    for c2 in range(1, 3):
                        t = t + errs[c2] * cwsq_rows[c2]
                    return t

                def a_err(iv, px=px):
                    d = a_sel.reconstruct_ldr_bc7_f32(iv)[0] - a_f[px]
                    return d * d if uniform else d * d * a_cwsq

                re = rgb_err(ri)
                ae = a_err(ai)
                r_alt = (torch.clamp_min(ri, 1) - 1,
                         torch.minimum(ri + 1, rgb_maxi))
                a_alt = (torch.clamp_min(ai, 1) - 1,
                         torch.minimum(ai + 1, a_maxi))
                for ii in range(2):
                    are = rgb_err(r_alt[ii])
                    aae = a_err(a_alt[ii])
                    rb = are < re
                    ab = aae < ae
                    re = torch.minimum(are, re)
                    ae = torch.minimum(aae, ae)
                    ri = torch.where(rb, r_alt[ii], ri)
                    ai = torch.where(ab, a_alt[ii], ai)
                error_rgb = error_rgb + re
                error_a = error_a + ae
            if not last:
                rgb_refiner.contribute_unweighted_pw(pw_rot[px], ri)
                a_refiner.contribute_unweighted_pw([a_f[px]], ai)
            rgb_idx.append(ri)
            a_idx.append(ai)

        if fast_indexing:
            if uniform:
                error_rgb = agg_rgb[0] + agg_rgb[1] + agg_rgb[2]
                error_a = agg_a
            else:
                error_rgb = agg_rgb[0] * cwsq_rows[0]
                for c2 in range(1, 3):
                    error_rgb = error_rgb + agg_rgb[c2] * cwsq_rows[c2]
                error_a = agg_a * a_cwsq

        rank_r = rankt * num_refine_rounds + refine
        for bests, err, eps, idxs in (
                (rgb_best, error_rgb + inv, rgb_ep[0] + rgb_ep[1], rgb_idx),
                (a_best, error_a + inv, alpha_ep, a_idx)):
            better = _lex_better(err, rank_r, bests["err"], bests["rank"])
            bests["err"] = torch.where(better, err, bests["err"])
            bests["rank"] = torch.where(better, rank_r, bests["rank"])
            bests["ep"] = [torch.where(better, e, b)
                           for e, b in zip(eps, bests["ep"])]
            bests["idx"] = [torch.where(better, v, b)
                            for v, b in zip(idxs, bests["idx"])]

        if not last:
            r0, r1 = rgb_refiner.get_refined_endpoints_ldr()
            rgb_ep = [list(r0), list(r1)]
            aa0, aa1 = a_refiner.get_refined_endpoints_ldr()
            alpha_ep = [aa0[0], aa1[0]]

    return dict(
        rgb_err=rgb_best["err"], rgb_rank=rgb_best["rank"],
        rgb_ep=torch.stack(rgb_best["ep"], dim=1),
        rgb_idx=torch.stack(rgb_best["idx"], dim=1),
        a_err=a_best["err"], a_rank=a_best["rank"],
        a_ep=torch.stack(a_best["ep"], dim=1),
        a_idx=torch.stack(a_best["idx"], dim=1))


# --- Bit packing (BC67.cpp:2003-2203) -----------------------------------------

# the csrc/ libraries a BC7 encode launches
LIBRARIES = ("shape_pca", "single_plane", "dual_plane", "bc7_pack")

# rows of pack_fields' int32 [PACK_FIELDS, N]: pack's merged work, one row a
# field (csrc/bc7_pack.cu reads the same rows)
FIELD_MODE, FIELD_PARTITION, FIELD_ROTATION, FIELD_ISEL = range(4)
FIELD_EP = 4            # ep[s][e][ch] in row FIELD_EP + 8 * s + 4 * e + ch
FIELD_INDEXES = 28      # indexes[px]
FIELD_INDEXES2 = 44     # indexes2[px]
PACK_FIELDS = 60

# csrc/bc7_pack.cu's lookups, int32 [5, 64] by partition: PARTITION_MAP_2,
# PARTITION_MAP_3 (its 32 bits), FIXUP_INDEXES_2, FIXUP_INDEXES_3's columns
PACK_TABLES = np.stack([
    geom.PARTITION_MAP_2,
    geom.PARTITION_MAP_3.astype(np.uint32).view(np.int32),
    geom.FIXUP_INDEXES_2, geom.FIXUP_INDEXES_3[:, 0],
    geom.FIXUP_INDEXES_3[:, 1]]).astype(np.int32)


def pack_fields(work):
    """pack's merged work as one int32 [PACK_FIELDS, N] tensor, a row a
    field: one stack, so that neighbouring blocks sit side by side."""
    return torch.stack(
        [work["mode"], work["partition"], work["rotation"], work["isel"]]
        + [work["ep"][s][e][ch]
           for s in range(3) for e in range(2) for ch in range(4)]
        + list(work["indexes"]) + list(work["indexes2"]))


def bc7_pack(fields):
    """BC7's bit packing: pack_fields' int32 [PACK_FIELDS, N] -> uint8
    [N, 16] blocks, each under its own mode. csrc/bc7_pack.cu for a CUDA
    tensor, bc7_pack_plain for a CPU one."""
    if fields.device.type == "cpu":
        return bc7_pack_plain(fields)
    if fields.device.type != "cuda":
        raise ValueError(f"bc7_pack: expected a CPU or CUDA tensor, got one "
                         f"on {fields.device}")
    n = fields.shape[-1]
    check_tensor("fields", fields, I32, (PACK_FIELDS, n), fields.device)
    out = torch.empty((n, 16), dtype=torch.uint8, device=fields.device)
    cuda_lib.launch("bc7_pack", "bc7_pack", fields,
                    i32(PACK_TABLES, fields.device), n, out)
    return out


def bc7_pack_plain(fields):
    """bc7_pack in torch ops: _pack_bits on the rows of `fields`."""
    f = fields
    work = dict(
        mode=f[FIELD_MODE], partition=f[FIELD_PARTITION],
        rotation=f[FIELD_ROTATION], isel=f[FIELD_ISEL],
        ep=[[[f[FIELD_EP + 8 * s + 4 * e + ch] for ch in range(4)]
             for e in range(2)] for s in range(3)],
        indexes=[f[FIELD_INDEXES + px] for px in range(16)],
        indexes2=[f[FIELD_INDEXES2 + px] for px in range(16)])
    return _pack_bits(work, fields.shape[-1])


def _pack_var(words, value, offset, bits: int):
    """Append `value` (bits wide) at per-block bit `offset` into 4 i32 words."""
    for j in range(4):
        sh = offset - 32 * j
        in_lo = (sh >= 0) & (sh < 32)
        in_hi = (sh < 0) & (sh > -bits)
        lo = torch.where(in_lo, value << sh.clamp(0, 31), 0)
        hi = torch.where(in_hi, value >> (-sh).clamp(0, 31), 0)
        words[j] = words[j] | lo | hi
    return words


def _pack_mode_bits(mode: int, work, n):
    """Pack all blocks under `mode`'s layout; returns 4 [N] i32 words."""
    info = MODE_INFO[mode]
    num_subsets = info["num_subsets"]
    ib = info["index_bits"]
    aib = info["alpha_index_bits"]
    separate = info["alpha"] == "separate"
    combined = info["alpha"] == "combined"
    dev = work["mode"].device
    zero = torch.zeros((n,), dtype=I32, device=dev)

    partition = work["partition"]
    indexes = list(work["indexes"])
    indexes2 = list(work["indexes2"])
    ep = [[[work["ep"][s][e][ch] for ch in range(4)] for e in range(2)]
          for s in range(3)]

    def swap(flag, s, ch):
        a, b = ep[s][0][ch], ep[s][1][ch]
        ep[s][0][ch] = torch.where(flag, b, a)
        ep[s][1][ch] = torch.where(flag, a, b)

    if separate:
        flip_rgb = (indexes[0] & (1 << (ib - 1))) != 0
        flip_alpha = (indexes2[0] & (1 << (aib - 1))) != 0
        hi_rgb = (1 << ib) - 1
        hi_a = (1 << aib) - 1
        indexes = [torch.where(flip_rgb, hi_rgb - v, v) for v in indexes]
        indexes2 = [torch.where(flip_alpha, hi_a - v, v) for v in indexes2]
        if info["has_index_selector"]:
            isel = work["isel"] != 0
            flip_rgb, flip_alpha = (
                torch.where(isel, flip_alpha, flip_rgb),
                torch.where(isel, flip_rgb, flip_alpha))
        for ch in range(3):
            swap(flip_rgb, 0, ch)
        swap(flip_alpha, 0, 3)
        fix1 = fix2 = zero
    else:
        if num_subsets == 2:
            fix1 = lut(geom.FIXUP_INDEXES_2, partition)
            fix2 = zero
        elif num_subsets == 3:
            fix1 = lut(geom.FIXUP_INDEXES_3[:, 0], partition)
            fix2 = lut(geom.FIXUP_INDEXES_3[:, 1], partition)
        else:
            fix1 = fix2 = zero

        # owner subset per pixel
        if num_subsets == 2:
            pmap = lut(geom.PARTITION_MAP_2, partition)
            owner = [(pmap >> px) & 1 for px in range(16)]
        elif num_subsets == 3:
            pmap = programs.constant(geom.PARTITION_MAP_3, dev)[
                partition.long()]
            owner = [((pmap >> (2 * px)) & 3).to(I32) for px in range(16)]
        else:
            owner = [zero] * 16

        hi_idx = (1 << ib) - 1
        stack = torch.stack(indexes, dim=-1)
        flips = []
        for subset, fx in enumerate((zero, fix1, fix2)):
            if subset < num_subsets:
                anchor = stack.gather(1, fx.long()[:, None])[:, 0]
                flips.append((anchor & (1 << (ib - 1))) != 0)
            else:
                flips.append(torch.zeros((n,), dtype=torch.bool, device=dev))
        flips_stack = torch.stack(flips, dim=-1)
        for px in range(16):
            f = flips_stack.gather(1, owner[px].long()[:, None])[:, 0]
            indexes[px] = torch.where(f, hi_idx - indexes[px], indexes[px])
        for subset in range(num_subsets):
            for ch in range(4 if combined else 3):
                swap(flips[subset], subset, ch)

    words = [zero for _ in range(4)]
    off = 0

    def pack_static(value, bits):
        nonlocal off
        if bits == 0:
            return
        j = off // 32
        sh = off % 32
        words[j] = words[j] | (value << sh)
        if sh + bits > 32:
            words[j + 1] = words[j + 1] | (value >> (32 - sh))
        off += bits

    pack_static(torch.full((n,), 1 << mode, dtype=I32, device=dev), mode + 1)
    if info["partition_bits"]:
        pack_static(partition, info["partition_bits"])
    if separate:
        pack_static(work["rotation"], 2)
    if info["has_index_selector"]:
        pack_static(work["isel"], 1)

    rgb_bits = info["rgb_bits"]
    for ch in range(3):
        for subset in range(num_subsets):
            for e in range(2):
                pack_static(ep[subset][e][ch] >> (8 - rgb_bits), rgb_bits)
    alpha_bits = info["alpha_bits"]
    if alpha_bits:
        for subset in range(num_subsets):
            for e in range(2):
                pack_static(ep[subset][e][3] >> (8 - alpha_bits), alpha_bits)

    if info["pbit"] == "per_subset":
        for subset in range(num_subsets):
            pack_static((ep[subset][0][0] >> (7 - rgb_bits)) & 1, 1)
    elif info["pbit"] == "per_ep":
        for subset in range(num_subsets):
            for e in range(2):
                pack_static((ep[subset][e][0] >> (7 - rgb_bits)) & 1, 1)

    # index fields: widths depend on data (fixup positions), so offsets are
    # computed per block
    cum = torch.full((n,), off, dtype=I32, device=dev)
    for px in range(16):
        words = _pack_var(words, indexes[px], cum, ib)
        if px == 0:
            cum = cum + (ib - 1)
        else:
            cum = cum + (ib - (fix1 == px).to(I32) - (fix2 == px).to(I32))

    if separate:
        for px in range(16):
            words = _pack_var(words, indexes2[px], cum, aib)
            cum = cum + (aib - (1 if px == 0 else 0))

    return words


def _pack_bits(work, n):
    """Select each block's packed words by its winning mode; emit bytes."""
    dev = work["mode"].device
    final = [torch.zeros((n,), dtype=I32, device=dev) for _ in range(4)]
    for m in range(8):
        words = _pack_mode_bits(m, work, n)
        sel = work["mode"] == m
        for j in range(4):
            final[j] = torch.where(sel, words[j], final[j])
    byte_cols = [(final[j] >> (b * 8)) & 0xFF
                 for j in range(4) for b in range(4)]
    return torch.stack(byte_cols, dim=-1).to(torch.uint8)
