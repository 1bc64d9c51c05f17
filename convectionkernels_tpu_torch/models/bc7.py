"""BC7 encoder.

Batched reimplementation of the reference's BC7Computer
(ConvectionKernels_BC67.cpp:815-2445). Where the reference loops mode x
shape x parity x tweak x refine sequentially over 8 SIMD lanes, this encoder
evaluates the plan's candidates of every block at once in three kernels
(models/bc7_kernel.py) and resolves the reference's
first-strict-improvement-wins update rule exactly via lexicographic
(error, visitation-rank) minima: the reference's winner is always the
lowest-rank candidate achieving the global minimum error.

The host code here runs on the tensors' device: it packs the kernels'
inputs, combines partitions, recomputes the winners' indexes and packs the
bits. Float32 semantics follow the scalar reference build (ops/lanes.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bc7_plan import BC7EncodingPlan
from ..ops import lanes
from ..ops.index_select import IndexSelector
from ..options import Flags
from ..tables import bc7_geometry as geom
from . import bc7_common, bc7_kernel
from .bc7_common import MAX_TWEAK_ROUNDS, MODE_INFO

INF = float("inf")
BIG_RANK = 2**30
I32, F32 = torch.int32, torch.float32


def _i32(values, device):
    return torch.as_tensor(np.asarray(values, dtype=np.int32), device=device)


# --- Lexicographic best tracking ---------------------------------------------

class LexBest:
    """Running (error, rank) lexicographic minimum with payload tensors.

    Reproduces the reference's sequential strict-less update: the final
    winner is the minimum-rank candidate among those achieving the minimum
    error, where rank is the reference's visitation order.
    """

    def __init__(self, error, rank, payload: dict):
        self.error = error
        self.rank = rank
        self.payload = payload

    @classmethod
    def empty(cls, shape, payload_spec: dict, device):
        """No candidate yet: FLT_MAX error, BIG_RANK, zero int32 payloads of
        shape `shape + payload_spec[key]`."""
        error = torch.full(shape, lanes.FLT_MAX, dtype=F32, device=device)
        rank = torch.full(shape, BIG_RANK, dtype=I32, device=device)
        payload = {k: torch.zeros(shape + extra, dtype=I32, device=device)
                   for k, extra in payload_spec.items()}
        return cls(error, rank, payload)

    def update(self, error, rank, payload: dict, extra_valid=None):
        better = (error < self.error) | ((error == self.error)
                                         & (rank < self.rank))
        if extra_valid is not None:
            better = better & extra_valid
        self.error = torch.where(better, error, self.error)
        self.rank = torch.where(better, rank, self.rank)
        for k in self.payload:
            extra = self.payload[k].dim() - better.dim()
            b = better.reshape(better.shape + (1,) * extra)
            self.payload[k] = torch.where(b, payload[k], self.payload[k])


def _gather_cols(arr, col):
    """arr[n, col[n]]."""
    return arr.gather(1, col.long()[:, None])[:, 0]


def _lut(table, idx):
    """table[idx] for a small constant table."""
    return _i32(table, idx.device)[idx.long()]


# --- Single-plane search ------------------------------------------------------

def _single_plane_kernel_best(mode, pix, base, offset, seeds, parity_max,
                              alpha_s, pti_arr, masks, cfg, cw,
                              num_refine_rounds):
    """Pack the plan-valid (shape, tweak, parity) candidates of one mode
    into lanes and run bc7_kernel.single_plane_mode_best. Its winner reduce
    leaves each shape's winner on every lane of the shape's c_max-aligned
    segment, so consumers read shape s at lane s*c_max (col_stride) and
    unpack the two 4x8-bit endpoint words only on [N]-sized winners."""
    n = pix.shape[0]
    dev = pix.device
    lane_i, tweakf, c_max = bc7_kernel.single_plane_lanes(
        seeds, parity_max, cfg["index_range"], masks)
    if alpha_s is None:
        alpha_s = torch.zeros(base.shape[:2], dtype=F32, device=dev)
    pti = torch.zeros((n, 4), dtype=I32, device=dev)
    pti[:, :parity_max] = pti_arr.to(I32)
    err, rank, pk0, pk1 = bc7_kernel.single_plane_mode_best(
        mode, pix, base.contiguous(), offset.contiguous(),
        alpha_s.contiguous(), pti, _i32(lane_i, dev),
        torch.as_tensor(tweakf, device=dev), c_max, cfg, cw,
        num_refine_rounds)
    return LexBest(err, rank, {"eppk0": pk0, "eppk1": pk1}), c_max


def try_single_plane(pix, pixels, float_pixels, channel_weights, flags,
                     plan: BC7EncodingPlan, num_refine_rounds: int,
                     alpha_info: dict):
    """TrySinglePlane (BC67.cpp:1042-1662). Returns a list of mode-winner
    candidate dicts for the final cross-mode merge."""
    num_refine_rounds = max(num_refine_rounds, 1)
    cw = [np.float32(w) for w in channel_weights]
    cw_sq = [float(w * w) for w in cw]
    n = pix.shape[0]
    dev = pix.device
    has_alpha = alpha_info["has_non_max_alpha"]      # [N] bool
    allow_rgb = alpha_info["allow_rgb"]              # [N] bool
    is_punch_through = alpha_info["is_punch_through"]
    has_nonzero_alpha = alpha_info["has_non_zero_alpha"]

    fast_indexing = bool(flags & Flags.BC7_FAST_INDEXING)
    uniform = bool(flags & Flags.UNIFORM)
    try_single_color = bool(flags & Flags.BC7_TRY_SINGLE_COLOR)
    respect_punch_through = bool(flags & Flags.BC7_RESPECT_PUNCH_THROUGH)

    # --- Initial per-shape endpoints (BC67.cpp:1085-1144) ---
    rgb_ids = np.asarray(plan.rgb_shape_list, dtype=np.int32)
    rgba_ids = np.asarray(plan.rgba_shape_list, dtype=np.int32)
    all_masks = geom.shape_masks()
    rgb_base, rgb_offset, static_alpha_error_rgb = bc7_kernel.shape_pca(
        pix, _i32(bc7_kernel.shape_mask_bits(all_masks[rgb_ids]), dev), 3,
        cw, uniform, True)
    rgba4_base, rgba4_offset, _ = bc7_kernel.shape_pca(
        pix, _i32(bc7_kernel.shape_mask_bits(all_masks[rgba_ids]), dev), 4,
        cw, uniform, False)

    # RGBA endpoints: per lane, PCA4 when hasAlpha || !allowRGB, else
    # ExpandTo<4>(255) of the RGB line (BC67.cpp:1117-1143)
    use_pca4 = (has_alpha | ~allow_rgb)[:, None, None]
    rgb_col_of = np.full(243, -1, dtype=np.int32)
    rgb_col_of[rgb_ids] = np.arange(len(rgb_ids))
    rgba_from_rgb_cols = rgb_col_of[rgba_ids]
    # A shape can be in the RGBA list but not the RGB list (e.g. shape 0 at
    # quality<=50). The reference then expands an UNINITIALIZED RGB UFEP
    # (SinglePlaneTemporaries is stack garbage, BC67.cpp:803-812, expand at
    # :1142); under the zero-initialized oracle build this is a zero UFEP
    # (base=offset=0, alpha filled 255 by ExpandTo). Replicate that.
    missing = torch.as_tensor(rgba_from_rgb_cols < 0, device=dev)[None, :,
                                                                  None]
    safe_cols = torch.as_tensor(np.maximum(rgba_from_rgb_cols, 0),
                                dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    exp_b = torch.where(missing, zero, rgb_base[:, safe_cols])
    exp_o = torch.where(missing, zero, rgb_offset[:, safe_cols])
    exp_b[..., 3] = 255.0
    exp_o[..., 3] = 0.0
    rgba_base = torch.where(use_pca4, rgba4_base, exp_b)
    rgba_offset = torch.where(use_pca4, rgba4_offset, exp_o)

    mode_winners = []
    for mode_pos, mode in enumerate([0, 1, 2, 3, 6, 7]):
        info = MODE_INFO[mode]
        is_rgb = mode < 4
        num_subsets = info["num_subsets"]
        index_range = 1 << info["index_bits"]
        parity_max = {"per_ep": 4, "per_subset": 2}.get(info["pbit"], 1)

        # Mode shape list (BC67.cpp:1202-1226), plan-filtered
        if num_subsets == 1:
            mode_shape_list = geom.SHAPE_LIST_1
        elif num_subsets == 2:
            mode_shape_list = geom.SHAPE_LIST_2
        elif (1 << info["partition_bits"]) == 16:
            mode_shape_list = geom.SHAPE_LIST_3_SHORT
        else:
            mode_shape_list = geom.SHAPE_LIST_3

        seeds_all = (plan.seed_points_for_shape_rgb if is_rgb
                     else plan.seed_points_for_shape_rgba)
        shape_ids = np.asarray([s for s in mode_shape_list
                                if seeds_all[s] > 0], dtype=np.int32)
        if mode == 6 and not plan.mode6_enabled:
            shape_ids = shape_ids[:0]
        if shape_ids.size == 0:
            continue
        seeds = np.asarray([min(seeds_all[s], MAX_TWEAK_ROUNDS)
                            for s in shape_ids], dtype=np.int32)
        masks = all_masks[shape_ids]  # [S,16]

        # Per-shape unfinished endpoints for this mode's shape set
        if is_rgb:
            src_ids, src_base, src_offset = rgb_ids, rgb_base, rgb_offset
        else:
            src_ids, src_base, src_offset = rgba_ids, rgba_base, rgba_offset
        col_of = np.full(243, 0, dtype=np.int32)
        col_of[src_ids] = np.arange(len(src_ids))
        cols = torch.as_tensor(col_of[shape_ids], dtype=torch.long,
                               device=dev)
        base = src_base[:, cols]
        offset = src_offset[:, cols]

        # punchthrough invalidations per parity (BC67.cpp:1281-1303)
        pti = []
        for p_iter in range(parity_max):
            if respect_punch_through and mode in (6, 7):
                if p_iter == 0:
                    pti.append(is_punch_through & has_nonzero_alpha)
                elif p_iter == parity_max - 1:
                    pti.append(is_punch_through & has_alpha)
                else:
                    pti.append(is_punch_through)
            else:
                pti.append(torch.zeros((n,), dtype=torch.bool, device=dev))
        pti_arr = torch.stack(pti, dim=-1)  # [N,P]

        cfg = dict(fast_indexing=fast_indexing, uniform=uniform, cw_sq=cw_sq,
                   num_real_channels=3 if is_rgb else 4,
                   index_range=index_range)

        alpha_s = static_alpha_error_rgb[:, cols] if is_rgb else None
        best, col_stride = _single_plane_kernel_best(
            mode, pix, base, offset, seeds, parity_max, alpha_s, pti_arr,
            masks, cfg, cw, num_refine_rounds)

        # --- TrySingleColor (BC67.cpp:1435-1569) ---
        if try_single_color:
            _try_single_color(best, pixels, cw_sq, uniform, masks, alpha_s,
                              is_rgb, n, col_stride)

        # --- Partition combine (BC67.cpp:1571-1660) ---
        winner = _combine_partitions(mode, mode_pos, best, shape_ids, plan, n,
                                     has_alpha, allow_rgb, col_stride)
        if winner is not None:
            # Recompute the winner's pixel indexes from its endpoints: one
            # [N]-sized selector pass per subset (identical arithmetic to
            # the candidate search, BC67.cpp:1346-1363).
            owner = winner.pop("owner")
            zero_n = torch.zeros((n,), dtype=F32, device=dev)
            idx_by_subset = []
            for subset in range(num_subsets):
                sub_ep = [[winner["ep"][subset][epi][ch] for ch in range(4)]
                          for epi in range(2)]
                sel = IndexSelector(cw, sub_ep, index_range, 4)
                _, sub_idx = bc7_common.accumulate_error(
                    sel, zero_n, None, float_pixels, pixels, cfg,
                    keep_indexes=True)
                idx_by_subset.append(sub_idx)
            indexes = []
            for px in range(16):
                if num_subsets == 1:
                    indexes.append(idx_by_subset[0][px])
                else:
                    stack = torch.stack([idx_by_subset[s][px]
                                         for s in range(num_subsets)], dim=-1)
                    indexes.append(_gather_cols(stack, owner[px]))
            winner["indexes"] = indexes
            mode_winners.append(winner)

    return mode_winners


def _try_single_color(best, pixels, cw_sq, uniform, masks, alpha_s, is_rgb,
                      n, col_stride):
    """TrySingleColorRGBAMultiTable per shape (BC67.cpp:940-1040).

    `best` carries per-shape values replicated over col_stride-lane
    segments; the candidate is evaluated on the same width so the update
    stays elementwise.

    The reference's table-selection loop NEVER commits a candidate: the
    update gate is `better = AndNot(pti, better)` (BC67.cpp:1002-1003), and
    AndNot(a, b) computes a & ~b in both builds (ParallelMath.h:901, :1648)
    -- the arguments are swapped at this one call site, so the gate is
    false for every table. The effective single-color candidate is
    therefore always the INITIAL state: black endpoints/reconstruction
    with alpha 255 and index 0 (BC67.cpp:951-961).
    """
    dev = best.error.device
    num_real_channels = 3 if is_rgb else 4
    w_cols = best.error.shape[1]
    masks_w = np.repeat(masks, col_stride, axis=0)  # [w_cols, 16]
    assert masks_w.shape[0] == w_cols

    recon = [0, 0, 0, 255]
    agg = [torch.zeros((n, w_cols), dtype=I32, device=dev) for _ in range(4)]
    for px in range(16):
        m = torch.as_tensor(masks_w[:, px], device=dev)[None, :]
        for ch in range(num_real_channels):
            sq = lanes.sq_diff_int(recon[ch], pixels[px][ch][:, None])
            agg[ch] = agg[ch] + torch.where(m, sq, torch.zeros_like(sq))
    if uniform:
        tot = agg[0]
        for e in agg[1:]:
            tot = tot + e
        error = lanes.to_float(tot)
    else:
        error = lanes.to_float(agg[0]) * cw_sq[0]
        for ch in range(1, 4):
            error = error + lanes.to_float(agg[ch]) * cw_sq[ch]

    if is_rgb:
        error = error + alpha_s.repeat_interleave(col_stride, dim=1)

    # single-color candidates come after all tweak/parity candidates; black
    # ep0==ep1 endpoints make the post-combine index recompute reproduce
    # the reference's index 0
    # endpoint word of (0, 0, 0, 255): 255 << 24 as an int32
    pk = torch.full((n, w_cols), (255 << 24) - (1 << 32), dtype=I32,
                    device=dev)
    rank = torch.full((n, w_cols), BIG_RANK - 1, dtype=I32, device=dev)
    best.update(error, rank, {"eppk0": pk, "eppk1": pk})


def _combine_partitions(mode, mode_pos, best, shape_ids, plan, n, has_alpha,
                        allow_rgb, col_stride):
    """Per-partition error combine + winner materialization
    (BC67.cpp:1571-1660). Shape s is read at column s * col_stride."""
    info = MODE_INFO[mode]
    num_subsets = info["num_subsets"]
    num_partitions = 1 << info["partition_bits"]
    is_rgb = mode < 4
    dev = best.error.device

    col_of = np.full(243, -1, dtype=np.int32)
    col_of[shape_ids] = np.arange(len(shape_ids)) * col_stride

    if mode in (0, 1, 2, 3):
        enabled_bits = [plan.mode0_partition_enabled,
                        plan.mode1_partition_enabled,
                        plan.mode2_partition_enabled,
                        plan.mode3_partition_enabled][mode]
    elif mode == 6:
        enabled_bits = 1 if plan.mode6_enabled else 0
    else:
        # mode 7: the reference's combine loop iterates ALL partitions due to
        # assigning the wrong variable (BC67.cpp:1590-1597 writes
        # partitionEnabledBits, not partitionsEnabledBits) — replicated.
        enabled_bits = (1 << num_partitions) - 1

    def shapes_of(p):
        if num_subsets == 1:
            return [0]
        if num_subsets == 2:
            return [int(geom.SHAPES_2[p][k]) for k in range(2)]
        return [int(geom.SHAPES_3[p][k]) for k in range(3)]

    # keep only enabled partitions whose shapes were all evaluated
    parts = [p for p in range(num_partitions)
             if (enabled_bits >> p) & 1
             and all(col_of[s] >= 0 for s in shapes_of(p))]
    if not parts:
        return None

    table = np.asarray([[col_of[s] for s in shapes_of(p)] for p in parts],
                       dtype=np.int64)  # [parts, subsets]
    cols_t = torch.as_tensor(table, device=dev)
    total_error = best.error[:, cols_t[:, 0]]
    for k in range(1, num_subsets):
        total_error = total_error + best.error[:, cols_t[:, k]]

    # per-lane validity (scalar-build semantics)
    valid = torch.ones((n, 1), dtype=torch.bool, device=dev)
    if is_rgb:
        valid = valid & allow_rgb[:, None]
    if mode == 7 and plan.mode7_rgb_partition_enabled == 0:
        # In the scalar build the in-loop RGB-partition filter
        # (BC67.cpp:1625-1635) is a no-op; the only per-lane gate is
        # whether mode 7 ran: allowMode7 = hasAlpha || mode7RGBPartitionEnabled.
        valid = valid & has_alpha[:, None]

    cand = torch.where(valid, total_error, torch.full((), INF, device=dev))
    err, win = lanes.lex_min_with_index(cand, 1)
    win_part = _lut(parts, win)

    # materialize winner payload
    zero = torch.zeros((n,), dtype=I32, device=dev)
    ep = [[[zero for _ in range(4)] for _ in range(2)] for _ in range(3)]
    for subset in range(num_subsets):
        c = _lut(table[:, subset], win)
        for epi in range(2):
            pk = _gather_cols(best.payload[f"eppk{epi}"], c)
            for ch in range(4):
                ep[subset][epi][ch] = (pk >> (8 * ch)) & 0xFF

    # owning subset of each pixel
    if num_subsets == 1:
        owner = [zero] * 16
    elif num_subsets == 2:
        pmap = _lut(geom.PARTITION_MAP_2, win_part)
        owner = [(pmap >> px) & 1 for px in range(16)]
    else:
        pmap = torch.as_tensor(geom.PARTITION_MAP_3, device=dev)[
            win_part.long()]
        owner = [((pmap >> (2 * px)) & 3).to(I32) for px in range(16)]

    rank = mode_pos * 64 + win_part
    return dict(mode=mode, error=err, rank=rank, partition=win_part, ep=ep,
                owner=owner)


# --- Dual-plane search (modes 4/5) -------------------------------------------

def _dual_plane_combos(plan: BC7EncodingPlan):
    """Plan-valid (mode, rotation, index-selector) combos in the
    reference's visitation (sequence) order (BC67.cpp:1664-1758)."""
    combos = []
    seq = 0
    for mode in (4, 5):
        for rotation in range(4):
            num_sp = (list(plan.mode4_sp[rotation]) if mode == 4
                      else [plan.mode5_sp[rotation]] * 2)
            if num_sp[0] == 0 and num_sp[1] == 0:
                seq += (2 if mode == 4 else 1)
                continue
            max_isel = 2 if mode == 4 else 1
            for isel in range(max_isel):
                this_seq = seq
                seq += 1
                if num_sp[isel] <= 0:
                    continue
                combos.append(dict(mode=mode, rot=rotation, isel=isel,
                                   num_tweak=min(num_sp[isel],
                                                 MAX_TWEAK_ROUNDS),
                                   seq=this_seq))
    return combos


def _dual_plane_kernel_candidates(pix, channel_weights, flags,
                                  plan: BC7EncodingPlan,
                                  num_refine_rounds: int):
    """TryDualPlane (BC67.cpp:1664-1965) via bc7_kernel.dual_plane_best;
    per-combo winner selection over the 4 tweak lanes happens here."""
    combos = _dual_plane_combos(plan)
    if not combos:
        return []
    n = pix.shape[0]
    dev = pix.device
    t_cap = MAX_TWEAK_ROUNDS
    ci, cf = bc7_kernel.dual_plane_consts(
        combos, [np.float32(w) for w in channel_weights])
    out = bc7_kernel.dual_plane_best(
        pix, torch.as_tensor(ci, device=dev), torch.as_tensor(cf, device=dev),
        num_refine_rounds, bool(flags & Flags.UNIFORM),
        bool(flags & Flags.BC7_FAST_INDEXING))
    q_count = len(combos)

    def reduce4(err, rank, payload):
        """Per-combo (error, rank) lex winner over the 4 tweak lanes (the
        winner lane is unique because ranks differ per lane). payload is
        [N, C, L]; returns [N, Q] error and [N, C, Q] payload."""
        e = err.view(n, q_count, t_cap)
        r = rank.view(n, q_count, t_cap)
        m = torch.amin(e, dim=-1)
        at_min = e == m[..., None]
        rm = torch.amin(torch.where(at_min, r, torch.full_like(r, BIG_RANK)),
                        dim=-1)
        sel = at_min & (r == rm[..., None])
        g = payload.view(n, payload.shape[1], q_count, t_cap)
        v = g[..., 0]
        for j in range(1, t_cap):
            v = torch.where(sel[:, None, :, j], g[..., j], v)
        return m, v

    rgb_err_q, rgb_pl = reduce4(out["rgb_err"], out["rgb_rank"],
                                torch.cat([out["rgb_ep"], out["rgb_idx"]], 1))
    a_err_q, a_pl = reduce4(out["a_err"], out["a_rank"],
                            torch.cat([out["a_ep"], out["a_idx"]], 1))

    zero = torch.zeros((n,), dtype=I32, device=dev)
    candidates = []
    for q, cb in enumerate(combos):
        ep = [[[zero for _ in range(4)] for _ in range(2)] for _ in range(3)]
        for epi in range(2):
            for ch in range(3):
                ep[0][epi][ch] = rgb_pl[:, epi * 3 + ch, q]
            ep[0][epi][3] = a_pl[:, epi, q]
        rgb_indexes = [rgb_pl[:, 6 + px, q] for px in range(16)]
        alpha_indexes = [a_pl[:, 2 + px, q] for px in range(16)]
        # work.m_indexes gets alpha when indexSelector else RGB
        # (BC67.cpp:1950-1954)
        if cb["isel"]:
            indexes, indexes2 = alpha_indexes, rgb_indexes
        else:
            indexes, indexes2 = rgb_indexes, alpha_indexes
        candidates.append(dict(
            mode=cb["mode"], error=rgb_err_q[:, q] + a_err_q[:, q],
            rank=8 * 64 + cb["seq"], partition=None, ep=ep, indexes=indexes,
            indexes2=indexes2, rotation=cb["rot"], isel=cb["isel"]))
    return candidates


# --- Top level ----------------------------------------------------------------

def pack(pixels_u8, flags: int, channel_weights, plan: BC7EncodingPlan,
         num_refine_rounds: int):
    """BC7Computer::Pack (BC67.cpp:1975-2204): uint8 [N, 16, 4] pixels on
    any device -> uint8 [N, 16] blocks on that device."""
    p = pixels_u8.to(I32)
    n = p.shape[0]
    dev = p.device
    pix = p.reshape(n, 64).contiguous()

    pixels = [[p[:, px, ch] for ch in range(4)] for px in range(16)]
    float_pixels = [[lanes.to_float(c) for c in row] for row in pixels]

    # alpha classification (BC67.cpp:1054-1078), per lane (scalar semantics)
    alpha = p[:, :, 3]
    max_alpha = torch.amax(alpha, dim=1)
    min_alpha = torch.amin(alpha, dim=1)
    is_pt = ((alpha == 0) | (alpha == 255)).all(dim=1)
    alpha_info = dict(
        has_non_max_alpha=min_alpha < 255,
        has_non_zero_alpha=max_alpha > 0,
        allow_rgb=min_alpha > 250,
        is_punch_through=is_pt,
    )

    sp = try_single_plane(pix, pixels, float_pixels, channel_weights, flags,
                          plan, num_refine_rounds, alpha_info)
    dp = _dual_plane_kernel_candidates(pix, channel_weights, flags, plan,
                                       max(num_refine_rounds, 1))

    # merge all candidates lexicographically (= the reference's sequential
    # strict-improvement update over TrySinglePlane then TryDualPlane)
    zero = torch.zeros((n,), dtype=I32, device=dev)
    work = dict(
        error=torch.full((n,), lanes.FLT_MAX, dtype=F32, device=dev),
        rank=torch.full((n,), BIG_RANK, dtype=I32, device=dev),
        mode=zero, partition=zero, rotation=zero, isel=zero,
        ep=[[[zero for _ in range(4)] for _ in range(2)] for _ in range(3)],
        indexes=[zero] * 16, indexes2=[zero] * 16,
    )

    def where(better, value, current):
        if not torch.is_tensor(value):
            value = torch.full_like(current, value)
        return torch.where(better, value, current)

    for cand in sp + dp:
        rank = cand["rank"]
        if not torch.is_tensor(rank):
            rank = torch.full((n,), rank, dtype=I32, device=dev)
        better = (cand["error"] < work["error"]) | (
            (cand["error"] == work["error"]) & (rank < work["rank"]))
        work["error"] = torch.where(better, cand["error"], work["error"])
        work["rank"] = torch.where(better, rank, work["rank"])
        work["mode"] = where(better, cand["mode"], work["mode"])
        if cand.get("partition") is not None:
            work["partition"] = where(better, cand["partition"],
                                      work["partition"])
        # reference: m_partition and m_isr share a union; dual-plane writes
        # rotation/isel into the same storage
        if "rotation" in cand:
            work["isel"] = where(better, cand["isel"], work["isel"])
            work["rotation"] = where(better, cand["rotation"],
                                     work["rotation"])
            work["partition"] = where(better, 0, work["partition"])
        else:
            work["isel"] = where(better, 0, work["isel"])
            work["rotation"] = where(better, 0, work["rotation"])
        for s in range(3):
            for e in range(2):
                for ch in range(4):
                    work["ep"][s][e][ch] = torch.where(
                        better, cand["ep"][s][e][ch], work["ep"][s][e][ch])
        for px in range(16):
            work["indexes"][px] = torch.where(
                better, cand["indexes"][px], work["indexes"][px])
            i2 = cand.get("indexes2")
            if i2 is not None:
                work["indexes2"][px] = torch.where(
                    better, i2[px], work["indexes2"][px])

    return _pack_bits(work, n)


# --- Bit packing (BC67.cpp:2003-2203) -----------------------------------------

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
            fix1 = _lut(geom.FIXUP_INDEXES_2, partition)
            fix2 = zero
        elif num_subsets == 3:
            fix1 = _lut(geom.FIXUP_INDEXES_3[:, 0], partition)
            fix2 = _lut(geom.FIXUP_INDEXES_3[:, 1], partition)
        else:
            fix1 = fix2 = zero

        # owner subset per pixel
        if num_subsets == 2:
            pmap = _lut(geom.PARTITION_MAP_2, partition)
            owner = [(pmap >> px) & 1 for px in range(16)]
        elif num_subsets == 3:
            pmap = torch.as_tensor(geom.PARTITION_MAP_3, device=dev)[
                partition.long()]
            owner = [((pmap >> (2 * px)) & 3).to(I32) for px in range(16)]
        else:
            owner = [zero] * 16

        hi_idx = (1 << ib) - 1
        stack = torch.stack(indexes, dim=-1)
        flips = []
        for subset, fx in enumerate((zero, fix1, fix2)):
            if subset < num_subsets:
                flips.append((_gather_cols(stack, fx) & (1 << (ib - 1))) != 0)
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
