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
inputs, combines partitions and recomputes the winners' indexes; the bits
are packed by bc7_kernel.bc7_pack (csrc/bc7_pack.cu on the card,
_pack_bits on the CPU). Float32 semantics follow the scalar reference
build (ops/lanes.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib, programs
from ..bc7_plan import BC7EncodingPlan
from ..ops import lanes
from ..ops.index_select import IndexSelector
from ..ops.lanes import BIG_RANK, F32, I32, INF, LexBest
from ..options import Flags
from ..programs import i32, lut
from ..tables import bc7_geometry as geom
from . import bc7_common, bc7_kernel
from .bc7_common import MAX_TWEAK_ROUNDS, MODE_INFO


def _gather_cols(arr, col):
    """arr[n, col[n]]."""
    return arr.gather(1, col.long()[:, None])[:, 0]


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
        alpha_s.contiguous(), pti, i32(lane_i, dev),
        programs.constant(tweakf, dev), c_max, cfg, cw,
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
        pix, i32(bc7_kernel.shape_mask_bits(all_masks[rgb_ids]), dev), 3,
        cw, uniform, True)
    rgba4_base, rgba4_offset, _ = bc7_kernel.shape_pca(
        pix, i32(bc7_kernel.shape_mask_bits(all_masks[rgba_ids]), dev), 4,
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
    missing = programs.constant(rgba_from_rgb_cols < 0, dev)[None, :, None]
    safe_cols = programs.constant(np.maximum(rgba_from_rgb_cols, 0), dev,
                                  np.int64)
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
        cols = programs.constant(col_of[shape_ids], dev, np.int64)
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
        m = programs.constant(masks_w[:, px], dev)[None, :]
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
    cols_t = programs.constant(table, dev)
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
    win_part = lut(parts, win)

    # materialize winner payload
    zero = torch.zeros((n,), dtype=I32, device=dev)
    ep = [[[zero for _ in range(4)] for _ in range(2)] for _ in range(3)]
    for subset in range(num_subsets):
        c = lut(table[:, subset], win)
        for epi in range(2):
            pk = _gather_cols(best.payload[f"eppk{epi}"], c)
            for ch in range(4):
                ep[subset][epi][ch] = (pk >> (8 * ch)) & 0xFF

    # owning subset of each pixel
    if num_subsets == 1:
        owner = [zero] * 16
    elif num_subsets == 2:
        pmap = lut(geom.PARTITION_MAP_2, win_part)
        owner = [(pmap >> px) & 1 for px in range(16)]
    else:
        pmap = programs.constant(geom.PARTITION_MAP_3, dev)[
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
        pix, programs.constant(ci, dev), programs.constant(cf, dev),
        num_refine_rounds, bool(flags & Flags.UNIFORM),
        bool(flags & Flags.BC7_FAST_INDEXING),
        bc7_kernel.dual_plane_work(ci, cf, dev))
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
    if dev.type == "cuda":
        cuda_lib.build_all(bc7_kernel.LIBRARIES)   # the nvcc runs at once
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

    return bc7_kernel.bc7_pack(bc7_kernel.pack_fields(work))
