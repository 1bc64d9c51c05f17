"""ETC1, ETC2 (RGB, punchthrough), ETC2 alpha and EAC11 encoders.

The PyTorch counterpart of the JAX package's models/etc.py, itself the
batched form of the reference's ETCComputer (ConvectionKernels_ETC.cpp).
Every function works on N blocks at once on the blocks' device; per-lane
branching is `torch.where`.

- ETC1 evaluates every (table, offset) candidate of a half block as tensor
  axes: the differential and individual quantizers on the run-deduplicated
  slot axis (ETC1_RUN_BOUNDS), FakeBT709 on the dense [8, 81] axis. The
  pixels of a half block and the three channels are tensor axes too.
- The differential pair resolve (FindBestDifferentialCombination) is a
  masked pair argmin over per-table row chunks, [N, K_t, A] at a time,
  that keeps the reference scan's fast path, first achiever and
  re-acceptance of equal-total ties (_resolve_differential).
- The alpha and EAC11 search is one [N, 16, 320] candidate grid (table x
  range x multiplier, pixels an axis) with a first-occurrence argmin.
- ETC2's T and H scans put the 8 tables x 33 premultiplier offsets on one
  table-major candidate axis beside the 16 pixels; the H pair totals are
  one [N, 8, 33, 33] grid. The planar fit's three channels are an axis.

Candidate visitation order and float32 operation order follow the JAX
package, so the bytes equal its op-by-op bytes. A float32 sum over pixels
stays a chain of adds in the reference's order; a three-channel error is
(d0 * d0 + d1 * d1) + d2 * d2; integer sums are one `torch.sum`. Integers
are int32 throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import programs
from ..ops import lanes
from ..ops.exact_math import exact_divide, exact_sqrt
from ..ops.lanes import F32, FLT_MAX, I32, INF
from ..options import Flags, Options
from ..programs import i32
from ..tables import etc_tables

FLIP_TABLES = np.array([
    [[0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15]],
    [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15]],
], dtype=np.int32)  # g_flipTables (ETC.cpp:47-57)

RANK_NONE = 2**30

PIXEL_SELECTOR_ORDER = np.array([0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7,
                                 11, 15], dtype=np.int32)
MODIFIER_CODES = np.array([3, 2, 0, 1], dtype=np.int32)


def _f32(v):
    """A Python float holding float32(v): torch multiplies a float32 tensor
    by it in float32, as JAX multiplies by an np.float32."""
    return float(np.float32(v))


def _weights(options: Options):
    return [np.float32(options.red_weight), np.float32(options.green_weight),
            np.float32(options.blue_weight)]


def convert_to_fake_bt709(rgb):
    """ConvertToFakeBT709 (ETC.cpp:2337-2347) on channels stacked on dim 1."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    y = (r * _f32(0.368233989135369) + g * _f32(1.23876274963149)
         + b * _f32(0.125054068802017))
    u = r * _f32(0.5) - g * _f32(0.4541529) - b * _f32(0.04584709)
    v = (r * _f32(-0.081014709086133) - g * _f32(0.272538676238785)
         + b * _f32(0.353553390593274))
    return torch.stack([y, u, v], dim=1)


def convert_from_fake_bt709(yuv):
    """ConvertFromFakeBT709 (ETC.cpp:2349-2359) on channels stacked on
    dim 1."""
    yy = yuv[:, 0] * _f32(0.57735026466774571071)
    u, v = yuv[:, 1], yuv[:, 2]
    r = yy + u * _f32(1.5748000207960953486)
    g = (yy - u * _f32(0.46812425854364753669)
         - v * _f32(0.26491652528157560861))
    b = yy + v * _f32(2.6242146882856944069)
    return torch.stack([r, g, b], dim=1)


def _channel_view(t, ndim):
    """t [3] viewed to broadcast against a tensor of `ndim` dims whose
    channel axis is dim 1."""
    return t.view([1, 3] + [1] * (ndim - 2))


def recon_terms(recon, options: Options):
    """The float32 reconstruction a candidate's error is taken against:
    the FakeBT709 transform, the value itself (uniform) or the value times
    the channel weight. recon: int32, channels on dim 1."""
    r = lanes.to_float(recon)
    if options.flags & Flags.ETC_USE_FAKE_BT709:
        return convert_to_fake_bt709(r)
    if options.flags & Flags.UNIFORM:
        return r
    w = programs.constant(_weights(options), recon.device, np.float32)
    return r * _channel_view(w, r.dim())


def error_from_terms(terms, pw):
    """(d0 * d0 + d1 * d1) + d2 * d2 with d = terms - pw, channels on dim 1.

    The uniform error squares pixel - recon, and the FakeBT709 and
    weighted ones recon - pw: the squares are the same bits, and
    to_float(pixel - recon) is exact for 8-bit values."""
    d = terms - pw
    d.mul_(d)
    err = d[:, 0] + d[:, 1]
    return err.add_(d[:, 2])


def compute_error(recon, pw, options: Options):
    """ComputeError{Uniform,Weighted,FakeBT709} (ETC.cpp:59-92): recon
    int32, pw float32 (the uniform preweighted pixels are the pixels),
    channels on dim 1."""
    return error_from_terms(recon_terms(recon, options), pw)


def extract_blocks(pixels_u8, options: Options):
    """ExtractBlocks (ETC.cpp:2128-2155): int32 pixels [N, 16, 3] and the
    preweighted float32 pixels [N, 16, 3]."""
    pixels = pixels_u8[:, :, :3].to(I32)
    p = lanes.to_float(pixels)
    if options.flags & Flags.ETC_USE_FAKE_BT709:
        pw = convert_to_fake_bt709(p.transpose(1, 2)).transpose(1, 2)
    elif options.flags & Flags.UNIFORM:
        pw = p
    else:
        w = programs.constant(_weights(options), p.device, np.float32)
        pw = p * w
    return pixels, pw.contiguous()


class StageBest:
    """Cross-stage winner: (error, stage-rank) lexicographic minimum over
    emitted 64-bit blocks (hi/lo 32-bit words)."""

    def __init__(self, n, device):
        self.error = torch.full((n,), FLT_MAX, dtype=F32, device=device)
        self.rank = torch.full((n,), RANK_NONE, dtype=I32, device=device)
        self.hi = torch.zeros((n,), dtype=I32, device=device)
        self.lo = torch.zeros((n,), dtype=I32, device=device)
        self.lane_mask = None  # per-lane gate for subsequent updates

    def update(self, error, rank: int, hi, lo, valid=None):
        better = (error < self.error) | ((error == self.error)
                                         & (rank < self.rank))
        if valid is not None:
            better = better & valid
        if self.lane_mask is not None:
            better = better & self.lane_mask
        self.error = torch.where(better, error, self.error)
        self.rank = torch.where(better, torch.full_like(self.rank, rank),
                                self.rank)
        self.hi = torch.where(better, hi, self.hi)
        self.lo = torch.where(better, lo, self.lo)

    def reset_where(self, mask):
        """ConditionalSet(bestError, mask, FLT_MAX): punchthrough restart."""
        self.error = torch.where(mask, torch.full_like(self.error, FLT_MAX),
                                 self.error)
        self.rank = torch.where(mask, torch.full_like(self.rank, RANK_NONE),
                                self.rank)

    def to_bytes(self):
        return words_to_bytes(torch.stack([self.hi, self.lo], dim=1))


def words_to_bytes(words):
    """int32 [N, W] big-endian words -> uint8 [N, 4 W]."""
    shifts = i32([24, 16, 8, 0], words.device)
    out = (words[:, :, None] >> shifts) & 0xFF
    return out.reshape(words.shape[0], -1).to(torch.uint8)


# --- ETC1 search ---------------------------------------------------------------

def _padded_offsets():
    """[8, 81] offsets per table, short tables padded with their last value
    (padding duplicates produce identical candidates, which is harmless)."""
    out = np.zeros((8, etc_tables.MAX_POTENTIAL_OFFSETS), dtype=np.int32)
    counts = np.zeros(8, dtype=np.int32)
    for t in range(8):
        offs = etc_tables.potential_offsets(t)
        counts[t] = len(offs)
        out[t, :len(offs)] = offs
        out[t, len(offs):] = offs[-1]
    return out, counts


def _quantize_etc1_base(cu, differential: bool):
    """Quantize candidate base colors (ETC.cpp:2718-2735). cu: int32 0..2040."""
    if differential:
        return ((cu << 5) - cu + (cu >> 3) + 1024) >> 11
    return ((cu << 5) - (cu << 1) + (cu >> 3) + 2048) >> 12


# Run-deduplicated candidate slot axis (the JAX package's ETC1_RUN_BOUNDS,
# re-derived by tests/test_etc.py::test_etc1_run_bounds): within a table,
# each channel's quantized base is monotone in the offset, so consecutive
# offsets collapse into runs of one color, and error and selectors depend
# only on (table, color). At most K_t runs occur in table t, so a static
# [sum(K)] slot axis in (table, run) order replaces the dense [8 * 81] one:
# 286 slots with the differential quantizer, 175 with the individual one.
ETC1_RUN_BOUNDS = {
    True: (7, 14, 23, 31, 42, 48, 45, 76),   # differential quantizer
    False: (4, 7, 13, 16, 23, 29, 37, 46),   # individual quantizer
}
_EMPTY_COLOR = 1 << 15  # packed colors are 15-bit; sentinel above


def _slot_layout(differential: bool):
    """(run bounds, per-slot table ids [A], per-slot modifier rows [A,4])."""
    kb = ETC1_RUN_BOUNDS[differential]
    slot_tables = np.repeat(np.arange(8, dtype=np.int32), kb)
    mods_a = np.repeat(np.asarray(etc_tables.ETC1_MODIFIER_TABLES,
                                  dtype=np.int32), kb, axis=0)
    return kb, slot_tables, mods_a


def _candidate_colors(cum, quantize):
    """Packed 15-bit candidate base colors [N, 8, 81] of a half block:
    cum [N, 3] int32 channel sums of its 8 pixels, each (table, offset)
    quantized by `quantize` (int32 [N, 3, 8, 81] -> the 3 channels)."""
    offsets = i32(_padded_offsets()[0], cum.device)
    cu = torch.clamp(cum[:, :, None, None] + offsets, 0, 2040)
    q = quantize(cu)
    return q[0] | (q[1] << 5) | (q[2] << 10)


def _etc1_candidates_dedup(cum, sector_pw, differential: bool,
                           options: Options):
    """One (flip, sector, d) candidate set on the run-slot axis.

    cum: int32 [N, 3] channel sums of the 8 sector pixels; sector_pw
    [N, 8, 3] float32 their preweighted values. Returns (error, color,
    selectors, table), each [N, A] with A = sum(ETC1_RUN_BOUNDS[differential])
    slots in (table, run) order, the reference's deduplicated visitation
    order. Empty slots carry INF error and color 0, so they can never win a
    reduction nor be chosen as a differential partner.
    """
    dev = cum.device
    kb, slot_tables, mods_a = _slot_layout(differential)
    packed = _candidate_colors(cum, lambda cu: _quantize_etc1_base(
        cu, differential).unbind(1))                      # [N, 8, 81]
    n, _, width = packed.shape

    # per-table run ids (prefix count of color changes); a run's offsets
    # all carry its color, so writing each offset's color at its run's
    # slot leaves the run color there, and runs past K_t are dropped as
    # the JAX package's masked min drops them
    prev = torch.cat([torch.full((n, 8, 1), -1, dtype=I32, device=dev),
                      packed[:, :, :-1]], dim=-1)
    u = torch.cumsum((packed != prev).to(I32), dim=-1, dtype=I32) - 1
    runs = torch.full((n, 8, width), _EMPTY_COLOR, dtype=I32, device=dev)
    runs.scatter_(2, u.long(), packed)
    slots = i32(np.concatenate([t * width + np.arange(k)
                                for t, k in enumerate(kb)]), dev)
    ucolor = runs.reshape(n, -1).index_select(1, slots)   # [N, A]
    is_empty = ucolor == _EMPTY_COLOR
    ucolor = torch.where(is_empty, torch.zeros_like(ucolor), ucolor)

    error, selectors = _test_half_block_flat(
        ucolor, sector_pw, mods_a, differential, options)
    error = torch.where(is_empty, torch.full_like(error, INF), error)
    table = i32(slot_tables, dev).expand(n, -1)
    return error, ucolor, selectors, table


def _unquantize(packed, differential: bool):
    """The 3 channels of packed 5-5-5 (or 4-4-4 in 5-bit fields) colors,
    expanded to 8 bits, stacked on dim 1."""
    shifts = _channel_view(i32([0, 5, 10], packed.device), packed.dim() + 1)
    q = (packed.unsqueeze(1) >> shifts) & 31
    if differential:
        return (q << 3) | (q >> 2)
    return (q << 4) | q


def _selector_bits(sel, px_dim):
    """OR over the pixel axis `px_dim` (8 or 16 pixels) of 2-bit
    sel << (2 * px); bit 31 wraps into the sign as the reference's uint32
    does."""
    shape = [1] * sel.dim()
    shape[px_dim] = sel.shape[px_dim]
    shifts = (2 * torch.arange(sel.shape[px_dim], dtype=I32,
                               device=sel.device)).view(shape)
    return torch.sum(sel << shifts, dim=px_dim, dtype=I32)


def _test_half_block(packed, sector_pw, modifiers, differential: bool,
                     options: Options):
    """TestHalfBlock (ETC.cpp:94-149) on the dense candidate axes.

    packed: int32 [N, T, C]; sector_pw [N, 8, 3] float32; modifiers:
    [T, 4]. Returns (error [N, T, C] float32, selectors [N, T, C] int32).
    The pixels stay a loop: the per-pixel grids are [N, 4, T, C] (a pixel
    axis would make them 8 times that).
    """
    mods = i32(np.asarray(modifiers).T, packed.device)   # [4, T]
    unquant = _unquantize(packed, differential)            # [N, 3, T, C]
    modified = torch.clamp(unquant[:, :, None] + mods[None, None, :, :, None],
                           0, 255)                         # [N, 3, 4, T, C]
    terms = recon_terms(modified, options)
    selectors = None
    total_error = None
    for px in range(8):
        err = error_from_terms(terms, sector_pw[:, px, :, None, None, None])
        # per-pixel best selector: strict-less, first wins == ordered argmin
        sel = lanes.first_argmin(err, 1)
        best = torch.amin(err, dim=1)
        total_error = best if total_error is None else total_error + best
        s = sel << (px * 2)
        selectors = s if selectors is None else selectors | s
    return total_error, selectors


def _test_half_block_flat(packed, sector_pw, mods_a, differential: bool,
                          options: Options):
    """_test_half_block on a flat candidate axis with per-slot modifier
    rows: packed [N, A] int32, mods_a [A, 4]. The same arithmetic in the
    same order, with the 8 pixels a tensor axis ([N, 3, 4, 8, A] grids) and
    the error total a chain over them."""
    mods = i32(np.asarray(mods_a).T, packed.device)       # [4, A]
    unquant = _unquantize(packed, differential)            # [N, 3, A]
    modified = torch.clamp(unquant[:, :, None, :] + mods, 0, 255)
    terms = recon_terms(modified, options)[:, :, :, None, :]
    pw = sector_pw.transpose(1, 2)[:, :, None, :, None]    # [N, 3, 1, 8, 1]
    err = error_from_terms(terms, pw)                      # [N, 4, 8, A]
    best, sel = lanes.lex_min_with_index(err, 1)           # [N, 8, A] each
    total_error = best[:, 0]
    for px in range(1, 8):
        total_error = total_error + best[:, px]
    return total_error, _selector_bits(sel, 1)


def _unique_rank(colors, table_axis_len: int, per_table: int):
    """Unique-attempt index per lane in the reference's deduplicated
    storage order: prefix count of color-change flags, a table's first
    entry always new. colors: int32 [N, T * C] in (table, offset) order."""
    n = colors.shape[0]
    flat = colors.reshape(n, table_axis_len, per_table)
    prev = torch.cat([torch.full((n, table_axis_len, 1), -1, dtype=I32,
                                 device=colors.device), flat[:, :, :-1]],
                     dim=-1)
    is_new = (flat != prev).to(I32).reshape(n, -1)
    return torch.cumsum(is_new, dim=-1, dtype=I32) - 1


def _sector_data(pixels, pw, flip: int):
    """(pw [N, 8, 3], channel sums [N, 3]) of each sector of `flip`."""
    out = []
    for sector in range(2):
        idx = i32(FLIP_TABLES[flip][sector], pixels.device)
        out.append((pw.index_select(1, idx),
                    torch.sum(pixels.index_select(1, idx), dim=1, dtype=I32)))
    return out


def compress_etc1_internal(stage: StageBest, rank_base: int, pixels, pw,
                           options: Options, punchthrough_min_d: bool):
    """CompressETC1BlockInternal (ETC.cpp:2624-2882): pixels [N, 16, 3]
    int32, pw [N, 16, 3] float32."""
    n, dev = pixels.shape[0], pixels.device
    c_count = etc_tables.MAX_POTENTIAL_OFFSETS
    modifiers = np.asarray(etc_tables.ETC1_MODIFIER_TABLES)
    fake = bool(options.flags & Flags.ETC_USE_FAKE_BT709)
    accurate = bool(options.flags & Flags.ETC_FAKE_BT709_ACCURATE)

    for flip in range(2):
        sectors = _sector_data(pixels, pw, flip)
        ind_best = [None, None]   # per-sector individual-mode best
        diff_data = [None, None]  # per-sector differential candidates

        for d in range(1 if punchthrough_min_d else 0, 2):
            for sector in range(2):
                spw, cum = sectors[sector]
                if not fake:
                    # on the run-slot axis every attempt is unique, so the
                    # visitation rank is the slot position
                    error, colors, selectors, tables_b = \
                        _etc1_candidates_dedup(cum, spw, d == 1, options)
                    kb = ETC1_RUN_BOUNDS[d == 1]
                    urank = torch.arange(error.shape[1], dtype=I32,
                                         device=dev).expand(n, -1)
                    row_chunks = tuple(
                        (int(s), int(s + k))
                        for s, k in zip(np.cumsum((0,) + kb[:-1]), kb))
                else:
                    # FakeBT709's octant-corrected quantizer is not
                    # run-structured in the offset: the dense axis
                    packed = _candidate_colors(
                        cum, lambda cu: _resolve_fake_bt709_rounding(
                            cu.unbind(1), d == 1, accurate))
                    error, selectors = _test_half_block(
                        packed, spw, modifiers, d == 1, options)
                    colors = packed.reshape(n, -1)
                    tables_b = i32(np.repeat(np.arange(8), c_count),
                                   dev).expand(n, -1)
                    error = error.reshape(n, -1)
                    selectors = selectors.reshape(n, -1)
                    urank = _unique_rank(colors, 8, c_count)
                    row_chunks = tuple((t * c_count, (t + 1) * c_count)
                                       for t in range(8))

                if d == 0:
                    # individual: per-sector lex-argmin in (table, offset)
                    # order
                    win = lanes.first_argmin(error, -1)
                    ind_best[sector] = dict(
                        error=torch.amin(error, dim=-1),
                        color=lanes.take_winner(colors, win),
                        selectors=lanes.take_winner(selectors, win),
                        table=lanes.take_winner(tables_b, win))
                else:
                    diff_data[sector] = dict(
                        error=error, color=colors, selectors=selectors,
                        table=tables_b, urank=urank, row_chunks=row_chunks)

            if d == 0:
                total = ind_best[0]["error"] + ind_best[1]["error"]
                hi, lo = _emit_etc1(flip, 0, ind_best, n, transparent=False)
                stage.update(total, rank_base + flip * 2, hi, lo)
            else:
                win = _resolve_differential(diff_data, n, stage.error)
                hi, lo = _emit_etc1(flip, 1, win, n, transparent=False)
                stage.update(win[0]["total"], rank_base + flip * 2 + 1, hi,
                             lo)
    return stage


def _resolve_differential(diff_data, n, best_in, can_ignore=None):
    """FindBestDifferentialCombination (ETC.cpp:219-362) as the JAX
    package's dense masked pair argmin (its docstring gives the argument):

    - a row i's (sector-0 candidate's) best legal partner minimizes
      (e1, u1); the total e0[i] + mine1[i] is recomputed from the same two
      operands;
    - legality (each channel's difference in (-5, 4)) is one SWAR subtract
      on 10-bit packed fields, borrow-proof through a guard bit per field;
    - the committed row is the first achiever of the minimal total T in
      (e0, u0) order, replaced by the LAST row with mine1 < fl(T - e0)
      when there is one (the scan's re-acceptance of equal totals), and by
      the fast path's row when the per-sector minima form a legal pair
      whose sum beats best_in.

    best_in: [N] float32, the stage's best error entering this resolve.
    The pair grids are [N, K_t, A] for each table's rows, never [N, A, A].
    """
    e0 = diff_data[0]["error"]
    e1 = diff_data[1]["error"]
    c0 = diff_data[0]["color"]
    c1 = diff_data[1]["color"]
    u0 = diff_data[0]["urank"]
    u1 = diff_data[1]["urank"]
    dev = e0.device
    a_count = e0.shape[1]
    row_chunks = diff_data[0].get("row_chunks")
    if row_chunks is None:
        per_table = a_count // 8
        row_chunks = tuple((t * per_table, (t + 1) * per_table)
                           for t in range(8))
    big = 2**30
    unit = 1 | (1 << 10) | (1 << 20)

    def swar_fields(c):
        return (c & 31) | (((c >> 5) & 31) << 10) | (((c >> 10) & 31) << 20)

    fields0 = swar_fields(c0)                              # [N, A]
    # +4 bias centers the (-5, 4) window at [0, 7]; +512 guard per field
    fields1 = swar_fields(c1) + 516 * unit
    swar_mask = 0x3F8 * unit
    swar_legal = 512 * unit

    ignore_any = None
    if can_ignore is not None:
        ignore_any = (can_ignore[0] | can_ignore[1])[:, None, None]

    # packed (uidx1, j): u1 < a_count, so u1 * a_count + j orders by
    # (u1, j); j ties carry identical payloads (duplicate candidates)
    jj = torch.arange(a_count, dtype=I32, device=dev)
    u1j = u1 * a_count + jj

    # per row, the min legal partner error; the winning row's partner is
    # reconstructed afterwards on one [N, A] pass
    mine1_rows = []
    for (c0a, c0b) in row_chunks:
        diff = fields1[:, None, :] - fields0[:, c0a:c0b, None]
        ok = diff.bitwise_and_(swar_mask) == swar_legal    # [N, rows, A]
        del diff
        if ignore_any is not None:
            ok = ok | ignore_any
        mine1_rows.append(torch.amin(torch.where(
            ok, e1[:, None, :], INF), dim=2))
        del ok
    mine1 = torch.cat(mine1_rows, dim=1)                   # [N, A]
    total = e0 + mine1

    # first row reaching the minimal total T in (e0, u0) scan order
    tmin = torch.amin(total, dim=-1)
    m = total == tmin[:, None]
    ke0 = torch.amin(torch.where(m, e0, INF), dim=-1)
    m = m & (e0 == ke0[:, None])
    ku0 = torch.amin(torch.where(m, u0, big), dim=-1)
    m = m & (u0 == ku0[:, None])
    wini = torch.amin(torch.where(m, jj, big), dim=-1)     # iota: no ties
    wini = torch.clamp_max(wini, a_count - 1)

    # re-acceptance: the LAST row in (e0, u0) order whose min legal
    # partner beats fl(T - e0) replaces the first achiever
    reacc = mine1 < (tmin[:, None] - e0)
    ge0 = torch.amax(torch.where(reacc, e0, -INF), dim=-1)
    mr = reacc & (e0 == ge0[:, None])
    gu0 = torch.amax(torch.where(mr, u0, -1), dim=-1)
    mr = mr & (u0 == gu0[:, None])
    s_wini = torch.amax(torch.where(mr, jj, -1), dim=-1)
    wini = torch.where(s_wini >= 0, s_wini, wini)

    # fast path: the per-sector unconstrained lex-min (err, urank)
    # attempts, committed when their sum beats best_in and the pair is
    # legal (or a sector is ignorable); its partner is row bd0's min
    # legal partner, so only the row index is overridden
    bd0e = torch.amin(e0, dim=-1)
    mf = e0 == bd0e[:, None]
    bd0u = torch.amin(torch.where(mf, u0, big), dim=-1)
    mf = mf & (u0 == bd0u[:, None])
    bd0i = torch.clamp_max(torch.amin(torch.where(mf, jj, big), dim=-1),
                           a_count - 1)
    bd1e = torch.amin(e1, dim=-1)
    mf = e1 == bd1e[:, None]
    bd1uj = torch.amin(torch.where(mf, u1j, big), dim=-1)
    bd1j = torch.clamp_max(bd1uj % a_count, a_count - 1)
    bd0c = lanes.take_winner(fields0, bd0i)
    bd1c = lanes.take_winner(fields1, bd1j)  # pre-biased fields
    pair_legal = ((bd1c - bd0c) & swar_mask) == swar_legal
    if ignore_any is not None:
        pair_legal = pair_legal | ignore_any[:, 0, 0]
    enable = (bd0e + bd1e) < best_in
    wini = torch.where(enable & pair_legal, bd0i, wini)

    def g0(x):
        return lanes.take_winner(x, wini)

    win_total = g0(total)
    valid = torch.isfinite(win_total)
    # the winning row's partner: its legal partners at e1 == mine1, then
    # the least (u1, j)
    win_f0 = g0(fields0)
    win_mine1 = g0(mine1)
    okw = ((fields1 - win_f0[:, None]) & swar_mask) == swar_legal
    if ignore_any is not None:
        okw = okw | ignore_any[:, :, 0]
    mw = okw & (e1 == win_mine1[:, None])
    winj_uj = torch.amin(torch.where(mw, u1j, big), dim=-1)
    winj = torch.where(valid, torch.clamp_max(winj_uj, big - 1) % a_count,
                       torch.zeros_like(winj_uj))

    def g1(x):
        return lanes.take_winner(x, winj)

    def vz(x):
        return torch.where(valid, x, torch.zeros_like(x))

    color0 = vz(g0(c0))
    color1 = vz(g1(c1))
    sel0 = vz(g0(diff_data[0]["selectors"]))
    sel1 = vz(g1(diff_data[1]["selectors"]))
    table0 = vz(g0(diff_data[0]["table"]))
    table1 = vz(g1(diff_data[1]["table"]))

    if can_ignore is not None:
        # an ignored sector adopts the other sector's color (ETC.cpp:249-252)
        color0 = torch.where(can_ignore[0], color1, color0)
        color1 = torch.where(can_ignore[1] & ~can_ignore[0], color0, color1)
    win0 = dict(total=win_total, color=color0, selectors=sel0, table=table0)
    win1 = dict(color=color1, selectors=sel1, table=table1)
    return [win0, win1]


def _resolve_fake_bt709_rounding(cu, differential, accurate):
    """ResolveHalfBlockFakeBT709Rounding{Accurate,Fast} (ETC.cpp:2157-2285):
    cu, 3 int32 channel tensors -> their 3 quantized channels."""
    if accurate:
        if differential:
            quant = [((c << 5) - c + (c >> 3)) >> 11 for c in cu]
        else:
            quant = [((c << 5) - (c << 1) + (c >> 3)) >> 12 for c in cu]
        low = []
        high = []
        for q in quant:
            if differential:
                unq = (q << 3) | (q >> 2)
                qn = torch.clamp_max(q + 1, 31)
                unq_next = (qn << 3) | (qn >> 2)
            else:
                unq = (q << 4) | q
                unq_next = torch.clamp_max(unq + 17, 255)
            low.append(lanes.to_float(unq << 3))
            high.append(lanes.to_float(unq_next << 3))
        cum_yuv = convert_to_fake_bt709(lanes.to_float(torch.stack(cu, 1)))
        best_err = None
        best_octant = None
        for octant in range(8):
            rgb = torch.stack([high[ch] if (octant >> ch) & 1 else low[ch]
                               for ch in range(3)], 1)
            d = convert_to_fake_bt709(rgb) - cum_yuv
            # the reference's error expression, d1 + d1 (not d1 * d1)
            # included (ETC.cpp:2225)
            err = d[:, 0] * d[:, 0] + d[:, 1] + d[:, 1] + d[:, 2] * d[:, 2]
            if best_err is None:
                best_err = err
                best_octant = torch.zeros_like(cu[0])
            else:
                better = err < best_err
                best_octant = torch.where(better, octant, best_octant)
                best_err = torch.minimum(err, best_err)
        return [quant[ch] + ((best_octant >> ch) & 1) for ch in range(3)]

    # fast path: octant lookup table (ETC.cpp:2233-2285)
    fill = [c + (c >> 8) for c in cu]
    table = i32(etc_tables.fake_bt709_rounding16(), cu[0].device)
    if differential:
        r_off = (fill[0] << 6) & 0xF00
        g_off = (fill[1] << 4) & 0x0F0
        b_off = (fill[2] >> 2) & 0x00F
        base = [f >> 6 for f in fill]
        upper = 31
    else:
        r_off = (fill[0] << 5) & 0xF00
        g_off = (fill[1] << 1) & 0x0F0
        b_off = (fill[2] >> 3) & 0x00F
        base = [f >> 7 for f in fill]
        upper = 15
    octant = torch.take(table, (r_off | g_off | b_off).long())
    return [torch.clamp_max(base[ch] + ((octant >> ch) & 1), upper)
            for ch in range(3)]


def _lo_word(low_bits, high_bits):
    """The low word of a T/H/ETC1 block: pixel PIXEL_SELECTOR_ORDER[px]'s
    low bit at px and high bit at 16 + px. low/high: [N, 16] 0 or 1."""
    order = i32(PIXEL_SELECTOR_ORDER, low_bits.device)
    bit = torch.arange(16, dtype=I32, device=low_bits.device)
    return torch.sum((low_bits.index_select(1, order) << bit)
                     | (high_bits.index_select(1, order) << (bit + 16)),
                     dim=1, dtype=I32)


def _emit_etc1(flip: int, d: int, win, n, transparent: bool):
    """EmitETC1Block (ETC.cpp:2565-2622): (hi, lo) int32 words of each
    block. `win`: per sector a dict of color, selectors and table [N]."""
    colors = [[(win[s]["color"] >> (ch * 5)) & 31 for ch in range(3)]
              for s in range(2)]
    hi = torch.zeros((n,), dtype=I32, device=win[0]["color"].device)
    if d == 0:
        shifts = [(28, 24), (20, 16), (12, 8)]
        for ch, (s0, s1) in enumerate(shifts):
            hi = hi | (colors[0][ch] << s0) | (colors[1][ch] << s1)
    else:
        shifts = [(27, 24), (19, 16), (11, 8)]
        for ch, (s0, s1) in enumerate(shifts):
            hi = hi | (colors[0][ch] << s0) \
                | (((colors[1][ch] - colors[0][ch]) & 7) << s1)
    hi = hi | (win[0]["table"] << 5) | (win[1]["table"] << 2)
    if not transparent:
        hi = hi | (d << 1)
    hi = hi | flip

    # selectors to block order, remapped to MODIFIER_CODES [3, 2, 0, 1] as
    # bit math: out_hi = ~s_hi, out_lo = ~gray(s)
    shifts = 2 * torch.arange(8, dtype=I32, device=hi.device)
    s = torch.cat([(win[sector]["selectors"][:, None] >> shifts) & 3
                   for sector in range(2)], dim=1)         # [N, 16]
    codes = ((((s >> 1) ^ 1) << 1) | (((s ^ (s >> 1)) & 1) ^ 1))
    codes = codes.index_select(1, i32(np.argsort(np.concatenate(
        FLIP_TABLES[flip])), hi.device))
    return hi, _lo_word(codes & 1, (codes >> 1) & 1)


def compress_etc1(pixels_u8, options: Options):
    """CompressETC1Block (ETC.cpp:2117-2126): uint8 [N, 16, 4] -> [N, 8]."""
    pixels, pw = extract_blocks(pixels_u8, options)
    stage = StageBest(pixels.shape[0], pixels.device)
    compress_etc1_internal(stage, 0, pixels, pw, options,
                           punchthrough_min_d=False)
    return stage.to_bytes()


# --- ETC2 alpha and EAC11 ------------------------------------------------------

def compress_etc2_alpha(pixels_u8):
    """CompressETC2AlphaBlock (ETC.cpp:1889-1900): the 8-bit alpha plane
    of uint8 [N, 16, 4] -> [N, 8]."""
    return _compress_alpha_internal(pixels_u8[:, :, 3].to(I32), False, False)


def compress_eac11(pixels_s16, is_signed: bool):
    """CompressEACBlock (ETC.cpp:2087-2114): one 11-bit channel, int16
    [N, 16] -> [N, 8]."""
    v = pixels_s16.to(I32)
    if is_signed:
        v = torch.clamp_min(torch.clamp_max(v, 1023) + 1024, 1)
    else:
        v = torch.clamp_min(torch.clamp_max(v, 2047), 0)
    return _compress_alpha_internal(v, True, is_signed)


def _alpha_candidates():
    """The 320 (table, range, multiplier) candidates in the reference's
    visitation order: table ids, min and max offsets, multiplier offsets."""
    mod_pos = etc_tables.ALPHA_MODIFIER_TABLE_POSITIVE
    rows = []
    for table_index in range(16):
        for r in range(10):
            subrange = r % 3
            main_range = r // 3
            max_off = int(mod_pos[table_index][3 - main_range
                                               - (subrange & 1)])
            min_off = -int(mod_pos[table_index][3 - main_range
                                                - ((subrange >> 1) & 1)]) - 1
            for mult_off in range(2):
                rows.append((table_index, min_off, max_off, mult_off))
    return np.asarray(rows, dtype=np.int32).T


def _quantize_etc2_alpha(table_index, value, base, mult, is_11bit, is_signed):
    """QuantizeETC2Alpha (ETC.cpp:2366-2412): (quantized value, 3-bit
    index) of `value` against each candidate. table_index, base and mult
    broadcast against value (int32)."""
    dev = value.device
    width = etc_tables.ALPHA_ROUNDING_TABLE_WIDTH
    rounding = i32(etc_tables.alpha_rounding_tables(), dev).reshape(-1)
    mod_pos = i32(etc_tables.ALPHA_MODIFIER_TABLE_POSITIVE, dev).reshape(-1)
    offset = value - base
    about_reflector2 = offset + offset + mult
    lookup = (torch.abs(about_reflector2) >> 1) // torch.clamp_min(mult, 1)
    lookup = torch.clamp_max(lookup, width - 1)
    pos_index = torch.take(rounding, (table_index * width + lookup).long())
    pos_offset = torch.take(mod_pos, (table_index * 4 + pos_index).long())

    sign_bits = about_reflector2 >> 31  # 0 or -1
    offset_value = base + (pos_offset ^ sign_bits) * mult
    if is_11bit:
        q = torch.clamp_max(torch.clamp_min(offset_value,
                                            1 if is_signed else 0), 2047)
    else:
        q = torch.clamp_max(torch.clamp_min(offset_value, 0), 255)
    return q, pos_index + 4 - (sign_bits & 4)


def _compress_alpha_internal(pixels, is_11bit: bool, is_signed: bool):
    """CompressETC2AlphaBlockInternal (ETC.cpp:1902-2085): int32 [N, 16]
    values -> uint8 [N, 8].

    The reference's table(16) x range(10) x multiplier(2) loops are one
    320-wide candidate axis beside the 16 pixels; its sequential
    strict-less update order (table-major) is a first-occurrence argmin."""
    dev = pixels.device
    min_a = torch.amin(pixels, dim=1)
    max_a = torch.amax(pixels, dim=1)
    span = max_a - min_a
    mid2 = max_a + min_a

    cand_table, cand_min_off, cand_max_off, cand_mult_off = (
        i32(a, dev) for a in _alpha_candidates())
    min_mult = span[:, None] // (cand_max_off - cand_min_off)
    if is_11bit:
        min_mult = torch.clamp_max(min_mult, 112) & 120
        mult = torch.where(cand_mult_off == 1, min_mult + 8,
                           torch.clamp_min(min_mult, 1))
    else:
        min_mult = torch.clamp_min(torch.clamp_max(min_mult, 14), 1)
        mult = torch.where(cand_mult_off == 1, min_mult + 1, min_mult)

    unclamped2 = mid2[:, None] - mult * cand_max_off - mult * cand_min_off
    if is_11bit:
        if is_signed:
            unclamped2 = unclamped2 + 8
        clamped2 = torch.clamp_max(
            torch.clamp_min(unclamped2, 16 if is_signed else 0), 4095)
        base = (clamped2 >> 1) & 2040
        if not is_signed:
            base = base + 4
    else:
        clamped2 = torch.clamp_max(torch.clamp_min(unclamped2, 0), 510)
        base = (clamped2 + 1) >> 1                         # [N, 320]

    value = pixels[:, :, None]
    q, _ = _quantize_etc2_alpha(cand_table, value, base[:, None],
                                mult[:, None], is_11bit, is_signed)
    d = q - value
    total = torch.sum(d * d, dim=1, dtype=I32)             # [N, 320]
    win = lanes.first_argmin(total, -1)

    best_table = cand_table[win.long()]
    best_base = lanes.take_winner(base, win)
    best_mult = lanes.take_winner(mult, win)
    _, best_idx = _quantize_etc2_alpha(
        best_table[:, None], pixels, best_base[:, None], best_mult[:, None],
        is_11bit, is_signed)                               # [N, 16]
    if is_11bit:
        best_mult = best_mult >> 3
        if is_signed:
            best_base = best_base ^ 0x80

    # emission (ETC.cpp:2049-2084): base, multiplier and table, then 16
    # 3-bit indices MSB-first in pixelSelectorOrder
    ordered = best_idx.index_select(
        1, i32(np.argsort(PIXEL_SELECTOR_ORDER), dev)).to(torch.int64)
    shifts = torch.arange(45, -1, -3, dtype=torch.int64, device=dev)
    stream = torch.sum(ordered << shifts, dim=1)           # 48 bits
    cols = [best_base & 0xFF, (best_mult << 4) | best_table]
    cols += [((stream >> (40 - 8 * k)) & 0xFF).to(I32) for k in range(6)]
    return torch.stack(cols, dim=-1).to(torch.uint8)


# --- ETC2: T, H and planar modes ---------------------------------------------

INT32_MIN = -2147483648
TH_MODS = np.asarray(etc_tables.TH_MODIFIER_TABLE, dtype=np.int32)
TH_OFFSETS = 33          # premultiplier offsets -16..16 of the T and H scans
VIRTUAL_T_STEPS = 16     # premultiplier steps of the virtual T scan
PUNCHTHROUGH_MODIFIERS = np.array([8, 17, 29, 42, 60, 80, 106, 183],
                                  dtype=np.int32)


def _chain_sum(x, dim: int):
    """The float32 sum over `dim` as a chain of adds in index order, the
    reference's loop order (torch.sum would reassociate it)."""
    total = x.select(dim, 0).clone()
    for i in range(1, x.shape[dim]):
        total.add_(x.select(dim, i))
    return total


def _without_fake_bt709(pixels, pw, options: Options):
    """The options and preweighted pixels of the errors that use
    Uniform/Weighted even under FakeBT709 (EncodeTMode's line colors,
    ETC.cpp:607-612, and the virtual T mode's line and H colors): the
    weighted error then compares weighted RGB against YUV-preweighted
    pixels, as the reference does; the uniform one takes the pixels."""
    opts = dataclasses.replace(
        options, flags=options.flags & ~Flags.ETC_USE_FAKE_BT709)
    if opts.flags & Flags.UNIFORM:
        return opts, lanes.to_float(pixels)
    return opts, pw


def _unpack_selectors(selectors):
    """[N] words of 16 2-bit selectors -> [N, 16] int32 in pixel order."""
    shifts = 2 * torch.arange(16, dtype=I32, device=selectors.device)
    return (selectors[:, None] >> shifts) & 3


def _pixel_bits(bits, px_dim: int = 1):
    """OR over the 16-pixel axis of bits << px (bits 0 or 1)."""
    shape = [1] * bits.dim()
    shape[px_dim] = 16
    shifts = torch.arange(16, dtype=I32, device=bits.device).view(shape)
    return torch.sum(bits.to(I32) << shifts, dim=px_dim, dtype=I32)


def _emit_tmode(line_color, isolated_color, selectors, table, opaque: bool):
    """EmitTModeBlock (ETC.cpp:2414-2460): (hi, lo) words. line_color and
    isolated_color: [N, 3] 4-bit channels (the H-mode fallback passes
    5-bit ones, as the reference does); selectors: [N] 2-bit words."""
    rh = (isolated_color[:, 0] >> 2) & 3
    rl = isolated_color[:, 0] & 3
    zero = torch.zeros_like(rh)
    hi = torch.where((rh + rl) < 4, zero | (1 << 26), zero | -536870912)
    hi = hi | (rh << 27) | (rl << 24) | (isolated_color[:, 1] << 20) \
        | (isolated_color[:, 2] << 16) | (line_color[:, 0] << 12) \
        | (line_color[:, 1] << 8) | (line_color[:, 2] << 4) \
        | (((table >> 1) & 3) << 2) | (table & 1)
    if opaque:
        hi = hi | 2
    sel = _unpack_selectors(selectors)
    return hi, _lo_word(sel & 1, (sel >> 1) & 1)


def _emit_hmode(block_colors, sector_bits, sign_bits, table, opaque: bool):
    """EmitHModeBlock (ETC.cpp:2462-2563), with its T-mode fallback for
    equal colors and its swap to encode the table's low bit.
    block_colors: [N, 2] packed 4-bit colors, red high."""
    c0, c1 = block_colors[:, 0], block_colors[:, 1]
    px_bits = torch.arange(16, dtype=I32, device=c0.device)

    # T-mode fallback for equal colors
    t_line = (c0[:, None] >> i32([10, 5, 0], c0.device)) & 0x1F
    t_sel = _selector_bits(((sign_bits[:, None] >> px_bits) & 1) << 1,
                           1) | 0x55555555
    t_hi, t_lo = _emit_tmode(t_line, t_line, t_sel, table, opaque)

    swap = ((table & 1) == 1) != (c0 > c1)
    first = torch.where(swap, c1, c0)
    second = torch.where(swap, c0, c1)
    sector_bits = torch.where(swap, sector_bits ^ 0xFFFF, sector_bits)
    r1 = (first >> 10) & 15
    g1 = (first >> 5) & 15
    b1 = first & 15
    g1a, g1b = g1 >> 1, g1 & 1
    b1a, b1b = b1 >> 3, b1 & 7

    zero = torch.zeros_like(c0)
    hi = torch.where(((g1a & 4) != 0) & (r1 + g1a < 8), zero | INT32_MIN,
                     zero)
    fake_dg = b1b >> 1
    fake_g = b1a | (g1b << 1)
    hi = torch.where(fake_g + fake_dg < 4, hi | (1 << 18), hi | (7 << 21))
    hi = hi | (r1 << 27) | (g1a << 24) | (g1b << 20) | (b1a << 19) \
        | (b1b << 15) | (((second >> 10) & 15) << 11) \
        | (((second >> 5) & 15) << 7) | ((second & 15) << 3) \
        | (((table >> 2) & 1) << 2) | ((table >> 1) & 1)
    if opaque:
        hi = hi | 2
    lo = _lo_word((sign_bits[:, None] >> px_bits) & 1,
                  (sector_bits[:, None] >> px_bits) & 1)
    return torch.where(c0 == c1, t_hi, hi), torch.where(c0 == c1, t_lo, lo)


def _decode_planar_coeff(coeff, ch_dim: int = 1):
    """DecodePlanarCoeff (ETC.cpp:1266-1272) of [N, 3, ...] coefficients,
    channels on `ch_dim`: green has 7 bits, red and blue 6."""
    shape = [1] * coeff.dim()
    shape[ch_dim] = 3
    left = i32([2, 1, 2], coeff.device).view(shape)
    right = i32([4, 6, 4], coeff.device).view(shape)
    return (coeff << left) | (coeff >> right)


def _emit_planar(best_coeffs):
    """Planar block emission (ETC.cpp:1590-1660): (hi, lo) words from
    [N, 3 (channel), 3 (o, h, v)] coefficients."""
    (ro, rh, rv), (go, gh, gv), (bo, bh, bv) = (
        best_coeffs[:, ch].unbind(1) for ch in range(3))
    go1, go2 = go >> 6, go & 63
    bo1, bo2, bo3 = bo >> 5, (bo >> 3) & 3, bo & 7
    fake_r, fake_dr = ro >> 2, go1 | ((ro & 3) << 1)
    fake_g, fake_dg = go2 >> 2, ((go2 & 3) << 1) | bo1
    fake_b, fake_db = bo2, bo3 >> 1

    zero = torch.zeros_like(ro)
    hi = torch.where(((fake_dr & 4) != 0) & (fake_r + fake_dr < 8),
                     zero | INT32_MIN, zero)
    hi = torch.where(((fake_dg & 4) != 0) & (fake_g + fake_dg < 8),
                     hi | (1 << 23), hi)
    hi = torch.where(fake_b + fake_db < 4, hi | (1 << 10), hi | (7 << 13))
    hi = hi | (ro << 25) | (go1 << 24) | (go2 << 17) | (bo1 << 16) \
        | (bo2 << 11) | (bo3 << 7) | ((rh >> 1) << 2) | 2 | (rh & 1)
    lo = (gh << 25) | (bh << 19) | (rv << 13) | (gv << 6) | bv
    return hi, lo


def _planar_normal_terms():
    """The host-side float32 terms of the planar least-squares system
    (ETC.cpp:1300-1365), which depend on pixel coordinates only. The
    reference accumulates fho/fhv/fov twice per pixel through the aliased
    references foh/fvh/fvo (`float &foh = fho;`, ETC.cpp:1305-1327)."""
    f = np.float32
    fhh = fho = fhv = foo = fov = fvv = f(0)
    for px in range(16):
        x, y = f(px % 4), f(px // 4)
        fhh = f(fhh + x * x)
        fhv = f(f(fhv + x * y) + y * x)
        fho = f(f(fho + x) + x)
        fvv = f(fvv + y * y)
        fov = f(f(fov + y) + y)
        foo = f(foo + 1)
    d, e, ff = f(2.0) * fhh, fho, fhv
    i, j, k = fhv, fov, f(2.0) * fvv
    m, nn, p = fho, f(2.0) * foo, fov
    r0to1 = f(-i / d)
    r0to2 = f(-m / d)
    j1 = f(j + r0to1 * e)
    k1 = f(k + r0to1 * ff)
    n1 = f(nn + r0to2 * e)
    p1 = f(p + r0to2 * ff)
    r1to2 = f(-p1 / k1)
    n2 = f(n1 + r1to2 * j1)
    r2to1 = f(-j1 / n2)
    elim2 = f(-ff / k1)
    elim1 = f(-e / n2)
    return dict(d=d, k1=k1, n2=n2, r0to1=r0to1, r0to2=r0to2, r1to2=r1to2,
                r2to1=r2to1, elim2=elim2, elim1=elim1)


_PLANAR_X = np.arange(16, dtype=np.int32) % 4
_PLANAR_Y = np.arange(16, dtype=np.int32) // 4


def _planar_decode(best_coeffs):
    """The decoded 8-bit plane [N, 3, ..., 16] of [N, 3, ..., 3 (o, h, v)]
    coefficients (channels on dim 1)."""
    dec = _decode_planar_coeff(best_coeffs)
    d_o, d_h, d_v = dec[..., 0:1], dec[..., 1:2], dec[..., 2:3]
    x = i32(_PLANAR_X, dec.device)
    y = i32(_PLANAR_Y, dec.device)
    interp = (x * (d_h - d_o) + y * (d_v - d_o) + ((d_o << 2) + 2)) >> 2
    return torch.clamp(interp, 0, 255)


def encode_planar(stage: StageBest, rank_base: int, pixels, pw,
                  options: Options):
    """EncodePlanar (ETC.cpp:1274-1663): the algebraic least-squares plane
    fit, its coefficients rounded (down and up, the 2 x 2 x 2 search per
    channel, or to nearest under FakeBT709). The three channels are one
    tensor axis."""
    n, dev = pixels.shape[0], pixels.device
    fake = bool(options.flags & Flags.ETC_USE_FAKE_BT709)
    t = _planar_normal_terms()

    # fh, fv, fo per channel: the reference subtracts c*x, c*y and c twice
    # per pixel (ETC.cpp:1330-1343), each a chain in pixel order
    src = pw if fake else lanes.to_float(pixels)           # [N, 16, 3]
    xy1 = programs.constant(np.stack([_PLANAR_X, _PLANAR_Y, np.ones(16)], 1),
                            dev, np.float32)               # [16, 3]
    acc = torch.zeros((n, 3, 3), dtype=F32, device=dev)    # [N, ch, (h,v,o)]
    for px in range(16):
        c = src[:, px, :, None] * xy1[px]
        acc = (acc - c) - c
    g_d, l_d, q_d = acc.unbind(2)

    def full(v):
        return torch.full((n, 3), float(v), dtype=F32, device=dev)

    l1_d = l_d + g_d * float(t["r0to1"])
    q1_d = q_d + g_d * float(t["r0to2"])
    q2_d = q1_d + l1_d * float(t["r1to2"])
    o = exact_divide(-q2_d, full(t["n2"]))
    l2_d = l1_d + q2_d * float(t["r2to1"])
    g2_d = g_d + l2_d * float(t["elim2"]) + q2_d * float(t["elim1"])
    h = exact_divide(-g2_d, full(t["d"])) * 4.0 + o
    v = exact_divide(-l2_d, full(t["k1"])) * 4.0 + o
    fco = torch.stack([o, h, v], 2)                        # [N, ch, (o,h,v)]
    if fake:
        fco = convert_from_fake_bt709(fco)
    # 127/255 and 63/255 are doubles rounded once to float32
    scale = programs.constant(np.float32([63.0 / 255.0, 127.0 / 255.0,
                                          63.0 / 255.0]), dev)[:, None]
    cap = programs.constant(np.float32([63.0, 127.0, 63.0]), dev)[:, None]
    coeff = torch.minimum(cap, torch.clamp_min(fco, 0.0) * scale)

    if fake:
        best_coeffs = lanes.round_and_convert_to_int_nearest(coeff)
        recon = _planar_decode(best_coeffs)                # [N, 3, 16]
        total_error = _chain_sum(compute_error(
            recon, pw.transpose(1, 2), options), 1)
    else:
        # the 8 (o, h, v) roundings in (io, ih, iv) order, k = 4 io + 2 ih
        # + iv; a strict-less update from FLT_MAX is a first argmin
        ranges = torch.stack([lanes.round_down_to_int(coeff),
                              lanes.round_up_to_int(coeff)], 3)
        bit = ((torch.arange(8, dtype=I32, device=dev)[:, None]
                >> i32([2, 1, 0], dev)) & 1)              # [8, 3]
        cand = torch.gather(
            ranges[:, :, None].expand(n, 3, 8, 3, 2), 4,
            bit.long()[None, None, :, :, None].expand(n, 3, 8, 3, 1)
        ).squeeze(4)                                       # [N, 3, 8, 3]
        delta = lanes.to_float(pixels.transpose(1, 2)[:, :, None, :]
                               - _planar_decode(cand))     # [N, 3, 8, 16]
        err = _chain_sum(delta * delta, 3)                 # [N, 3, 8]
        win = lanes.first_argmin(err, 2)                   # [N, 3]
        best_err = torch.amin(err, dim=2)
        best_coeffs = torch.gather(
            cand, 2, win.long()[:, :, None, None].expand(n, 3, 1, 3)
        ).squeeze(2)
        if not options.flags & Flags.UNIFORM:
            w = _weights(options)
            best_err = best_err * programs.constant(
                [w[ch] * w[ch] for ch in range(3)], dev, np.float32)
        total_error = (best_err[:, 0] + best_err[:, 1]) + best_err[:, 2]

    hi, lo = _emit_planar(best_coeffs)
    stage.update(total_error, rank_base, hi, lo)


def _resolve_th_fake_bt709(quantized, targets, granularity):
    """ResolveTHFakeBT709Rounding (ETC.cpp:2286-2327): quantized and
    targets int32 [N, 3, ...] (channels on dim 1), granularity int32
    broadcasting against them. The 8 octants are a tensor axis; the
    reference's strict-less octant scan is a first argmin over it."""
    unq = (quantized << 4) | quantized
    unq_next = torch.clamp_max(unq + 17, 255)
    low = lanes.to_float((unq * granularity) << 1).unsqueeze(2)
    high = lanes.to_float((unq_next * granularity) << 1).unsqueeze(2)
    octant_bits = (torch.arange(8, dtype=I32, device=unq.device)[None, :]
                   >> i32([0, 1, 2], unq.device)[:, None]) & 1  # [3, 8]
    octant_bits = octant_bits.view([1, 3, 8] + [1] * (unq.dim() - 2))
    yuv = convert_to_fake_bt709(torch.where(octant_bits == 1, high, low))
    d = yuv - convert_to_fake_bt709(lanes.to_float(targets)).unsqueeze(2)
    # the reference's error expression, d1 + d1 (not d1 * d1) included
    # (ETC.cpp:2318)
    err = d[:, 0] * d[:, 0] + d[:, 1] + d[:, 1] + d[:, 2] * d[:, 2]
    octant = lanes.first_argmin(err, 1).unsqueeze(1)
    return quantized + ((octant >> _channel_view(
        i32([0, 1, 2], unq.device), unq.dim())) & 1)


def _th_totals(groups, pixels):
    """Channel sums [N, 3] of the pixels in `groups` [N, 16] and the
    count of those pixels [N]."""
    total = torch.sum(torch.where(groups[:, :, None], pixels, 0), dim=1,
                      dtype=I32)
    return total, torch.sum(groups, dim=1, dtype=I32)


def encode_tmode(stage: StageBest, rank_base: int, is_isolated, pixels, pw,
                 options: Options):
    """EncodeTMode (ETC.cpp:396-648). is_isolated: [N, 16] bool.

    The 8 modifier tables x 33 premultiplier offsets are one table-major
    candidate axis (K = 264), the 16 pixels another; the reference's
    (table, offset) first-wins order is the first argmin over K."""
    n, dev = pixels.shape[0], pixels.device
    fake = bool(options.flags & Flags.ETC_USE_FAKE_BT709)
    pw_t = pw.transpose(1, 2)                              # [N, 3, 16]

    iso_total, num_iso = _th_totals(is_isolated, pixels)
    line_total = torch.sum(pixels, dim=1, dtype=I32) - iso_total
    num_line = 16 - num_iso

    numerator = iso_total + iso_total
    if not fake:
        numerator = numerator + ((num_iso << 4) | num_iso)[:, None]
    iso_q = lanes.div_floor(numerator, (num_iso * 34)[:, None])  # [N, 3]
    if fake:
        iso_q = _resolve_th_fake_bt709(iso_q, numerator, num_iso[:, None])
    iso_error = compute_error((iso_q | (iso_q << 4))[:, :, None], pw_t,
                              options)                     # [N, 16]

    # line-color candidates: the premultiplier in [-16, 16], clamped per
    # lane to +-num_line (clamp duplicates carry identical payloads)
    offs = torch.arange(-16, 17, dtype=I32, device=dev)
    clamped = torch.maximum(-num_line[:, None],
                            torch.minimum(num_line[:, None], offs))
    mods = i32(TH_MODS, dev)
    mod_addend = (clamped[:, None, :] * (2 * mods)[None, :, None]).reshape(
        n, 8 * TH_OFFSETS)
    base = line_total + line_total
    if not fake:
        base = base + ((num_line << 4) | num_line)[:, None]
    numer = torch.clamp_min(base[:, :, None] + mod_addend[:, None, :], 0)
    q = torch.clamp_max(lanes.div_floor(
        numer, (num_line * 34)[:, None, None]), 15)        # [N, 3, K]
    if fake:
        q = torch.clamp_max(_resolve_th_fake_bt709(
            q, numer, num_line[:, None, None]), 15)
    packed = q[:, 0] | (q[:, 1] << 5) | (q[:, 2] << 10)    # red low

    unq = (q << 4) | q
    mod_k = i32(np.repeat(TH_MODS, TH_OFFSETS), dev)
    opts_nf, pw_nf = _without_fake_bt709(pixels, pw, options)
    pw_nf = pw_nf.transpose(1, 2)[:, :, :, None]           # [N, 3, 16, 1]
    px_err = iso_error[:, :, None].expand(n, 16, 8 * TH_OFFSETS)
    px_sel = torch.zeros((n, 16, 8 * TH_OFFSETS), dtype=I32, device=dev)
    for i, line in enumerate((torch.clamp_max(unq + mod_k, 255), unq,
                              torch.clamp_min(unq - mod_k, 0))):
        e = error_from_terms(recon_terms(line, opts_nf)[:, :, None, :],
                             pw_nf)                        # [N, 16, K]
        px_sel = torch.where(e < px_err, i + 1, px_sel)
        px_err = torch.minimum(e, px_err)
        del e
    error = _chain_sum(px_err, 1)                          # [N, K]
    selectors = _selector_bits(px_sel, 1)
    del px_err, px_sel

    win_err, win = lanes.lex_min_with_index(error, (1,))
    line_color = (lanes.take_winner(packed, win)[:, None]
                  >> i32([0, 5, 10], dev)) & 15
    hi, lo = _emit_tmode(line_color, iso_q, lanes.take_winner(selectors, win),
                         win // TH_OFFSETS, True)
    stage.update(win_err, rank_base, hi, lo)


def _table_rank(colors):
    """Unique-color rank of each candidate within its table (the reference
    dedups consecutive candidates per table): colors [..., 8, 33]."""
    prev = torch.cat([torch.full_like(colors[..., :1], -1),
                      colors[..., :-1]], dim=-1)
    return torch.cumsum((colors != prev).to(I32), dim=-1, dtype=I32) - 1


def encode_hmode(stage: StageBest, rank_base: int, groupings, pixels, pw,
                 options: Options):
    """EncodeHMode (ETC.cpp:649-886). groupings: [N, 16] bool, True for
    sector 1.

    Each sector's 8 x 33 candidate colors carry a per-pixel best error
    over the modifier's two signs; the (table, i1, i0) pair totals are one
    [N, 8, 33, 33] grid chained over the 16 pixels in pixel order, whose
    flat first argmin is the reference's strict-improvement combo walk
    (ETC.cpp:797-815). The winner's sector and sign bits are recomputed
    from the winning pair's colors on [N, 16]."""
    n, dev = pixels.shape[0], pixels.device
    pw_t = pw.transpose(1, 2)                              # [N, 3, 16]
    total1, count1 = _th_totals(groupings, pixels)
    totals = torch.stack([torch.sum(pixels, dim=1, dtype=I32) - total1,
                          total1], 1)                      # [N, 2, 3]
    counts = torch.stack([16 - count1, count1], 1)         # [N, 2]

    offs = torch.arange(-16, 17, dtype=I32, device=dev)
    clamped = torch.maximum(-counts[:, :, None],
                            torch.minimum(counts[:, :, None], offs))
    mods = i32(TH_MODS, dev)
    mod_addend = (clamped[:, :, None, :]
                  * (2 * mods)[None, None, :, None]).reshape(n, 2, 1, -1)
    numer = torch.clamp_min((totals * 2 + counts[:, :, None] * 17)[..., None]
                            + mod_addend, 0)               # [N, 2, 3, K]
    q = torch.clamp_max(lanes.div_floor(
        numer, (counts * 34)[:, :, None, None]), 15)
    colors = (q[:, :, 0] << 10) | (q[:, :, 1] << 5) | q[:, :, 2]  # red high

    unq = (q << 4) | q
    mod_k = i32(np.repeat(TH_MODS, TH_OFFSETS), dev)
    errs = []
    for sector in range(2):
        e_plus = error_from_terms(recon_terms(
            torch.clamp_max(unq[:, sector] + mod_k, 255), options)[
                :, :, None, :], pw_t[:, :, :, None])       # [N, 16, K]
        e_minus = error_from_terms(recon_terms(
            torch.clamp_min(unq[:, sector] - mod_k, 0), options)[
                :, :, None, :], pw_t[:, :, :, None])
        errs.append(torch.minimum(e_plus, e_minus).view(
            n, 16, 8, TH_OFFSETS))
        del e_plus, e_minus
    e0, e1 = errs

    # pair totals [N, 8, 33 (i1), 33 (i0)], chained over the pixels
    total = torch.minimum(e1[:, 0, :, :, None], e0[:, 0, :, None, :])
    step = torch.empty_like(total)
    for px in range(1, 16):
        torch.minimum(e1[:, px, :, :, None], e0[:, px, :, None, :], out=step)
        total.add_(step)
    del step, errs, e0, e1

    # the reference's combo walk pre-increments index0, so the (0, 0) pair
    # is reached only by wrapping, which happens iff sector 1 has exactly
    # one unique color
    u0 = _table_rank(colors[:, 0].view(n, 8, TH_OFFSETS))
    u1 = _table_rank(colors[:, 1].view(n, 8, TH_OFFSETS))
    nu1 = torch.amax(u1, dim=2) + 1
    total.masked_fill_((u0[:, :, None, :] == 0) & (u1[:, :, :, None] == 0)
                       & (nu1[:, :, None, None] > 1), INF)
    err, win = lanes.lex_min_with_index(total, (1, 2, 3))
    del total
    table = win // (TH_OFFSETS * TH_OFFSETS)
    rem = win % (TH_OFFSETS * TH_OFFSETS)
    color0 = lanes.take_winner(colors[:, 0], table * TH_OFFSETS
                               + rem % TH_OFFSETS)
    color1 = lanes.take_winner(colors[:, 1], table * TH_OFFSETS
                               + rem // TH_OFFSETS)

    # the winner's per-pixel decisions, recomputed on [N, 16]
    modifier = mods[table.long()][:, None, None]

    def lane_errors(packed):
        u = (packed[:, None] >> i32([10, 5, 0], dev)) & 15
        u = ((u << 4) | u)[:, :, None]                     # [N, 3, 1]
        e_plus = compute_error(torch.clamp_max(u + modifier, 255), pw_t,
                               options)
        e_minus = compute_error(torch.clamp_min(u - modifier, 0), pw_t,
                                options)
        return torch.minimum(e_plus, e_minus), e_minus < e_plus

    e0p, s0 = lane_errors(color0)
    e1p, s1 = lane_errors(color1)
    pick1 = e1p < e0p
    hi, lo = _emit_hmode(torch.stack([color0, color1], 1), _pixel_bits(pick1),
                         _pixel_bits(torch.where(pick1, s1, s0)), table, True)
    stage.update(err, rank_base, hi, lo, valid=torch.isfinite(err))


def chroma_side_axes(options: Options):
    """ETC2CompressionDataInternal ctor (ETC.cpp:3117-3145): the weighted
    chroma axes, host-side float32 math."""
    f = np.float32
    cd = [f(options.red_weight), f(options.green_weight),
          f(options.blue_weight)]
    rot = [cd[1], cd[2], cd[0]]
    offs = f(-(rot[0] * cd[0] + rot[1] * cd[1] + rot[2] * cd[2])
             / (cd[0] * cd[0] + cd[1] * cd[1] + cd[2] * cd[2]))
    a0 = [f(rot[i] + cd[i] * offs) for i in range(3)]
    a1u = [f(a0[1] * cd[2] - a0[2] * cd[1]),
           f(a0[2] * cd[0] - a0[0] * cd[2]),
           f(a0[0] * cd[1] - a0[1] * cd[0])]
    l0 = f(a0[0] * a0[0] + a0[1] * a0[1] + a0[2] * a0[2])
    l1 = f(a1u[0] * a1u[0] + a1u[1] * a1u[1] + a1u[2] * a1u[2])
    ratio = f(np.sqrt(np.float64(l0 / l1)))  # std::sqrt on float promotes
    ratio = f(np.float32(np.sqrt(f(l0 / l1))))
    a1 = [f(a1u[i] * ratio) for i in range(3)]
    return a0, a1


def _sector_assignments(pixels, pw, options: Options, num_opaque=None):
    """The chroma split of CompressETC2Block (ETC.cpp:1723-1848): [N, 16]
    bool sector of each pixel. num_opaque: [N] int32 opaque pixel counts
    on the punchthrough path (the centered chroma is scaled by it), None
    on the opaque path (scaled by 16)."""
    if options.flags & Flags.UNIFORM:
        p0, p1, p2 = pixels.unbind(2)
        cc3 = torch.stack([p0 - p2, p0 - (p1 << 1) + p2], 2)  # [N, 16, 2]
        centroid = torch.sum(cc3, dim=1, dtype=I32)[:, None]
        if num_opaque is not None:
            chroma = lanes.to_float(cc3 * num_opaque[:, None, None] - centroid)
        else:
            chroma = lanes.to_float((cc3 << 4) - centroid)
        rcp_sqrt3 = _f32(0.57735026918962576450914878050196)
        chroma = torch.stack([chroma[..., 0], chroma[..., 1] * rcp_sqrt3], 2)
    else:
        axes = programs.constant(np.float32(chroma_side_axes(options)),
                                 pw.device)                # [2, 3]
        t = pw[:, :, None, :] * axes                       # [N, 16, 2, 3]
        cc3 = (t[..., 0] + t[..., 1]) + t[..., 2]          # [N, 16, 2]
        centroid = _chain_sum(cc3, 1)[:, None]
        if num_opaque is not None:
            scale = lanes.to_float(num_opaque)[:, None, None]
        else:
            scale = 16.0
        chroma = cc3 * scale - centroid

    nx, ny = chroma[..., 0], chroma[..., 1]
    cov_xx, cov_yy, cov_xy = _chain_sum(
        torch.stack([nx * nx, ny * ny, nx * ny], 2), 1).unbind(1)
    half_trace = (cov_xx + cov_yy) * 0.5
    det = cov_xx * cov_yy - cov_xy * cov_xy
    mm = exact_sqrt(torch.clamp_min(half_trace * half_trace - det, 0.0))
    ev = half_trace + mm
    dx = cov_yy - ev + cov_xy
    dy = -(cov_xx - ev + cov_xy)
    dx = torch.where((dx == 0.0) & (dy == 0.0), torch.ones_like(dx), dx)
    return (nx * dx[:, None] + ny * dy[:, None]) < 0.0


# --- ETC2 top-level encoders ------------------------------------------------

def punchthrough_threshold(threshold: float) -> int:
    """The alpha below which a pixel is transparent (ETC.cpp:1690-1700),
    with the reference's float arithmetic."""
    f_thr = max(min(1.0, threshold), 0.0) * 255.0
    return int(np.floor(np.float32(f_thr) + 1.0))


def _zero_transparent(pixels_u8, pixels, pw, options: Options):
    """(is_transparent [N, 16], pixels and pw with transparent pixels
    zeroed (ETC.cpp:1705-1717), opaque pixel counts [N])."""
    transparent = (pixels_u8[:, :, 3].to(I32)
                   < punchthrough_threshold(options.threshold))
    pixels = torch.where(transparent[:, :, None], 0, pixels)
    pw = torch.where(transparent[:, :, None], 0.0, pw)
    return (transparent, pixels, pw,
            16 - torch.sum(transparent, dim=1, dtype=I32))


def _punchthrough_stages(stage: StageBest, sectors, pixels, pw, transparent,
                         options: Options):
    """The punchthrough stages of CompressETC2Block (ETC.cpp:1866-1886):
    the virtual T mode on both sector splits, then punchthrough ETC1, at
    ranks 10, 11 and 12 and up."""
    encode_virtual_tmode_punchthrough(stage, 10, sectors, pixels, pw,
                                      transparent, options)
    encode_virtual_tmode_punchthrough(stage, 11, ~sectors, pixels, pw,
                                      transparent, options)
    compress_etc1_punchthrough(stage, 12, pixels, pw, transparent, options)


def compress_etc2(pixels_u8, options: Options, punchthrough_alpha: bool):
    """CompressETC2Block (ETC.cpp:1664-1887): uint8 [N, 16, 4] -> [N, 8].

    Stage ranks: 0 planar, 1 T, 2 T flipped, 3 H flipped, 4 and up ETC1
    (differential only); with punchthrough_alpha, the lanes that hold a
    transparent pixel restart and keep only the punchthrough stages."""
    pixels, pw = extract_blocks(pixels_u8, options)
    n, dev = pixels.shape[0], pixels.device
    num_opaque = None
    if punchthrough_alpha:
        transparent, pixels, pw, num_opaque = _zero_transparent(
            pixels_u8, pixels, pw, options)

    stage = StageBest(n, dev)
    encode_planar(stage, 0, pixels, pw, options)
    sectors = _sector_assignments(pixels, pw, options, num_opaque)
    encode_tmode(stage, 1, sectors, pixels, pw, options)
    encode_tmode(stage, 2, ~sectors, pixels, pw, options)
    encode_hmode(stage, 3, ~sectors, pixels, pw, options)
    compress_etc1_internal(stage, 4, pixels, pw, options,
                           punchthrough_min_d=True)

    if punchthrough_alpha:
        any_transparent = transparent.any(dim=1)
        stage.reset_where(any_transparent)
        stage.lane_mask = any_transparent
        _punchthrough_stages(stage, sectors, pixels, pw, transparent, options)
    return stage.to_bytes()


def compress_etc2_punchthrough_only(pixels_u8, options: Options):
    """CompressETC2Block with punchthrough alpha for blocks that hold a
    transparent pixel: for them the reference discards every opaque
    stage's result (bestError is reset to FLT_MAX, ETC.cpp:1874) and the
    punchthrough stages always give a finite error, so these stages alone
    give its bytes. A block without a transparent pixel gets valid but
    meaningless bytes; api.encode_etc2_punchthrough routes such blocks to
    compress_etc2 instead."""
    pixels, pw = extract_blocks(pixels_u8, options)
    transparent, pixels, pw, num_opaque = _zero_transparent(
        pixels_u8, pixels, pw, options)
    stage = StageBest(pixels.shape[0], pixels.device)
    sectors = _sector_assignments(pixels, pw, options, num_opaque)
    _punchthrough_stages(stage, sectors, pixels, pw, transparent, options)
    return stage.to_bytes()


def encode_virtual_tmode_punchthrough(stage: StageBest, rank_base: int,
                                      is_isolated_base, pixels, pw,
                                      transparent, options: Options):
    """EncodeVirtualTModePunchthrough (ETC.cpp:888-1264).

    The 8 tables x 16 premultiplier steps are one table-major candidate
    axis (K = 128). The reference scans 17 steps (ETC.cpp:1015), but step
    16 clamps to step 15's +L candidate on every lane with at most 15
    line pixels, which is every lane with a transparent pixel; the result
    is kept only on such lanes (compress_etc2's lane mask, or the
    dispatch's routing)."""
    n, dev = pixels.shape[0], pixels.device
    fake = bool(options.flags & Flags.ETC_USE_FAKE_BT709)
    pw_t = pw.transpose(1, 2)                              # [N, 3, 16]
    opaque = ~transparent

    iso_total, num_iso = _th_totals(is_isolated_base & opaque, pixels)
    line_total, num_line = _th_totals(~is_isolated_base & opaque, pixels)
    addend = (num_iso << 4) | num_iso
    numerator = iso_total + iso_total
    if not fake:
        numerator = numerator + addend[:, None]
    iso_q = lanes.div_floor(numerator, (num_iso * 34)[:, None])
    if fake:
        iso_q = _resolve_th_fake_bt709(iso_q, numerator, num_iso[:, None])

    # H-mode isolated colors of the 8 tables: [N, 3, 8]
    mods = i32(TH_MODS, dev)
    off_total = iso_total[:, :, None] + mods * num_iso[:, None, None]
    h_iso_q = torch.clamp_max(lanes.div_floor(
        off_total + off_total + addend[:, None, None],
        (num_iso * 34)[:, None, None]), 15)

    iso_error = torch.where(transparent, 0.0, compute_error(
        (iso_q | (iso_q << 4))[:, :, None], pw_t, options))  # [N, 16]

    # the premultiplier scan -L..L step 2 per lane (ETC.cpp:1015-1044),
    # steps past +L clamped to +L
    steps = torch.arange(VIRTUAL_T_STEPS, dtype=I32, device=dev)
    clamped = torch.minimum(num_line[:, None], -num_line[:, None] + 2 * steps)
    mod_addend = (clamped[:, None, :] * (2 * mods)[None, :, None]).reshape(
        n, 8 * VIRTUAL_T_STEPS)
    base = line_total + line_total
    if not fake:
        base = base + ((num_line << 4) | num_line)[:, None]
    numer = torch.clamp_min(base[:, :, None] + mod_addend[:, None, :], 0)
    q = torch.clamp_max(lanes.div_floor(
        numer, (num_line * 34)[:, None, None]), 15)        # [N, 3, K]
    if fake:
        q = torch.clamp_max(_resolve_th_fake_bt709(
            q, numer, num_line[:, None, None]), 15)
    # punchthrough T packs its channels red high, unlike the opaque T mode
    packed = (q[:, 0] << 10) | (q[:, 1] << 5) | q[:, 2]

    mod_k = i32(np.repeat(TH_MODS, VIRTUAL_T_STEPS), dev)
    low_bit_zero = i32(np.repeat(np.arange(8), VIRTUAL_T_STEPS) & 1,
                       dev) == 0
    h_q = h_iso_q.repeat_interleave(VIRTUAL_T_STEPS, dim=2)  # [N, 3, K]
    packed_h2 = (h_q[:, 0] << 10) | (h_q[:, 1] << 5) | h_q[:, 2]

    opts_nf, pw_nf = _without_fake_bt709(pixels, pw, options)
    pw_nf = pw_nf.transpose(1, 2)[:, :, :, None]           # [N, 3, 16, 1]

    def errors(recon):
        return error_from_terms(recon_terms(recon, opts_nf)[:, :, None, :],
                                pw_nf)                     # [N, 16, K]

    tr = transparent[:, :, None]
    h_errors = torch.where(tr, 0.0, errors(
        torch.clamp_min(((h_q << 4) | h_q) - mod_k, 0)))
    unq = (q << 4) | q
    e_plus = errors(torch.clamp_max(unq + mod_k, 255))
    e_minus = errors(torch.clamp_min(unq - mod_k, 0))
    # scalar LessOrEqual is `<` (ParallelMath.h:1589-1597)
    sel = torch.where(e_plus < e_minus, 1, 3).to(I32)
    line_err = torch.where(tr, 0.0, torch.minimum(e_plus, e_minus))
    del e_plus, e_minus
    t_err = _chain_sum(torch.minimum(line_err, iso_error[:, :, None]), 1)
    h_err = _chain_sum(torch.minimum(line_err, h_errors), 1)
    use_h = (h_err < t_err) & ((packed < packed_h2) == low_bit_zero)
    round_err = torch.where(use_h, h_err, t_err)

    iso_px_err = torch.where(use_h[:, None, :], h_errors,
                             iso_error[:, :, None])
    sel = torch.where(iso_px_err < line_err, 0, sel)
    sel = torch.where(tr, 2, sel)
    selectors = _selector_bits(sel, 1)
    del iso_px_err, line_err, h_errors, sel

    win_err, win = lanes.lex_min_with_index(round_err, (1,))
    best_packed = lanes.take_winner(packed, win)
    best_sel = lanes.take_winner(selectors, win)
    table = win // VIRTUAL_T_STEPS
    line_color = (best_packed[:, None] >> i32([10, 5, 0], dev)) & 15
    t_hi, t_lo = _emit_tmode(line_color, iso_q, best_sel, table, False)

    # selector remaps as bit math: sector [1, 0, 1, 0] == (sel & 1) ^ 1;
    # sign [1, 0, 0, 1] == gray(sel) ^ 1
    s = _unpack_selectors(best_sel)
    h_hi, h_lo = _emit_hmode(
        torch.stack([best_packed, lanes.take_winner(packed_h2, win)], 1),
        _pixel_bits((s & 1) ^ 1), _pixel_bits(((s ^ (s >> 1)) & 1) ^ 1),
        table, False)
    best_use_h = lanes.take_winner(use_h, win)
    stage.update(win_err, rank_base, torch.where(best_use_h, h_hi, t_hi),
                 torch.where(best_use_h, h_lo, t_lo))


def _test_half_block_punchthrough(packed, sector_pw, sector_transparent,
                                  modifier, options: Options):
    """TestHalfBlockPunchthrough (ETC.cpp:151-217) over a candidate axis:
    packed [N, K] int32, sector_pw [N, 8, 3], sector_transparent [N, 8],
    modifier [K] int32. The selector is remapped (1 -> 2, 2 -> 3); a
    transparent pixel takes selector 1 at error 0."""
    q = (packed[:, None, :] >> _channel_view(i32([0, 5, 10], packed.device),
                                             3)) & 31
    unquant = (q << 3) | (q >> 2)                          # [N, 3, K]
    modified = torch.stack([torch.maximum(unquant, modifier) - modifier,
                            unquant,
                            torch.clamp_max(unquant + modifier, 255)], 2)
    terms = recon_terms(modified, options)[:, :, :, None, :]
    pw = sector_pw.transpose(1, 2)[:, :, None, :, None]    # [N, 3, 1, 8, 1]
    best, sel = lanes.lex_min_with_index(error_from_terms(terms, pw), 1)
    tr = sector_transparent[:, :, None]                    # [N, 8, 1]
    best = torch.where(tr, 0.0, best)
    sel = torch.where(tr, 1, torch.clamp_max(sel << 1, 3))
    return _chain_sum(best, 1), _selector_bits(sel, 1)


def compress_etc1_punchthrough(stage: StageBest, rank_base: int, pixels, pw,
                               transparent, options: Options):
    """CompressETC1PunchthroughBlockInternal (ETC.cpp:2884-3058): the
    differential mode with transparent pixels, the 8 tables x 17 offsets
    one table-major candidate axis (K = 136)."""
    n, dev = pixels.shape[0], pixels.device
    n_offs = 17
    mods = i32(PUNCHTHROUGH_MODIFIERS, dev)
    mod_k = i32(np.repeat(PUNCHTHROUGH_MODIFIERS, n_offs), dev)
    table_k = i32(np.repeat(np.arange(8), n_offs), dev).expand(n, -1)
    offs = torch.arange(-8, 9, dtype=I32, device=dev)
    for flip in range(2):
        diff_data, can_ignore = [], []
        for sector in range(2):
            idx = i32(FLIP_TABLES[flip][sector], dev)
            s_tr = transparent.index_select(1, idx)        # [N, 8]
            cum = torch.sum(pixels.index_select(1, idx), dim=1, dtype=I32)
            can_ignore.append(s_tr.all(dim=1))
            # the reference counts *transparent* pixels into
            # sectorNumOpaque (ETC.cpp:2955-2957), replicated
            count = torch.sum(s_tr, dim=1, dtype=I32)
            clamped = torch.maximum(-count[:, None],
                                    torch.minimum(count[:, None], offs))
            offset = (clamped[:, None, :] * mods[None, :, None]).reshape(n, -1)
            cu = torch.minimum((255 * count)[:, None, None], torch.clamp_min(
                cum[:, :, None] + offset[:, None, :], 0))  # [N, 3, K]
            numer = (cu << 5) - cu + (cu >> 3) + (count << 7)[:, None, None]
            quant = lanes.div_floor(
                numer, (torch.clamp_min(count, 1) << 8)[:, None, None])
            packed = quant[:, 0] | (quant[:, 1] << 5) | (quant[:, 2] << 10)
            err, sel = _test_half_block_punchthrough(
                packed, pw.index_select(1, idx), s_tr, mod_k, options)
            diff_data.append(dict(error=err, color=packed, selectors=sel,
                                  table=table_k,
                                  urank=_unique_rank(packed, 8, n_offs)))
        win = _resolve_differential(diff_data, n, stage.error,
                                    can_ignore=can_ignore)
        hi, lo = _emit_etc1(flip, 1, win, n, transparent=True)
        stage.update(win[0]["total"], rank_base + flip, hi, lo)
