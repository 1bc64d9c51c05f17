"""ETC1, ETC2 alpha and EAC11 encoders.

The PyTorch counterpart of the ETC1 and alpha halves of the JAX package's
models/etc.py, itself the batched form of the reference's ETCComputer
(ConvectionKernels_ETC.cpp). Every function works on N blocks at once on
the blocks' device; per-lane branching is `torch.where`.

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

Candidate visitation order and float32 operation order follow the JAX
package, so the bytes equal its op-by-op bytes. A float32 sum over pixels
stays a chain of adds in the reference's order; a three-channel error is
(d0 * d0 + d1 * d1) + d2 * d2; integer sums are one `torch.sum`. Integers
are int32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lanes
from ..options import Flags, Options
from ..tables import etc_tables

F32, I32 = torch.float32, torch.int32

FLIP_TABLES = np.array([
    [[0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15]],
    [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15]],
], dtype=np.int32)  # g_flipTables (ETC.cpp:47-57)

INF = float("inf")
FLT_MAX = lanes.FLT_MAX
RANK_NONE = 2**30

PIXEL_SELECTOR_ORDER = np.array([0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7,
                                 11, 15], dtype=np.int32)
MODIFIER_CODES = np.array([3, 2, 0, 1], dtype=np.int32)


def _f32(v):
    """A Python float holding float32(v): torch multiplies a float32 tensor
    by it in float32, as JAX multiplies by an np.float32."""
    return float(np.float32(v))


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


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
    w = torch.tensor(_weights(options), dtype=F32, device=recon.device)
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
        w = torch.tensor(_weights(options), dtype=F32, device=p.device)
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
    shifts = _i32([24, 16, 8, 0], words.device)
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
    offsets = _i32(_padded_offsets()[0], cum.device)
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
    slots = _i32(np.concatenate([t * width + np.arange(k)
                                 for t, k in enumerate(kb)]), dev)
    ucolor = runs.reshape(n, -1).index_select(1, slots)   # [N, A]
    is_empty = ucolor == _EMPTY_COLOR
    ucolor = torch.where(is_empty, torch.zeros_like(ucolor), ucolor)

    error, selectors = _test_half_block_flat(
        ucolor, sector_pw, mods_a, differential, options)
    error = torch.where(is_empty, torch.full_like(error, INF), error)
    table = _i32(slot_tables, dev).expand(n, -1)
    return error, ucolor, selectors, table


def _unquantize(packed, differential: bool):
    """The 3 channels of packed 5-5-5 (or 4-4-4 in 5-bit fields) colors,
    expanded to 8 bits, stacked on dim 1."""
    shifts = _channel_view(_i32([0, 5, 10], packed.device), packed.dim() + 1)
    q = (packed.unsqueeze(1) >> shifts) & 31
    if differential:
        return (q << 3) | (q >> 2)
    return (q << 4) | q


def _selector_bits(sel, px_dim):
    """OR over the pixel axis `px_dim` (8 pixels) of sel << (2 * px)."""
    shape = [1] * sel.dim()
    shape[px_dim] = 8
    shifts = (2 * torch.arange(8, dtype=I32, device=sel.device)).view(shape)
    return torch.sum(sel << shifts, dim=px_dim, dtype=I32)


def _test_half_block(packed, sector_pw, modifiers, differential: bool,
                     options: Options):
    """TestHalfBlock (ETC.cpp:94-149) on the dense candidate axes.

    packed: int32 [N, T, C]; sector_pw [N, 8, 3] float32; modifiers:
    [T, 4]. Returns (error [N, T, C] float32, selectors [N, T, C] int32).
    The pixels stay a loop: the per-pixel grids are [N, 4, T, C] (a pixel
    axis would make them 8 times that).
    """
    mods = _i32(np.asarray(modifiers).T, packed.device)   # [4, T]
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
    mods = _i32(np.asarray(mods_a).T, packed.device)       # [4, A]
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
        idx = _i32(FLIP_TABLES[flip][sector], pixels.device)
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
                    tables_b = _i32(np.repeat(np.arange(8), c_count),
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
    table = _i32(etc_tables.fake_bt709_rounding16(), cu[0].device)
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

    # selectors to full-block order, remapped to MODIFIER_CODES [3, 2, 0,
    # 1] as bit math: out_hi = ~s_hi, out_lo = ~gray(s)
    shifts = 2 * torch.arange(8, dtype=I32, device=hi.device)
    s = torch.cat([(win[sector]["selectors"][:, None] >> shifts) & 3
                   for sector in range(2)], dim=1)         # [N, 16]
    codes = ((((s >> 1) ^ 1) << 1) | (((s ^ (s >> 1)) & 1) ^ 1))
    dst = np.concatenate(FLIP_TABLES[flip])
    src = np.argsort(dst)[PIXEL_SELECTOR_ORDER]            # block order
    ordered = codes.index_select(1, _i32(src, hi.device))
    bit = torch.arange(16, dtype=I32, device=hi.device)
    lo = torch.sum(((ordered & 1) << bit) | (((ordered >> 1) & 1)
                                             << (bit + 16)), dim=1, dtype=I32)
    return hi, lo


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
    rounding = _i32(etc_tables.alpha_rounding_tables(), dev).reshape(-1)
    mod_pos = _i32(etc_tables.ALPHA_MODIFIER_TABLE_POSITIVE, dev).reshape(-1)
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
        _i32(a, dev) for a in _alpha_candidates())
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
        1, _i32(np.argsort(PIXEL_SELECTOR_ORDER), dev)).to(torch.int64)
    shifts = torch.arange(45, -1, -3, dtype=torch.int64, device=dev)
    stream = torch.sum(ordered << shifts, dim=1)           # 48 bits
    cols = [best_base & 0xFF, (best_mult << 4) | best_table]
    cols += [((stream >> (40 - 8 * k)) & 0xFF).to(I32) for k in range(6)]
    return torch.stack(cols, dim=-1).to(torch.uint8)
