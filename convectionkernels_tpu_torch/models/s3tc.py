"""S3TC (BC1-BC5) encoders.

The PyTorch counterpart of the JAX package's models/s3tc.py, itself the
batched form of the reference's S3TCComputer (ConvectionKernels_S3TC.cpp).
Every function works on N blocks at once on the blocks' device; per-lane
branching is `torch.where`. Candidate visitation order (range x tweak x
refine, then the count partitions) and float32 operation order follow the
reference, so the bytes equal the JAX package's.

The 16 pixels of a block are a tensor axis wherever the work is
elementwise: selection, reconstruction and per-pixel error terms run over
[N, 16] at once. A float32 sum over pixels whose terms are not integers
(the paranoid and weighted errors, the refiner's totals, the exhaustive
fit's totals) stays a chain in the reference's order, pixel outer and
channel inner, one add a step. An integer sum is the same in any order and
is one `torch.sum`. Integers are int32 throughout.

The interpolated-alpha chain (BC3's alpha, BC4, BC5) is one hand-written
kernel on the card, csrc/s3tc_alpha.cu behind s3tc_alpha; its torch body,
s3tc_alpha_plain, is the CPU path, and the card tests hold the two bit for
bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cuda_lib, programs, tracing
from ..ops import lanes, pca
from ..ops.index_select import IndexSelector, aggregated_error_finalize
from ..ops.lanes import F32, I32
from ..ops.refine import EndpointRefiner
from ..options import Flags
from ..tables import s3tc_single_color

PARANOIA = float(np.float32(0.03))  # ParanoidFactorForSpan's factor

# the csrc/ libraries an S3TC encode launches
LIBRARIES = ("s3tc_alpha",)

# indexOrder tables for the final BC1 pack (S3TC.cpp:980-1030), indexed by
# case: 0 = range4 equal-eps, 1 = range4 swapped, 2 = range4 unswapped,
# 3 = range3 swapped, 4 = range3 unswapped.
_INDEX_ORDER = np.array([
    [0, 0, 0, 0],
    [1, 3, 2, 0],
    [0, 2, 3, 1],
    [1, 2, 0, 3],
    [0, 2, 1, 3],
], dtype=np.int32)


def quantize_to_5bits(v):
    """QuantizeTo5Bits (S3TC.cpp:58-62): multiply-shift + bit-replication."""
    reduced = (v * 249 + 1024) >> 11
    return (reduced << 3) | (reduced >> 2)


def quantize_to_6bits(v):
    """QuantizeTo6Bits (S3TC.cpp:52-56)."""
    reduced = (v * 253 + 512) >> 10
    return (reduced << 2) | (reduced >> 4)


def quantize_to_565(ep):
    """QuantizeTo565 (S3TC.cpp:64-69)."""
    return [quantize_to_5bits(ep[0]), quantize_to_6bits(ep[1]),
            quantize_to_5bits(ep[2])]


def paranoid_factor_for_span(span):
    """ParanoidFactorForSpan (S3TC.cpp:71-74)."""
    return torch.abs(lanes.to_float(span)) * PARANOIA


def paranoid_diff(a, b, d):
    """ParanoidDiff (S3TC.cpp:76-81)."""
    abs_diff = torch.abs(lanes.to_float(a - b))
    abs_diff = abs_diff + d
    return abs_diff * abs_diff


def _chain(terms):
    """0 + terms[..., 0] + terms[..., 1] + ..., one float32 add a step."""
    total = torch.zeros(terms.shape[:-1], dtype=F32, device=terms.device)
    for j in range(terms.shape[-1]):
        total = total + terms[..., j]
    return total


def _full(like, value):
    return torch.full_like(like, value, dtype=I32)


class _Best:
    """Lane-parallel best-candidate state: error [N], endpoints [N, 2, 3],
    indexes [N, 16] and range [N]."""

    def __init__(self, n, device):
        self.error = torch.full((n,), lanes.FLT_MAX, dtype=F32, device=device)
        self.endpoints = torch.zeros((n, 2, 3), dtype=I32, device=device)
        self.indexes = torch.zeros((n, 16), dtype=I32, device=device)
        self.range = torch.zeros((n,), dtype=I32, device=device)

    def update(self, better, error, endpoints, indexes, range_: int):
        """endpoints: two lists of 3 int32 [N]; indexes: int32 [N, 16]."""
        eps = torch.stack([torch.stack(e, dim=-1) for e in endpoints], dim=1)
        self.error = torch.where(better, error, self.error)
        self.endpoints = torch.where(better[:, None, None], eps,
                                     self.endpoints)
        self.indexes = torch.where(better[:, None], indexes, self.indexes)
        self.range = torch.where(better, _full(self.range, range_),
                                 self.range)


def _select_and_score(paranoid, selector, factors, pixel, float_pixel, cw_sq):
    """SelectIndexLDR and the per-channel error terms of TestEndpoints
    (S3TC.cpp:221-247) for pixel values broadcast against the selector's
    endpoints: (index, 3 terms), the terms float32 paranoid errors times
    the squared weight, or int32 squared differences."""
    index = selector.select_index_ldr(float_pixel)
    recon = selector.reconstruct_ldr_precise(index)
    if paranoid:
        terms = [paranoid_diff(recon[ch], pixel[ch], factors[ch]) * cw_sq[ch]
                 for ch in range(3)]
    else:
        terms = [lanes.sq_diff_int(recon[ch], pixel[ch]) for ch in range(3)]
    return index, terms


def _quantized_selector(unquantized_eps, range_, cw, paranoid):
    endpoints = [quantize_to_565(unquantized_eps[0]),
                 quantize_to_565(unquantized_eps[1])]
    selector = IndexSelector(cw, endpoints, range_, 3)
    factors = ([paranoid_factor_for_span(endpoints[0][ch] - endpoints[1][ch])
                for ch in range(3)] if paranoid else None)
    return endpoints, selector, factors


def _test_endpoints(flags, pixels, float_pixels, pw_pixels, unquantized_eps,
                    range_: int, cw, cw_sq, best: _Best, refiner):
    """TestEndpoints (S3TC.cpp:190-258) over the 16 pixels at once.

    pixels / float_pixels / pw_pixels: [N, 16, 4]; unquantized_eps: two
    lists of 3 int32 [N]. `refiner` (or None) takes every pixel."""
    paranoid = bool(flags & Flags.S3TC_PARANOID)
    endpoints, selector, factors = _quantized_selector(
        [[e[:, None] for e in eps] for eps in unquantized_eps], range_, cw,
        paranoid)
    index, terms = _select_and_score(
        paranoid, selector, factors, [pixels[..., ch] for ch in range(3)],
        [float_pixels[..., ch] for ch in range(3)], cw_sq)
    if refiner is not None:
        refiner.contribute_unweighted_pw_pixels(
            [pw_pixels[..., ch] for ch in range(3)], index)
    if paranoid:
        # pixel outer, channel inner, as the reference adds them
        error = _chain(torch.stack(terms, dim=-1).flatten(1))
    else:
        agg = [t.sum(dim=1, dtype=I32) for t in terms]
        error = aggregated_error_finalize(agg, bool(flags & Flags.UNIFORM),
                                          cw_sq)
    better = error < best.error
    best.update(better, error, [[e[:, 0] for e in eps] for eps in endpoints],
                index, range_)


def _test_single_color(flags, pixels, range_: int, cw_sq, best: _Best):
    """TestSingleColor (S3TC.cpp:83-188)."""
    paranoid = bool(flags & Flags.S3TC_PARANOID)
    tables = s3tc_single_color.load_tables(pixels.device)
    totals = pixels[..., :3].sum(dim=1, dtype=I32)
    average = (totals + 8) >> 4

    key = f"{range_ - 1}{'_p' if paranoid else ''}"
    entries = [tables[f"{6 if ch == 1 else 5}_{key}"][average[:, ch].long()]
               for ch in range(3)]  # [N, 4]: min, max, actualColor, span
    eps = [[e[:, 0] for e in entries], [e[:, 1] for e in entries]]
    interpolated = [e[:, 2:3] for e in entries]

    if paranoid:
        terms = [paranoid_diff(interpolated[ch], pixels[..., ch],
                               paranoid_factor_for_span(
                                   entries[ch][:, 3:4])) * cw_sq[ch]
                 for ch in range(3)]
    else:
        terms = [lanes.to_float(lanes.sq_diff_int(
            interpolated[ch], pixels[..., ch])) * cw_sq[ch]
            for ch in range(3)]
    error = _chain(torch.stack(terms, dim=-1).flatten(1))

    better = error < best.error
    best.update(better, error, eps, torch.ones_like(best.indexes), range_)


def pack_rgb(pixels, flags: int, channel_weights, alpha_test: bool,
             alpha_threshold: float, exhaustive: bool, max_tweak_rounds: int,
             num_refine_rounds: int):
    """PackRGB (S3TC.cpp:717-1052): uint8 or int32 [N, 16, 4] RGBA blocks
    -> uint8 [N, 8] BC1 color blocks on the blocks' device."""
    num_refine_rounds = max(num_refine_rounds, 1)
    max_tweak_rounds = max(max_tweak_rounds, 1)

    p = pixels.to(I32)
    n, dev = p.shape[0], p.device
    cw = [np.float32(w) for w in channel_weights]
    cw_sq = [float(w * w) for w in cw]
    cw_t = programs.constant(cw, dev, np.float32)

    if alpha_test:
        # threshold computed in float32 exactly as the C++ float expression
        thr = int(np.floor(np.float32(alpha_threshold) * np.float32(255.0)
                           + np.float32(0.5)))
        alpha = (p[..., 3] >= thr).to(I32) * 255
        p = torch.cat([p[..., :3], alpha[..., None]], dim=-1)

    float_pixels = lanes.to_float(p)
    pw_pixels = float_pixels * cw_t

    weights = torch.ones((n, 16), dtype=F32, device=dev)
    if alpha_test:
        weights = torch.where(p[..., 3] < 255, torch.zeros_like(weights),
                              weights)

    centroid, direction, min_d, max_d = pca.endpoint_selector(
        [[pw_pixels[:, px, ch] for ch in range(3)] for px in range(16)],
        [weights[:, px] for px in range(16)], 3)
    base, offset = pca.get_endpoints(centroid, direction, min_d, max_d, cw, 3)

    best = _Best(n, dev)
    if exhaustive:
        partitions = len(_count_partitions(4)) + (
            len(_count_partitions(3)) if alpha_test else 0)
        with tracing.stage("s3tc.exhaustive", blocks=n,
                           pairs=n * partitions):
            _pack_rgb_exhaustive(flags, p, float_pixels, base, offset, cw,
                                 cw_sq, cw_t, alpha_test, best)
    else:
        zero_f = torch.zeros((n,), dtype=F32, device=dev)
        for range_ in range(3 if alpha_test else 4, 5):
            tweak_rounds = min(lanes.tweak_rounds_for_range(range_),
                               max_tweak_rounds)
            for tweak in range(tweak_rounds):
                endpoints = pca.finish_ldr(base, offset, tweak, range_, 3)
                for refine in range(num_refine_rounds):
                    last = refine == num_refine_rounds - 1
                    # the last round's refit is never read
                    refiner = (None if last else
                               EndpointRefiner(zero_f, 3, range_, cw))
                    _test_endpoints(flags, p, float_pixels, pw_pixels,
                                    endpoints, range_, cw, cw_sq, best,
                                    refiner)
                    if not last:
                        endpoints = refiner.get_refined_endpoints_ldr()

    return _pack_bc1_blocks(best)


@functools.lru_cache(maxsize=None)
def _count_partitions(n_counts: int):
    """The count partitions of the 16 sorted pixels in the reference's
    visitation order (S3TC.cpp:885-935): 965 of 4 counts, 150 of 3.
    Shared: never write to it."""
    out = []
    for n0 in range(16):
        for n1 in range((15 if n0 == 0 else 16 - n0) + 1):
            if n_counts == 3:
                n2 = 16 - n1 - n0
                if n2 != 16:
                    out.append([n0, n1, n2])
                continue
            rest = 16 - n1 - n0
            for n2 in range((15 if rest == 16 else rest) + 1):
                n3 = 16 - n2 - n1 - n0
                if n3 != 16:
                    out.append([n0, n1, n2, n3])
    return np.asarray(out, dtype=np.int32)


def _pack_rgb_exhaustive(flags, pixels, float_pixels, base, offset, cw,
                         cw_sq, cw_t, alpha_test, best):
    """Exhaustive cluster-fit path (S3TC.cpp:798-935).

    Sorts pixels along an 11-bit projection and least-squares fits every
    count-partition of the sorted order.
    """
    n, dev = pixels.shape[0], pixels.device

    # 11-bit sort keys with the pixel's index in the low 4 bits; range 2048
    # only selects, it never reconstructs
    sort_ep = pca.finish_ldr(base, offset, 0, 11, 3)
    sort_selector = IndexSelector(
        cw, [[e[:, None] for e in eps] for eps in sort_ep], 1 << 11, 3)
    keys = sort_selector.select_index_ldr(
        [float_pixels[..., ch] for ch in range(3)]) << 4
    if alpha_test:
        keys = torch.where(pixels[..., 3] < 255, _full(keys, -16), keys)
    keys = keys + torch.arange(16, dtype=I32, device=dev)
    # Every key is distinct (the low 4 bits are the pixel), so the order is
    # unique: the ascending order of the reference's insertion-sort network
    # (S3TC.cpp:830-843) is the one torch.sort gives.
    keys = torch.sort(keys, dim=1).values

    first_element = (keys < 0).sum(dim=1, dtype=I32)
    num_elements = 16 - first_element

    # sortedInputs[15-e] = pixels[key[e] & 15] for e >= firstElement, zero
    # elsewhere (S3TC.cpp:845-878)
    gathered = torch.gather(pixels, 1,
                            (keys & 15).long()[..., None].expand(-1, -1, 4))
    valid = (torch.arange(16, device=dev)[None, :]
             >= first_element[:, None])[..., None]
    sorted_inputs = torch.where(valid, gathered,
                                torch.zeros_like(gathered)).flip(1)
    pw_sorted = lanes.to_float(sorted_inputs) * cw_t

    _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements,
                 _count_partitions(4), cw, cw_sq, best)
    _test_single_color(flags, pixels, 4, cw_sq, best)
    if alpha_test:
        _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements,
                     _count_partitions(3), cw, cw_sq, best)
        _test_single_color(flags, pixels, 3, cw_sq, best)


def _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements,
                 counts, cw, cw_sq, best):
    """TestCounts over all count-partitions at once (S3TC.cpp:260-301).

    counts: [P, n_counts] in the reference's visitation order. A lane stops
    contributing once a count group overruns numElements; element n of
    group i contributes only while n < numElements.
    """
    p_count, n_counts = counts.shape
    n, dev = pixels.shape[0], pixels.device

    # element slot -> (group index, within-group position), static
    grp = np.zeros((p_count, 16), dtype=np.int32)
    pos = np.zeros((p_count, 16), dtype=np.int32)
    for p_i in range(p_count):
        e = 0
        for i in range(n_counts):
            for n_in in range(counts[p_i, i]):
                grp[p_i, e], pos[p_i, e] = i, n_in
                e += 1
    counts_t = programs.constant(counts, dev)
    grp_t = programs.constant(grp, dev)
    pos_t = programs.constant(pos, dev)

    # prefix_ok[i] = every group before i fits within numElements
    ne = num_elements[:, None]
    prefix_ok = [torch.ones((n, p_count), dtype=torch.bool, device=dev)]
    for i in range(n_counts - 1):
        prefix_ok.append(prefix_ok[-1] & (counts_t[None, :, i] <= ne))

    rcp_max = float(np.float32(1.0) / np.float32(n_counts - 1))
    zero = torch.zeros((), dtype=F32, device=dev)
    acc = torch.zeros((n, p_count), dtype=F32, device=dev)
    tv, vv, tt, tsum = [acc] * 3, [acc] * 3, acc, acc
    wu = torch.zeros((n, p_count), dtype=I32, device=dev)
    for e in range(16):
        i_e = grp_t[None, :, e]
        pref = prefix_ok[0]
        for i in range(1, n_counts):
            pref = torch.where(i_e == i, prefix_ok[i], pref)
        mask = pref & (pos_t[None, :, e] < ne)
        t = lanes.to_float(i_e) * rcp_max
        for ch in range(3):
            v = pw_sorted[:, e, ch, None]
            tv[ch] = tv[ch] + torch.where(mask, t * v, zero)
            vv[ch] = vv[ch] + torch.where(mask, v, zero)
        tt = tt + torch.where(mask, t * t, zero)
        tsum = tsum + torch.where(mask, t, zero)
        wu = wu + mask.to(I32)
    del prefix_ok, pref, mask

    refiner = EndpointRefiner(acc, 3, n_counts, cw)
    refiner.tv, refiner.v, refiner.tt, refiner.t, refiner.wu = \
        tv, vv, tt, tsum, wu
    del tv, vv, tt, tsum, wu
    e0, e1 = refiner.get_refined_endpoints_ldr()
    del refiner

    err, eps = _test_endpoints_batch(flags, pixels, float_pixels, [e0, e1],
                                     n_counts, cw, cw_sq)
    win = lanes.first_argmin(err, -1).long()[:, None]

    def g(x):
        return torch.gather(x, 1, win)[:, 0]

    win_err = g(err)
    win_eps = [[g(eps[j][ch]) for ch in range(3)] for j in range(2)]
    # The winner's indexes are recomputed from its endpoints rather than
    # kept for every partition: selection is elementwise in the endpoints
    # and the pixel, so the same inputs give the same indexes.
    selector = IndexSelector(cw, [[x[:, None] for x in eps_j]
                                  for eps_j in win_eps], n_counts, 3)
    indexes = selector.select_index_ldr(
        [float_pixels[..., ch] for ch in range(3)])
    better = win_err < best.error
    best.update(better, win_err, win_eps, indexes, n_counts)


def _test_endpoints_batch(flags, pixels, float_pixels, unquantized_eps,
                          range_: int, cw, cw_sq):
    """TestEndpoints (S3TC.cpp:190-258) over a trailing candidate axis.

    unquantized_eps: two lists of 3 int32 [N, P]. Returns (error [N, P],
    quantized endpoints: two lists of 3 int32 [N, P])."""
    paranoid = bool(flags & Flags.S3TC_PARANOID)
    endpoints, selector, factors = _quantized_selector(
        unquantized_eps, range_, cw, paranoid)
    error = torch.zeros(endpoints[0][0].shape, dtype=F32,
                        device=pixels.device)
    agg = [torch.zeros_like(endpoints[0][0]) for _ in range(3)]
    for px in range(16):
        _, terms = _select_and_score(
            paranoid, selector, factors,
            [pixels[:, px, ch, None] for ch in range(3)],
            [float_pixels[:, px, ch, None] for ch in range(3)], cw_sq)
        for ch in range(3):
            if paranoid:
                error = error + terms[ch]
            else:
                agg[ch] = agg[ch] + terms[ch]
    if not paranoid:
        error = aggregated_error_finalize(agg, bool(flags & Flags.UNIFORM),
                                          cw_sq)
    return error, endpoints


def pack_explicit_alpha(pixels, channel: int):
    """PackExplicitAlpha (S3TC.cpp:303-341): BC2 4-bit alpha -> uint8
    [N, 8]."""
    p = pixels[..., channel].to(I32)
    zero = torch.zeros_like(p[:, :1])
    selector = IndexSelector([1.0], [[zero], [_full(zero, 255)]], 16, 1)
    index = selector.select_index_ldr([lanes.to_float(p)])
    return (index[:, 0::2] | (index[:, 1::2] << 4)).to(torch.uint8)


def _heuristic_candidates():
    """(first_index, last_index) pairs of the clipping heuristic with at
    least one pixel skipped, in the reference's order (S3TC.cpp:489-538)."""
    pairs = [(f, l) for f in range(16) for l in range(f, 16)
             if f + (15 - l) > 0]
    return (np.asarray([f for f, _ in pairs], dtype=np.int64),
            np.asarray([l for _, l in pairs], dtype=np.int64))


def pack_interpolated_alpha(pixels, channel: int, is_signed: bool,
                            max_tweak_rounds: int, num_refine_rounds: int):
    """PackInterpolatedAlpha (S3TC.cpp:343-715): BC3 alpha / BC4 / BC5 channel.

    pixels: [N, 16, C] blocks, values 0-255 (signed inputs already biased
    into unsigned space by the caller, bias_signed_input). Returns uint8
    [N, 8]: s3tc_alpha, csrc/s3tc_alpha.cu for a CUDA tensor, its plain
    version for a CPU one.
    """
    if pixels.device.type == "cuda":
        cuda_lib.build_all(LIBRARIES)
        if pixels.dtype != torch.uint8:
            pixels = pixels.to(I32)
        pixels = pixels.contiguous()
    return s3tc_alpha(pixels, channel, is_signed, max_tweak_rounds,
                      num_refine_rounds)


def s3tc_alpha(pixels, channel: int, is_signed: bool, max_tweak_rounds: int,
               num_refine_rounds: int):
    """pack_interpolated_alpha of channel `channel` of uint8 or int32
    [N, 16, C] blocks -> uint8 [N, 8]: csrc/s3tc_alpha.cu for a CUDA tensor
    (contiguous), s3tc_alpha_plain for a CPU one."""
    if pixels.device.type == "cpu":
        return s3tc_alpha_plain(pixels, channel, is_signed, max_tweak_rounds,
                                num_refine_rounds)
    if pixels.device.type != "cuda":
        raise ValueError(f"s3tc_alpha: expected a CPU or CUDA tensor, got "
                         f"one on {pixels.device}")
    if pixels.dtype not in (torch.uint8, I32):
        raise TypeError(f"s3tc_alpha: expected uint8 or int32 blocks, got "
                        f"{pixels.dtype}")
    if pixels.dim() != 3 or pixels.shape[1] != 16 or \
            not 0 <= channel < pixels.shape[2]:
        raise ValueError(f"s3tc_alpha: expected [N, 16, C] blocks with "
                         f"channel {channel} < C, got {tuple(pixels.shape)}")
    if not pixels.is_contiguous():
        raise ValueError("s3tc_alpha: the blocks must be contiguous")
    n = pixels.shape[0]
    out = torch.empty((n, 8), dtype=torch.uint8, device=pixels.device)
    cuda_lib.launch("s3tc_alpha", "s3tc_alpha", pixels,
                    int(pixels.dtype == I32), pixels.shape[2], channel,
                    int(is_signed), max(max_tweak_rounds, 1),
                    max(num_refine_rounds, 1), n, out)
    return out


def s3tc_alpha_plain(pixels, channel: int, is_signed: bool,
                     max_tweak_rounds: int, num_refine_rounds: int):
    """s3tc_alpha in torch ops, lane-parallel over the blocks on their
    device."""
    max_tweak_rounds = max(max_tweak_rounds, 1)
    num_refine_rounds = max(num_refine_rounds, 1)

    v = pixels[..., channel].to(I32)
    n, dev = v.shape[0], v.device
    zero_f = torch.zeros((n,), dtype=F32, device=dev)
    one_weight = [1.0]

    high_terminal = 254 if is_signed else 255
    if is_signed:
        v = torch.clamp_max(v, high_terminal)
    fv = lanes.to_float(v)

    # The reference bubble-sorts the plain values (S3TC.cpp:372-385): the
    # ascending values are the same whatever sort gives them.
    sorted_px = torch.sort(v, dim=1).values

    best_error = torch.full((n,), lanes.FLT_MAX, dtype=F32, device=dev)
    best_is_full = torch.zeros((n,), dtype=I32, device=dev)
    best_ep = torch.zeros((n, 2), dtype=I32, device=dev)
    best_indexes = torch.zeros((n, 16), dtype=I32, device=dev)

    def update_best(error, is_full_range, indexes, ep):
        nonlocal best_error, best_is_full, best_indexes, best_ep
        better = error < best_error
        best_error = torch.minimum(error, best_error)
        best_is_full = torch.where(better, _full(best_is_full, is_full_range),
                                   best_is_full)
        best_indexes = torch.where(better[:, None], indexes, best_indexes)
        best_ep = torch.where(better[:, None], torch.stack(ep, dim=1),
                              best_ep)

    def rounds(base, offset, select_range, num_tweak, test_round):
        """The tweak x refine chain: test_round(selector) gives (error,
        indexes, refiner index, refiner mask) of one round's endpoints.
        Both phases seed with FinishLDR at range 8, though the reduced
        phase selects with range 6, as the reference does (S3TC.cpp:567)."""
        is_full_range = int(select_range == 8)
        for tweak in range(num_tweak):
            e0, e1 = pca.finish_ldr(base, offset, tweak, 8, 1)
            ep = [e0[0], e1[0]]
            for refine in range(num_refine_rounds):
                if is_signed:
                    ep = [torch.clamp_max(e, high_terminal) for e in ep]
                selector = IndexSelector(
                    one_weight, [[ep[0][:, None]], [ep[1][:, None]]],
                    select_range, 1)
                error, indexes, refit_index, refit_mask = test_round(selector)
                update_best(error, is_full_range, indexes, ep)
                if refine != num_refine_rounds - 1:
                    refiner = EndpointRefiner(zero_f, 1, select_range,
                                              one_weight)
                    refiner.contribute_unweighted_pw_pixels(
                        [fv], refit_index, mask=refit_mask)
                    r0, r1 = refiner.get_refined_endpoints_ldr()
                    ep = [r0[0], r1[0]]

    # --- Full-precision 8-interpolant phase (S3TC.cpp:400-469) ---
    def full_range_round(selector):
        index = selector.select_index_ldr([fv])
        recon = selector.reconstruct_ldr_precise(index)[0]
        agg = lanes.sq_diff_int(recon, v).sum(dim=1, dtype=I32)
        return lanes.to_float(agg), index, index, None

    rounds([lanes.to_float(sorted_px[:, 0])],
           [lanes.to_float(sorted_px[:, 15] - sorted_px[:, 0])], 8,
           min(lanes.tweak_rounds_for_range(8), max_tweak_rounds),
           full_range_round)

    # --- Reduced-precision phase, reserved endpoints (S3TC.cpp:471-649) ---
    # Clipping heuristic: assign end indexes while clearance*10 <= range.
    heuristic_min = sorted_px[:, 0]
    heuristic_max = sorted_px[:, 15]
    lowest_clearance = torch.minimum(heuristic_min,
                                     high_terminal - heuristic_max)
    clearance_x10 = (lowest_clearance << 2) + (lowest_clearance << 4)
    # scalar build's LessOrEqual is actually `<` (ParallelMath.h:1589-1597)
    can_try_clipping = clearance_x10 < heuristic_max - heuristic_min

    # The reference's bestSkipCount is never updated (S3TC.cpp:489-538), so
    # the last candidate in iteration order that passes wins.
    zero_col = torch.zeros_like(sorted_px[:, :1])
    low_clearances = torch.cat([zero_col, sorted_px[:, :15]], dim=1)
    high_clearances = torch.cat(
        [zero_col, high_terminal - sorted_px[:, 1:].flip(1)], dim=1)
    first_i, last_i = (programs.constant(a, dev)
                       for a in _heuristic_candidates())
    clearance = torch.maximum(high_clearances[:, 15 - last_i],
                              low_clearances[:, first_i])
    cl_x10 = (clearance << 2) + (clearance << 4)
    passes = can_try_clipping[:, None] & (
        cl_x10 < sorted_px[:, last_i] - sorted_px[:, first_i])
    last_pass = torch.where(
        passes, torch.arange(len(first_i), dtype=I32, device=dev),
        _full(passes, -1)).amax(dim=1)
    chosen = last_pass.clamp_min(0).long()
    any_pass = last_pass >= 0
    heuristic_min = torch.where(any_pass, torch.gather(
        sorted_px, 1, first_i[chosen][:, None])[:, 0], heuristic_min)
    heuristic_max = torch.where(any_pass, torch.gather(
        sorted_px, 1, last_i[chosen][:, None])[:, 0], heuristic_max)

    # the least value above 0 (else 1) and the greatest below the high
    # terminal (else high_terminal - 1): S3TC.cpp:540-552's loop
    big = _full(sorted_px, 1 << 30)
    simple_min = torch.where(sorted_px > 0, sorted_px, big).amin(dim=1)
    simple_min = torch.where(simple_min == 1 << 30, _full(simple_min, 1),
                             simple_min)
    simple_max = torch.where(sorted_px < high_terminal, sorted_px,
                             _full(sorted_px, -1)).amax(dim=1)
    simple_max = torch.where(simple_max < 0,
                             _full(simple_max, high_terminal - 1), simple_max)

    # each pixel's error at the reserved endpoints 0 (index 6) and the high
    # terminal (index 7), the same in every round
    zero_err = lanes.to_float(lanes.sq_diff_int(torch.zeros_like(v), v))
    high_err = lanes.to_float(lanes.sq_diff_int(_full(v, high_terminal), v))
    reserved_index = torch.where(high_err < zero_err, _full(v, 7),
                                 _full(v, 6))
    reserved_err = torch.minimum(zero_err, high_err)

    def reduced_range_round(selector):
        sel_index = selector.select_index_ldr([fv])
        recon = selector.reconstruct_ldr_precise(sel_index)[0]
        sel_err = lanes.to_float(lanes.sq_diff_int(recon, v))
        sel_better = sel_err < reserved_err
        index = torch.where(sel_better, sel_index, reserved_index)
        # Each term is the square of an integer difference, at most 65025,
        # and 16 of them stay below 2^24: every partial sum is an integer
        # float32 holds exactly, so this sum is the same in any order.
        error = torch.minimum(reserved_err, sel_err).sum(dim=1)
        return error, index, sel_index, sel_better

    num_tweak6 = min(lanes.tweak_rounds_for_range(6), max_tweak_rounds)
    for lo in (simple_min, heuristic_min):
        for hi in (simple_max, heuristic_max):
            rounds([lanes.to_float(lo)], [lanes.to_float(hi - lo)], 6,
                   num_tweak6, reduced_range_round)

    return _pack_interpolated_alpha_blocks(best_ep, best_is_full,
                                           best_indexes, is_signed)


def _pack_interpolated_alpha_blocks(best_ep, best_is_full_range, best_indexes,
                                    is_signed: bool):
    """Final packing (S3TC.cpp:651-714) of int32 endpoints [N, 2], range
    flags [N] and indexes [N, 16] -> uint8 [N, 8]."""
    ep0, ep1 = best_ep[:, 0], best_ep[:, 1]
    if is_signed:
        ep0 = ep0 - 127
        ep1 = ep1 - 127

    is_full = best_is_full_range != 0
    swap = is_full != (ep0 > ep1)
    out_ep0 = torch.where(swap, ep1, ep0)
    out_ep1 = torch.where(swap, ep0, ep1)

    max_value = (5 + 2 * is_full.to(I32))[:, None]
    index = best_indexes
    index = torch.where(swap[:, None] & (index <= max_value),
                        max_value - index, index)
    remapped = torch.where(index < max_value, index + 1, index)
    remapped = torch.where(index == max_value, torch.ones_like(index),
                           remapped)
    index = torch.where(index != 0, remapped, index)

    # 16 x 3-bit little-endian stream into bytes 2..7
    shifts = 3 * torch.arange(16, dtype=torch.int64, device=index.device)
    stream = (index.to(torch.int64) << shifts).sum(dim=1)
    byte_cols = [out_ep0 & 0xFF, out_ep1 & 0xFF] + [
        ((stream >> (8 * k)) & 0xFF).to(I32) for k in range(6)]
    return torch.stack(byte_cols, dim=-1).to(torch.uint8)


def bias_signed_input(pixels):
    """Util::BiasSignedInput (ConvectionKernels_Util.cpp:47-60): int8 ->
    int32 in 0..254."""
    return torch.clamp_min(pixels.to(I32), -127) + 127


def _pack_bc1_blocks(best: _Best):
    """Final scalar packing (S3TC.cpp:966-1051), vectorized over blocks."""
    e = best.endpoints
    cep = (((e[..., 0] & 0xF8) << 8) | ((e[..., 1] & 0xFC) << 3)
           | ((e[..., 2] & 0xF8) >> 3))
    cep0, cep1 = cep[:, 0], cep[:, 1]

    is4 = best.range == 4
    case = torch.where(is4,
                       torch.where(cep0 == cep1, 0,
                                   torch.where(cep0 < cep1, 1, 2)),
                       torch.where(cep0 > cep1, 3, 4)).to(I32)
    swap = (case == 1) | (case == 3)
    ep_a = torch.where(swap, cep1, cep0)
    ep_b = torch.where(swap, cep0, cep1)

    order = programs.constant(_INDEX_ORDER.reshape(-1), e.device)
    mapped = order[(case[:, None] * 4 + best.indexes).long()]
    packed = (mapped[:, 0::4] | (mapped[:, 1::4] << 2)
              | (mapped[:, 2::4] << 4) | (mapped[:, 3::4] << 6))
    byte_cols = torch.stack([ep_a & 0xFF, (ep_a >> 8) & 0xFF,
                             ep_b & 0xFF, (ep_b >> 8) & 0xFF], dim=-1)
    return torch.cat([byte_cols, packed], dim=-1).to(torch.uint8)
