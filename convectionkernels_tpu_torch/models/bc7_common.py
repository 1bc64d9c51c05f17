"""BC7 pieces shared by the plain versions of the kernels
(models/bc7_kernel.py) and the host-side winner recompute (models/bc7.py).

Everything here is elementwise torch on tensors of any shape. The CUDA
sources (csrc/bc7_common.cuh) mirror these functions operation for
operation.

Reference: ConvectionKernels_BC67.cpp (cited per function).
"""

from __future__ import annotations

import torch

from ..ops import lanes

# BC7ModeInfo (BC67.cpp:107-119): pbit mode (0=per-endpoint, 1=per-subset,
# 2=none), alpha mode (0=combined, 1=separate, 2=none), rgbBits, alphaBits,
# partitionBits, numSubsets, indexBits, alphaIndexBits, hasIndexSelector
MODE_INFO = {
    0: dict(pbit="per_ep", alpha="none", rgb_bits=4, alpha_bits=0,
            partition_bits=4, num_subsets=3, index_bits=3, alpha_index_bits=0,
            has_index_selector=False),
    1: dict(pbit="per_subset", alpha="none", rgb_bits=6, alpha_bits=0,
            partition_bits=6, num_subsets=2, index_bits=3, alpha_index_bits=0,
            has_index_selector=False),
    2: dict(pbit="none", alpha="none", rgb_bits=5, alpha_bits=0,
            partition_bits=6, num_subsets=3, index_bits=2, alpha_index_bits=0,
            has_index_selector=False),
    3: dict(pbit="per_ep", alpha="none", rgb_bits=7, alpha_bits=0,
            partition_bits=6, num_subsets=2, index_bits=2, alpha_index_bits=0,
            has_index_selector=False),
    4: dict(pbit="none", alpha="separate", rgb_bits=5, alpha_bits=6,
            partition_bits=0, num_subsets=1, index_bits=2, alpha_index_bits=3,
            has_index_selector=True),
    5: dict(pbit="none", alpha="separate", rgb_bits=7, alpha_bits=8,
            partition_bits=0, num_subsets=1, index_bits=2, alpha_index_bits=2,
            has_index_selector=False),
    6: dict(pbit="per_ep", alpha="combined", rgb_bits=7, alpha_bits=7,
            partition_bits=0, num_subsets=1, index_bits=4, alpha_index_bits=0,
            has_index_selector=False),
    7: dict(pbit="per_ep", alpha="combined", rgb_bits=5, alpha_bits=5,
            partition_bits=6, num_subsets=2, index_bits=2, alpha_index_bits=0,
            has_index_selector=False),
}

MAX_TWEAK_ROUNDS = 4  # BC67.h:40


# --- Endpoint quantization (BC67.cpp:827-938) -------------------------------

def quantize(color, bits: int, channels: int):
    """Quantize (BC67.cpp:827-831)."""
    return [((color[ch] << bits) - color[ch] + (127 + (1 << (7 - bits)))) >> 8
            if ch < channels else color[ch] for ch in range(len(color))]


def quantize_p(color, bits: int, p, channels: int):
    """QuantizeP (BC67.cpp:833-849). `p` is an int32 tensor of parity bits."""
    addend = torch.where(p != 0, torch.full_like(p, (1 << (8 - bits)) - 1),
                         torch.full_like(p, 255))
    out = []
    for ch in range(len(color)):
        if ch < channels:
            c = ((color[ch] << (bits + 1)) - color[ch] + addend) >> 9
            out.append((c << 1) | p)
        else:
            out.append(color[ch])
    return out


def unquantize(color, bits: int, channels: int):
    """Unquantize (BC67.cpp:851-859)."""
    out = []
    for ch in range(len(color)):
        if ch < channels:
            c = color[ch] << (8 - bits)
            out.append(c | (c >> bits))
        else:
            out.append(color[ch])
    return out


def compress_endpoints(mode: int, ep, p0, p1, full255):
    """CompressEndpoints0..7 for 4-channel single-plane modes
    (BC67.cpp:861-906, 925-938). ep = [ep0_chs, ep1_chs]; p0/p1 parity
    tensors."""
    out = []
    for j, p in ((0, p0), (1, p1)):
        chs = list(ep[j])
        if mode == 0:
            chs = unquantize(quantize_p(chs, 4, p, 3), 5, 3)
            chs[3] = full255
        elif mode == 1:
            chs = unquantize(quantize_p(chs, 6, p0, 3), 7, 3)  # per-subset p
            chs[3] = full255
        elif mode == 2:
            chs = unquantize(quantize(chs, 5, 3), 5, 3)
            chs[3] = full255
        elif mode == 3:
            chs = quantize_p(chs, 7, p, 3)
            chs[3] = full255
        elif mode == 6:
            chs = quantize_p(chs, 7, p, 4)
        elif mode == 7:
            chs = unquantize(quantize_p(chs, 5, p, 4), 6, 4)
        else:
            raise ValueError(mode)
        out.append(chs)
    return out


def accumulate_error(selector, shape_like, members, fps, ips, cfg,
                     with_refiner=None, pwps=None, keep_indexes=False):
    """One pass over the 16 pixels: select (+/-1 retest when slow indexing),
    accumulate weighted error, optionally feed the refiner
    (BC67.cpp:1346-1432).

    cfg keys: fast_indexing, uniform, cw_sq (4 floats), num_real_channels,
    index_range. `members` are bool tensors, or None for every pixel.
    """
    fast_indexing = cfg["fast_indexing"]
    uniform = cfg["uniform"]
    cw_sq = cfg["cw_sq"]
    num_real_channels = cfg["num_real_channels"]
    index_range = cfg["index_range"]

    def member(px, x, zero):
        return x if members is None else torch.where(members[px], x, zero)

    shape_error = torch.zeros_like(shape_like)
    agg = [torch.zeros(shape_like.shape, dtype=lanes.I32,
                       device=shape_like.device) for _ in range(4)]
    zero_i = torch.zeros((), dtype=lanes.I32, device=shape_like.device)
    zero_f = torch.zeros((), dtype=lanes.F32, device=shape_like.device)
    indexes = []
    for px in range(16):
        index = selector.select_index_ldr(fps[px])
        if fast_indexing:
            recon = selector.reconstruct_ldr_bc7(index, num_real_channels)
            for ch in range(num_real_channels):
                agg[ch] = agg[ch] + member(
                    px, lanes.sq_diff_int(recon[ch], ips[px][ch]), zero_i)
        else:
            def px_error(idx_val, px=px):
                # f32 throughout, bit-identical to the int path: recon
                # values and squared diffs are integers below 2^24
                rec = selector.reconstruct_ldr_bc7_f32(idx_val,
                                                       num_real_channels)
                errs = []
                for ch in range(num_real_channels):
                    d = rec[ch] - fps[px][ch]
                    errs.append(d * d)
                if uniform:
                    tot = errs[0]
                    for e in errs[1:]:
                        tot = tot + e
                    return tot
                tot = errs[0] * cw_sq[0]
                for ch in range(1, num_real_channels):
                    tot = tot + errs[ch] * cw_sq[ch]
                return tot

            error = px_error(index)
            alt0 = torch.clamp_min(index, 1) - 1
            alt1 = torch.clamp_max(index + 1, index_range - 1)
            for alt in (alt0, alt1):
                alt_error = px_error(alt)
                better = alt_error < error
                error = torch.minimum(error, alt_error)
                index = torch.where(better, alt, index)
            shape_error = shape_error + member(px, error, zero_f)

        if with_refiner is not None:
            with_refiner.contribute_unweighted_pw(
                [pwps[px][ch] for ch in range(4)], index,
                num_real_channels,
                mask=None if members is None else members[px])
        if keep_indexes:
            indexes.append(index)

    if fast_indexing:
        if uniform:
            tot = agg[0]
            for e in agg[1:]:
                tot = tot + e
            shape_error = lanes.to_float(tot)
        else:
            shape_error = lanes.to_float(agg[0]) * cw_sq[0]
            for ch in range(1, 4):
                shape_error = shape_error + lanes.to_float(agg[ch]) * cw_sq[ch]
    return shape_error, indexes
