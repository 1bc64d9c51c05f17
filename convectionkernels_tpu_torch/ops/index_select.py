"""Index quantization by projection.

Batched equivalent of the reference's IndexSelector
(ConvectionKernels_IndexSelector.h:13-142,
ConvectionKernels_IndexSelector.cpp:43-62): precompute origin and axis from
the endpoints, select each pixel's index by dot product, and reconstruct
palette entries with the fixed-point weight-reciprocal table.

All integer arithmetic is int32 (matching the scalar reference build); the
fixed-point products stay below 2^31 by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lanes
from .exact_math import exact_divide

# g_weightReciprocals (ConvectionKernels_IndexSelector.cpp:43-62), indexed by
# range; entry r is the fixed-point reciprocal of (r - 1) scaled by 2^15.
WEIGHT_RECIPROCALS = (
    0, 0, 32768, 16384, 10923, 8192, 6554, 5461, 4681, 4096, 3641, 3277,
    2979, 2731, 2521, 2341, 2185,
)


class IndexSelector:
    """Mirror of IndexSelector<nch>.

    `range_` is a Python int (the usual case) or, where the index range
    varies per candidate lane (the dual-plane search), the pair
    (`max_value`, `recip`) of broadcastable f32 tensors (range-1, weight
    reciprocal). Channel weights may likewise be floats or broadcastable
    f32 tensors; the arithmetic is elementwise either way.
    """

    def __init__(self, channel_weights, endpoints, range_, nch: int):
        """Init (IndexSelector.h:39-77). endpoints: (ep0, ep1) lists of
        int32 tensors (interpolation space == color space for LDR)."""
        self.nch = nch
        if isinstance(range_, int):
            self.range = range_
            self.max_value = float(range_ - 1)
            self.recip_f = None
        else:
            self.range = None
            self.max_value, self.recip_f = range_
        self.endpoints = endpoints
        self._ep_f = None  # lazy f32 view for reconstruct_ldr_bc7_f32

        self.origin = [lanes.to_float(endpoints[0][ch]) for ch in range(nch)]
        ep_diff_weighted = []
        for ch in range(nch):
            opposing = lanes.to_float(endpoints[1][ch])
            ep_diff_weighted.append(
                (opposing - self.origin[ch]) * _weight(channel_weights[ch]))

        len_sq = ep_diff_weighted[0] * ep_diff_weighted[0]
        for ch in range(1, nch):
            len_sq = len_sq + ep_diff_weighted[ch] * ep_diff_weighted[ch]
        len_sq = lanes.make_safe_denominator(len_sq)

        if torch.is_tensor(self.max_value):
            mv = self.max_value.expand_as(len_sq)
        else:
            mv = torch.full_like(len_sq, self.max_value)
        mv_div_lensq = exact_divide(mv, len_sq)
        self.axis = [
            ep_diff_weighted[ch] * _weight(channel_weights[ch]) * mv_div_lensq
            for ch in range(nch)
        ]

    def select_index_ldr(self, float_pixel):
        """SelectIndexLDR (IndexSelector.h:124-131): project + clamp + round."""
        dist = (float_pixel[0] - self.origin[0]) * self.axis[0]
        for ch in range(1, self.nch):
            dist = dist + (float_pixel[ch] - self.origin[ch]) * self.axis[ch]
        if torch.is_tensor(self.max_value):
            clamped = torch.minimum(dist, self.max_value)
        else:
            clamped = torch.clamp_max(dist, self.max_value)
        return lanes.round_and_convert_to_int_nearest(
            torch.clamp_min(clamped, 0.0))

    def reconstruct_ldr_bc7(self, index, num_real_channels=None):
        """ReconstructLDR_BC7 (IndexSelector.h:90-100): 64ths weights."""
        nrc = self.nch if num_real_channels is None else num_real_channels
        recip = WEIGHT_RECIPROCALS[self.range]
        weight = (recip * index + 256) >> 9
        out = []
        for ch in range(nrc):
            ep0f = (64 - weight) * self.endpoints[0][ch]
            ep1f = weight * self.endpoints[1][ch]
            out.append((ep0f + ep1f + 32) >> 6)
        return out

    def reconstruct_ldr_bc7_f32(self, index, num_real_channels=None):
        """ReconstructLDR_BC7 computed in f32, bit-identical to the int
        path: every intermediate is a non-negative integer below 2^24, so
        f32 multiply/add is exact and >>k is floor(x * 2^-k). Returns f32
        tensors (integer-valued)."""
        nrc = self.nch if num_real_channels is None else num_real_channels
        recip = (float(WEIGHT_RECIPROCALS[self.range])
                 if self.recip_f is None else self.recip_f)
        w = torch.floor((lanes.to_float(index) * recip + 256.0)
                        * float(np.float32(1.0 / 512.0)))
        if self._ep_f is None:
            self._ep_f = [[lanes.to_float(e) for e in eps]
                          for eps in self.endpoints]
        out = []
        for ch in range(nrc):
            t = ((64.0 - w) * self._ep_f[0][ch]
                 + w * self._ep_f[1][ch] + 32.0)
            out.append(torch.floor(t * float(np.float32(1.0 / 64.0))))
        return out

    def reconstruct_ldr_precise(self, index, num_real_channels=None):
        """ReconstructLDRPrecise (IndexSelector.h:102-112): 255ths weights."""
        nrc = self.nch if num_real_channels is None else num_real_channels
        recip = WEIGHT_RECIPROCALS[self.range]
        weight = (recip * index + 64) >> 7
        out = []
        for ch in range(nrc):
            ep0f = (256 - weight) * self.endpoints[0][ch]
            ep1f = weight * self.endpoints[1][ch]
            out.append((ep0f + ep1f + 128) >> 8)
        return out


def aggregated_error_finalize(err_channels, flags_uniform: bool,
                              channel_weights_sq):
    """AggregatedError::Finalize (ConvectionKernels_AggregatedError.h:30-46).

    err_channels: int32 tensors of unweighted squared-error sums, one per
    channel; channel_weights_sq: their float32 weights.
    """
    if flags_uniform:
        total = err_channels[0]
        for ch in range(1, len(err_channels)):
            total = total + err_channels[ch]
        return lanes.to_float(total)
    total = lanes.to_float(err_channels[0]) * _weight(channel_weights_sq[0])
    for ch in range(1, len(err_channels)):
        total = total + lanes.to_float(err_channels[ch]) * _weight(
            channel_weights_sq[ch])
    return total


def _weight(w):
    return w if torch.is_tensor(w) else float(np.float32(w))
