# Frozen copy of convectionkernels_tpu_torch/ops/refine.py:1-144 at commit
# 9895176, the benchmark's plain reference: never edited to follow the
# program. Unchanged but for this header.
"""Least-squares endpoint refinement.

Batched equivalent of the reference's EndpointRefiner
(ConvectionKernels_EndpointRefiner.h:16-176): accumulates totals
(tv, v, tt, t, w) over per-pixel index assignments and solves v = a*t + b
for refined endpoints. Masked contributions reproduce the reference's
per-lane control flow. Eager PyTorch runs every multiply and add as its
own rounded operation, so nothing here guards against FMA contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lanes
from .exact_math import exact_divide, exact_reciprocal


class EndpointRefiner:
    """Mirror of EndpointRefiner<nch>: a mutable accumulator of tensors."""

    def __init__(self, zero, nch: int, index_range, channel_weights,
                 rcp_max_index=None, rcp_channel_weights=None):
        """Init (EndpointRefiner.h:38-60).

        Where the index range and channel weights vary per candidate lane
        (the dual-plane search), pass precomputed broadcastable
        `rcp_max_index` / `rcp_channel_weights` tensors instead
        (host-computed with the same f32 divisions as the scalar path).
        """
        self.nch = nch
        self.tv = [zero] * nch
        self.v = [zero] * nch
        self.tt = zero
        self.t = zero
        self.wu = torch.zeros(zero.shape, dtype=lanes.I32, device=zero.device)
        if rcp_max_index is None:
            rcp_max_index = float(np.float32(1.0)
                                  / np.float32(index_range - 1))
        self.rcp_max_index = rcp_max_index
        if rcp_channel_weights is None:
            rcp_channel_weights = []
            for w in channel_weights[:nch]:
                w = np.float32(w)
                rcp_channel_weights.append(
                    1.0 if w == 0.0 else float(np.float32(1.0) / w))
        self.rcp_channel_weights = rcp_channel_weights

    def contribute_unweighted_pw(self, pw_pixel, index, num_real_channels=None,
                                 mask=None):
        """ContributeUnweightedPW (EndpointRefiner.h:79-93).

        `mask` (bool) reproduces per-lane skipping: masked-off lanes
        contribute +0.0, an exact no-op on the non-negative accumulators.
        """
        nrc = self.nch if num_real_channels is None else num_real_channels
        t = lanes.to_float(index) * self.rcp_max_index

        def m(x):
            return x if mask is None else torch.where(
                mask, x, torch.zeros((), dtype=x.dtype, device=x.device))

        for ch in range(nrc):
            val = pw_pixel[ch]
            self.tv[ch] = self.tv[ch] + m(t * val)
            self.v[ch] = self.v[ch] + m(val)
        self.tt = self.tt + m(t * t)
        self.t = self.t + m(t)
        if mask is None:
            self.wu = self.wu + 1
        else:
            self.wu = self.wu + mask.to(lanes.I32)

    def contribute_unweighted_pw_pixels(self, pw_pixels, index, mask=None):
        """contribute_unweighted_pw for each pixel of a trailing pixel axis,
        in pixel order.

        pw_pixels: one float32 tensor [..., P] a channel; index (int32) and
        mask (bool) [..., P]. Every pixel's terms are computed at once;
        the totals then take them one pixel at a time, all totals in one
        stacked add a pixel. Each element of the stack is its own chain, so
        the totals are bit-identical to P calls of contribute_unweighted_pw.
        """
        nrc = len(pw_pixels)
        t = lanes.to_float(index) * self.rcp_max_index
        terms = torch.stack(torch.broadcast_tensors(
            *[t * v for v in pw_pixels], *pw_pixels, t * t, t), dim=-1)
        if mask is not None:
            terms = torch.where(mask[..., None], terms, torch.zeros(
                (), dtype=terms.dtype, device=terms.device))
        totals = [*self.tv[:nrc], *self.v[:nrc], self.tt, self.t]
        acc = torch.stack([x.expand(terms.shape[:-2]) for x in totals],
                          dim=-1)
        for px in range(terms.shape[-2]):
            acc = acc + terms[..., px, :]
        self.tv[:nrc] = acc[..., :nrc].unbind(-1)
        self.v[:nrc] = acc[..., nrc:2 * nrc].unbind(-1)
        self.tt, self.t = acc[..., 2 * nrc], acc[..., 2 * nrc + 1]
        if mask is None:
            self.wu = self.wu + terms.shape[-2]
        else:
            self.wu = self.wu + mask.sum(dim=-1, dtype=lanes.I32)

    def get_refined_endpoints(self):
        """GetRefinedEndpoints (EndpointRefiner.h:100-145). Returns float eps."""
        w = lanes.make_safe_denominator(lanes.to_float(self.wu))
        w_rcp = exact_reciprocal(w)  # scalar Reciprocal == exact division

        adenom = (self.tt * w - self.t * self.t) * w_rcp
        adenom_zero = adenom == 0.0
        adenom = torch.where(adenom_zero, torch.ones_like(adenom), adenom)

        ep0, ep1 = [], []
        for ch in range(self.nch):
            a = exact_divide(self.tv[ch] - self.t * self.v[ch] * w_rcp, adenom)
            b = (self.v[ch] - a * self.t) * w_rcp
            p1 = torch.where(adenom_zero, self.v[ch] * w_rcp, b)
            p2 = torch.where(adenom_zero, p1, a + b)
            inv_w = self.rcp_channel_weights[ch]
            ep0.append(p1 * inv_w)
            ep1.append(p2 * inv_w)
        return ep0, ep1

    def get_refined_endpoints_ldr(self, num_real_channels=None):
        """GetRefinedEndpointsLDR (EndpointRefiner.h:147-157) -> int32 eps."""
        nrc = self.nch if num_real_channels is None else num_real_channels
        f0, f1 = self.get_refined_endpoints()
        ep0 = [lanes.round_and_convert_to_int_nearest(
            lanes.clamp(f0[ch], 0.0, 255.0)) for ch in range(nrc)]
        ep1 = [lanes.round_and_convert_to_int_nearest(
            lanes.clamp(f1[ch], 0.0, 255.0)) for ch in range(nrc)]
        return ep0, ep1

    def get_refined_endpoints_hdr(self, signed: bool):
        """GetRefinedEndpointsHDR (EndpointRefiner.h:159-175) -> int32 eps
        clamped to the 2CL half range."""
        f0, f1 = self.get_refined_endpoints()
        lo = -31743.0 if signed else 0.0
        ep0 = [lanes.round_and_convert_to_int_nearest(
            lanes.clamp(f, lo, 31743.0)) for f in f0]
        ep1 = [lanes.round_and_convert_to_int_nearest(
            lanes.clamp(f, lo, 31743.0)) for f in f1]
        return ep0, ep1
