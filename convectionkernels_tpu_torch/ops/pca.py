"""PCA endpoint estimation.

Batched form of the reference's EndpointSelector / PackedCovarianceMatrix
pipeline (ConvectionKernels_EndpointSelector.h:13-149,
ConvectionKernels_PackedCovarianceMatrix.h:10-64): three passes over the 16
pixels of each block — centroid, covariance accumulation, min/max
projection — followed by power iteration with max-component normalization.

Every argument is a tensor (or Python float) broadcastable against the
others. Float32 accumulation order matches the reference exactly: pixels
accumulate sequentially and cross-channel sums accumulate in channel
order, with no torch.sum where the reference chains adds.
"""

from __future__ import annotations

import torch

from . import lanes
from .exact_math import exact_divide, exact_sqrt


def pyramid_add(cov, diff, weight, nch: int):
    """PackedCovarianceMatrix::Add — cov is a list of N(N+1)/2 tensors."""
    out = []
    index = 0
    for row in range(nch):
        for col in range(row + 1):
            out.append(cov[index] + diff[row] * diff[col] * weight)
            index += 1
    return out


def pyramid_product(cov, vec, nch: int):
    """PackedCovarianceMatrix::Product — exact column accumulation order."""
    out = []
    for row in range(nch):
        total = None
        index = (row * (row + 1)) >> 1
        for col in range(nch):
            term = vec[col] * cov[index]
            total = term if total is None else total + term
            if col >= row:
                index += col + 1
            else:
                index += 1
        out.append(total)
    return out


def endpoint_selector(pw_pixels, pixel_weights, nch: int, iterations: int = 8,
                      member_mask=None):
    """EndpointSelector<nch, iterations> over all three passes.

    Args:
      pw_pixels: 16 lists of `nch` float32 tensors (pre-weighted pixels).
      pixel_weights: 16 float32 tensors (contribution weights).
      member_mask: optional 16 bool tensors; pass 2's min/max projection
        only sees member pixels (the reference's per-shape loops,
        BC67.cpp:1096-1103).

    Returns (centroid, direction, min_dist, max_dist).
    """
    shape = torch.broadcast_shapes(
        *[pw_pixels[px][ch].shape for px in range(16) for ch in range(nch)],
        *[w.shape for w in pixel_weights])
    device = pixel_weights[0].device
    zero = torch.zeros(shape, dtype=lanes.F32, device=device)

    # Pass 0: centroid (EndpointSelector.h:73-87)
    centroid = [zero] * nch
    weight_total = zero
    for px in range(16):
        w = pixel_weights[px]
        for ch in range(nch):
            centroid[ch] = centroid[ch] + pw_pixels[px][ch] * w
        weight_total = weight_total + w
    denom = lanes.make_safe_denominator(weight_total)
    centroid = [exact_divide(c, denom) for c in centroid]

    # Pass 1: covariance (EndpointSelector.h:89-96)
    cov = [zero] * ((nch * (nch + 1)) // 2)
    for px in range(16):
        diff = [pw_pixels[px][ch] - centroid[ch] for ch in range(nch)]
        cov = pyramid_add(cov, diff, pixel_weights[px], nch)

    # FinishDirection: power iteration (EndpointSelector.h:98-130)
    approx = [torch.ones_like(zero)] * nch
    for _ in range(iterations):
        product = pyramid_product(cov, approx, nch)
        largest = product[0]
        for ch in range(1, nch):
            largest = torch.maximum(largest, product[ch])
        largest = lanes.make_safe_denominator(largest)
        approx = [exact_divide(p, largest) for p in product]

    approx_len = None
    for ch in range(nch):
        term = approx[ch] * approx[ch]
        approx_len = term if approx_len is None else approx_len + term
    approx_len = lanes.make_safe_denominator(exact_sqrt(approx_len))
    direction = [exact_divide(a, approx_len) for a in approx]

    # Pass 2: min/max projection (EndpointSelector.h:132-141)
    min_dist = torch.full_like(zero, lanes.FLT_MAX)
    max_dist = torch.full_like(zero, -lanes.FLT_MAX)
    for px in range(16):
        dist = None
        for ch in range(nch):
            term = direction[ch] * (pw_pixels[px][ch] - centroid[ch])
            dist = term if dist is None else dist + term
        if member_mask is not None:
            min_dist = torch.minimum(min_dist, torch.where(
                member_mask[px], dist, torch.full_like(dist, lanes.FLT_MAX)))
            max_dist = torch.maximum(max_dist, torch.where(
                member_mask[px], dist, torch.full_like(dist, -lanes.FLT_MAX)))
        else:
            min_dist = torch.minimum(min_dist, dist)
            max_dist = torch.maximum(max_dist, dist)

    return centroid, direction, min_dist, max_dist


def get_endpoints(centroid, direction, min_dist, max_dist, channel_weights,
                  nch: int):
    """EndpointSelector::GetEndpoints (EndpointSelector.h:51-71).

    Returns (base, offset) per channel — the UnfinishedEndpoints line.
    Mirrors the reference exactly, including dividing by the *raw* channel
    weight (the computed safeWeight is unused in the reference).
    `channel_weights` entries are Python floats or broadcastable tensors.
    """
    base, offset = [], []
    for ch in range(nch):
        mn = centroid[ch] + direction[ch] * min_dist
        mx = centroid[ch] + direction[ch] * max_dist
        w = channel_weights[ch]
        if not torch.is_tensor(w):
            w = torch.full_like(mn, float(w))
        base.append(exact_divide(mn, w))
        offset.append(exact_divide(mx - mn, w))
    return base, offset


def finish_ldr(base, offset, tweak: int, range_: int, nch: int):
    """UnfinishedEndpoints::FinishLDR (ConvectionKernels_UnfinishedEndpoints.h:84-99).

    Quantizes the PCA line to integer endpoints with tweak factors.
    Returns (ep0, ep1): lists of int32 tensors.
    """
    f0, f1 = lanes.compute_tweak_factors(tweak, range_)
    ep0, ep1 = [], []
    for ch in range(nch):
        e0f = lanes.clamp(base[ch] + offset[ch] * float(f0), 0.0, 255.0)
        e1f = lanes.clamp(base[ch] + offset[ch] * float(f1), 0.0, 255.0)
        ep0.append(lanes.round_and_convert_to_int_nearest(e0f))
        ep1.append(lanes.round_and_convert_to_int_nearest(e1f))
    return ep0, ep1
