"""Lane math: exact float/int semantics shared by the encoders.

The batched form of the reference's ParallelMath layer
(ConvectionKernels_ParallelMath.h). Every value is a torch tensor whose
leading axis is the block axis; per-lane predication (`Select` /
`ConditionalSet`) is `torch.where`.

Bit-exactness contract: semantics follow the reference's *scalar* build
(ParallelMath.h:1281-1812):
  - round-to-nearest == floor(x + 0.5f), never torch.round (ParallelMath.h:1677)
  - Reciprocal == exact IEEE 1/x                     (ParallelMath.h:1456)
  - integer lane types are int32                     (ParallelMath.h:1311-1318)
Integer tensors are built with an explicit int32 dtype: a tensor made from
a Python list or an int64 numpy array would otherwise be int64.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32

FLT_MAX = float(np.float32(3.4028234663852886e38))


def to_float(v):
    """ParallelMath::ToFloat — int32 lane -> float32."""
    return v.to(F32)


def round_and_convert_to_int_nearest(v):
    """RoundAndConvertToU15/U16/S16 under round-to-nearest, as int32: the
    scalar RoundTowardNearestForScope floor(v + 0.5f) (ParallelMath.h:1677)."""
    return torch.floor(v + 0.5).to(I32)


def clamp(v, lo, hi):
    """ParallelMath::Clamp: min then max order preserved (scalar :1447-1454)."""
    return torch.clamp_min(torch.clamp_max(v, float(hi)), float(lo))


def make_safe_denominator(v):
    """MakeSafeDenominator: 0 -> 1 (ParallelMath.h:1398-1402)."""
    return torch.where(v == 0.0, torch.ones_like(v), v)


def sq_diff_int(a, b):
    """SqDiffUInt8 scalar: (a-b)^2 in int32 (ParallelMath.h:1705-1723)."""
    d = a - b
    return d * d


def twoscl_half_to_float(v):
    """TwosCLHalfToFloat (scalar build, ParallelMath.h:1727-1750).

    Converts the internal two's-complement-sign half-float representation
    (2CL, an int32 holding a 16-bit value) to float32 with integer ops and
    a bit-cast, including the denormal correction.

    Mirrors the scalar build exactly: signBits is derived from |v|, so it
    is zero except for v == -32768, and the result is the magnitude (the
    SSE2 build keeps v's sign). The left shifts wrap in int32.
    """
    abs_v = v.abs()
    sign_bits = abs_v & (-32768)
    mantissa = abs_v & 0x03FF
    exponent = abs_v & 0x7C00
    is_denormal = exponent == 0
    exponent = (exponent >> 3) + 14336
    denorm_corr_bits = torch.where(
        is_denormal, sign_bits | 14336, torch.zeros_like(v)) << 16
    f_bits = ((exponent | sign_bits) << 16) | (mantissa << 13)
    return f_bits.view(F32) - denorm_corr_bits.view(F32)


def first_argmin(x, dim: int):
    """First-occurrence argmin over `dim` as two plain min-reduces: the
    value min, then the least index among the positions that reach it."""
    m = torch.amin(x, dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    iota = torch.arange(x.shape[dim], dtype=I32, device=x.device).view(shape)
    big = torch.full((), x.shape[dim], dtype=I32, device=x.device)
    return torch.amin(torch.where(x == m, iota, big), dim=dim)


def lex_min_with_index(x, dim):
    """(min value, first-occurrence index) over `dim`: strict-less on
    value, ties keep the earlier index.

    `dim` is an int, reduced as an explicit compare chain, or a tuple of
    axes: the index is then the row-major flat index over those axes in
    the order given (the first axis carries the largest stride), found
    with two min-reduces over the flattened axes.
    """
    if not isinstance(dim, int):
        dims = [d + x.dim() if d < 0 else d for d in dim]
        keep = [d for d in range(x.dim()) if d not in dims]
        flat = x.permute(*keep, *dims).reshape(
            *[x.shape[d] for d in keep], -1)
        return torch.amin(flat, dim=-1), first_argmin(flat, -1)
    n = x.shape[dim]
    best = x.select(dim, 0)
    idx = torch.zeros(best.shape, dtype=I32, device=x.device)
    for j in range(1, n):
        v = x.select(dim, j)
        better = v < best
        best = torch.where(better, v, best)
        idx = torch.where(better, torch.full_like(idx, j), idx)
    return best, idx


def take_winner(x, win):
    """x[i, win[i]] for x [N, K], win [N] (the JAX package's one-hot
    masked reduce, which equals a gather for the values stored there:
    ints, bools and floats other than -0.0)."""
    return torch.gather(x, 1, win.long()[:, None]).squeeze(1)


def take_winner_t(x, win):
    """x[win[j], j] for x [K, N] (block-minor layout), win [N]."""
    return torch.gather(x, 0, win.long()[None, :]).squeeze(0)


def compute_tweak_factors(tweak: int, range_: int) -> tuple[np.float32, np.float32]:
    """Util::ComputeTweakFactors (ConvectionKernels_Util.cpp:75-84).

    Host-side: tweak/range are static. Returns float32 factors with the exact
    C float arithmetic (including -0.0 for factor0 when minOutsideUnits==0).
    """
    total_units = range_ - 1
    min_outside = (tweak >> 1) & 1
    max_outside = tweak & 1
    inside = total_units - min_outside - max_outside
    f0 = -(np.float32(min_outside)) / np.float32(inside)
    f1 = np.float32(max_outside) / np.float32(inside) + np.float32(1.0)
    return f0, f1


def tweak_rounds_for_range(range_: int) -> int:
    """BCCommon::TweakRoundsForRange (ConvectionKernels_BCCommon.cpp:39-44)."""
    return 3 if range_ == 3 else 4
