# Frozen copy of convectionkernels_tpu_torch/ops/exact_math.py:1-42 at
# commit 9895176, the benchmark's plain reference: never edited to follow
# the program. Unchanged but for this header.
"""Correctly-rounded float32 division, reciprocal and sqrt.

The reference encoder's decisions hinge on exact IEEE results (its scalar
build uses hardware divss/sqrtss). PyTorch's float32 `/` is IEEE
round-to-nearest on the CPU and on CUDA, and so is `torch.sqrt` on CUDA
(the CUDA kernels of this package are compiled with -prec-div=true
-prec-sqrt=true -ftz=false). PyTorch's CPU float sqrt is a SLEEF routine
with up to 0.5001 ulp of error, so on the CPU its result is corrected to
the nearest float. tests/test_torch_ops.py holds all three bit-identical
to the JAX package's integer emulation.
"""

from __future__ import annotations

import torch


def exact_divide(a, b):
    """Correctly-rounded (IEEE RN) float32 a / b."""
    return a / b


def exact_reciprocal(v):
    """Correctly-rounded 1.0f / v (the reference scalar Reciprocal)."""
    return torch.ones_like(v) / v


def exact_sqrt(x):
    """Correctly-rounded (IEEE RN) float32 sqrt."""
    s = torch.sqrt(x)
    if x.device.type != "cpu":
        return s
    # s is within one ulp of the true root: step to a neighbour when x lies
    # beyond the square of the midpoint between them. Midpoints of floats
    # have 25 bits, so their float64 sums, halves and squares are exact.
    lo = torch.nextafter(s, torch.zeros_like(s))
    hi = torch.nextafter(s, torch.full_like(s, float("inf")))
    xd, sd = x.double(), s.double()
    m_lo = (sd + lo.double()) * 0.5
    m_hi = (sd + hi.double()) * 0.5
    return torch.where(xd < m_lo * m_lo, lo,
                       torch.where(xd > m_hi * m_hi, hi, s))
