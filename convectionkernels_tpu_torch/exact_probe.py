"""Exactness probe for the CUDA toolchain (csrc/exact_probe.cu).

Runs divide, sqrt, floor(x + 0.5), the min-then-max clamp, a `v - a*t`
product chain and int32 multiply/shift chains on the card and compares
the bits with the same operations in PyTorch on the CPU. If nvcc's flags
contracted a multiply-add, approximated a divide or sqrt, or flushed a
subnormal, this fails before any encoded byte is compared.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from .ops.exact_math import exact_sqrt


def probe_inputs(n: int = 1 << 20, seed: int = 0):
    """[n] f32 pairs (a, b): random magnitudes over the whole exponent
    range plus edge values (0, -0, subnormals, 1, FLT_MAX, powers of two);
    b is never 0 where a is 0, so no 0/0 NaN arises."""
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.17549435e-38, 1.0,
                      -1.0, 0.5, 2.0, 255.0, 255.49998, 127.5, 3.4028235e38,
                      -3.4028235e38, 2.0 ** -126, 2.0 ** 100, 65536.0],
                     dtype=np.float32)
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    a = bits.view(np.float32).copy()
    a[~np.isfinite(a)] = 1.5
    b = (rng.standard_normal(n) * 300).astype(np.float32)
    a[: n // 4] = (rng.standard_normal(n // 4) * 300).astype(np.float32)
    a[: edges.size] = edges
    b[: edges.size] = edges[::-1]
    b[b == 0] = 3.0
    return a, b


def plain(a, b):
    """The probe's operations in PyTorch: (f [6, n] f32, i [2, n] i32)."""
    f = torch.stack([
        a / b,
        exact_sqrt(torch.abs(a)),
        torch.floor(a + 0.5),
        torch.clamp_min(torch.clamp_max(a, 255.0), 0.0),
        (b - a * b) * a,
        torch.ones_like(b) / b,
    ])
    ia = torch.floor(f[3] + 0.5).to(torch.int32)
    ib = torch.floor(torch.clamp_min(torch.clamp_max(b, 255.0), 0.0)
                     + 0.5).to(torch.int32)
    w = ((ia & 15) * 4681 + 256) >> 9
    q = ((ia << 7) - ia + 255) >> 9
    i = torch.stack([((64 - w) * ia + w * ib + 32) >> 6,
                     (((q << 1) | (ib & 1)) << 1) | (q >> 6)])
    return f, i


def run(a, b):
    """The probe kernel on CUDA tensors a, b [n] f32."""
    n = a.shape[0]
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or t.shape != (n,) or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous CUDA f32 [n]")
    f = torch.empty((6, n), dtype=torch.float32, device=a.device)
    i = torch.empty((2, n), dtype=torch.int32, device=a.device)
    cuda_lib.launch("exact_probe", "exact_probe", a, b, n, f, i)
    return f, i


F_NAMES = ("divide", "sqrt", "round_nearest", "clamp", "v_minus_a_times_t",
           "reciprocal")
I_NAMES = ("bc7_reconstruct", "quantize_chain")


def check(device, n: int = 1 << 20, seed: int = 0) -> dict:
    """Mismatch count of each probed operation, card vs CPU (all 0 when
    the toolchain is exact). NaN results must coincide; their payload
    bits are not compared. Clamp results are compared by value: the sign
    of a zero from min/max is unspecified, and every clamp in the kernels
    feeds floor(x + 0.5)."""
    a, b = probe_inputs(n, seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    f_ref, i_ref = plain(ta, tb)
    f_got, i_got = run(ta.to(device), tb.to(device))
    torch.cuda.synchronize(device)
    f_got, i_got = f_got.cpu(), i_got.cpu()
    out = {}
    for k, name in enumerate(F_NAMES):
        ref_nan, got_nan = torch.isnan(f_ref[k]), torch.isnan(f_got[k])
        if name == "clamp":
            differ = f_ref[k] != f_got[k]
        else:
            differ = f_ref[k].view(torch.int32) != f_got[k].view(torch.int32)
        out[name] = int(((differ & ~(ref_nan & got_nan))
                         | (ref_nan != got_nan)).sum())
    for k, name in enumerate(I_NAMES):
        out[name] = int((i_ref[k] != i_got[k]).sum())
    return out
