"""The BC6H kernel: the meta-round chain of one partitioned precision group.

  partitioned_group_meta_rounds  <- convectionkernels_tpu
                                    bc6h_kernel.partitioned_group_meta_rounds

The wrapper launches csrc/bc6h_group.cu for a CUDA tensor and takes the
plain PyTorch version for a CPU tensor; there is no other switch and no
fallback. Both compute, for the 64 (partition, subset) rows of a block
(subset-major: q = subset * 32 + partition) and every tweak x refine round:
tweak-seeded or refined endpoints, the HDR quantize/unquantize, index
selection (the strict-less scan over the 8 interpolants, or the fast
projection), the inversion at the row's fixup pixel with the endpoint swap,
the dedup against earlier rounds, the subset error summed in pixel order,
and the least-squares refit that seeds the next round.

Unlike the TPU kernel, tensors are block-major (a CUDA block of 64 threads
owns one texture block, so its stores are contiguous over q), any N is
taken, and the subset masks and fixup pixels, which the format fixes, are
module constants rather than arguments.

Bound on an H100: operations. A block reads 1.7 KB and writes 30 KB at 12
rounds, about 10 ns of memory time at 3.35 TB/s, against about 2.4 million
float32 and int32 operations, about 35 ns at 67 Tops/s (chip_smoke.py's
work model has the counts).

Reference: ConvectionKernels_BC67.cpp:2776-2911.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib, programs
from ..ops import lanes
from ..tables import bc7_geometry as geom
from . import bc6h_common
from .bc7_kernel import _check_tensor

Q = 64            # (partition, subset) rows of a partitioned group
INDEX_RANGE = 8   # 3-bit indexes

# Launches of the CUDA kernel, counted where the wrapper launches it (and
# by a program's replay, for the launches its graph holds).
LAUNCHES = programs.launch_counter()

F32, I32 = torch.float32, torch.int32


def _subset_tables():
    """(member [64, 16] bool, fixups [64] int) of the subset-major rows."""
    member = np.zeros((Q, 16), dtype=bool)
    fixups = np.zeros(Q, dtype=np.int64)
    for part in range(32):
        bits = int(geom.PARTITION_MAP_2[part])
        for px in range(16):
            member[((bits >> px) & 1) * 32 + part, px] = True
        fixups[32 + part] = int(geom.FIXUP_INDEXES_2[part])
    return member, fixups


SUBSET_MEMBER, SUBSET_FIXUPS = _subset_tables()


def _launch_constants(cw):
    """The constants of a launch as C arrays (csrc/bc6h_group.cu, Params):
    18 floats (cw, cw^2 and 1/cw per channel, the tweak factor pairs of the
    4 tweaks, 1/(range-1)) and 128 ints (member bits, fixup pixel per q)."""
    w = [np.float32(c) for c in cw[:3]]
    tweaks = [lanes.compute_tweak_factors(t, INDEX_RANGE)
              for t in range(bc6h_common.MAX_TWEAK_ROUNDS)]
    floats = (w + [c * c for c in w]
              + [np.float32(1.0) if c == 0.0 else np.float32(1.0) / c
                 for c in w]
              + [t[0] for t in tweaks] + [t[1] for t in tweaks]
              + [np.float32(1.0) / np.float32(INDEX_RANGE - 1)])
    bits = (SUBSET_MEMBER.astype(np.int64) << np.arange(16)).sum(axis=1)
    ints = [int(b) for b in bits] + [int(f) for f in SUBSET_FIXUPS]
    return ((ctypes.c_float * 18)(*[float(f) for f in floats]),
            (ctypes.c_int * (2 * Q))(*ints))


def partitioned_group_meta_rounds(pix, base, offset, aprec, is_signed,
                                  fast_indexing, uniform, cw,
                                  num_tweak_rounds, num_refine_rounds):
    """Every meta round of one partitioned precision group.

    Args:
      pix: [N, 48] int32 clamped 2CL pixels (px*3 + ch).
      base, offset: [N, 3, 64] float32 PCA lines (channel, subset-major q).
      aprec: the group's endpoint precision (6..11).
      cw: channel weights (the first 3 are used).
      num_tweak_rounds (1..4), num_refine_rounds (1..3): A = their product.

    Returns (err [N, A, 64] float32, valid [N, A, 64] int32, eps
    [N, A, 6, 64] int32 stored endpoints, idx [N, A, 2, 64] int32: the 16
    stored 3-bit indexes in two words, pixels 0-9 and 10-15), rounds in
    tweak-major order.
    """
    if pix.device.type == "cpu":
        return partitioned_group_meta_rounds_plain(
            pix, base, offset, aprec, is_signed, fast_indexing, uniform, cw,
            num_tweak_rounds, num_refine_rounds)
    n, dev = pix.shape[0], pix.device
    if not (1 <= num_tweak_rounds <= bc6h_common.MAX_TWEAK_ROUNDS
            and 1 <= num_refine_rounds <= bc6h_common.MAX_REFINE_ROUNDS):
        raise ValueError(f"rounds out of range: {num_tweak_rounds} x "
                         f"{num_refine_rounds}")
    if not 6 <= aprec <= 11:
        raise ValueError(f"aprec {aprec} is not a partitioned group's")
    _check_tensor("pix", pix, I32, (n, 48), dev)
    _check_tensor("base", base, F32, (n, 3, Q), dev)
    _check_tensor("offset", offset, F32, (n, 3, Q), dev)
    a_count = num_tweak_rounds * num_refine_rounds
    err = torch.empty((n, a_count, Q), dtype=F32, device=dev)
    valid = torch.empty((n, a_count, Q), dtype=I32, device=dev)
    eps = torch.empty((n, a_count, 6, Q), dtype=I32, device=dev)
    idx = torch.empty((n, a_count, 2, Q), dtype=I32, device=dev)
    if n == 0:
        return err, valid, eps, idx
    fn = cuda_lib.function("bc6h_group")
    floats, ints = _launch_constants(cw)
    code = fn(pix.data_ptr(), base.data_ptr(), offset.data_ptr(), n, aprec,
              int(is_signed), int(fast_indexing), int(uniform),
              num_tweak_rounds, num_refine_rounds, floats, ints,
              err.data_ptr(), valid.data_ptr(), eps.data_ptr(),
              idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, f"partitioned_group_meta_rounds(aprec {aprec})")
    LAUNCHES["partitioned_group_meta_rounds"] += 1
    return err, valid, eps, idx


def pack_indexes(idx):
    """[..., 16, Q] 3-bit indexes -> [..., 2, Q] words (pixels 0-9 in the
    first, 10-15 in the second, 3 bits each from bit 0)."""
    lo = idx[..., 0, :]
    for px in range(1, 10):
        lo = lo | (idx[..., px, :] << (3 * px))
    hi = idx[..., 10, :]
    for px in range(11, 16):
        hi = hi | (idx[..., px, :] << (3 * (px - 10)))
    return torch.stack([lo, hi], dim=-2)


def partitioned_group_meta_rounds_plain(pix, base, offset, aprec, is_signed,
                                        fast_indexing, uniform, cw,
                                        num_tweak_rounds, num_refine_rounds):
    """Plain PyTorch version of partitioned_group_meta_rounds (same
    signature), on the device of its tensors."""
    dev = pix.device
    err, valid, eps, idx = bc6h_common.meta_round_chain(
        pix, [base[:, ch] for ch in range(3)],
        [offset[:, ch] for ch in range(3)], aprec, is_signed, fast_indexing,
        uniform, cw, num_tweak_rounds, num_refine_rounds, INDEX_RANGE,
        programs.constant(SUBSET_MEMBER, dev),
        programs.constant(SUBSET_FIXUPS, dev))
    return err, valid, eps, pack_indexes(idx)
