# Frozen copy of convectionkernels_tpu_torch/models/bc6h_kernel.py:1-159 at
# commit 9895176, the benchmark's plain reference: never edited to follow
# the program. Changed: partitioned_group_meta_rounds runs its plain PyTorch
# version on any device; the CUDA launch, its argument checks and the launch
# counter are left out.
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

import numpy as np
import torch

from .. import programs
from ..ops import lanes
from ..tables import bc7_geometry as geom
from . import bc6h_common

Q = 64            # (partition, subset) rows of a partitioned group
INDEX_RANGE = 8   # 3-bit indexes

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
    return partitioned_group_meta_rounds_plain(
        pix, base, offset, aprec, is_signed, fast_indexing, uniform, cw,
        num_tweak_rounds, num_refine_rounds)


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
