"""The benchmark's plain reference encoders: a frozen copy of the port's
plain PyTorch path for BC7 and BC6H (models/, ops/, tables/, bc7_plan.py,
options.py at commit 9895176, each file's header names its source), with
every kernel wrapper running its plain version. It imports torch and numpy
only: nothing of the program and nothing of JAX.

The port's CPU path was held byte for byte against the JAX package and
its goldens, and its plain kernel versions bit for bit against the CUDA
kernels on the card; the copy gives the same bytes on the CPU and on the
card. The entry points take the blocks as the benchmark hands them to the
program, in chunks of `chunk` blocks (blocks are independent).
"""

from __future__ import annotations

import torch

from .bc7_plan import plan_from_quality
from .models import bc6h, bc7
from .options import Options


def encode_bc7(blocks: torch.Tensor, quality: int,
               chunk: int = 8192) -> torch.Tensor:
    """BC7 at `quality` with default Options: uint8 [N, 16, 4] -> uint8
    [N, 16] on the blocks' device."""
    options, plan = Options(), plan_from_quality(quality)
    cw = options.channel_weights()
    return _chunked(blocks, chunk, lambda b: bc7.pack(
        b, options.flags, cw, plan, options.refine_rounds_bc7))


def encode_bc6hu(blocks: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """BC6H unsigned with default Options: int16 half-float bits
    [N, 16, 4] -> uint8 [N, 16] on the blocks' device."""
    options = Options()
    cw = options.channel_weights()
    return _chunked(blocks, chunk, lambda b: bc6h.pack(
        b, options.flags, cw, False, options.seed_points,
        options.refine_rounds_bc6h))


def _chunked(blocks, chunk, body):
    outs = [body(blocks[i:i + chunk]) for i in range(0, blocks.shape[0],
                                                     chunk)]
    return torch.cat(outs) if outs else torch.zeros(
        (0, 16), dtype=torch.uint8, device=blocks.device)
