"""The block axis split over several processes, one card each.

The counterpart of the JAX package's parallel/distributed.py. Blocks are
independent (etc2packer.cpp:215-281), so each process blockifies only its
raster slice of the image (edge clamping applied to the whole image, as
etc2packer.cpp:226-231 does), encodes it on its own card, and holds its
contiguous slice of the output; an optional all-gather assembles the whole
output on every process. Options and the BC7 plan are arguments of
`encode`, the same in every process, so nothing but the bytes travels.

The processes form a torch.distributed group: NCCL between cards, gloo on
the CPU or where two processes share one card (NCCL refuses two ranks on
one card). Over gloo the gather goes through host tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils import image as image_util
from .sharding import pad_to_multiple


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> None:
    """torch.distributed.init_process_group with NCCL when this machine has
    a card and gloo otherwise, unless `backend` says which. Arguments left
    None take torch's defaults (init_method "env://", which reads
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK). Call it once a process,
    before encode_image_distributed."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {k: v for k, v in (("init_method", init_method),
                                ("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend=backend, **kwargs)


def _world() -> tuple[int, int]:
    """(world size, rank); (1, 0) when no process group is set up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _block_grid(height: int, width: int) -> tuple[int, int]:
    return (height + 3) // 4, (width + 3) // 4


def local_block_range(n_blocks: int, n_pad: int) -> tuple[int, int]:
    """[start, end) of the padded block axis owned by this process: the
    axis is split evenly over the ranks in rank order."""
    world, rank = _world()
    if n_pad % world:
        raise ValueError(f"{n_pad} padded blocks do not split evenly over "
                         f"{world} processes")
    per = n_pad // world
    start = rank * per
    return start, start + per


def blockify_local_slice(image: np.ndarray, start: int, end: int,
                         n_blocks: int) -> np.ndarray:
    """Blockify only the rows of `image` covering global blocks [start, end).

    Blocks are in raster order (bh x bw grid); this process needs pixel
    rows [4*r0, 4*r1) where r0/r1 are the covering block-row range. Blocks
    past n_blocks (padding, so that every process holds as many blocks)
    repeat the slice's first block, or block 0 when the slice holds only
    padding.
    """
    h, w = image.shape[:2]
    bh, bw = _block_grid(h, w)
    real_end = min(end, n_blocks)
    if real_end > start:
        r0 = start // bw
        r1 = (real_end - 1) // bw + 1
        rows = image[r0 * 4: min(r1 * 4, h)]
        blocks = image_util.blockify(rows)  # [(r1-r0)*bw, 16, 4]
        local = blocks[start - r0 * bw: real_end - r0 * bw]
    else:  # this process owns only padding
        local = image_util.blockify(image[:4, :4])[:0]
    if end > max(start, n_blocks):  # pad region: replicate a valid block
        pad_block = (local[:1] if len(local)
                     else image_util.blockify(image[:4, :4])[:1])
        pad = np.broadcast_to(pad_block,
                              (end - max(start, n_blocks),) + pad_block.shape[1:])
        local = np.concatenate([local, pad], axis=0)
    return np.ascontiguousarray(local)


def encode_image_distributed(encode, image: np.ndarray, device=None,
                             assemble: bool = False):
    """Encode a [H, W, C] u8 image split over the processes of the group.

    Returns (local_bytes, start, n_blocks): this process's contiguous slice
    of the encoded output (raster block order, NumPy) and its global
    offset; with assemble=True returns the whole [n_blocks, B] NumPy array
    instead, gathered to every process.

    `encode`: one of the port's entry points or a functools.partial of
    one, called as encode(blocks, device=device). `device` defaults to
    card `rank % device_count` (the CPU only when asked for).
    """
    world, rank = _world()
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())

    h, w = image.shape[:2]
    bh, bw = _block_grid(h, w)
    n_blocks = bh * bw
    n_pad = pad_to_multiple(n_blocks, world)
    start, end = local_block_range(n_blocks, n_pad)
    out = encode(blockify_local_slice(image, start, end, n_blocks),
                 device=device)

    if assemble:
        if dist.is_available() and dist.is_initialized():
            if dist.get_backend() != "nccl":
                out = out.cpu()
            parts = [torch.empty_like(out) for _ in range(world)]
            dist.all_gather(parts, out)
            out = torch.cat(parts)
        return out.cpu().numpy()[:n_blocks]
    return out.cpu().numpy()[: max(0, min(end, n_blocks) - start)], start, \
        n_blocks
