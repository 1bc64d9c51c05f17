"""The block axis split over several devices.

The counterpart of the JAX package's parallel/sharding.py. Blocks never
interact (the reference's callers loop over 8-block groups,
etc2packer.cpp:215-281), so any partition of the block axis gives the same
bytes: each device encodes one contiguous slice of it with the port's own
entry point, and the bytes come back to the host in raster order. No
device talks to another.
"""

from __future__ import annotations

import numpy as np
import torch


def default_devices() -> list[torch.device]:
    """Every CUDA card, in index order (the JAX package's default_mesh
    over jax.devices())."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass devices=['cpu'] to split "
                           "over the CPU")
    return [torch.device("cuda", i) for i in range(count)]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def encode_sharded(encode, pixels, devices=None) -> np.ndarray:
    """Encode [N, ...] pixel blocks split over `devices` (default: every
    card), as NumPy bytes [N, B] in raster order.

    `encode` is one of the port's entry points, or a functools.partial of
    one, called as encode(slice, device=d). The block axis is cut into
    len(devices) contiguous slices of ceil(N / len(devices)) blocks (the
    last one shorter, none empty); every slice's encode is started before
    the first result is read back, so the devices overlap as far as the
    host lets them. A device may be named more than once. Entry points
    that split their blocks on the host (ETC2 punchthrough's transparency
    split) split each slice on their own, with the same bytes.

    Unlike the JAX function there is no `chunk` argument and no padding:
    each slice goes through the entry point's own chunking (the api
    module's CHUNK_* sizes, which tests may lower).
    """
    devices = (default_devices() if devices is None
               else [torch.device(d) for d in devices])
    if not devices:
        raise ValueError("encode_sharded needs at least one device")
    if not torch.is_tensor(pixels):
        pixels = np.asarray(pixels)
    n = pixels.shape[0]
    per = max(1, -(-n // len(devices)))
    outs = [encode(pixels[start:start + per], device=dev)
            for start, dev in zip(range(0, max(n, 1), per), devices)]
    return np.concatenate([out.cpu().numpy() for out in outs], axis=0)
