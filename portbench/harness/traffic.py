"""The traffic generator: a mix file's parameters -> the requests a run
sends.

A request is one texture: its levels in order, each [N, 16, 4] host blocks
as the program's entry point takes them. A run's traffic is a pool (what
the warm-up and the settle send) and the window's requests, in the order
the window sends them. Mix keys:
  image_size      side of each generated image, in texels
  pool_images     images made, from seeds seed, seed + 1, ...
  tile_size       null: each image is one request; else the image is cut
                  into tile_size x tile_size tiles in raster order, each a
                  request
  mips            true: a request is the full mip chain of its texture
  window_requests distinct requests made for the window: request v is pool
                  request v mod len(pool) with the lowest bit of each
                  colour channel flipped by a mask drawn from the seed
                  (alpha untouched), so no input of the window repeats one
                  sent before it; the window cycles only past the last
  settle_s        seconds of pool requests sent after the warm-up calls,
                  outside set-up and the window
  trace_requests  how many whole requests a --trace 1 run profiles
  check_full_max  levels of at most this many blocks are checked whole
  check_sample    blocks drawn from the seed in each larger level of each
                  served request for the check (harness/check.py)
The configuration's `input` chooses the images: ldr_rgba8 (uint8 RGBA,
integer box-filter mips) or hdr_rgba16f (half floats as int16 bits,
float32 box-filter mips rounded to half). Every seed gives the same
sizes in the same order.

A kind of traffic or input this generator cannot make is new files
only: a mix names its own generator (`"generator": "module:function"`,
called as generator(mix, config, seed) -> Traffic) and may name its own
loop (`"loop"`, harness/runner.py); the configuration may name its own
entry builder and reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import inputs, spec


@dataclasses.dataclass
class Request:
    levels: list          # [N, 16, 4] host blocks per mip level

    @property
    def blocks(self) -> int:
        return sum(lv.shape[0] for lv in self.levels)

    @property
    def texels(self) -> int:
        """16 texels a real block: a 2x2 or 1x1 level counts as its one
        block, and no bucket pad is counted."""
        return 16 * self.blocks


@dataclasses.dataclass
class Traffic:
    pool: list            # Requests the warm-up and the settle send
    window: list          # Requests the window sends, in order


INPUTS = {
    "ldr_rgba8": (inputs.make_texture_image, inputs.mip_chain, None),
    "hdr_rgba16f": (inputs.make_hdr_image, inputs.mip_chain_half, np.int16),
}

# room for the mask's offsets beyond the largest level, in values: the
# window's variants of one pool request start their masks at offsets drawn
# from this many places
MASK_ROOM = 4 * 2**22


def image_seed(seed: int, i: int) -> int:
    """The seed of pool image i: any whole number is taken."""
    return (seed + i) % 2**64


def make_pool(mix: dict, input_name: str, seed: int) -> list[Request]:
    make, chain, view = INPUTS[input_name]
    size, tile = int(mix["image_size"]), mix.get("tile_size")
    pool = []
    for i in range(int(mix["pool_images"])):
        image = make(image_seed(seed, i), size)
        t = size if tile is None else int(tile)
        for y in range(0, size, t):
            for x in range(0, size, t):
                piece = image[y:y + t, x:x + t]
                levels = chain(piece) if mix.get("mips") else [piece]
                blocks = [inputs.blockify(lv) for lv in levels]
                if view is not None:
                    blocks = [b.view(view) for b in blocks]
                pool.append(Request(blocks))
    return pool


def variants(pool: list[Request], count: int, seed: int) -> list[Request]:
    """`count` requests for the window: request v is pool[v % len(pool)]
    with the lowest bit of each colour channel XORed with a random mask
    (one bit per value, alpha's bit 0), read from one random array at an
    offset drawn for each level of each request."""
    if count <= 0:
        return list(pool)
    rng = np.random.default_rng([seed % 2**63, 0x7A81])
    largest = max(lv.size for r in pool for lv in r.levels)
    length = largest + MASK_ROOM
    bits = rng.integers(0, 2, size=length // 4 * 4, dtype=np.uint8)
    bits.reshape(-1, 4)[:, 3] = 0
    masks = {}
    out = []
    for v in range(count):
        base = pool[v % len(pool)]
        levels = []
        for lv in base.levels:
            mask = masks.get(lv.dtype)
            if mask is None:
                mask = masks[lv.dtype] = bits.astype(lv.dtype)
            at = 4 * int(rng.integers(0, (length - lv.size) // 4 + 1))
            levels.append(lv ^ mask[at:at + lv.size].reshape(lv.shape))
        out.append(Request(levels))
    return out


def make(mix: dict, config: dict, seed: int,
         root: str = spec.ROOT) -> Traffic:
    """The run's traffic: the mix's own generator where it names one,
    else the pool of make_pool and its window variants."""
    if "generator" in mix:
        return spec.resolve(mix["generator"], root)(mix, config, seed)
    pool = make_pool(mix, config["input"], seed)
    return Traffic(pool, variants(pool, int(mix.get("window_requests", 0)),
                                  seed))


def level_sizes(pool: list[Request]) -> list[int]:
    """Every distinct level size the pool sends, largest first."""
    return sorted({lv.shape[0] for r in pool for lv in r.levels},
                  reverse=True)
