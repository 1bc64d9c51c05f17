"""Command-line encoder: image -> KTX/DDS.

The counterpart of the JAX package's cli.py (itself the equivalent of the
reference's etc2packer example CLI, etc2packer.cpp:43-293, extended to all
supported formats), with the same flags and the same output bytes. The
whole image's blocks go to the card in one call (the entry points chunk
them); with more than one card, or -shard, the blocks are split over
every card (parallel.sharding.encode_sharded).

Usage:
  python -m convectionkernels_tpu_torch.cli [options] input output
  -f <format>     bc1|bc2|bc3|bc4|bc4s|bc5|bc5s|bc6h|bc6hs|bc7|etc1|etc2|
                  etc2rgba|etc2pt|eac_r11|eac_r11s|eac_rg11|eac_rg11s
  -q <1..100>     BC7 quality plan
  -u              uniform channel weights
  -fakebt709      etc2comp-compatible pseudo-BT.709 error metric
  -fast|-better|-ultra   flag presets
  -t <0..1>       BC1/punchthrough alpha threshold
  -mips           encode a full mip chain (2x2 box filter)
  -shard          force the split over the cards (default: split when
                  there is more than one card)
input is a .npy uint8 [H, W, 3 or 4] array, or any image PIL reads;
output is written as DDS when it ends in .dds, else as KTX.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from . import api
from .bc7_plan import BC7EncodingPlan, plan_from_quality
from .options import Flags, Options
from .parallel import sharding
from .utils import containers, image as image_util


def load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(
            "no image loader available (install PIL or use .npy)") from None
    return np.asarray(Image.open(path).convert("RGBA"))


def _u8_to_s8(blocks: np.ndarray) -> np.ndarray:
    """u8 image channel -> signed s8 input (127.5-centered remap)."""
    return (blocks.astype(np.int16) - 128).clip(-127, 127).astype(np.int8)


def _u8_to_half_bits(blocks: np.ndarray) -> np.ndarray:
    """LDR u8 blocks -> f16 bit patterns (for HDR sources use the API with
    int16 half-float input directly)."""
    return (blocks.astype(np.float32)
            / np.float32(255.0)).astype(np.float16).view(np.int16)


def _eac_channel(blocks: np.ndarray, ch: int) -> np.ndarray:
    return blocks[:, :, ch].astype(np.int16) << 3  # 8-bit -> 11-bit scale


def get_encoder(fmt: str, options: Options, quality, device=None):
    """Returns (encode(blocks, sharded) -> NumPy bytes, container_fmt).

    encode() runs the port's entry point on `device` (the card when None),
    or, when `sharded`, splits the blocks over every card (over `device`
    alone when one is named).
    """
    devices = None if device is None else [device]

    def run(fn, blocks, sharded):
        if sharded:
            return sharding.encode_sharded(fn, blocks, devices)
        return fn(blocks, device=device).cpu().numpy()

    def simple(fn, transform=None):
        def encode(blocks, sharded):
            return run(fn, blocks if transform is None else transform(blocks),
                       sharded)
        return encode

    def dual_channel(fn, tr0, tr1):
        """Two independent single-channel passes, 8+8 bytes interleaved
        per block (the reference's BC5/RG11 model, API.cpp:166-199)."""
        def encode(blocks, sharded):
            return np.concatenate([run(fn, tr0(blocks), sharded),
                                   run(fn, tr1(blocks), sharded)], axis=-1)
        return encode

    if fmt == "bc7":
        plan = (plan_from_quality(quality) if quality is not None
                else BC7EncodingPlan())
        return (simple(functools.partial(api.encode_bc7, options=options,
                                         plan=plan)), "bc7")
    if fmt in ("bc6h", "bc6hs"):
        signed = fmt == "bc6hs"
        fn = api.encode_bc6hs if signed else api.encode_bc6hu
        return (simple(functools.partial(fn, options=options),
                       _u8_to_half_bits),
                "bc6h_sf" if signed else "bc6h_uf")
    if fmt in ("bc4s", "bc5s"):
        # the JAX CLI labels the signed formats' containers unsigned
        # (DXGI 80/83, GL 0x8DBB/0x8DBD); the port writes the same bytes
        fn = api.encode_bc4s if fmt == "bc4s" else api.encode_bc5s
        return (simple(functools.partial(fn, options=options), _u8_to_s8),
                "bc4u" if fmt == "bc4s" else "bc5u")
    if fmt in ("eac_r11", "eac_r11s", "eac_rg11", "eac_rg11s"):
        fn = functools.partial(api.encode_eac11, signed=fmt.endswith("s"),
                               options=options)
        if fmt.startswith("eac_r11"):
            return simple(fn, lambda b: _eac_channel(b, 0)), fmt
        return (dual_channel(fn, lambda b: _eac_channel(b, 0),
                             lambda b: _eac_channel(b, 1)), fmt)

    simple_map = {
        "bc1": (api.encode_bc1, "bc1"),
        "bc2": (api.encode_bc2, "bc2"),
        "bc3": (api.encode_bc3, "bc3"),
        "bc4": (api.encode_bc4u, "bc4u"),
        "bc5": (api.encode_bc5u, "bc5u"),
        "etc1": (api.encode_etc1, "etc1"),
        "etc2": (api.encode_etc2, "etc2"),
        "etc2rgba": (api.encode_etc2_rgba, "etc2_rgba"),
        "etc2pt": (api.encode_etc2_punchthrough, "etc2_punchthrough"),
    }
    if fmt not in simple_map:
        raise SystemExit(f"unknown format: {fmt}")
    fn, container_fmt = simple_map[fmt]
    return simple(functools.partial(fn, options=options)), container_fmt


def main(argv=None, device=None) -> int:
    """Run the CLI on `argv` (default: sys.argv[1:]). The encodes run on
    `device`, the card when None; pass device="cpu" for the CPU."""
    argv = sys.argv[1:] if argv is None else argv
    fmt = "etc2"
    quality = None
    flags = Flags.DEFAULT
    threshold = 0.5
    mips = False
    shard = None
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-f":
            i += 1
            fmt = argv[i]
        elif a == "-q":
            i += 1
            quality = int(argv[i])
        elif a == "-u":
            flags |= Flags.UNIFORM
        elif a == "-fakebt709":
            flags |= Flags.ETC_USE_FAKE_BT709
        elif a == "-fast":
            flags = Flags.FAST
        elif a == "-better":
            flags = Flags.BETTER
        elif a == "-ultra":
            flags = Flags.ULTRA
        elif a == "-t":
            i += 1
            threshold = float(argv[i])
        elif a == "-mips":
            mips = True
        elif a == "-shard":
            shard = True
        else:
            paths.append(a)
        i += 1

    if len(paths) != 2:
        print(__doc__)
        return 1
    input_path, output_path = paths

    img = load_image(input_path)
    options = Options(flags=flags, threshold=threshold)
    encode, container_fmt = get_encoder(fmt, options, quality, device)

    if shard is None:
        shard = device is None and torch.cuda.device_count() > 1

    images = image_util.mip_chain(img) if mips else [img]
    levels = []
    for level_img in images:
        h, w = level_img.shape[:2]
        blocks = image_util.blockify(level_img)
        levels.append((encode(blocks, shard), w, h))

    if output_path.endswith(".dds"):
        containers.write_dds(output_path, levels, fmt=container_fmt)
    else:
        containers.write_ktx(output_path, levels, fmt=container_fmt)
    total = sum(b.nbytes for b, _, _ in levels)
    print(f"wrote {output_path}: {fmt}, {levels[0][1]}x{levels[0][2]}, "
          f"{len(levels)} level(s), {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
