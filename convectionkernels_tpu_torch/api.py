"""Public S3TC, BC7 and BC6H API.

The PyTorch counterpart of cvtt::Kernels' S3TC, BC7 and BC6H entry points
(ConvectionKernels.h:236-277, ConvectionKernels_API.cpp). Every entry point
takes a batch of N blocks ([N, 16, 4] pixels) and runs on `device`: the
CUDA card by default, where the hand-written kernels run, or the CPU when
the caller asks for it, where their plain PyTorch versions run.

Blocks are independent, so a large batch is encoded in host-side chunks
(CHUNK_S3TC, CHUNK_S3TC_EXHAUSTIVE, CHUNK_BC7, CHUNK_BC6H blocks), which
bounds the device memory of the per-candidate tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bc7_plan
from .models import bc6h, bc7, decode, s3tc
from .options import Flags, Options

# Blocks per S3TC encode chunk, and per chunk of an exhaustive BC1-BC3
# encode, whose [N, 965] partition tensors peak at about 145 KB a block
# (9.1 GiB at 65,536). The S3TC encoders are eager tensor code, so each
# chunk costs a fixed launch overhead (about 65 ms for BC1, 250 ms for BC3
# on an H100); PERF.md records the sweeps these values come from.
CHUNK_S3TC = 65536
CHUNK_S3TC_EXHAUSTIVE = 65536

# Blocks per encode chunk. On an H100 the encode's host-side torch ops cost
# a fixed launch overhead per chunk, so larger chunks are faster until the
# per-candidate outputs (~90 KB a block at q50) crowd device memory;
# PERF.md records the sweep this value comes from.
CHUNK_BC7 = 65536

# Blocks per BC6H encode chunk. At the default 12 meta rounds a partitioned
# group's kernel outputs take 30 KB a block and its combine grids several
# times that; PERF.md records the sweep on an H100 this value comes from.
CHUNK_BC6H = 65536


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    and there is none (the CPU is only used when asked for by name)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return dev


def _as_blocks(pixels, device, dtype=torch.uint8) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(pixels) if not torch.is_tensor(pixels)
                        else pixels)
    if t.dim() != 3 or t.shape[1] != 16 or t.shape[2] != 4:
        raise ValueError(f"expected [N, 16, 4] pixel blocks, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype} pixels, got {t.dtype}")
    return t.to(device)


def _chunked(pack_chunk, blocks, chunk: int, width: int = 16) -> torch.Tensor:
    """`pack_chunk` over `chunk`-sized slices of the block axis; `width`
    bytes a block."""
    outs = [pack_chunk(blocks[i:i + chunk])
            for i in range(0, blocks.shape[0], chunk)]
    if not outs:
        return torch.zeros((0, width), dtype=torch.uint8,
                           device=blocks.device)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def encode_bc7(pixels, options: Options = Options(), plan=None, quality=None,
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC7 (API.cpp:41-54): uint8 [N, 16, 4] -> uint8
    [N, 16] on `device`.

    `plan` is a BC7EncodingPlan (default: max quality); `quality` (1-100)
    configures a plan via ConfigureBC7EncodingPlanFromQuality.
    """
    dev = resolve_device(device)
    if plan is None:
        plan = (bc7_plan.plan_from_quality(quality) if quality is not None
                else bc7_plan.BC7EncodingPlan())
    blocks = _as_blocks(pixels, dev)
    cw = options.channel_weights()
    return _chunked(lambda b: bc7.pack(b, options.flags, cw, plan,
                                       options.refine_rounds_bc7),
                    blocks, CHUNK_BC7)


def decode_bc7(blocks, device=None) -> torch.Tensor:
    """Kernels::DecodeBC7 (API.cpp:288-298): uint8 [N, 16] -> uint8
    [N, 16, 4] on `device`. Decoding runs on the host in NumPy."""
    dev = resolve_device(device)
    if torch.is_tensor(blocks):
        blocks = blocks.cpu().numpy()
    return torch.as_tensor(decode.decode_bc7(np.asarray(blocks))).to(dev)


def _encode_bc6h(pixels, options: Options, signed: bool, device):
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev, torch.int16)
    cw = options.channel_weights()
    return _chunked(lambda b: bc6h.pack(b, options.flags, cw, signed,
                                        options.seed_points,
                                        options.refine_rounds_bc6h),
                    blocks, CHUNK_BC6H)


def encode_bc6hu(pixels, options: Options = Options(),
                 device=None) -> torch.Tensor:
    """Kernels::EncodeBC6HU (API.cpp:56-69), unsigned HDR: int16 half-float
    bits [N, 16, 4] (alpha ignored) -> uint8 [N, 16] on `device`."""
    return _encode_bc6h(pixels, options, False, device)


def encode_bc6hs(pixels, options: Options = Options(),
                 device=None) -> torch.Tensor:
    """Kernels::EncodeBC6HS (API.cpp:71-84), signed HDR: int16 half-float
    bits [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_bc6h(pixels, options, True, device)


def _decode_bc6h(blocks, signed: bool, device):
    dev = resolve_device(device)
    if torch.is_tensor(blocks):
        blocks = blocks.cpu().numpy()
    return torch.as_tensor(decode.decode_bc6h(np.asarray(blocks),
                                              signed)).to(dev)


def decode_bc6hu(blocks, device=None) -> torch.Tensor:
    """Kernels::DecodeBC6HU (API.cpp:300-310): uint8 [N, 16] -> int16
    half-float bits [N, 16, 4] (alpha 1.0) on `device`. Decoding runs on
    the host in NumPy."""
    return _decode_bc6h(blocks, False, device)


def decode_bc6hs(blocks, device=None) -> torch.Tensor:
    """Kernels::DecodeBC6HS (API.cpp:312-322): the signed counterpart of
    decode_bc6hu."""
    return _decode_bc6h(blocks, True, device)


def _encode_s3tc(pack_chunk, pixels, options: Options, device, width: int,
                 signed=False, color=False) -> torch.Tensor:
    """`pack_chunk` over the blocks in chunks: CHUNK_S3TC_EXHAUSTIVE
    blocks where a BC1 color half runs the exhaustive search."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev, torch.int8 if signed else torch.uint8)
    if signed:
        blocks = s3tc.bias_signed_input(blocks)
    exhaustive = color and bool(options.flags & Flags.S3TC_EXHAUSTIVE)
    return _chunked(pack_chunk, blocks,
                    CHUNK_S3TC_EXHAUSTIVE if exhaustive else CHUNK_S3TC, width)


def _rgb(blocks, options: Options, alpha_test: bool):
    """PackRGB with the options' settings: BC1 (with the alpha test) or the
    color half of BC2 / BC3 (API.cpp:86-131)."""
    return s3tc.pack_rgb(
        blocks, options.flags, options.channel_weights(), alpha_test,
        options.threshold if alpha_test else 1.0,
        bool(options.flags & Flags.S3TC_EXHAUSTIVE), options.seed_points,
        options.refine_rounds_s3tc)


def _interpolated(blocks, options: Options, channel: int, signed: bool):
    return s3tc.pack_interpolated_alpha(blocks, channel, signed,
                                        options.seed_points,
                                        options.refine_rounds_iic)


def encode_bc1(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC1 (API.cpp:86-99): BC1 with the alpha test, uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc(lambda b: _rgb(b, options, True), pixels, options,
                        device, 8, color=True)


def encode_bc2(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC2 (API.cpp:101-115): 4-bit alpha then BC1 color,
    uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc(
        lambda b: torch.cat([s3tc.pack_explicit_alpha(b, 3),
                             _rgb(b, options, False)], dim=-1),
        pixels, options, device, 16, color=True)


def encode_bc3(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC3 (API.cpp:117-131): interpolated alpha then BC1
    color, uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc(
        lambda b: torch.cat([_interpolated(b, options, 3, False),
                             _rgb(b, options, False)], dim=-1),
        pixels, options, device, 16, color=True)


def encode_bc4u(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC4U (API.cpp:133-146): the red channel, uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc(lambda b: _interpolated(b, options, 0, False),
                        pixels, options, device, 8)


def encode_bc4s(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC4S (API.cpp:148-164): the red channel of signed
    input, int8 [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc(lambda b: _interpolated(b, options, 0, True),
                        pixels, options, device, 8, signed=True)


def _bc5(options: Options, signed: bool):
    return lambda b: torch.cat([_interpolated(b, options, 0, signed),
                                _interpolated(b, options, 1, signed)], dim=-1)


def encode_bc5u(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC5U (API.cpp:166-180): red then green, uint8
    [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc(_bc5(options, False), pixels, options, device, 16)


def encode_bc5s(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC5S (API.cpp:182-199): red then green of signed
    input, int8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc(_bc5(options, True), pixels, options, device, 16,
                        signed=True)
