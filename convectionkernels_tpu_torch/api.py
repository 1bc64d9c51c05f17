"""Public S3TC, BC7, BC6H, ETC1, ETC2 and EAC11 API.

The PyTorch counterpart of cvtt::Kernels' entry points
(ConvectionKernels.h:236-277, ConvectionKernels_API.cpp). Every entry point
takes a batch of N blocks ([N, 16, C] pixels, or [N, 16] values for
encode_eac11), converted and checked as the JAX package's entry points
convert them, and runs on `device`: the CUDA card by default, where the
hand-written kernels run, or the CPU when the caller asks for it, where
their plain PyTorch versions run.

Blocks are independent, so a large batch is encoded in host-side chunks
(CHUNK_S3TC, CHUNK_S3TC_EXHAUSTIVE, CHUNK_BC7, CHUNK_BC6H, CHUNK_ETC,
CHUNK_ETC2, CHUNK_EAC blocks), which bounds the device memory of the
per-candidate tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bc7_plan
from .models import bc6h, bc7, decode, etc, s3tc
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

# Blocks per ETC1 encode chunk and per ETC2 alpha / EAC11 chunk. ETC1's
# differential pair resolve holds [N, K_t, A] grids (up to 76 x 286 int32
# pairs a block, 81 x 648 with FakeBT709) and the alpha search [N, 16, 320]
# grids. On an H100 one chunk of 65,536 is the fastest of the sizes swept,
# peaking at 11.8 GiB for ETC1 (18.0 with FakeBT709) and 14.2 for the alpha
# search; PERF.md records the sweeps.
CHUNK_ETC = 65536
CHUNK_EAC = 65536

# Blocks per ETC2 (RGB, RGBA, punchthrough) encode chunk. ETC2 runs ETC1's
# differential half beside the planar, T and H searches, whose H-mode pair
# totals are [N, 8, 33, 33] float32 (35 KB a block). On an H100 one chunk
# of 65,536 is 12% (etc2) and 25% (punchthrough) faster than 16,384,
# peaking at 11.8 GiB (14.2 with RGBA's alpha search, 18.0 with
# FakeBT709); PERF.md records the sweep.
CHUNK_ETC2 = 65536


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    and there is none (the CPU is only used when asked for by name)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return dev


_NUMPY_DTYPES = {torch.uint8: np.uint8, torch.int8: np.int8,
                 torch.int16: np.int16}


def _cast(pixels, dtype) -> torch.Tensor:
    """`pixels` as a `dtype` tensor, converted as the JAX package's entry
    points convert (jnp.asarray(pixels, dtype), which calls np.asarray):
    an array-like goes through np.asarray itself; a tensor, which stays on
    its device, is converted by NumPy's rules: integers wrap, floats
    truncate toward zero to int32 (NaN, infinities and values outside
    int32 giving INT32_MIN) and then wrap."""
    if not torch.is_tensor(pixels):
        return torch.from_numpy(np.array(pixels, dtype=_NUMPY_DTYPES[dtype]))
    if pixels.dtype == dtype:
        return pixels
    t = pixels
    if t.is_floating_point():
        t = t.double()
        inside = torch.isfinite(t) & (t > -2.0**31 - 1) & (t < 2.0**31)
        t = torch.where(inside, t.trunc(), -2.0**31).to(torch.int64)
    return t.to(dtype)


def _static_index(t, dim: int, count: int) -> torch.Tensor:
    """Entries 0 .. count - 1 of `t` along `dim` as the JAX package reads
    them, with static integer indices: an index past the end clamps to the
    last entry, and entries past `count` are not read."""
    size = t.shape[dim]
    if size == count:
        return t
    return t.index_select(dim, torch.tensor(
        [min(i, size - 1) for i in range(count)], device=t.device))


def _as_blocks(pixels, device, dtype=torch.uint8,
               sixteen_pixels=True) -> torch.Tensor:
    """[N, 16, 4] `dtype` blocks on `device` from any [N, P, C] array-like
    (P, C >= 1) that the JAX entry point takes: [N, 16, C] where it checks
    the shape (`sixteen_pixels`), any P where it does not (BC6H). The JAX
    package reads pixel p and channel c with static indices, which clamp
    to the last one, so a missing pixel or channel repeats the last one
    and those past the 16th pixel or fourth channel are not read."""
    t = _cast(pixels, dtype)
    if t.dim() != 3 or t.shape[1] < 1 or t.shape[2] < 1 or (
            sixteen_pixels and t.shape[1] != 16):
        raise ValueError(f"expected [N, 16, C] pixel blocks, got "
                         f"{tuple(t.shape)}")
    return _static_index(_static_index(t, 2, 4), 1, 16).to(device)


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
    blocks = _as_blocks(pixels, dev, torch.int16, sixteen_pixels=False)
    cw = options.channel_weights()
    return _chunked(lambda b: bc6h.pack(b, options.flags, cw, signed,
                                        options.seed_points,
                                        options.refine_rounds_bc6h),
                    blocks, CHUNK_BC6H)


def encode_bc6hu(pixels, options: Options = Options(),
                 device=None) -> torch.Tensor:
    """Kernels::EncodeBC6HU (API.cpp:56-69), unsigned HDR: int16 half-float
    bits [N, 16, 4] (alpha ignored) -> uint8 [N, 16] on `device`. As in the
    JAX package, [N, P, C] with P other than 16 is read with clamped pixel
    indices."""
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


def encode_etc1(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeETC1 (API.cpp:201-214): uint8 [N, 16, 4] -> uint8
    [N, 8] on `device`."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    return _chunked(lambda b: etc.compress_etc1(b, options), blocks,
                    CHUNK_ETC, 8)


def encode_etc2_alpha(pixels, options: Options = Options(),
                      device=None) -> torch.Tensor:
    """Kernels::EncodeETC2Alpha (API.cpp:246-257): the alpha channel of
    uint8 [N, 16, 4] -> uint8 [N, 8] on `device`."""
    del options  # the alpha search has no option
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    return _chunked(etc.compress_etc2_alpha, blocks, CHUNK_EAC, 8)


def encode_eac11(pixels, signed: bool = False, options: Options = Options(),
                 device=None) -> torch.Tensor:
    """Kernels::EncodeETC2Alpha11 (API.cpp:259-268): one 11-bit channel,
    int16 [N, 16] (clamped to [0, 2047], or [-1023, 1023] when `signed`)
    -> uint8 [N, 8] on `device`. As in the JAX package, [N, P] with P other
    than 16 is read with clamped pixel indices; a rank other than 2, which
    the JAX package encodes into an array of another shape, raises."""
    del options  # the alpha search has no option
    dev = resolve_device(device)
    values = _cast(pixels, torch.int16)
    if values.dim() != 2 or values.shape[1] < 1:
        raise ValueError(f"expected [N, 16] values, got "
                         f"{tuple(values.shape)}")
    return _chunked(lambda b: etc.compress_eac11(b, signed),
                    _static_index(values, 1, 16).to(dev), CHUNK_EAC, 8)


def encode_etc2(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeETC2 (API.cpp:216-229): uint8 [N, 16, 4] -> uint8
    [N, 8] on `device`."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    return _chunked(lambda b: etc.compress_etc2(b, options, False), blocks,
                    CHUNK_ETC2, 8)


def encode_etc2_rgba(pixels, options: Options = Options(),
                     device=None) -> torch.Tensor:
    """Kernels::EncodeETC2RGBA (API.cpp:270-286): the ETC2 alpha block then
    the ETC2 color block, uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    return _chunked(lambda b: torch.cat([
        etc.compress_etc2_alpha(b), etc.compress_etc2(b, options, False)],
        dim=-1), blocks, CHUNK_ETC2, 16)


def encode_etc2_punchthrough(pixels, options: Options = Options(),
                             device=None) -> torch.Tensor:
    """Kernels::EncodeETC2PunchthroughAlpha (API.cpp:231-244): uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`; a pixel whose alpha is below
    `options.threshold` (x 255) is transparent.

    A block's bytes come either from the opaque stages (no transparent
    pixel) or from the punchthrough stages alone (ETC.cpp:1866-1886), so
    the blocks are split by that test, as the JAX package's host dispatch
    splits them: blocks without a transparent pixel go through
    compress_etc2, the others through compress_etc2_punchthrough_only,
    each group in chunks, and the bytes are written back in input order.
    The split reads one [N] mask on the host."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    thr = etc.punchthrough_threshold(options.threshold)
    any_transparent = (blocks[:, :, 3].to(torch.int32) < thr).any(
        dim=1).cpu().numpy()
    out = torch.empty((blocks.shape[0], 8), dtype=torch.uint8, device=dev)
    for rows, encode in (
            (~any_transparent, lambda b: etc.compress_etc2(b, options, False)),
            (any_transparent,
             lambda b: etc.compress_etc2_punchthrough_only(b, options))):
        if rows.any():
            rows = torch.as_tensor(np.flatnonzero(rows), device=dev)
            out[rows] = _chunked(encode, blocks.index_select(0, rows),
                                 CHUNK_ETC2, 8)
    return out
