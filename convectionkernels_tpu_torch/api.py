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
per-candidate tensors. Each encode goes through a cached program of its
configuration (programs.py, as the JAX package's `_*_fn` programs): the
blocks padded to a bucket, one program a chunk, on the card a CUDA graph
replayed from the third call of a (configuration, bucket) on.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bc7_plan, programs, tracing
from .models import bc6h, bc7, decode, etc, s3tc
from .options import Flags, Options
from .programs import release_programs  # noqa: F401 (the JAX api's name)

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
    return _bc7_program(options, plan, blocks.device)(blocks, CHUNK_BC7)


@programs.program_cache
def _bc7_program(options: Options, plan, device) -> programs.Program:
    cw = options.channel_weights()
    return programs.Program(lambda b: bc7.pack(
        b, options.flags, cw, plan, options.refine_rounds_bc7), 16)


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
    return _bc6h_program(options, signed, blocks.device)(blocks, CHUNK_BC6H)


@programs.program_cache
def _bc6h_program(options: Options, signed: bool, device) -> programs.Program:
    cw = options.channel_weights()
    return programs.Program(lambda b: bc6h.pack(
        b, options.flags, cw, signed, options.seed_points,
        options.refine_rounds_bc6h), 16)


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


# the S3TC entry points: bytes a block, signed input, and whether the
# block has a BC1 color half (which the exhaustive search makes heavy)
_S3TC = {"bc1": (8, False, True), "bc2": (16, False, True),
         "bc3": (16, False, True), "bc4u": (8, False, False),
         "bc4s": (8, True, False), "bc5u": (16, False, False),
         "bc5s": (16, True, False)}


def _encode_s3tc(kind: str, pixels, options: Options, device) -> torch.Tensor:
    """The S3TC program `kind` over the blocks: CHUNK_S3TC_EXHAUSTIVE
    blocks a chunk where a BC1 color half runs the exhaustive search."""
    _, signed, color = _S3TC[kind]
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev, torch.int8 if signed else torch.uint8)
    exhaustive = color and bool(options.flags & Flags.S3TC_EXHAUSTIVE)
    return _s3tc_program(kind, options, blocks.device)(
        blocks, CHUNK_S3TC_EXHAUSTIVE if exhaustive else CHUNK_S3TC)


@programs.program_cache
def _s3tc_program(kind: str, options: Options, device) -> programs.Program:
    width, signed, _ = _S3TC[kind]

    def rgb(b, alpha_test):
        """PackRGB with the options' settings: BC1 (with the alpha test)
        or the color half of BC2 / BC3 (API.cpp:86-131)."""
        return s3tc.pack_rgb(
            b, options.flags, options.channel_weights(), alpha_test,
            options.threshold if alpha_test else 1.0,
            bool(options.flags & Flags.S3TC_EXHAUSTIVE), options.seed_points,
            options.refine_rounds_s3tc)

    def interpolated(b, channel):
        return s3tc.pack_interpolated_alpha(b, channel, signed,
                                            options.seed_points,
                                            options.refine_rounds_iic)

    def body(b):
        if signed:
            b = s3tc.bias_signed_input(b)
        if kind == "bc1":
            return rgb(b, True)
        if kind == "bc2":
            return torch.cat([s3tc.pack_explicit_alpha(b, 3), rgb(b, False)],
                             dim=-1)
        if kind == "bc3":
            # the stages a bucket's first call times (tracing.stage): the
            # alpha half, then the color half, which holds the exhaustive
            # search's own stage (models/s3tc.py pack_rgb)
            with tracing.stage("s3tc.alpha"):
                alpha = interpolated(b, 3)
            with tracing.stage("s3tc.color"):
                color = rgb(b, False)
            return torch.cat([alpha, color], dim=-1)
        if kind in ("bc4u", "bc4s"):
            return interpolated(b, 0)
        return torch.cat([interpolated(b, 0), interpolated(b, 1)], dim=-1)

    return programs.Program(body, width)


def encode_bc1(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC1 (API.cpp:86-99): BC1 with the alpha test, uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc("bc1", pixels, options, device)


def encode_bc2(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC2 (API.cpp:101-115): 4-bit alpha then BC1 color,
    uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc("bc2", pixels, options, device)


def encode_bc3(pixels, options: Options = Options(),
               device=None) -> torch.Tensor:
    """Kernels::EncodeBC3 (API.cpp:117-131): interpolated alpha then BC1
    color, uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc("bc3", pixels, options, device)


def encode_bc4u(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC4U (API.cpp:133-146): the red channel, uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc("bc4u", pixels, options, device)


def encode_bc4s(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC4S (API.cpp:148-164): the red channel of signed
    input, int8 [N, 16, 4] -> uint8 [N, 8] on `device`."""
    return _encode_s3tc("bc4s", pixels, options, device)


def encode_bc5u(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC5U (API.cpp:166-180): red then green, uint8
    [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc("bc5u", pixels, options, device)


def encode_bc5s(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeBC5S (API.cpp:182-199): red then green of signed
    input, int8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    return _encode_s3tc("bc5s", pixels, options, device)


@programs.program_cache
def _etc_program(kind: str, options, device) -> programs.Program:
    """The ETC program `kind`: etc1, etc2, etc2_rgba, etc2_punchthrough
    (the punchthrough stages alone, for blocks with a transparent pixel),
    etc2_alpha, eac11 or eac11s (these three take no option: None)."""
    if kind == "etc1":
        return programs.Program(lambda b: etc.compress_etc1(b, options), 8)
    if kind == "etc2":
        return programs.Program(
            lambda b: etc.compress_etc2(b, options, False), 8)
    if kind == "etc2_rgba":
        return programs.Program(lambda b: torch.cat([
            etc.compress_etc2_alpha(b), etc.compress_etc2(b, options, False)],
            dim=-1), 16)
    if kind == "etc2_punchthrough":
        return programs.Program(
            lambda b: etc.compress_etc2_punchthrough_only(b, options), 8)
    if kind == "etc2_alpha":
        return programs.Program(etc.compress_etc2_alpha, 8)
    return programs.Program(
        lambda b: etc.compress_eac11(b, kind == "eac11s"), 8)


def encode_etc1(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeETC1 (API.cpp:201-214): uint8 [N, 16, 4] -> uint8
    [N, 8] on `device`."""
    blocks = _as_blocks(pixels, resolve_device(device))
    return _etc_program("etc1", options, blocks.device)(blocks, CHUNK_ETC)


def encode_etc2_alpha(pixels, options: Options = Options(),
                      device=None) -> torch.Tensor:
    """Kernels::EncodeETC2Alpha (API.cpp:246-257): the alpha channel of
    uint8 [N, 16, 4] -> uint8 [N, 8] on `device`."""
    del options  # the alpha search has no option
    blocks = _as_blocks(pixels, resolve_device(device))
    return _etc_program("etc2_alpha", None, blocks.device)(blocks, CHUNK_EAC)


def encode_eac11(pixels, signed: bool = False, options: Options = Options(),
                 device=None) -> torch.Tensor:
    """Kernels::EncodeETC2Alpha11 (API.cpp:259-268): one 11-bit channel,
    int16 [N, 16] (clamped to [0, 2047], or [-1023, 1023] when `signed`)
    -> uint8 [N, 8] on `device`. As in the JAX package, [N, P] with P other
    than 16 is read with clamped pixel indices; a rank other than 2 or a
    second axis of 0 raises ValueError (the JAX entry point raises too)."""
    del options  # the alpha search has no option
    dev = resolve_device(device)
    values = _cast(pixels, torch.int16)
    if values.dim() != 2 or values.shape[1] < 1:
        raise ValueError(f"expected [N, 16] values, got "
                         f"{tuple(values.shape)}")
    values = _static_index(values, 1, 16).to(dev)
    return _etc_program("eac11s" if signed else "eac11", None,
                        values.device)(values, CHUNK_EAC)


def encode_etc2(pixels, options: Options = Options(),
                device=None) -> torch.Tensor:
    """Kernels::EncodeETC2 (API.cpp:216-229): uint8 [N, 16, 4] -> uint8
    [N, 8] on `device`."""
    blocks = _as_blocks(pixels, resolve_device(device))
    return _etc_program("etc2", options, blocks.device)(blocks, CHUNK_ETC2)


def encode_etc2_rgba(pixels, options: Options = Options(),
                     device=None) -> torch.Tensor:
    """Kernels::EncodeETC2RGBA (API.cpp:270-286): the ETC2 alpha block then
    the ETC2 color block, uint8 [N, 16, 4] -> uint8 [N, 16] on `device`."""
    blocks = _as_blocks(pixels, resolve_device(device))
    return _etc_program("etc2_rgba", options, blocks.device)(blocks,
                                                             CHUNK_ETC2)


def encode_etc2_punchthrough(pixels, options: Options = Options(),
                             device=None) -> torch.Tensor:
    """Kernels::EncodeETC2PunchthroughAlpha (API.cpp:231-244): uint8
    [N, 16, 4] -> uint8 [N, 8] on `device`; a pixel whose alpha is below
    `options.threshold` (x 255) is transparent.

    A block's bytes come either from the opaque stages (no transparent
    pixel) or from the punchthrough stages alone (ETC.cpp:1866-1886), so
    the blocks are split by that test, as the JAX package's host dispatch
    splits them (api.py:381-392 there): blocks without a transparent pixel
    go through the etc2 program (compress_etc2), the others through the
    punchthrough-only program (compress_etc2_punchthrough_only), each side
    at its own bucket, and the bytes are written back in input order. The
    split reads one [N] mask on the host."""
    dev = resolve_device(device)
    blocks = _as_blocks(pixels, dev)
    thr = etc.punchthrough_threshold(options.threshold)
    any_transparent = (blocks[:, :, 3].to(torch.int32) < thr).any(
        dim=1).cpu().numpy()
    sides = [(kind, rows) for kind, rows in (
        ("etc2", ~any_transparent), ("etc2_punchthrough", any_transparent))
        if rows.any()]
    if len(sides) == 1:
        return _etc_program(sides[0][0], options, blocks.device)(blocks,
                                                                 CHUNK_ETC2)
    out = torch.empty((blocks.shape[0], 8), dtype=torch.uint8, device=dev)
    for kind, rows in sides:
        rows = torch.as_tensor(np.flatnonzero(rows), device=dev)
        out[rows] = _etc_program(kind, options, blocks.device)(
            blocks.index_select(0, rows), CHUNK_ETC2)
    return out
