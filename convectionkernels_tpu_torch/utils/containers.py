"""Compressed-texture container writers (KTX v1 and DDS).

The counterpart of the JAX package's utils/containers.py, which writes the
reference CLI's KTX output (etc2packer.cpp:115-200, ktxheader.h) and DDS
for the BC formats; the port writes the same bytes.
"""

from __future__ import annotations

import struct

import numpy as np

# GL internal format enums (KTX spec / GL registry constants)
GL_INTERNAL_FORMATS = {
    "etc1": 0x8D64,             # ETC1_RGB8_OES
    "etc2": 0x9274,             # COMPRESSED_RGB8_ETC2
    "etc2_rgba": 0x9278,        # COMPRESSED_RGBA8_ETC2_EAC
    "etc2_punchthrough": 0x9276,  # COMPRESSED_RGB8_PUNCHTHROUGH_ALPHA1
    "eac_r11": 0x9270,          # COMPRESSED_R11_EAC
    "eac_r11s": 0x9271,         # COMPRESSED_SIGNED_R11_EAC
    "eac_rg11s": 0x9273,        # COMPRESSED_SIGNED_RG11_EAC
    "eac_rg11": 0x9272,         # COMPRESSED_RG11_EAC
    "bc1": 0x83F1,              # COMPRESSED_RGBA_S3TC_DXT1
    "bc2": 0x83F2,
    "bc3": 0x83F3,
    "bc4u": 0x8DBB,
    "bc5u": 0x8DBD,
    "bc6h_uf": 0x8E8F,
    "bc6h_sf": 0x8E8E,
    "bc7": 0x8E8C,
}

GL_BASE_FORMATS = {
    "etc1": 0x1907, "etc2": 0x1907, "etc2_rgba": 0x1908,
    "etc2_punchthrough": 0x1908, "eac_r11": 0x1903, "eac_r11s": 0x1903,
    "eac_rg11": 0x8227, "eac_rg11s": 0x8227, "bc1": 0x1908, "bc2": 0x1908, "bc3": 0x1908,
    "bc4u": 0x1903, "bc5u": 0x8227, "bc6h_uf": 0x1907, "bc6h_sf": 0x1907,
    "bc7": 0x1908,
}

BLOCK_BYTES = {
    "etc1": 8, "etc2": 8, "etc2_rgba": 16, "etc2_punchthrough": 8,
    "eac_r11": 8, "eac_r11s": 8, "eac_rg11": 16, "eac_rg11s": 16, "bc1": 8, "bc2": 16,
    "bc3": 16, "bc4u": 8, "bc5u": 16, "bc6h_uf": 16, "bc6h_sf": 16,
    "bc7": 16,
}

# DXGI formats for DDS (DX10 header)
DXGI_FORMATS = {
    "bc1": 71, "bc2": 74, "bc3": 77, "bc4u": 80, "bc5u": 83,
    "bc6h_uf": 95, "bc6h_sf": 96, "bc7": 98,
}

_KTX_MAGIC = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB,
                    0x0D, 0x0A, 0x1A, 0x0A])


def _as_levels(blocks, width, height):
    """Normalize input to a list of (blocks, w, h) mip levels."""
    if isinstance(blocks, list):
        return blocks
    return [(blocks, width, height)]


def write_ktx(path: str, blocks, width: int = None, height: int = None,
              fmt: str = None) -> None:
    """Write encoded blocks as a KTX v1 file.

    `blocks` is either one [N, bytes] array (single level, with width/height)
    or a list of (blocks, w, h) tuples for a full mip chain."""
    levels = _as_levels(blocks, width, height)
    width, height = levels[0][1], levels[0][2]
    header = _KTX_MAGIC + struct.pack(
        "<13I",
        0x04030201,                       # endianness
        0,                                # glType (compressed)
        1,                                # glTypeSize
        0,                                # glFormat
        GL_INTERNAL_FORMATS[fmt],
        GL_BASE_FORMATS[fmt],
        width, height,
        0,                                # pixelDepth
        0,                                # numberOfArrayElements
        1,                                # numberOfFaces
        len(levels),                      # numberOfMipmapLevels
        0,                                # bytesOfKeyValueData
    )
    with open(path, "wb") as f:
        f.write(header)
        for lvl_blocks, _, _ in levels:
            data = np.ascontiguousarray(lvl_blocks, dtype=np.uint8).tobytes()
            f.write(struct.pack("<I", len(data)))
            f.write(data)
            if len(data) % 4:  # mipPadding to 4-byte alignment (KTX 1 spec)
                f.write(b"\0" * (4 - len(data) % 4))


def write_dds(path: str, blocks, width: int = None, height: int = None,
              fmt: str = None) -> None:
    """Write encoded BC blocks as a DDS (DX10 header) file.

    `blocks` is either one [N, bytes] array (single level) or a list of
    (blocks, w, h) tuples for a full mip chain."""
    if fmt not in DXGI_FORMATS:
        raise ValueError(f"no DXGI format for {fmt}")
    levels = _as_levels(blocks, width, height)
    width, height = levels[0][1], levels[0][2]
    pitch = max(1, (width + 3) // 4) * BLOCK_BYTES[fmt]
    mip_count = len(levels)

    DDSD_FLAGS = 0x1 | 0x2 | 0x4 | 0x1000 | 0x80000  # caps|h|w|pf|linearsize
    if mip_count > 1:
        DDSD_FLAGS |= 0x20000  # DDSD_MIPMAPCOUNT
    header = struct.pack("<4s", b"DDS ")
    header += struct.pack("<7I", 124, DDSD_FLAGS, height, width, pitch, 0,
                          mip_count)
    header += struct.pack("<11I", *([0] * 11))          # dwReserved1
    # DDS_PIXELFORMAT: size=32, DDPF_FOURCC, 'DX10'
    header += struct.pack("<2I4s5I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    caps1 = 0x1000 | (0x400008 if mip_count > 1 else 0)  # texture|mipmap
    header += struct.pack("<5I", caps1, 0, 0, 0, 0)     # caps..reserved2
    assert len(header) == 128
    dx10 = struct.pack("<5I", DXGI_FORMATS[fmt], 3, 0, 1, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(dx10)
        for lvl_blocks, _, _ in levels:
            f.write(np.ascontiguousarray(lvl_blocks,
                                         dtype=np.uint8).tobytes())
