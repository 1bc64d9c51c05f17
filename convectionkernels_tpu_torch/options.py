"""Encoder options and flags.

Mirrors the reference's run-time configuration surface
(ConvectionKernels.h:33-103): a bitmask flag namespace and an Options
struct. Options is a frozen dataclass; its weights are float32-derived
exactly as the C++ float expressions compute them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class Flags:
    """Bitmask flags (ConvectionKernels.h:33-68)."""

    BC7_FAST_INDEXING = 0x008
    BC7_TRY_SINGLE_COLOR = 0x010
    BC7_RESPECT_PUNCH_THROUGH = 0x020
    BC6H_FAST_INDEXING = 0x040
    S3TC_EXHAUSTIVE = 0x080
    S3TC_PARANOID = 0x100
    UNIFORM = 0x200
    ETC_USE_FAKE_BT709 = 0x400
    ETC_FAKE_BT709_ACCURATE = 0x800

    FASTEST = BC6H_FAST_INDEXING | BC7_FAST_INDEXING | S3TC_PARANOID
    FASTER = FASTEST
    FAST = BC7_FAST_INDEXING | S3TC_PARANOID
    DEFAULT = BC7_FAST_INDEXING | S3TC_PARANOID
    BETTER = S3TC_PARANOID | S3TC_EXHAUSTIVE
    ULTRA = (BC7_TRY_SINGLE_COLOR | S3TC_PARANOID | S3TC_EXHAUSTIVE
             | ETC_FAKE_BT709_ACCURATE)


@dataclasses.dataclass(frozen=True)
class Options:
    """Mirror of cvtt::Options (ConvectionKernels.h:73-103).

    Weight defaults reproduce the reference's Rec.709-derived constants,
    computed in float32 exactly as the C++ float expressions do.
    """

    flags: int = Flags.DEFAULT
    threshold: float = 0.5
    red_weight: float = float(np.float32(0.2125) / np.float32(0.7154))
    green_weight: float = 1.0
    blue_weight: float = float(np.float32(0.0721) / np.float32(0.7154))
    alpha_weight: float = 1.0
    refine_rounds_bc7: int = 2
    refine_rounds_bc6h: int = 3
    refine_rounds_iic: int = 8
    refine_rounds_s3tc: int = 2
    seed_points: int = 4

    def channel_weights(self) -> tuple[float, float, float, float]:
        """Util::FillWeights (ConvectionKernels_Util.cpp:62-73)."""
        if self.flags & Flags.UNIFORM:
            return (1.0, 1.0, 1.0, 1.0)
        return (self.red_weight, self.green_weight, self.blue_weight,
                self.alpha_weight)
