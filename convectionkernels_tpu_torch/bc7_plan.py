"""BC7 encoding plan: quality/fine-tuning configuration.

Mirror of cvtt::BC7EncodingPlan / BC7FineTuningParams and their configurators
(ConvectionKernels.h:105-199, ConvectionKernels_BC67.cpp:3291-3483).
The plan is a frozen (hashable) dataclass. The encoder reads it on the host
to build exactly the enabled shape / partition candidate lanes, which is the
batched form of the reference's runtime seed-count pruning.
"""

from __future__ import annotations

import dataclasses

from .tables import bc7_geometry as geom
from .tables.bc7_prio_data import PRIO_RGB, PRIO_RGBA

_NUM_RGB_SHAPES = 243
_NUM_RGBA_SHAPES = 129


@dataclasses.dataclass(frozen=True)
class BC7FineTuningParams:
    """Mirror of cvtt::BC7FineTuningParams (ConvectionKernels.h:105-140)."""

    mode0_sp: tuple = (4,) * 16
    mode1_sp: tuple = (4,) * 64
    mode2_sp: tuple = (4,) * 64
    mode3_sp: tuple = (4,) * 64
    mode4_sp: tuple = ((4, 4),) * 4  # [rotation][indexSelector]
    mode5_sp: tuple = (4,) * 4       # [rotation]
    mode6_sp: int = 4
    mode7_sp: tuple = (4,) * 64


@dataclasses.dataclass(frozen=True)
class BC7EncodingPlan:
    """Mirror of cvtt::BC7EncodingPlan (ConvectionKernels.h:142-199).

    The default constructor is the max-quality plan (all shapes, 4 seeds).
    """

    mode0_partition_enabled: int = 0xFFFF
    mode1_partition_enabled: int = 0xFFFFFFFFFFFFFFFF
    mode2_partition_enabled: int = 0xFFFFFFFFFFFFFFFF
    mode3_partition_enabled: int = 0xFFFFFFFFFFFFFFFF
    mode7_rgba_partition_enabled: int = 0xFFFFFFFFFFFFFFFF
    mode7_rgb_partition_enabled: int = 0xFFFFFFFFFFFFFFFF
    mode4_sp: tuple = ((4, 4),) * 4
    mode5_sp: tuple = (4,) * 4
    mode6_enabled: bool = True
    seed_points_for_shape_rgb: tuple = (4,) * _NUM_RGB_SHAPES
    seed_points_for_shape_rgba: tuple = (4,) * _NUM_RGBA_SHAPES
    rgb_shape_list: tuple = tuple(range(_NUM_RGB_SHAPES))
    rgba_shape_list: tuple = tuple(range(_NUM_RGBA_SHAPES))


def plan_from_fine_tuning_params(params: BC7FineTuningParams) -> BC7EncodingPlan:
    """ConfigureBC7EncodingPlanFromFineTuningParams (BC67.cpp:3355-3483)."""
    sp_rgb = [0] * _NUM_RGB_SHAPES
    sp_rgba = [0] * _NUM_RGBA_SHAPES

    mode0_bits = 0
    for partition in range(16):
        sp = params.mode0_sp[partition]
        if sp == 0:
            continue
        mode0_bits |= 1 << partition
        for subset in range(3):
            shape = int(geom.SHAPES_3[partition][subset])
            sp_rgb[shape] = max(sp_rgb[shape], sp)

    def two_subset_mode(sp_list, target):
        bits = 0
        for partition in range(64):
            sp = sp_list[partition]
            if sp == 0:
                continue
            bits |= 1 << partition
            for subset in range(2):
                shape = int(geom.SHAPES_2[partition][subset])
                target[shape] = max(target[shape], sp)
        return bits

    mode1_bits = two_subset_mode(params.mode1_sp, sp_rgb)

    mode2_bits = 0
    for partition in range(64):
        sp = params.mode2_sp[partition]
        if sp == 0:
            continue
        mode2_bits |= 1 << partition
        for subset in range(3):
            shape = int(geom.SHAPES_3[partition][subset])
            sp_rgb[shape] = max(sp_rgb[shape], sp)

    mode3_bits = two_subset_mode(params.mode3_sp, sp_rgb)

    mode6_enabled = params.mode6_sp != 0
    if mode6_enabled:
        sp_rgba[0] = max(sp_rgba[0], params.mode6_sp)

    mode7_rgba_bits = two_subset_mode(params.mode7_sp, sp_rgba)

    rgb_shape_list = tuple(i for i in range(_NUM_RGB_SHAPES) if sp_rgb[i] > 0)
    rgba_shape_list = tuple(i for i in range(_NUM_RGBA_SHAPES) if sp_rgba[i] > 0)

    mode7_rgb_bits = mode7_rgba_bits & ~mode3_bits & 0xFFFFFFFFFFFFFFFF

    return BC7EncodingPlan(
        mode0_partition_enabled=mode0_bits,
        mode1_partition_enabled=mode1_bits,
        mode2_partition_enabled=mode2_bits,
        mode3_partition_enabled=mode3_bits,
        mode7_rgba_partition_enabled=mode7_rgba_bits,
        mode7_rgb_partition_enabled=mode7_rgb_bits,
        mode4_sp=tuple(tuple(x) for x in params.mode4_sp),
        mode5_sp=tuple(params.mode5_sp),
        mode6_enabled=mode6_enabled,
        seed_points_for_shape_rgb=tuple(sp_rgb),
        seed_points_for_shape_rgba=tuple(sp_rgba),
        rgb_shape_list=rgb_shape_list,
        rgba_shape_list=rgba_shape_list,
    )


def plan_from_quality(quality: int) -> BC7EncodingPlan:
    """ConfigureBC7EncodingPlanFromQuality (BC67.cpp:3291-3352)."""
    quality = min(max(quality, 1), 100)

    num_rgb = len(PRIO_RGB) * quality // 100
    num_rgba = len(PRIO_RGBA) * quality // 100

    mode0 = [0] * 16
    mode1 = [0] * 64
    mode2 = [0] * 64
    mode3 = [0] * 64
    mode4 = [[0, 0] for _ in range(4)]
    mode5 = [0] * 4
    mode6 = 0
    mode7 = [0] * 64

    for prio_list, count in ((PRIO_RGB, num_rgb), (PRIO_RGBA, num_rgba)):
        for sp, mode, sub in prio_list[:count]:
            if mode == 0:
                mode0[sub] = sp
            elif mode == 1:
                mode1[sub] = sp
            elif mode == 2:
                mode2[sub] = sp
            elif mode == 3:
                mode3[sub] = sp
            elif mode == 4:
                mode4[sub // 10][sub % 10] = sp
            elif mode == 5:
                # mode 5 codes are also rotation*10+indexMode encoded; the
                # reference unpacks only the rotation bits (BC67.cpp:3340)
                mode5[sub // 10] = sp
            elif mode == 6:
                mode6 = sp
            elif mode == 7:
                mode7[sub] = sp

    params = BC7FineTuningParams(
        mode0_sp=tuple(mode0), mode1_sp=tuple(mode1), mode2_sp=tuple(mode2),
        mode3_sp=tuple(mode3), mode4_sp=tuple(tuple(x) for x in mode4),
        mode5_sp=tuple(mode5), mode6_sp=mode6, mode7_sp=tuple(mode7))
    return plan_from_fine_tuning_params(params)
