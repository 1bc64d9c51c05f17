"""S3TC single-color tables (equivalent of ConvectionKernels_S3TC_SingleColor.h,
regenerated by the MakeTables reimplementation; see Program.cs:412-419 for
the emitted configurations)."""

from __future__ import annotations

import functools

import torch

from .make_tables import s3tc_single_color_table

# name: (endpoint bits, max index, paranoia) in Program.cs's emit order;
# "_p" tables serve the paranoid error, 3 / 2 the 4- and 3-color ranges
CONFIGS = {
    "5_3": (5, 3, 0.0),
    "6_3": (6, 3, 0.0),
    "5_2": (5, 2, 0.0),
    "6_2": (6, 2, 0.0),
    "5_3_p": (5, 3, 0.03),
    "6_3_p": (6, 3, 0.03),
    "5_2_p": (5, 2, 0.03),
    "6_2_p": (6, 2, 0.03),
}


@functools.lru_cache(maxsize=None)
def load_tables(device="cpu") -> dict:
    """Returns {name: int32 [256, 4] tensor on `device`} for all 8
    configurations: (min, max, actualColor, span) per target value."""
    return {
        name: torch.as_tensor(s3tc_single_color_table(*config),
                              device=torch.device(device))
        for name, config in CONFIGS.items()
    }
