# The one function of convectionkernels_tpu_torch/programs.py (at commit
# 9895176) that the frozen encoders call, `constant` (programs.py:93-106),
# without the program layer around it.
"""Device constants for the frozen encoders."""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def constant(values, device, dtype=None) -> torch.Tensor:
    """np.asarray(values, dtype) as a tensor on `device`, made once per
    value and device and then shared: never write to it."""
    a = np.ascontiguousarray(np.asarray(values, dtype=dtype))
    device = torch.device(device)
    key = (a.dtype.str, a.shape, a.tobytes(), str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(a.copy()).to(device)
    return t
