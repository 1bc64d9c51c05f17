"""convectionkernels_tpu_torch — S3TC, BC7, BC6H, ETC1, ETC2 and EAC11 texture
block compression in PyTorch with hand-written CUDA kernels for NVIDIA
Hopper.

The PyTorch port of convectionkernels_tpu (which stays the reference): the
same bytes for the same blocks, Options and BC7 plan. It imports torch and
numpy only, never JAX or the reference package.
"""

from .api import (decode_bc6hs, decode_bc6hu, decode_bc7, encode_bc1,
                  encode_bc2, encode_bc3, encode_bc4s, encode_bc4u,
                  encode_bc5s, encode_bc5u, encode_bc6hs, encode_bc6hu,
                  encode_bc7, encode_eac11, encode_etc1, encode_etc2,
                  encode_etc2_alpha, encode_etc2_punchthrough,
                  encode_etc2_rgba)
from .bc7_plan import (BC7EncodingPlan, BC7FineTuningParams,
                       plan_from_fine_tuning_params, plan_from_quality)
from .options import Flags, Options

__all__ = [
    "BC7EncodingPlan",
    "BC7FineTuningParams",
    "Flags",
    "Options",
    "decode_bc6hs",
    "decode_bc6hu",
    "decode_bc7",
    "encode_bc1",
    "encode_bc2",
    "encode_bc3",
    "encode_bc4s",
    "encode_bc4u",
    "encode_bc5s",
    "encode_bc5u",
    "encode_bc6hs",
    "encode_bc6hu",
    "encode_bc7",
    "encode_eac11",
    "encode_etc1",
    "encode_etc2",
    "encode_etc2_alpha",
    "encode_etc2_punchthrough",
    "encode_etc2_rgba",
    "plan_from_fine_tuning_params",
    "plan_from_quality",
]
