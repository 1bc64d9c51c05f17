"""JAX-produced BC7 goldens for the torch port, and their re-derivation.

The JAX package encodes a BC7 configuration on a CPU in 25-110 s (trace
plus compile), so the default tier holds the port against bytes the JAX
package produced once, stored in convectionkernels_tpu_torch/testdata.
The slow tests below re-derive every stored golden from the JAX package
and assert that it is unchanged.

The q50 golden holds two sets of bytes for the same 256 blocks:
`api_blocks` from the JAX package's jitted `encode_bc7`, and `blocks`
from its `models.bc7.pack` run op by op (not jitted), where every float32
operation rounds on its own as in the scalar reference. They differ in one
block (62): XLA's compiled program lands one ulp under a 0.5 boundary in a
refine solve that the op-by-op run and a float32 scalar emulation
(tests/test_torch_bc7.py) put above it. The port is held to `blocks`.

Regenerate the files with:  python -m tests.test_torch_goldens
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests import blockgen

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "convectionkernels_tpu_torch", "testdata")
Q50_PATH = os.path.join(TESTDATA, "bc7_q50_golden.npz")
LIGHT_PATH = os.path.join(TESTDATA, "bc7_light_golden.npz")

LIGHT = dict(seed_points=1, refine_rounds_s3tc=1, refine_rounds_iic=1,
             refine_rounds_bc7=1, refine_rounds_bc6h=1)

FAST = 0x008          # Flags.BC7_FAST_INDEXING
SINGLE_COLOR = 0x010  # Flags.BC7_TRY_SINGLE_COLOR
PUNCH = 0x020         # Flags.BC7_RESPECT_PUNCH_THROUGH
DEFAULT = 0x108       # Flags.DEFAULT

# (name, corpus, flags) of the quality-5 LIGHT goldens
LIGHT_CASES = (
    ("rgb", "rgb", DEFAULT),
    ("alpha", "alpha", DEFAULT),
    ("slow_indexing", "alpha", DEFAULT & ~FAST),
    ("single_color", "rgb", DEFAULT | SINGLE_COLOR),
    ("punch_through", "punch", DEFAULT | PUNCH),
)


def punch_through_blocks(n, seed):
    """Alpha blocks whose alpha is only 0 or 255 (BC7 punch-through)."""
    px = blockgen.alpha_blocks(n, seed)
    px[..., 3] = np.where(px[..., 3] < 128, 0, 255).astype(np.uint8)
    return px


def q50_corpus():
    """256 blocks: mixed (random, gradient, flat, alpha), alpha and
    punch-through."""
    return np.concatenate([blockgen.mixed_blocks(128, seed=201),
                           blockgen.alpha_blocks(64, seed=203),
                           punch_through_blocks(64, seed=205)], axis=0)


def light_corpus(name):
    """The corpora of tests/test_light_options.py (24 blocks each)."""
    if name == "rgb":
        px = blockgen.gradient_blocks(24, seed=107)
        px[..., 3] = 255
        return px
    if name == "alpha":
        return blockgen.alpha_blocks(24, seed=109)
    return punch_through_blocks(24, seed=111)


def jax_q50_bytes(px):
    import convectionkernels_tpu as ck
    return np.asarray(ck.encode_bc7(px, quality=50))


def jax_q50_op_by_op(px):
    from convectionkernels_tpu.bc7_plan import plan_from_quality
    from convectionkernels_tpu.models import bc7
    from convectionkernels_tpu.options import Options
    o = Options()
    return np.asarray(bc7.pack(px, o.flags, o.channel_weights(),
                               plan_from_quality(50), o.refine_rounds_bc7))


def jax_light_bytes(px, flags):
    import convectionkernels_tpu as ck
    return np.asarray(ck.encode_bc7(px, ck.Options(flags=flags, **LIGHT),
                                    quality=5))


def load_q50():
    """(pixels, bytes the port must give, bytes of the jitted JAX API)."""
    with np.load(Q50_PATH) as z:
        return z["pixels"], z["blocks"], z["api_blocks"]


def load_light(name):
    with np.load(LIGHT_PATH) as z:
        return z[f"{name}_pixels"], z[f"{name}_blocks"], int(z[f"{name}_flags"])


@pytest.mark.slow
def test_q50_golden_matches_jax():
    px, blocks, api_blocks = load_q50()
    np.testing.assert_array_equal(px, q50_corpus())
    np.testing.assert_array_equal(jax_q50_bytes(px), api_blocks)
    np.testing.assert_array_equal(jax_q50_op_by_op(px), blocks)


@pytest.mark.slow
@pytest.mark.parametrize("case", LIGHT_CASES, ids=[c[0] for c in LIGHT_CASES])
def test_light_golden_matches_jax(case):
    name, corpus, flags = case
    px, blocks, stored_flags = load_light(name)
    assert stored_flags == flags
    np.testing.assert_array_equal(px, light_corpus(corpus))
    np.testing.assert_array_equal(jax_light_bytes(px, flags), blocks)


def _write():
    import tests.conftest  # noqa: F401  (exactness XLA flags, CPU platform)

    os.makedirs(TESTDATA, exist_ok=True)
    light = {}
    for name, corpus, flags in LIGHT_CASES:
        px = light_corpus(corpus)
        light[f"{name}_pixels"] = px
        light[f"{name}_blocks"] = jax_light_bytes(px, flags)
        light[f"{name}_flags"] = np.int32(flags)
        print("light", name, flush=True)
    np.savez_compressed(LIGHT_PATH, **light)
    px = q50_corpus()
    np.savez_compressed(Q50_PATH, pixels=px, blocks=jax_q50_op_by_op(px),
                        api_blocks=jax_q50_bytes(px))
    print("q50", flush=True)


if __name__ == "__main__":
    _write()
