"""The plain reference against bytes the JAX package produced.

portbench/reference/ is a frozen copy of the port's plain PyTorch path, so
its agreement with the code the port was checked against has to be shown
on its own: every stored JAX golden of BC7 (quality 50 with default
Options, the bc7_q50 configuration; quality 5 with light Options and the
flags of each case) and of BC6H (every case, the default-Options one being
the bc6hu configuration) is encoded by the reference and compared byte for
byte with the JAX package's op-by-op bytes. The goldens are data files of
convectionkernels_tpu_torch/testdata, written by the JAX package and read
here as plain NumPy arrays. On a card (`-m cuda`) the same comparisons
run with the reference on the card, as the output check runs it.
"""

import os

import numpy as np
import pytest
import torch

from harness import spec
from reference import encode_bc6hu, encode_bc7
from reference.bc7_plan import plan_from_quality
from reference.models import bc6h, bc7
from reference.options import Options

TESTDATA = os.path.join(spec.ROOT, "convectionkernels_tpu_torch", "testdata")

# the quality-5 golden's light Options (tests/test_torch_goldens.py LIGHT)
LIGHT = dict(seed_points=1, refine_rounds_bc7=1, refine_rounds_bc6h=1)
LIGHT_CASES = ("rgb", "alpha", "slow_indexing", "single_color",
               "punch_through")
BC6H_CASES = ("light", "rounds22", "signed_fast", "uniform",
              "edge_unsigned", "edge_signed", "default")


def _devices():
    cuda = [pytest.mark.cuda, pytest.mark.skipif(
        not torch.cuda.is_available(), reason="needs a CUDA card")]
    return ["cpu", pytest.param("cuda", marks=cuda)]


def _load(name):
    path = os.path.join(TESTDATA, name)
    if not os.path.exists(path):
        pytest.fail(f"the golden {path} is missing")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_bytes(got: torch.Tensor, want: np.ndarray):
    got = got.cpu().numpy()
    bad = np.flatnonzero((got != want).any(axis=1))
    assert got.shape == want.shape and bad.size == 0, (
        f"{bad.size} of {len(want)} blocks differ, first {bad[:5].tolist()}")


@pytest.mark.parametrize("device", _devices())
def test_bc7_q50_equals_the_jax_golden(device):
    """All 256 blocks of the q50 golden through the entry the check uses."""
    z = _load("bc7_q50_golden.npz")
    got = encode_bc7(torch.from_numpy(z["pixels"]).to(device), quality=50)
    _assert_bytes(got, z["blocks"])


@pytest.mark.parametrize("device", _devices())
@pytest.mark.parametrize("case", LIGHT_CASES)
def test_bc7_light_equals_the_jax_golden(case, device):
    z = _load("bc7_light_golden.npz")
    options = Options(flags=int(z[f"{case}_flags"]), **LIGHT)
    got = bc7.pack(torch.from_numpy(z[f"{case}_pixels"]).to(device),
                   options.flags, options.channel_weights(),
                   plan_from_quality(5), options.refine_rounds_bc7)
    _assert_bytes(got, z[f"{case}_blocks"])


@pytest.mark.parametrize("device", _devices())
@pytest.mark.parametrize("case", BC6H_CASES)
def test_bc6h_equals_the_jax_golden(case, device):
    """Each case under its own flags, seed points, rounds and signedness
    (`config`); `default` also through the entry the check uses."""
    z = _load("bc6h_golden.npz")
    flags, seed_points, rounds, signed = (int(v) for v in z[f"{case}_config"])
    px = torch.from_numpy(z[f"{case}_pixels"]).to(device)
    options = Options(flags=flags)
    got = bc6h.pack(px, flags, options.channel_weights(), bool(signed),
                    seed_points, rounds)
    _assert_bytes(got, z[f"{case}_blocks"])
    if case == "default":
        assert (flags, seed_points, rounds, signed) == (
            Options().flags, Options().seed_points,
            Options().refine_rounds_bc6h, 0)
        _assert_bytes(encode_bc6hu(px), z[f"{case}_blocks"])
