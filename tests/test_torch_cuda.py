"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel wrapper is held bit for bit against its plain PyTorch version
on the same card inputs, and encode_bc7 on the card against the stored
JAX bytes. This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import exact_probe
from convectionkernels_tpu_torch.models import bc7, bc7_kernel
from tests.test_torch_goldens import (LIGHT, LIGHT_CASES, load_light,
                                      load_q50)

pytestmark = pytest.mark.cuda

PLAIN = {"shape_pca": bc7_kernel.shape_pca_plain,
         "single_plane_mode_best": bc7_kernel.single_plane_mode_best_plain,
         "dual_plane_best": bc7_kernel.dual_plane_best_plain}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def test_exact_probe(card):
    assert not any(exact_probe.check(card).values())


def test_kernels_match_plain_versions(card, monkeypatch):
    """Every launch of a q50 encode, kernel against plain version."""
    seen = {name: 0 for name in PLAIN}
    for name, plain in PLAIN.items():
        kernel = getattr(bc7_kernel, name)

        def checked(*args, _kernel=kernel, _plain=plain, _name=name):
            got = _kernel(*args)
            want = _plain(*args)
            g, w = got, want
            if isinstance(got, dict):
                g, w = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
            pairs = [(a, b) for a, b in zip(g, w) if torch.is_tensor(a)]
            assert pairs and all(same_bits(a, b) for a, b in pairs), _name
            seen[_name] += 1
            return got

        monkeypatch.setattr(bc7_kernel, name, checked)
    px, blocks, _ = load_q50()
    pix = torch.as_tensor(px[:64], device=card)
    opts = ckt.Options()
    out = bc7.pack(pix, opts.flags, opts.channel_weights(),
                   ckt.plan_from_quality(50), opts.refine_rounds_bc7)
    assert seen == {"shape_pca": 2, "single_plane_mode_best": 6,
                    "dual_plane_best": 1}
    np.testing.assert_array_equal(out.cpu().numpy(), blocks[:64])


@pytest.mark.parametrize("case", LIGHT_CASES, ids=[c[0] for c in LIGHT_CASES])
def test_encode_light_on_card(card, case):
    px, blocks, flags = load_light(case[0])
    bc7_kernel.LAUNCHES.clear()
    got = ckt.encode_bc7(px, ckt.Options(flags=flags, **LIGHT), quality=5,
                         device=card)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)
    assert all(bc7_kernel.LAUNCHES[k] > 0 for k in PLAIN)


def test_encode_q50_on_card(card):
    px, blocks, _ = load_q50()
    got = ckt.encode_bc7(px, quality=50)          # device=None: the card
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)


def test_wrappers_check_their_inputs(card):
    pix = torch.zeros((4, 64), dtype=torch.int32, device=card)
    masks = torch.full((3,), 0xFFFF, dtype=torch.int32, device=card)
    cw = ckt.Options().channel_weights()
    with pytest.raises(TypeError):
        bc7_kernel.shape_pca(pix.float(), masks, 3, cw, False, True)
    with pytest.raises(ValueError):
        bc7_kernel.shape_pca(pix.t().contiguous().t(), masks, 3, cw, False,
                             True)
    with pytest.raises(ValueError):
        bc7_kernel.shape_pca(pix, masks.cpu(), 3, cw, False, True)
