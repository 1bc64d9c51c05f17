"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel wrapper is held bit for bit against its plain PyTorch version
on the same card inputs, and encode_bc7, encode_bc6hu and encode_bc6hs on
the card against the stored JAX bytes. This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import exact_probe
from convectionkernels_tpu_torch.models import (bc6h, bc6h_kernel, bc7,
                                                bc7_kernel)
from tests.test_torch_goldens import (BC6H_CASES, LIGHT, LIGHT_CASES,
                                      hdr_blocks, hdr_edge_blocks,
                                      load_bc6h, load_light, load_q50)

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


# --- BC6H ------------------------------------------------------------------------

BC6H_KERNEL_CASES = (
    # name, signed, fast indexing, uniform, aPrec, tweaks, refines
    ("unsigned_slow_aprec10", False, False, False, 10, 4, 3),
    ("signed_fast_aprec6", True, True, False, 6, 4, 3),
    ("signed_slow_uniform_aprec11", True, False, True, 11, 4, 3),
    ("unsigned_fast_aprec7_2x2", False, True, False, 7, 2, 2),
    ("unsigned_slow_aprec8_1x1", False, False, False, 8, 1, 1),
)


@pytest.mark.parametrize("case", BC6H_KERNEL_CASES,
                         ids=[c[0] for c in BC6H_KERNEL_CASES])
def test_bc6h_kernel_matches_plain_version(card, case):
    """All four outputs bit-equal, on ordinary and edge-value blocks, at a
    block count that is no multiple of anything."""
    _, is_signed, fast, uniform, aprec, tweaks, refines = case
    px = np.concatenate([hdr_blocks(600, seed=51),
                         hdr_edge_blocks(423, seed=53)])
    opts = ckt.Options(flags=ckt.Flags.UNIFORM if uniform else 0)
    cw = [float(np.float32(w)) for w in opts.channel_weights()[:3]]
    pix = bc6h.prepare_pixels(torch.as_tensor(px, device=card), is_signed)
    ufep_base, ufep_offset = bc6h.pca_lines(pix, cw)
    cols = [2 * p + s for s in range(2) for p in range(32)]
    base = torch.stack([b[:, cols] for b in ufep_base], dim=1).contiguous()
    offset = torch.stack([o[:, cols] for o in ufep_offset],
                         dim=1).contiguous()
    before = bc6h_kernel.LAUNCHES["partitioned_group_meta_rounds"]
    got = bc6h_kernel.partitioned_group_meta_rounds(
        pix, base, offset, aprec, is_signed, fast, uniform, cw, tweaks,
        refines)
    torch.cuda.synchronize()
    assert bc6h_kernel.LAUNCHES["partitioned_group_meta_rounds"] == before + 1
    want = bc6h_kernel.partitioned_group_meta_rounds_plain(
        pix, base, offset, aprec, is_signed, fast, uniform, cw, tweaks,
        refines)
    for name, a, b in zip(("err", "valid", "eps", "idx"), got, want):
        assert a.dtype == b.dtype and same_bits(a, b), name
    # the plain version on the card equals the plain version on the CPU
    cpu = bc6h_kernel.partitioned_group_meta_rounds(
        pix.cpu(), base.cpu(), offset.cpu(), aprec, is_signed, fast, uniform,
        cw, tweaks, refines)
    for name, a, b in zip(("err", "valid", "eps", "idx"), got, cpu):
        assert same_bits(a.cpu(), b), name


@pytest.mark.parametrize("case", BC6H_CASES, ids=[c[0] for c in BC6H_CASES])
def test_encode_bc6h_on_card(card, case):
    name, _, signed, flags, seed_points, refine_rounds = case
    px, blocks, _ = load_bc6h(name)
    encode = ckt.encode_bc6hs if signed else ckt.encode_bc6hu
    bc6h_kernel.LAUNCHES.clear()
    got = encode(px, ckt.Options(flags=flags, seed_points=seed_points,
                                 refine_rounds_bc6h=refine_rounds))
    assert got.device.type == "cuda"        # device=None: the card
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)
    assert bc6h_kernel.LAUNCHES["partitioned_group_meta_rounds"] == 6


def test_bc6h_wrapper_checks_its_inputs(card):
    pix = torch.zeros((4, 48), dtype=torch.int32, device=card)
    line = torch.zeros((4, 3, 64), dtype=torch.float32, device=card)
    cw = ckt.Options().channel_weights()
    run = bc6h_kernel.partitioned_group_meta_rounds
    with pytest.raises(TypeError):
        run(pix.float(), line, line, 10, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line[:, :, :32], line, 10, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line.cpu(), line, 10, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line, line, 10, False, False, False, cw, 5, 3)
    with pytest.raises(ValueError):
        run(pix, line, line, 16, False, False, False, cw, 4, 3)
