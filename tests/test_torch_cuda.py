"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel wrapper is held bit for bit against its plain PyTorch version
on the same card inputs, encode_bc7, encode_bc6hu and encode_bc6hs on the
card against the stored JAX bytes, and the S3TC and ETC entry points
(eager tensor code, no kernel of their own) on the card against the stored
JAX bytes and against the port on the CPU. This file imports nothing of JAX, so it runs on a machine
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
from tests import blockgen
from tests.test_torch_goldens import (BC6H_CASES, DEFAULT, ETC_CASES, FAST,
                                      LIGHT, LIGHT_CASES, PUNCH, S3TC_CASES,
                                      UNIFORM, hdr_blocks, hdr_edge_blocks,
                                      load_bc6h, load_etc, load_light,
                                      load_q50, load_s3tc,
                                      punch_through_blocks, signed_blocks)

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


# --- shape_pca's layout: 32 blocks a CUDA block, a warp a shape -------------------

def pca_corpus(n, seed):
    """n blocks cycling through mixed, flat and 0/255 blocks."""
    m = max(32, -(-n // 8) * 8)     # mixed_blocks takes multiples of 8
    rng = np.random.default_rng(seed)
    extremes = (rng.integers(0, 2, size=(m, 16, 4)) * 255).astype(np.uint8)
    parts = [blockgen.mixed_blocks(m, seed), blockgen.flat_blocks(m, seed + 1),
             extremes]
    return np.stack(parts, axis=1).reshape(-1, 16, 4)[:n].copy()


def pca_mask_lists():
    """Shape lists of 1, 81 (q50 RGBA), 215 (q50 RGB) and 243 shapes, the
    16 one-member shapes, and masks with bits above 15 set (which both
    versions ignore: one has no pixel left), as membership bits."""
    from convectionkernels_tpu_torch.tables import bc7_geometry
    bits = bc7_kernel.shape_mask_bits(bc7_geometry.shape_masks())
    plan = ckt.plan_from_quality(50)
    return {"1": bits[[5]], "81": bits[list(plan.rgba_shape_list)],
            "215": bits[list(plan.rgb_shape_list)], "243": bits,
            "one_member": (1 << np.arange(16)).astype(np.int32),
            "high_bits": np.concatenate([
                bits[:8] | (1 << 20), bits[8:16] | np.int32(-(1 << 16)),
                np.array([1 << 16], dtype=np.int32)]).astype(np.int32)}


@pytest.mark.parametrize("shapes", ("1", "81", "215", "243", "one_member",
                                    "high_bits"))
@pytest.mark.parametrize("n", (1, 31, 32, 33, 1000))
def test_shape_pca_matches_plain_version(card, n, shapes):
    """Every output bit-equal, for 3 and 4 channels, with and without the
    alpha error, uniform and weighted, at block counts around the 32-block
    group and shape counts around the 4-shape chunk."""
    masks = torch.as_tensor(pca_mask_lists()[shapes], device=card)
    pix = torch.as_tensor(pca_corpus(n, seed=400 + n).reshape(n, 64),
                          dtype=torch.int32, device=card)
    for nch in (3, 4):
        for with_alpha in (True, False):
            for uniform in (False, True):
                cw = (1.0,) * 4 if uniform else ckt.Options().channel_weights()
                call = (pix, masks, nch, cw, uniform, with_alpha)
                before = bc7_kernel.LAUNCHES["shape_pca"]
                got = bc7_kernel.shape_pca(*call)
                torch.cuda.synchronize()
                assert bc7_kernel.LAUNCHES["shape_pca"] == before + 1
                want = bc7_kernel.shape_pca_plain(*call)
                what = (nch, with_alpha, uniform)
                assert (got[2] is None) == (want[2] is None) == (not with_alpha)
                assert same_outputs([t for t in got if t is not None],
                                    [t for t in want if t is not None]), what


@pytest.mark.parametrize("shapes", ("81", "215"))
def test_shape_pca_every_chunk_matches_plain_version(card, shapes):
    """Each chunk the C entry point takes (1, 2 or 4 shapes a warp takes at
    once) gives the plain version's bits; the wrapper passes 4 with the
    alpha error and 2 without. Chunks of 0 and 3 are refused."""
    from convectionkernels_tpu_torch import cuda_lib
    masks = torch.as_tensor(pca_mask_lists()[shapes], device=card)
    n, s_count = 33, masks.shape[0]
    pix = torch.as_tensor(pca_corpus(n, seed=450).reshape(n, 64),
                          dtype=torch.int32, device=card)
    cw = ckt.Options().channel_weights()
    fn = cuda_lib.function("shape_pca")
    for nch, with_alpha in ((3, True), (4, False)):
        want = bc7_kernel.shape_pca_plain(pix, masks, nch, cw, False,
                                          with_alpha)
        for chunk in (1, 2, 4, 0, 3):
            base = torch.zeros((n, s_count, 4), dtype=torch.float32,
                               device=card)
            offset = torch.zeros_like(base)
            alpha = torch.zeros((n, s_count), dtype=torch.float32,
                                device=card)
            err = fn(pix.data_ptr(), masks.data_ptr(), n, s_count, nch,
                     bc7_kernel._cw_array(cw), 0, int(with_alpha), chunk,
                     base.data_ptr(), offset.data_ptr(),
                     alpha.data_ptr() if with_alpha else None,
                     bc7_kernel._stream())
            torch.cuda.synchronize()
            if chunk in (0, 3):
                assert err != 0
                continue
            assert err == 0
            got = [base, offset] + ([alpha] if with_alpha else [])
            assert same_outputs(got, [t for t in want if t is not None]), \
                (nch, chunk)


# --- the search kernels' thread layouts ----------------------------------------

# (name, flags, quality, Options fields) of the encodes whose search-kernel
# launches are held against the plain versions: fast and slow indexing,
# uniform weights, punch-through parities, one seed a shape (quality 5 with
# the LIGHT options) and one-lane segments (quality 1, mode 2)
SEARCH_CASES = (
    ("q50_fast", DEFAULT, 50, {}),
    ("q50_slow", DEFAULT & ~FAST, 50, {}),
    ("q50_uniform", DEFAULT | UNIFORM, 50, {}),
    ("q50_punch_through", DEFAULT | PUNCH, 50, {}),
    ("q5_light_slow", DEFAULT & ~FAST, 5, LIGHT),
    ("q1", DEFAULT, 1, {}),
)


def search_corpus(n, seed):
    """n blocks cycling through mixed, punch-through and alpha blocks."""
    m = max(32, -(-n // 8) * 8)     # mixed_blocks takes multiples of 8
    parts = [blockgen.mixed_blocks(m, seed), punch_through_blocks(m, seed + 1),
             blockgen.alpha_blocks(m, seed + 2)]
    return np.stack(parts, axis=1).reshape(-1, 16, 4)[:n].copy()


def same_outputs(got, want):
    if isinstance(got, dict):
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
    return all(same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", (1, 3, 33, 1000))
@pytest.mark.parametrize("case", SEARCH_CASES, ids=[c[0] for c in SEARCH_CASES])
def test_search_kernels_match_plain_versions(card, monkeypatch, case, n):
    """single_plane_mode_best and dual_plane_best against their plain
    versions on every launch of an encode, at block counts that are no
    multiple of any tile; single_plane_mode_best also with every parity of
    every other block punch-through invalid, where every error is +inf and
    the rank decides."""
    _, flags, quality, extra = case
    launches = {"single_plane_mode_best": [], "dual_plane_best": []}
    for name in launches:
        def keep(*args, _kernel=getattr(bc7_kernel, name), _name=name):
            launches[_name].append(args)
            return _kernel(*args)

        monkeypatch.setattr(bc7_kernel, name, keep)
    opts = ckt.Options(flags=flags, **extra)
    pix = torch.as_tensor(search_corpus(n, seed=300 + n), device=card)
    bc7.pack(pix, opts.flags, opts.channel_weights(),
             ckt.plan_from_quality(quality), opts.refine_rounds_bc7)
    monkeypatch.undo()
    modes = [args[0] for args in launches["single_plane_mode_best"]]
    assert {0, 1, 2, 3, 6} <= set(modes)
    assert len(launches["dual_plane_best"]) == 1
    for args in launches["single_plane_mode_best"]:
        pti = args[5].clone()
        pti[::2] = 1
        for call in (args, args[:5] + (pti,) + args[6:]):
            got = bc7_kernel.single_plane_mode_best(*call)
            want = bc7_kernel.single_plane_mode_best_plain(*call)
            assert same_outputs(got, want), f"mode {call[0]}"
    for args in launches["dual_plane_best"]:
        got = bc7_kernel.dual_plane_best(*args)
        assert same_outputs(got, bc7_kernel.dual_plane_best_plain(*args))


DUAL_ORDER_CASES = (
    # name, (mode, rotation, index selector, live tweaks) per combo
    ("one_live_lane", ((4, 1, 0, 1),)),
    ("every_lane_dead", ((4, 0, 0, 0), (5, 2, 0, 0))),
    ("dead_rotation_between", ((4, 0, 1, 3), (4, 1, 0, 0), (5, 3, 0, 2),
                               (4, 0, 0, 4))),
)


@pytest.mark.parametrize("fast", (True, False), ids=("fast", "slow"))
@pytest.mark.parametrize("case", DUAL_ORDER_CASES,
                         ids=[c[0] for c in DUAL_ORDER_CASES])
def test_dual_plane_work_orders(card, case, fast):
    """dual_plane_best against its plain version for lane tables whose
    work order (bc7_kernel.dual_plane_order) has a single live lane, none,
    or a rotation whose every lane is dead, with channel weights that tell
    rotations apart."""
    combos = [dict(mode=m, rot=r, isel=i, num_tweak=t, seq=q)
              for q, (m, r, i, t) in enumerate(case[1])]
    ci, cf = bc7_kernel.dual_plane_consts(combos, [1.0, 0.75, 0.5, 0.25])
    pix = torch.as_tensor(search_corpus(77, seed=17), device=card)
    pix = pix.to(torch.int32).reshape(-1, 64).contiguous()
    args = (pix, torch.as_tensor(ci, device=card),
            torch.as_tensor(cf, device=card), 2, False, fast)
    got = bc7_kernel.dual_plane_best(*args)
    assert same_outputs(got, bc7_kernel.dual_plane_best_plain(*args))


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


# --- S3TC: the card against the stored JAX bytes and the port on the CPU -----------

S3TC_ENTRIES = (
    ("bc1", {}), ("bc2", {}), ("bc3", {}), ("bc4u", {}), ("bc4s", {}),
    ("bc5u", {}), ("bc5s", {}), ("bc1_exhaustive", dict(flags=0x188)))


def s3tc_encode(entry, fields, px, device):
    fmt = entry.split("_")[0]
    return getattr(ckt, f"encode_{fmt}")(px, ckt.Options(**fields),
                                         device=device)


@pytest.mark.parametrize("case", S3TC_CASES, ids=[c[0] for c in S3TC_CASES])
def test_encode_s3tc_golden_on_card(card, case):
    name, fmt, _, fields = case
    px, blocks, _ = load_s3tc(name)
    got = s3tc_encode(fmt, fields, px, None)     # device=None: the card
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)
    np.testing.assert_array_equal(
        got.cpu().numpy(), s3tc_encode(fmt, fields, px, "cpu").numpy())


@pytest.mark.parametrize("n", (1, 31, 1000))
@pytest.mark.parametrize("entry", S3TC_ENTRIES, ids=[e[0] for e in S3TC_ENTRIES])
def test_encode_s3tc_card_equals_cpu(card, entry, n):
    name, fields = entry
    px = blockgen.mixed_blocks(max(32, n), seed=500 + n)[:n]
    if name in ("bc4s", "bc5s"):
        px = signed_blocks(max(32, n), seed=600 + n)[:n]
    got = s3tc_encode(name, fields, px, card)
    want = s3tc_encode(name, fields, px, "cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("entry", S3TC_ENTRIES, ids=[e[0] for e in S3TC_ENTRIES])
def test_encode_s3tc_above_the_chunk(card, entry, monkeypatch):
    """More blocks than a chunk: chunks of 32 give the CPU's bytes."""
    from convectionkernels_tpu_torch import api
    monkeypatch.setattr(api, "CHUNK_S3TC", 32)
    monkeypatch.setattr(api, "CHUNK_S3TC_EXHAUSTIVE", 32)
    name, fields = entry
    px = blockgen.mixed_blocks(104, seed=701)
    if name in ("bc4s", "bc5s"):
        px = signed_blocks(104, seed=703)
    got = s3tc_encode(name, fields, px, card)
    want = s3tc_encode(name, fields, px, "cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def etc_encode(entry, flags, px, device, threshold=0.5):
    if entry.startswith("eac11"):
        return ckt.encode_eac11(px, signed=entry == "eac11s", device=device)
    return getattr(ckt, f"encode_{entry}")(
        px, ckt.Options(flags=flags, threshold=threshold), device=device)


@pytest.mark.parametrize("case", ETC_CASES, ids=[c[0] for c in ETC_CASES])
def test_encode_etc_golden_on_card(card, case):
    name, entry, _, flags, threshold = case
    px, _, blocks, _ = load_etc(name)
    got = etc_encode(entry, flags, px, None, threshold)  # None: the card
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)


@pytest.fixture(scope="module")
def full_width_inputs():
    """1,024 blocks, every 64th, of chip_smoke.py's full-width ETC inputs:
    the BC7 texture, the JAX bench's int16 EAC values and the texture with
    the JAX bench's random alpha."""
    import chip_smoke
    eac_u, eac_s, _, alpha = chip_smoke.bench_rng44_draws()
    tex = chip_smoke.make_texture(seed=0)
    return {"texture": tex[::64], "eac_unsigned": eac_u[::64],
            "eac_signed": eac_s[::64],
            "texture_random_alpha": chip_smoke.with_alpha(tex, alpha)[::64]}


ETC_FULL = (("etc1", "etc1", 0x108), ("etc1_fake709", "etc1", 0x508),
            ("etc2_alpha", "etc2_alpha", 0x108),
            ("eac_r11", "eac11", 0x108), ("eac_r11s", "eac11s", 0x108),
            ("etc2", "etc2", 0x108), ("etc2_rgba", "etc2_rgba", 0x108),
            ("etc2_fake709", "etc2", 0x508),
            ("etc2_punchthrough", "etc2_punchthrough", 0x108))


@pytest.mark.parametrize("config", ETC_FULL, ids=[c[0] for c in ETC_FULL])
def test_encode_etc_full_width_card_equals_cpu(card, full_width_inputs,
                                               config, monkeypatch):
    """1,024 blocks of each full-width configuration, in chunks of 300 on
    the card and one chunk on the CPU."""
    from convectionkernels_tpu_torch import api
    _, entry, flags = config
    source = {"eac11": "eac_unsigned", "eac11s": "eac_signed",
              "etc2_punchthrough": "texture_random_alpha"}.get(
        entry, "texture")
    px = torch.as_tensor(full_width_inputs[source])
    want = etc_encode(entry, flags, px, "cpu")
    monkeypatch.setattr(api, "CHUNK_ETC", 300)
    monkeypatch.setattr(api, "CHUNK_ETC2", 300)
    monkeypatch.setattr(api, "CHUNK_EAC", 300)
    got = etc_encode(entry, flags, px.to(card), card)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_card_tensors_cast_as_numpy(card):
    """A card tensor of another dtype is converted as NumPy converts it,
    the JAX entry points' cast: floats truncate through int32 (NaN,
    infinities and values outside int32 give INT32_MIN), integers wrap."""
    from convectionkernels_tpu_torch import api
    f = torch.tensor([-1.5, 300.7, 255.9, 3.7, -0.5, float("nan"), 1e10,
                      -1e10, 3e9, 2.0**31 + 256, 70000.5, float("inf"),
                      -float("inf"), 2.0**31 - 0.5])
    i = torch.tensor([-1, 300, 255, -129, 70000, 2**40 + 5])
    for t in (f, f.double(), f.half(), i, i.int()):
        for dtype, np_dtype in ((torch.uint8, np.uint8), (torch.int8,
                                                           np.int8),
                                (torch.int16, np.int16)):
            got = api._cast(t.to(card), dtype)
            assert got.device.type == "cuda" and got.dtype == dtype
            np.testing.assert_array_equal(
                got.cpu().numpy(), np.asarray(t.numpy(), dtype=np_dtype))


# --- the CLI and the block axis split on the card --------------------------------

def cli_image():
    """64 x 64 RGBA: 256 blocks of chip_smoke.py's texture."""
    import chip_smoke
    from convectionkernels_tpu_torch.utils import image
    return image.unblockify(chip_smoke.make_texture(seed=0, size=64), 64, 64)


@pytest.mark.parametrize("flags", (["-f", "bc7", "-q", "5"], ["-f", "bc1"]),
                         ids=("bc7_q5", "bc1"))
def test_cli_on_card_equals_cpu(card, flags, tmp_path, monkeypatch):
    """The CLI with the card (device=None) writes the file it writes on the
    CPU; the BC7 run launches each of the three BC7 kernels."""
    from convectionkernels_tpu_torch import cli
    src = str(tmp_path / "in.npy")
    np.save(src, cli_image())
    bc7_kernel.LAUNCHES.clear()
    assert cli.main(flags + [src, str(tmp_path / "card.dds")]) == 0
    launched = {k: bc7_kernel.LAUNCHES[k] for k in PLAIN}
    assert cli.main(flags + [src, str(tmp_path / "cpu.dds")],
                    device="cpu") == 0
    assert (tmp_path / "card.dds").read_bytes() == \
        (tmp_path / "cpu.dds").read_bytes()
    if flags[1] == "bc7":
        assert all(launched.values()), launched


def test_encode_sharded_on_card_equals_one_call(card):
    from convectionkernels_tpu_torch.parallel import sharding
    px = blockgen.mixed_blocks(203, seed=807)
    want = ckt.encode_bc1(px, device=card).cpu().numpy()
    got = sharding.encode_sharded(ckt.encode_bc1, px, [card, card])
    np.testing.assert_array_equal(got, want)


def test_nccl_world_of_one_assembles(card):
    """A one-rank NCCL group on the card: the assembled bytes, gathered by
    NCCL, equal one call."""
    import socket

    import torch.distributed as dist

    from convectionkernels_tpu_torch.parallel import distributed
    from convectionkernels_tpu_torch.utils import image
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(init_method=f"tcp://localhost:{port}",
                           world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        img = cli_image()
        got = distributed.encode_image_distributed(ckt.encode_bc1, img,
                                                   assemble=True)
    finally:
        dist.destroy_process_group()
    want = ckt.encode_bc1(image.blockify(img), device=card).cpu().numpy()
    np.testing.assert_array_equal(got, want)
