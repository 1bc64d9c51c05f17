"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel wrapper is held bit for bit against its plain PyTorch version
on the same card inputs, encode_bc7, encode_bc6hu and encode_bc6hs on the
card against the stored JAX bytes, and the S3TC and ETC entry points
(eager tensor code, and S3TC's s3tc_alpha kernel) on the card against the
stored JAX bytes and against the port on the CPU, and the program layer's CUDA
graphs against the same encodes run op by op. Kernel launches are counted
at cuda_lib.launch for op-by-op wrapper calls (the `launches` fixture), and
by name in torch.profiler's trace (chip_smoke.csrc_launches) for encodes
through the program layer, whose replays launch no kernel from Python.
This file imports
nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import convectionkernels_tpu_torch as ckt
from convectionkernels_tpu_torch import (cuda_lib, exact_probe, programs,
                                         tracing)
from convectionkernels_tpu_torch.models import (bc6h, bc6h_kernel, bc7,
                                                bc7_kernel, s3tc)
from chip_smoke import csrc_launches
from tests import blockgen
from tests.test_torch_bc6h_combine import (GROUPS, meta_ids_of,
                                           synthetic_chain)
from tests.test_torch_goldens import (BC6H_CASES, BC6H_FAST, DEFAULT,
                                      BC7_PACK_MODES, ETC_CASES, FAST,
                                      LIGHT, LIGHT_CASES, PUNCH, S3TC_CASES,
                                      UNIFORM, alpha_blocks_with_edges,
                                      bc7_pack_work, hdr_blocks,
                                      hdr_edge_blocks,
                                      hdr_signed_blocks,
                                      load_bc6h, load_etc, load_light,
                                      load_q50, load_s3tc, map_work,
                                      punch_through_blocks, signed_blocks)

pytestmark = pytest.mark.cuda

PLAIN = {"shape_pca": bc7_kernel.shape_pca_plain,
         "single_plane_mode_best": bc7_kernel.single_plane_mode_best_plain,
         "dual_plane_best": bc7_kernel.dual_plane_best_plain,
         "bc7_pack": bc7_kernel.bc7_pack_plain}
# the csrc/ libraries of the BC7 kernels
BC7_LIBRARIES = ("shape_pca", "single_plane", "dual_plane", "bc7_pack")
# a BC6H chunk's launches of each csrc/ library
BC6H_CHUNK_KERNELS = {"bc6h_group": 6, "bc6h_single": 4, "bc6h_combine": 10}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def launches(monkeypatch):
    """launches(run) -> (run(), {library: launches}): every csrc/ kernel is
    launched through cuda_lib.launch, so an op-by-op wrapper call's launches
    are counted there, as they happen. A replayed graph launches nothing
    there: csrc_launches reads those from a trace."""
    counts = dict.fromkeys(cuda_lib.SOURCES, 0)
    real = cuda_lib.launch

    def counted(library, what, *args):
        real(library, what, *args)
        counts[library] += 1

    monkeypatch.setattr(cuda_lib, "launch", counted)

    def run_counted(run):
        counts.update(dict.fromkeys(counts, 0))
        out = run()
        return out, dict(counts)

    return run_counted


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
            elif torch.is_tensor(got):
                g, w = [got], [want]
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
                    "dual_plane_best": 1, "bc7_pack": 1}
    np.testing.assert_array_equal(out.cpu().numpy(), blocks[:64])


@pytest.mark.parametrize("case", LIGHT_CASES, ids=[c[0] for c in LIGHT_CASES])
def test_encode_light_on_card(card, case):
    px, blocks, flags = load_light(case[0])
    got, launched = csrc_launches(lambda: ckt.encode_bc7(
        px, ckt.Options(flags=flags, **LIGHT), quality=5, device=card))
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)
    assert all(launched[k] > 0 for k in BC7_LIBRARIES), launched


def test_encode_q50_on_card(card, no_programs):
    """The golden's one bucket: its first call (op by op), capture and
    replay each launch bc7_pack once, read from the trace."""
    px, blocks, _ = load_q50()
    for _ in range(3):
        got, launched = csrc_launches(
            lambda: ckt.encode_bc7(px, quality=50))   # device=None: the card
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), blocks)
        assert launched["bc7_pack"] == 1, launched
        assert all(launched[k] > 0 for k in BC7_LIBRARIES), launched
    assert graph_captures() == [1]


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


# --- bc7_pack: one thread a block, each under its own mode -----------------------

def pack_fields_on(card, n, mode, seed):
    """pack_fields of bc7_pack_work on the card; mode "wild": any int32
    in every row but the mode (0-7) and the partition (0-63)."""
    if mode != "wild":
        work = bc7_pack_work(n, mode=mode, seed=seed)
        return bc7_kernel.pack_fields(map_work(
            lambda a: torch.as_tensor(a, device=card), work))
    rng = np.random.default_rng(seed)
    f = rng.integers(-2**31, 2**31, (bc7_kernel.PACK_FIELDS, n))
    f = f.astype(np.int32)
    f[bc7_kernel.FIELD_MODE] = rng.integers(0, 8, n)
    f[bc7_kernel.FIELD_PARTITION] = rng.integers(0, 64, n)
    return torch.as_tensor(f, device=card)


@pytest.mark.parametrize("n", (1, 31, 32, 33, 1000))
@pytest.mark.parametrize("mode", list(range(8)) + ["mixed", "wild"])
def test_bc7_pack_matches_plain_version(card, launches, mode, n):
    """Every mode alone and all modes in one warp; at 1,000 blocks every
    partition of the mode, every rotation and index selector of modes 4
    and 5, and anchors with the high bit set and clear."""
    fields = pack_fields_on(card, n, None if mode == "mixed" else mode,
                            seed=900 + n)
    got, launched = launches(lambda: bc7_kernel.bc7_pack(fields))
    assert launched["bc7_pack"] == 1
    assert got.dtype == torch.uint8 and got.shape == (n, 16)
    assert torch.equal(got, bc7_kernel.bc7_pack_plain(fields))
    if n == 1000 and mode in range(8):
        parts, ib, aib, rot, isel = BC7_PACK_MODES[mode]
        f, k = fields.cpu().numpy(), bc7_kernel
        assert len(np.unique(f[k.FIELD_PARTITION])) == parts
        assert len(np.unique(f[k.FIELD_ROTATION] * 2 + f[k.FIELD_ISEL])) \
            == (4 if rot else 1) * (2 if isel else 1)
        anchor_top = f[k.FIELD_INDEXES] >> (ib - 1)     # pixel 0's
        assert set(np.unique(anchor_top)) == {0, 1}


def test_bc7_pack_checks_its_inputs(card, launches):
    """A wrong dtype, shape, layout or device raises before any launch."""
    fields = pack_fields_on(card, 64, None, seed=1)

    def rejected():
        for bad, error in (
                (fields.long(), TypeError),
                (fields[:-1].contiguous(), ValueError),
                (fields[0].contiguous(), ValueError),
                (fields.t().contiguous().t(), ValueError),
                (torch.empty(fields.shape, dtype=torch.int32, device="meta"),
                 ValueError)):
            with pytest.raises(error):
                bc7_kernel.bc7_pack(bad)

    _, launched = launches(rejected)
    assert launched["bc7_pack"] == 0


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
def test_shape_pca_matches_plain_version(card, launches, n, shapes):
    """Every output bit-equal, for 3 and 4 channels, with and without the
    alpha error, uniform and weighted, at block counts around the 32-block
    group and shape counts around the 4-shape chunk."""
    masks = torch.as_tensor(pca_mask_lists()[shapes], device=card)
    pix = torch.as_tensor(pca_corpus(n, seed=400 + n).reshape(n, 64),
                          dtype=torch.int32, device=card)
    calls = [(pix, masks, nch, (1.0,) * 4 if uniform
              else ckt.Options().channel_weights(), uniform, with_alpha)
             for nch in (3, 4) for with_alpha in (True, False)
             for uniform in (False, True)]
    outs, launched = launches(
        lambda: [bc7_kernel.shape_pca(*call) for call in calls])
    assert launched["shape_pca"] == len(calls)      # one a wrapper call
    for call, got in zip(calls, outs):
        nch, _, uniform, with_alpha = call[2:]
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
    masks = torch.as_tensor(pca_mask_lists()[shapes], device=card)
    n, s_count = 33, masks.shape[0]
    pix = torch.as_tensor(pca_corpus(n, seed=450).reshape(n, 64),
                          dtype=torch.int32, device=card)
    cw = ckt.Options().channel_weights()
    for nch, with_alpha in ((3, True), (4, False)):
        want = bc7_kernel.shape_pca_plain(pix, masks, nch, cw, False,
                                          with_alpha)
        for chunk in (1, 2, 4, 0, 3):
            base = torch.zeros((n, s_count, 4), dtype=torch.float32,
                               device=card)
            offset = torch.zeros_like(base)
            alpha = torch.zeros((n, s_count), dtype=torch.float32,
                                device=card)

            def launch():
                cuda_lib.launch("shape_pca", f"shape_pca(chunk {chunk})",
                                pix, masks, n, s_count, nch,
                                bc7_kernel._cw_array(cw), 0, int(with_alpha),
                                chunk, base, offset,
                                alpha if with_alpha else None)
                torch.cuda.synchronize()

            if chunk in (0, 3):
                with pytest.raises(RuntimeError, match="launch failed"):
                    launch()
                continue
            launch()
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
            torch.as_tensor(cf, device=card), 2, False, fast,
            bc7_kernel.dual_plane_work(ci, cf, card))
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
def test_bc6h_kernel_matches_plain_version(card, launches, case):
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
    got, launched = launches(
        lambda: bc6h_kernel.partitioned_group_meta_rounds(
            pix, base, offset, aprec, is_signed, fast, uniform, cw, tweaks,
            refines))
    assert launched["bc6h_group"] == 1
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
    got, launched = csrc_launches(lambda: encode(px, ckt.Options(
        flags=flags, seed_points=seed_points,
        refine_rounds_bc6h=refine_rounds)))
    assert got.device.type == "cuda"        # device=None: the card
    np.testing.assert_array_equal(got.cpu().numpy(), blocks)
    assert {k: launched[k] for k in BC6H_CHUNK_KERNELS} == BC6H_CHUNK_KERNELS


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



# --- BC6H's single-mode groups: the kernel against its plain version ------------

SINGLE_APRECS = (16, 12, 11, 10)


def extreme_hdr_blocks(is_signed):
    """Blocks at the ends of the clamped 2CL range: all 0, all 31743 (the
    largest finite half), all -31743 when signed, and the two mixed."""
    top = np.int16(0x7BFF)
    bottom = np.array(0xFBFF, dtype=np.uint16).view(np.int16)[()]
    values = [np.int16(0), top] + ([bottom] if is_signed else [])
    blocks = [np.full((16, 4), v, dtype=np.int16) for v in values]
    for low in values[:1] + values[2:]:
        mixed = np.full((16, 4), top, dtype=np.int16)
        mixed[::2] = low
        blocks.append(mixed)
    return np.stack(blocks)


def single_chain_inputs(px, is_signed, cw, card):
    pix = bc6h.prepare_pixels(torch.as_tensor(px, device=card), is_signed)
    ufep_base, ufep_offset = bc6h.pca_lines(pix, cw)
    return (pix, torch.stack([b[:, 64] for b in ufep_base], 1).contiguous(),
            torch.stack([o[:, 64] for o in ufep_offset], 1).contiguous())


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_bc6h_single_matches_plain_on_golden_chains(card, launches, signed,
                                                    fast, monkeypatch):
    """Every single-mode group of a pack of the blocks of every stored
    BC6H golden of that signedness, at 4 x 3 and 1 x 1 rounds: one launch
    each, its four outputs bit-equal to the plain version's."""
    px = np.concatenate([load_bc6h(c[0])[0] for c in BC6H_CASES
                         if c[2] == signed])
    real, seen = bc6h_kernel.single_group_meta_rounds, []

    def checked(*args):
        got, launched = launches(lambda: real(*args))
        assert launched["bc6h_single"] == 1
        want = bc6h_kernel.single_group_meta_rounds_plain(*args)
        for name, a, b in zip(("err", "valid", "eps", "idx"), got, want):
            assert a.dtype == b.dtype and same_bits(a, b), (args[3], name)
        seen.append(args[3])
        return got

    monkeypatch.setattr(bc6h_kernel, "single_group_meta_rounds", checked)
    opts = ckt.Options(flags=DEFAULT | (BC6H_FAST if fast else 0))
    for rounds in ((4, 3), (1, 1)):
        bc6h.pack(torch.as_tensor(px, device=card), opts.flags,
                  opts.channel_weights(), signed, *rounds)
    assert seen == list(SINGLE_APRECS) * 2


SINGLE_KERNEL_CASES = [(aprec, signed, fast) for aprec in SINGLE_APRECS
                       for signed in (False, True) for fast in (False, True)]


@pytest.mark.parametrize("case", SINGLE_KERNEL_CASES, ids=[
    f"aprec{a}_{'signed' if s else 'unsigned'}_{'fast' if f else 'slow'}"
    for a, s, f in SINGLE_KERNEL_CASES])
def test_bc6h_single_matches_plain_synthetic(card, launches, case):
    """Ordinary, edge-value and range-end blocks (0, 31743 and, signed,
    -31743), 1,024 + a few of them (no multiple of the 4 blocks a CUDA
    block holds), at every rounds setting 1..4 x 1..3, weighted and
    uniform: all four outputs bit-equal to the plain version's; then 1, 2
    and 5 blocks, and the plain version on the CPU."""
    aprec, is_signed, fast = case
    px = np.concatenate([hdr_signed_blocks(600, seed=81) if is_signed
                         else hdr_blocks(600, seed=83),
                         hdr_edge_blocks(424, seed=85),
                         extreme_hdr_blocks(is_signed)])
    assert px.shape[0] % 4 != 0
    for uniform in (False, True):
        opts = ckt.Options(flags=ckt.Flags.UNIFORM if uniform else 0)
        cw = [float(np.float32(w)) for w in opts.channel_weights()[:3]]
        pix, base, offset = single_chain_inputs(px, is_signed, cw, card)
        calls = [(pix, base, offset, aprec, is_signed, fast, uniform, cw,
                  tweaks, refines)
                 for tweaks in range(1, 5) for refines in range(1, 4)]
        outs, launched = launches(
            lambda: [bc6h_kernel.single_group_meta_rounds(*call)
                     for call in calls])
        assert launched["bc6h_single"] == len(calls)    # one a wrapper call
        for call, got in zip(calls, outs):
            want = bc6h_kernel.single_group_meta_rounds_plain(*call)
            for name, a, b in zip(("err", "valid", "eps", "idx"), got, want):
                assert a.dtype == b.dtype and same_bits(a, b), \
                    (uniform, call[8], call[9], name)
    for n in (1, 2, 5):
        call = (pix[:n].contiguous(), base[:n].contiguous(),
                offset[:n].contiguous(), aprec, is_signed, fast, uniform, cw,
                4, 3)
        got = bc6h_kernel.single_group_meta_rounds(*call)
        want = bc6h_kernel.single_group_meta_rounds_plain(*call)
        for name, a, b in zip(("err", "valid", "eps", "idx"), got, want):
            assert same_bits(a, b), (n, name)
    cpu = bc6h_kernel.single_group_meta_rounds(
        pix.cpu(), base.cpu(), offset.cpu(), aprec, is_signed, fast, uniform,
        cw, 4, 3)
    got = bc6h_kernel.single_group_meta_rounds(
        pix, base, offset, aprec, is_signed, fast, uniform, cw, 4, 3)
    for name, a, b in zip(("err", "valid", "eps", "idx"), got, cpu):
        assert same_bits(a.cpu(), b), name
    # the rounds do repeat endpoints here, so the dedup is exercised
    valid = got[1]
    assert 0 < int(valid.sum()) < valid.numel()


def test_bc6h_single_wrapper_checks_its_inputs(card, launches):
    pix = torch.zeros((4, 48), dtype=torch.int32, device=card)
    line = torch.zeros((4, 3), dtype=torch.float32, device=card)
    cw = ckt.Options().channel_weights()
    run = bc6h_kernel.single_group_meta_rounds
    with pytest.raises(TypeError):
        run(pix.float(), line, line, 16, False, False, False, cw, 4, 3)
    with pytest.raises(TypeError):
        run(pix, line.double(), line, 16, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line[:, :2], line, 16, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line, line.cpu(), 16, False, False, False, cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line.t().contiguous().t(), line, 16, False, False, False,
            cw, 4, 3)
    with pytest.raises(ValueError):
        run(pix, line, line, 16, False, False, False, cw, 5, 3)
    with pytest.raises(ValueError):
        run(pix, line, line, 9, False, False, False, cw, 4, 3)
    out, launched = launches(lambda: run(
        pix[:0], line[:0], line[:0], 16, False, False, False, cw, 4, 3))
    assert out[3].shape == (0, 12, 16, 1)
    assert launched["bc6h_single"] == 0

# --- BC6H's combine: the kernel against its plain version ---------------------------

def same_combine(got, want):
    """Every field combine returns, bit for bit; the name of the first that
    differs, or None."""
    names = ("err", "rank") + tuple(f"payload.{k}" for k in sorted(got[2]))
    pairs = [got[0], got[1]] + [got[2][k] for k in sorted(got[2])]
    wants = [want[0], want[1]] + [want[2][k] for k in sorted(got[2])]
    for name, a, b in zip(names, pairs, wants):
        if a.dtype != b.dtype or not same_bits(a, b):
            return name
    return None


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
@pytest.mark.parametrize("rounds", [(1, 1), (2, 3), (4, 3)],
                         ids=["1x1", "2x3", "4x3"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_bc6h_combine_matches_plain_on_golden_chains(card, launches, signed,
                                                     rounds, fast,
                                                     monkeypatch):
    """Every group's combine in a pack of the blocks of every stored BC6H
    golden of that signedness: one launch each, bit-equal to the plain
    version on the same chain outputs."""
    px = np.concatenate([load_bc6h(c[0])[0] for c in BC6H_CASES
                         if c[2] == signed])
    real, seen = bc6h_kernel.combine, []

    def checked(*args):
        got, launched = launches(lambda: real(*args))
        assert launched["bc6h_combine"] == 1
        assert same_combine(got, bc6h_kernel.combine_plain(*args)) is None
        seen.append(args[4])
        return got

    monkeypatch.setattr(bc6h_kernel, "combine", checked)
    opts = ckt.Options(flags=DEFAULT | (BC6H_FAST if fast else 0))
    bc6h.pack(torch.as_tensor(px, device=card), opts.flags,
              opts.channel_weights(), signed, *rounds)
    assert seen == [g[1] for g in GROUPS]


COMBINE_SIZES = [(g, n) for g in range(len(GROUPS)) for n in (0, 1, 33)] + [
    (4, 65537), (0, 65537)]


@pytest.mark.parametrize("case", COMBINE_SIZES,
                         ids=[f"{'p' if GROUPS[g][0] else 's'}{GROUPS[g][1]}"
                              f"_n{n}" for g, n in COMBINE_SIZES])
def test_bc6h_combine_matches_plain_synthetic(card, launches, case):
    """Synthetic chain outputs (planted ties across partitions and rounds,
    rows with no valid pair, +inf errors) of every precision group at 12
    rounds, N = 0, 1 and 33, and 65,537 blocks (rows drawn from 1,024) for
    a partitioned and a single-mode group."""
    g, n = case
    group = GROUPS[g]
    meta_ids = meta_ids_of(4, 3)
    pool = [torch.as_tensor(a, device=card)
            for a in synthetic_chain(max(n, 1) if n < 1024 else 1024, 12,
                                     group, seed=700 + g)]
    rows = torch.as_tensor(np.random.default_rng(g).integers(
        0, pool[0].shape[0], size=n), device=card)
    chain = [a.index_select(0, rows).contiguous() for a in pool]
    args = (*chain, group[1], group[2], meta_ids, 4 * 144 + g)
    got, launched = launches(lambda: bc6h_kernel.combine(*args))
    assert launched["bc6h_combine"] == (1 if n else 0)
    assert got[0].shape == (n,) and got[2]["idx"].shape == (n, 16)
    assert same_combine(got, bc6h_kernel.combine_plain(*args)) is None
    if n == 33:     # the plain version on the CPU agrees as well
        cpu = bc6h_kernel.combine(*[a.cpu() for a in chain], *args[4:])
        on_card = (cpu[0].to(card), cpu[1].to(card),
                   {k: v.to(card) for k, v in cpu[2].items()})
        assert same_combine(got, on_card) is None


def test_bc6h_combine_checks_its_inputs(card):
    group = GROUPS[4]
    meta_ids = meta_ids_of(4, 3)
    err, valid, eps, idx = [torch.as_tensor(a, device=card) for a in
                            synthetic_chain(4, 12, group, seed=3)]
    run = bc6h_kernel.combine
    with pytest.raises(TypeError):
        run(err, valid.float(), eps, idx, 11, group[2], meta_ids, 0)
    with pytest.raises(ValueError):
        run(err, valid, eps[:, :, :3], idx, 11, group[2], meta_ids, 0)
    with pytest.raises(ValueError):
        run(err, valid, eps, idx.cpu(), 11, group[2], meta_ids, 0)
    with pytest.raises(ValueError):
        run(err, valid, eps, idx, 11, group[2], meta_ids[:6], 0)
    with pytest.raises(ValueError):
        run(err, valid, eps, idx, 10, group[2], meta_ids, 0)
    with pytest.raises(ValueError):
        run(err, valid, eps.transpose(2, 3).contiguous().transpose(2, 3),
            idx, 11, group[2], meta_ids, 0)


def test_bc6h_replayed_program_equals_its_first_call(card):
    """encode_bc6hu's first call (op by op), capture and replays give the
    same bytes, the golden's; each call counts 6 partitioned-chain, 4
    single-chain and 10 combine launches."""
    programs.release_programs()
    try:
        (case,) = [c for c in BC6H_CASES if c[0] == "default"]
        px, blocks, _ = load_bc6h("default")
        opts = ckt.Options(flags=case[3], seed_points=case[4],
                           refine_rounds_bc6h=case[5])
        outs = []
        for _ in range(3):
            out, launched = csrc_launches(
                lambda: ckt.encode_bc6hu(px, opts, device=card))
            outs.append(out)
            assert {k: launched[k] for k in BC6H_CHUNK_KERNELS} == BC6H_CHUNK_KERNELS
        for out in outs:
            np.testing.assert_array_equal(out.cpu().numpy(), blocks)
        assert graph_captures() == [1]
    finally:
        programs.release_programs()


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


# --- s3tc_alpha: the interpolated-alpha chain, one thread a block ----------------

# (max_tweak_rounds, num_refine_rounds) of the chain: the default Options'
# 4 x 8 and the short chains
ALPHA_ROUNDS = [(t, r) for t in (1, 4) for r in (1, 2, 8)]


def alpha_inputs(px, signed):
    """uint8 [n, 16, 4] blocks on the CPU as pack_interpolated_alpha takes
    them: as they are, or shifted into int8 and biased (bias_signed_input,
    int32 0-254)."""
    if not signed:
        return torch.as_tensor(px)
    return s3tc.bias_signed_input(torch.as_tensor(
        (px.astype(np.int16) - 128).astype(np.int8)))


@pytest.mark.parametrize("rounds", ALPHA_ROUNDS,
                         ids=[f"t{t}r{r}" for t, r in ALPHA_ROUNDS])
@pytest.mark.parametrize("signed", (False, True), ids=("unsigned", "signed"))
@pytest.mark.parametrize("n", (1, 31, 256, 1000))
def test_s3tc_alpha_matches_plain_version(card, launches, n, signed, rounds):
    """pack_interpolated_alpha on the card, one s3tc_alpha launch a call,
    against its plain version on the CPU: the edge blocks (flat, 0 and
    255 only, the clipping heuristic not tried, passing and failing, ties
    in update_best) and mixed blocks, in two channels."""
    blocks = alpha_inputs(alpha_blocks_with_edges(n, seed=2300 + n), signed)
    on_card = blocks.to(card)
    for channel in (3, 0):
        got, launched = launches(lambda: s3tc.pack_interpolated_alpha(
            on_card, channel, signed, *rounds))
        assert launched["s3tc_alpha"] == 1
        assert got.dtype == torch.uint8 and got.shape == (n, 8)
        want = s3tc.pack_interpolated_alpha(blocks, channel, signed, *rounds)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("signed", (False, True), ids=("unsigned", "signed"))
def test_s3tc_alpha_full_chunk_matches_plain_version(card, signed):
    """One 65,536-block chunk of the benchmark's texture, the alpha
    channel at the default Options, against the plain version on the
    CPU."""
    from chip_smoke import make_texture
    blocks = alpha_inputs(make_texture(seed=5), signed)
    opts = ckt.Options()
    args = (3, signed, opts.seed_points, opts.refine_rounds_iic)
    got = s3tc.pack_interpolated_alpha(blocks.to(card), *args)
    want = s3tc.pack_interpolated_alpha(blocks, *args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_s3tc_alpha_launches_once_a_call_and_never_on_the_cpu(
        card, launches, no_programs):
    """One launch a call; BC5's first call (op by op) launches one a
    channel; the CPU path launches nothing."""
    blocks = alpha_inputs(alpha_blocks_with_edges(64, seed=2310), False)
    on_card = blocks.to(card)
    got, launched = launches(lambda: s3tc.pack_interpolated_alpha(
        on_card, 3, False, 4, 8))
    assert launched == {**dict.fromkeys(cuda_lib.SOURCES, 0), "s3tc_alpha": 1}
    _, launched = launches(lambda: ckt.encode_bc5u(on_card, device=card))
    assert launched["s3tc_alpha"] == 2
    want, launched = launches(lambda: s3tc.pack_interpolated_alpha(
        blocks, 3, False, 4, 8))
    assert not any(launched.values())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_s3tc_alpha_checks_its_inputs(card, launches):
    """A wrong dtype, shape, channel, layout or device raises before any
    launch."""
    blocks = torch.as_tensor(alpha_blocks_with_edges(64, seed=2311),
                             device=card)

    def rejected():
        for bad, channel, error in (
                (blocks.float(), 3, TypeError),
                (blocks.long(), 3, TypeError),
                (blocks[:, :, 0].contiguous(), 0, ValueError),
                (blocks[:, :15].contiguous(), 3, ValueError),
                (blocks, 4, ValueError),
                (blocks.transpose(0, 1).contiguous().transpose(0, 1), 3,
                 ValueError),
                (torch.empty(blocks.shape, dtype=torch.uint8, device="meta"),
                 3, ValueError)):
            with pytest.raises(error):
                s3tc.s3tc_alpha(bad, channel, False, 4, 8)

    _, launched = launches(rejected)
    assert launched["s3tc_alpha"] == 0


@pytest.mark.parametrize("case", [c for c in S3TC_CASES
                                  if c[1] in ("bc3", "bc4u", "bc4s", "bc5u",
                                              "bc5s")],
                         ids=lambda c: c[0])
def test_encode_s3tc_golden_launches_s3tc_alpha(card, no_programs, case):
    """Every stored BC3, BC4 and BC5 golden through its entry point: the
    first call (op by op), the capture and a replay each give the golden's
    bytes and run s3tc_alpha once a channel, read from the trace."""
    name, fmt, _, fields = case
    px, blocks, _ = load_s3tc(name)
    for _ in range(3):
        got, launched = csrc_launches(
            lambda: s3tc_encode(fmt, fields, px, card))
        np.testing.assert_array_equal(got.cpu().numpy(), blocks)
        assert launched["s3tc_alpha"] == (2 if fmt.startswith("bc5") else 1)
    assert graph_captures() == [1]


def test_bc3_replayed_program_equals_its_first_call(card, no_programs):
    """encode_bc3 at Flags.BETTER on 300 blocks (the 512 bucket): the first
    call (op by op), the capture and two replays give the CPU's bytes, one
    s3tc_alpha launch each, read from the trace."""
    px = blockgen.alpha_blocks(300, seed=2312)
    px[:53, :, 3] = alpha_blocks_with_edges(53, seed=2313)[:, :, 3]
    options = ckt.Options(flags=ckt.Flags.BETTER)
    want = ckt.encode_bc3(px, options, device="cpu").numpy()
    programs.release_programs()          # the CPU's program captures none
    for _ in range(4):
        got, launched = csrc_launches(
            lambda: ckt.encode_bc3(px, options, device=card))
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert launched["s3tc_alpha"] == 1, launched
    assert graph_captures() == [1]


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


def check_container_header(path, fmt, sizes):
    """The header and length of the DDS or KTX file `path` are those of the
    container format `fmt` with level sizes `sizes` [(width, height)]."""
    import struct

    from convectionkernels_tpu_torch.utils import containers as ct
    data = path.read_bytes()
    width = ct.BLOCK_BYTES[fmt]
    nbytes = [((w + 3) // 4) * ((h + 3) // 4) * width for w, h in sizes]
    (w0, h0), mips = sizes[0], len(sizes)
    if path.suffix == ".dds":
        flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x80000 | (0x20000 if mips > 1
                                                       else 0)
        assert data[:4] == b"DDS "
        assert struct.unpack_from("<7I", data, 4) == (
            124, flags, h0, w0, max(1, (w0 + 3) // 4) * width, 0, mips)
        assert struct.unpack_from("<2I4s", data, 76) == (32, 0x4, b"DX10")
        assert struct.unpack_from("<I", data, 108)[0] == \
            0x1000 | (0x400008 if mips > 1 else 0)
        assert struct.unpack_from("<5I", data, 128) == (
            ct.DXGI_FORMATS[fmt], 3, 0, 1, 0)
        assert len(data) == 148 + sum(nbytes)
        return
    assert data[:12] == ct._KTX_MAGIC
    assert struct.unpack_from("<13I", data, 12) == (
        0x04030201, 0, 1, 0, ct.GL_INTERNAL_FORMATS[fmt],
        ct.GL_BASE_FORMATS[fmt], w0, h0, 0, 0, 1, mips, 0)
    pos = 64
    for i, n in enumerate(nbytes):
        assert struct.unpack_from("<I", data, pos)[0] == n, f"level {i}"
        pos += 4 + n + (-n) % 4
    assert len(data) == pos


# (name, flags, output file, container format, csrc/ libraries the run
# must launch); "_module" runs the card's side as
# `python -m convectionkernels_tpu_torch.cli`, whose launches this process
# cannot see
CLI_CASES = (
    ("bc7_q5", ["-f", "bc7", "-q", "5"], "out.dds", "bc7", BC7_LIBRARIES),
    ("bc7_q5_module", ["-f", "bc7", "-q", "5"], "out.dds", "bc7", ()),
    ("bc1", ["-f", "bc1"], "out.dds", "bc1", ()),
    ("bc6h", ["-f", "bc6h"], "out.dds", "bc6h_uf",
     tuple(BC6H_CHUNK_KERNELS)),
    ("etc2_mips", ["-f", "etc2", "-mips"], "out.ktx", "etc2", ()),
    ("eac_rg11", ["-f", "eac_rg11"], "out.ktx", "eac_rg11", ()),
)


@pytest.mark.parametrize("case", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_cli_on_card_equals_cpu(card, case, tmp_path):
    """The CLI with the card (device=None) writes the file it writes on the
    CPU, with its container's header for every level; a BC7 or BC6H run
    launches each kernel of its format."""
    import os
    import subprocess
    import sys

    from convectionkernels_tpu_torch import cli
    from convectionkernels_tpu_torch.utils import image
    name, flags, out, fmt, libraries = case
    img = cli_image()
    src = str(tmp_path / "in.npy")
    np.save(src, img)
    card_path, cpu_path = tmp_path / f"card_{out}", tmp_path / f"cpu_{out}"
    if name.endswith("_module"):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "convectionkernels_tpu_torch.cli", *flags,
             src, str(card_path)], cwd=repo, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=repo), timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        launched = {}
    else:
        rc, launched = csrc_launches(
            lambda: cli.main(flags + [src, str(card_path)]))
        assert rc == 0
    assert cli.main(flags + [src, str(cpu_path)], device="cpu") == 0
    assert card_path.read_bytes() == cpu_path.read_bytes()
    levels = image.mip_chain(img) if "-mips" in flags else [img]
    check_container_header(card_path, fmt, [(level.shape[1], level.shape[0])
                                            for level in levels])
    assert all(launched[k] > 0 for k in libraries), launched


SHARDED = (("bc1", ckt.encode_bc1, 203, 2),
           ("bc7_q50", functools.partial(ckt.encode_bc7, quality=50), 203, 3),
           ("etc2_punchthrough", ckt.encode_etc2_punchthrough, 203, 3))


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
def test_encode_sharded_on_card_equals_one_call(card, case):
    """encode_sharded over slices of one card (a block count no multiple
    of them) equals one call."""
    from convectionkernels_tpu_torch.parallel import sharding
    _, encode, n, slices = case
    px = blockgen.mixed_blocks(n, seed=807)
    want = encode(px, device=card).cpu().numpy()
    got = sharding.encode_sharded(encode, px, [card] * slices)
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


def test_two_process_gloo_encode_on_card(card, tmp_path):
    """Two gloo processes sharing the card (NCCL refuses two ranks on one
    card), encode_image_distributed of encode_bc1 on it: each rank's local
    bytes are its slice of one call's, and each rank's assembled bytes are
    all of them."""
    from tests.test_torch_parallel import check_two_gloo_processes
    check_two_gloo_processes(tmp_path, str(card))


# --- programs: a CUDA graph of each configuration and bucket ----------------------

def graph_encoders(card):
    """bc7 at quality 5, bc1 and ETC2 punchthrough (both sides of its
    split) on a 64x64 texture, 256 blocks."""
    px = blockgen.mixed_blocks(256, seed=811)
    return {"bc7_q5": lambda: ckt.encode_bc7(px, ckt.Options(**LIGHT),
                                             quality=5, device=card),
            "bc1": lambda: ckt.encode_bc1(px, device=card),
            "etc2_punchthrough": lambda: ckt.encode_etc2_punchthrough(
                px, device=card)}


def graph_captures():
    return [b.captures for p in programs.programs()
            for b in p.buckets.values()]


@pytest.fixture
def no_programs():
    programs.release_programs()
    yield
    programs.release_programs()


# the stored goldens, as family/case: q50 and every BC6H, S3TC and ETC case
GOLDEN_REPLAYS = (("bc7/q50",) + tuple(f"bc6h/{c[0]}" for c in BC6H_CASES)
                  + tuple(f"s3tc/{c[0]}" for c in S3TC_CASES)
                  + tuple(f"etc/{c[0]}" for c in ETC_CASES))


def golden_encoder(name, card):
    """(A no-argument encode on the card of the blocks of the stored golden
    `name` (GOLDEN_REPLAYS), through its entry point and Options; the
    stored JAX bytes)."""
    family, _, case = name.partition("/")
    if family == "bc7":
        px, blocks, _ = load_q50()
        return lambda: ckt.encode_bc7(px, quality=50, device=card), blocks
    if family == "bc6h":
        ((_, _, signed, flags, seed_points, rounds),) = [
            c for c in BC6H_CASES if c[0] == case]
        px, blocks, _ = load_bc6h(case)
        encode = ckt.encode_bc6hs if signed else ckt.encode_bc6hu
        opts = ckt.Options(flags=flags, seed_points=seed_points,
                           refine_rounds_bc6h=rounds)
        return lambda: encode(px, opts, device=card), blocks
    if family == "s3tc":
        ((_, fmt, _, fields),) = [c for c in S3TC_CASES if c[0] == case]
        px, blocks, _ = load_s3tc(case)
        return lambda: s3tc_encode(fmt, fields, px, card), blocks
    ((_, entry, _, flags, threshold),) = [c for c in ETC_CASES
                                          if c[0] == case]
    px, _, blocks, _ = load_etc(case)
    return lambda: etc_encode(entry, flags, px, card, threshold), blocks


@pytest.mark.parametrize("name", ("bc7_q5", "bc1", "etc2_punchthrough")
                         + GOLDEN_REPLAYS)
def test_replayed_bytes_equal_eager_bytes(card, no_programs, name):
    """The first call (op by op on the static input), the second (capture,
    then replay) and the third (replay) give the bytes of the body run op
    by op under programs.eager(); each bucket is captured once. A stored
    golden's configuration gives the golden's bytes on every call."""
    if "/" in name:
        encode, golden = golden_encoder(name, card)
    else:
        encode, golden = graph_encoders(card)[name], None
    with programs.eager():
        want = encode()
    if golden is not None:
        np.testing.assert_array_equal(want.cpu().numpy(), golden)
    assert not any(graph_captures())
    for _ in range(3):
        torch.testing.assert_close(encode(), want, rtol=0, atol=0)
    assert graph_captures() and set(graph_captures()) == {1}


def test_programs_replay_out_of_capture_order(card, no_programs):
    """Two programs captured in order into the one shared pool, then
    replayed A, B, A, B, B, A: each call gives its eager bytes."""
    encoders = graph_encoders(card)
    with programs.eager():
        want = {k: encoders[k]() for k in ("bc7_q5", "bc1")}
    for name in ("bc7_q5", "bc1") * 2 + ("bc7_q5", "bc1", "bc7_q5", "bc1",
                                         "bc1", "bc7_q5"):
        torch.testing.assert_close(encoders[name](), want[name], rtol=0,
                                   atol=0)
    assert graph_captures() == [1, 1]


def test_release_programs_lowers_reserved_memory(card, no_programs):
    encoders = graph_encoders(card)
    for _ in range(2):
        for encode in encoders.values():
            encode()
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(card)
    programs.release_programs()
    assert programs.programs() == []
    assert torch.cuda.memory_reserved(card) < held


def test_second_call_in_a_bucket_captures_no_more(card, no_programs):
    """40 and 72 blocks share the 256-block bucket: the second call
    captures it, and no later call in the bucket captures again; the
    kernels' launches count on every replay."""
    px = blockgen.mixed_blocks(72, seed=812)
    with programs.eager():
        want = ckt.encode_bc7(px, quality=5, device=card)
    for n in (40, 72, 40, 72, 72):
        got, launched = csrc_launches(
            lambda: ckt.encode_bc7(px[:n], quality=5, device=card))
        torch.testing.assert_close(got, want[:n], rtol=0, atol=0)
        assert all(launched[k] > 0 for k in BC7_LIBRARIES), launched
    (program,) = programs.programs()
    assert list(program.buckets) == [(256, 16, 4)]
    assert program.buckets[(256, 16, 4)].captures == 1


def test_a_buckets_first_call_and_capture_are_timed_builds(
        card, no_programs, monkeypatch):
    """A bucket's first call and its capture are each one build, each timed
    up to a synchronize of the card; the replays after them build
    nothing."""
    px = blockgen.mixed_blocks(300, seed=813)
    with programs.eager():
        want = ckt.encode_bc7(px, quality=5, device=card)
    synced = []
    synchronize = torch.cuda.synchronize

    def logged(device=None):
        synchronize(device)
        synced.append((device, tracing.now_ns()))

    monkeypatch.setattr(torch.cuda, "synchronize", logged)
    n = len(tracing.builds())
    for _ in range(4):
        got = ckt.encode_bc7(px, quality=5, device=card)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    builds = [b for b in tracing.builds()[n:] if b.name != "kernel_build"]
    assert [(b.name, b.attrs) for b in builds] == [
        ("first_call", {"bucket": 512}), ("capture", {"bucket": 512})]
    assert builds[0].end <= builds[1].start
    for b in builds:
        assert any(d is not None and torch.device(d).type == "cuda"
                   and b.start <= t <= b.end
                   for d, t in synced), (b, synced)


def test_a_buckets_first_call_records_its_stages_and_replays_none(
        card, no_programs, monkeypatch):
    """BC3 at Flags.BETTER: the bucket's first call records the alpha half,
    the exhaustive search and the colour half, inside its build and each
    ending with a synchronize of the card; the capture and the replays
    record none, and nothing synchronizes while the capture runs; the
    bytes stay the op-by-op bytes."""
    px = blockgen.alpha_blocks(300, seed=2202)
    options = ckt.Options(flags=ckt.Flags.BETTER)
    with programs.eager():
        want = ckt.encode_bc3(px, options, device=card)
    synced = []
    synchronize = torch.cuda.synchronize

    def logged(device=None):
        capturing = torch.cuda.is_current_stream_capturing()
        synchronize(device)
        synced.append((device, tracing.now_ns(), capturing))

    monkeypatch.setattr(torch.cuda, "synchronize", logged)
    n, m = len(tracing.stages()), len(tracing.builds())
    for _ in range(4):
        got = ckt.encode_bc3(px, options, device=card)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    stages = tracing.stages()[n:]
    first, capture = [b for b in tracing.builds()[m:]
                      if b.name != "kernel_build"]
    assert (first.name, capture.name) == ("first_call", "capture")
    assert [(s.name, s.attrs) for s in stages] == [
        ("s3tc.alpha", {"bucket": 512}),
        ("s3tc.exhaustive", {"blocks": 512, "pairs": 512 * 965,
                             "bucket": 512}),
        ("s3tc.color", {"bucket": 512})]
    for s in stages:
        assert first.start <= s.start <= s.end <= first.end
        assert any(d is not None and torch.device(d).type == "cuda"
                   and s.end - 10**6 <= t <= s.end
                   for d, t, _ in synced), (s, synced)
    assert not any(capturing for _, _, capturing in synced)
