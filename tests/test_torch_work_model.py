"""chip_smoke.py's work model, on the CPU: the operation rate its bounds
use and the lanes it counts as needed work.

chip_smoke imports nothing of the port or of torch at import time, and
its work functions take CPU tensors, so these run without a card.
"""

from __future__ import annotations

import numpy as np
import torch

import chip_smoke
from convectionkernels_tpu_torch.models import bc7_kernel


def test_operation_rate_is_the_fma_free_issue_rate():
    # 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz, one operation a lane
    assert chip_smoke.H100_ISSUE_LANE_OPS_PER_S == 132 * 4 * 32 * 1.98e9
    assert abs(chip_smoke.H100_ISSUE_LANE_OPS_PER_S - 33.45e12) < 0.01e12


CFG = dict(fast_indexing=False, uniform=False, num_real_channels=3,
           index_range=8, cw_sq=[1.0] * 4)


def single_plane_args(n, lane_i, pti=None, cpow=2, rounds=2, cfg=CFG):
    """The argument tuple of single_plane_mode_best, at n blocks, for a
    hand-built lane table (columns: shape, parity, slot valid, members,
    rank)."""
    lane_i = torch.as_tensor(np.asarray(lane_i, dtype=np.int32).T.copy())
    k = lane_i.shape[1]
    s = int(lane_i[0].max()) + 1
    if pti is None:
        pti = torch.zeros((n, 4), dtype=torch.int32)
    return (0, torch.zeros((n, 64), dtype=torch.int32),
            torch.zeros((n, s, 4)), torch.zeros((n, s, 4)),
            torch.zeros((n, s)), pti, lane_i, torch.zeros((2, k)), cpow,
            cfg, [1.0] * 4, rounds)


# two shapes of two slots each: shape 0 owns pixels 0-2, shape 1 pixels 4-7
LANE = {"s0p0": [0, 0, 1, 0b111, 0], "s0p1": [0, 1, 1, 0b111, 4],
        "s1p0": [1, 0, 1, 0xF0, 0], "s1p1": [1, 1, 1, 0xF0, 4]}


def ops(n, lanes, **kw):
    return chip_smoke.work_single_plane(single_plane_args(n, lanes, **kw))[1]


def test_single_plane_counts_only_valid_lanes():
    n = 5
    every = [LANE[k] for k in ("s0p0", "s0p1", "s1p0", "s1p1")]
    invalid_last = every[:3] + [[1, 1, 0, 0xF0, 4]]
    # the invalid slot costs nothing: the same as a table without it
    assert ops(n, invalid_last) == ops(n, every[:3], cpow=2)
    # and what it saves is exactly one valid lane of its 4 members
    one_lane = ops(n, [LANE["s1p1"]], cpow=2)
    assert ops(n, every) - ops(n, invalid_last) == one_lane
    # a member pixel costs the same for each lane: shape 1 (4 members)
    # against shape 0 (3 members) differs by one pixel's work, per lane
    per_pixel = ops(n, [LANE["s1p0"]]) - ops(n, [LANE["s0p0"]])
    assert per_pixel > 0
    assert ops(n, [LANE["s1p0"]]) - ops(n, [[1, 0, 1, 0xE0, 0]]) == per_pixel
    # work scales with the blocks
    assert ops(2 * n, every) == 2 * ops(n, every)


def test_single_plane_selects_over_the_modes_channels():
    # ck::Selector<3> for an RGB mode, ck::Selector<4> for an RGBA one
    assert chip_smoke.select_ops(3) == 13 and chip_smoke.select_ops(4) == 16
    assert chip_smoke.select_ops(1) == 7
    assert chip_smoke.selector_init_ops(4) - chip_smoke.selector_init_ops(3) \
        == 8

    def per_pixel(nrc, fast):
        cfg = dict(CFG, num_real_channels=nrc, fast_indexing=fast)
        # one round: the member-pixel work is selection and error only
        return (ops(1, [LANE["s1p0"]], rounds=1, cfg=cfg)
                - ops(1, [[1, 0, 1, 0xE0, 0]], rounds=1, cfg=cfg))

    for fast in (True, False):
        # a fourth channel adds its select terms (a subtract, a multiply
        # and an add) and its error terms, nothing more
        error_terms = 9 if fast else 3 * 11
        assert per_pixel(4, fast) - per_pixel(3, fast) == 3 + error_terms
        # the weight (fast), or three candidates' weights and the retest
        # (slow), beside each channel's error terms
        rest = 3 if fast else 3 * 4 + 10
        assert per_pixel(3, fast) == (chip_smoke.select_ops(3) + rest
                                      + 3 * error_terms)


def test_single_plane_skips_punch_through_parities():
    n = 4
    every = [LANE[k] for k in ("s0p0", "s0p1", "s1p0", "s1p1")]
    pti = torch.zeros((n, 4), dtype=torch.int32)
    pti[1, 1] = 1          # block 1: parity 1 invalid, its lanes need nothing
    parity1 = [LANE["s0p1"], LANE["s1p1"]]
    assert (ops(n, every) - ops(n, every, pti=pti)
            == ops(1, parity1))


def dual_plane_args(n, combos, rounds=2, fast=True):
    ci, cf = bc7_kernel.dual_plane_consts(combos, [1.0, 0.5, 0.25, 1.0])
    return (torch.zeros((n, 64), dtype=torch.int32), torch.as_tensor(ci),
            torch.as_tensor(cf), rounds, False, fast)


def combo(mode, rot, isel, num_tweak=4):
    return dict(mode=mode, rot=rot, isel=isel, num_tweak=num_tweak, seq=0)


def dual_ops(n, combos):
    return chip_smoke.work_dual_plane(dual_plane_args(n, combos))[1]


def test_dual_plane_counts_the_pca_once_per_rotation():
    n = 3
    one = dual_ops(n, [combo(4, 1, 0)])
    same_rotation = dual_ops(n, [combo(4, 1, 0), combo(4, 1, 1)])
    mode5_same_rotation = dual_ops(n, [combo(4, 1, 0), combo(5, 1, 0)])
    two_rotations = dual_ops(n, [combo(4, 1, 0), combo(4, 2, 0)])
    lanes4 = same_rotation - one            # 4 more lanes, no more rotations
    rotation = two_rotations - same_rotation
    assert lanes4 > 0 and rotation > 0
    # one combo is one rotation and its 4 lanes
    assert one == rotation + lanes4
    # modes 4 and 5 of one rotation share its pixels and PCA line
    assert mode5_same_rotation == same_rotation


def test_dual_plane_counts_only_live_lanes():
    n = 3
    full = dual_ops(n, [combo(4, 1, 0), combo(4, 2, 0)])
    lanes4 = (dual_ops(n, [combo(4, 1, 0), combo(4, 1, 1)])
              - dual_ops(n, [combo(4, 1, 0)]))
    # a combo with 2 tweaks has 2 live lanes of its 4
    assert full - dual_ops(n, [combo(4, 1, 0), combo(4, 2, 0, num_tweak=2)]) \
        == lanes4 // 2
    # a rotation whose every lane is dead needs no PCA either
    assert dual_ops(n, [combo(4, 1, 0), combo(4, 2, 0, num_tweak=0)]) \
        == dual_ops(n, [combo(4, 1, 0)])


def test_single_plane_slot_efficiency_counts_invalid_slots_as_spent():
    # shape 0: 2 valid slots of 3 members; shape 1: one valid, one invalid
    # slot of 4 members, which its warp walks all the same
    lanes = [LANE["s0p0"], LANE["s0p1"], LANE["s1p0"], [1, 1, 0, 0xF0, 4]]
    args = single_plane_args(3, lanes)
    assert chip_smoke.single_plane_slot_efficiency([args]) == 10 / 14
    every = [LANE[k] for k in ("s0p0", "s0p1", "s1p0", "s1p1")]
    assert chip_smoke.single_plane_slot_efficiency(
        [single_plane_args(3, every), args]) == 24 / 28


def test_dual_plane_order_lists_live_lanes_and_their_rotations():
    import convectionkernels_tpu_torch as ckt
    from convectionkernels_tpu_torch.models import bc7
    combos = bc7._dual_plane_combos(ckt.plan_from_quality(50))
    ci, cf = bc7_kernel.dual_plane_consts(combos, [1.0, 0.5, 0.25, 1.0])
    order, n_live, n_rot = bc7_kernel.dual_plane_order(ci, cf)
    live = np.flatnonzero(~np.isposinf(cf[0]))
    # q50: 12 combos x 4 tweak slots, 39 live; 4 rotations
    assert (ci.shape[1], n_live, n_rot) == (48, 39, 4)
    assert sorted(order[0]) == list(range(48))
    assert list(order[0, :n_live]) == list(live)

    def rotation(k):
        return (tuple(ci[0:6, k] != 0), cf[7:10, k].tobytes())

    firsts = order[2, :n_rot]
    assert len({rotation(k) for k in firsts}) == n_rot
    for i, k in enumerate(order[0, :n_live]):
        first = firsts[order[1, i]]
        assert rotation(first) == rotation(k) and first <= k


def pca_ops(n, masks, nch=3, with_alpha=False):
    """work_shape_pca's operations for n blocks and the shape masks."""
    args = (torch.zeros((n, 64), dtype=torch.int32),
            torch.as_tensor(np.asarray(masks, dtype=np.int32)), nch,
            [1.0] * 4, False, with_alpha)
    return chip_smoke.work_shape_pca(args)[1]


def test_shape_pca_counts_member_pixels():
    # per member: the centroid's add, the covariance's differences,
    # products and sums, the projection's differences, products, sums, min
    # and max, each over nch channels; no multiply by a weight of 1
    for nch, per_member in ((3, 3 + (3 + 2 * 6) + (3 * 3 + 1)),
                            (4, 4 + (4 + 2 * 10) + (3 * 4 + 1))):
        one, full = pca_ops(1, [0x0001], nch), pca_ops(1, [0xFFFF], nch)
        assert full - one == 15 * per_member
        # how many pixels are members counts, not which
        assert pca_ops(1, [0x8000], nch) == one
        assert pca_ops(1, [0x00FF], nch) == pca_ops(1, [0xAAAA], nch)
        # shapes add up
        assert pca_ops(1, [0x0001, 0xFFFF], nch) == one + full


def test_shape_pca_alpha_term_scales_with_members():
    for nch in (3, 4):
        extra = [pca_ops(1, [m], nch, True) - pca_ops(1, [m], nch, False)
                 for m in (0x0001, 0x0003, 0x00FF, 0xFFFF)]
        # per shape a conversion and the weight; per member 255 - a, its
        # square and the sum
        assert extra == [2 + 3 * k for k in (1, 2, 8, 16)]


def test_shape_pca_ops_are_linear_in_blocks():
    masks = [0x0001, 0x0033, 0xFFFF]
    for nch, with_alpha in ((3, True), (4, False)):
        one = pca_ops(1, masks, nch, with_alpha)
        assert [pca_ops(n, masks, nch, with_alpha) for n in (2, 7, 65536)] \
            == [n * one for n in (2, 7, 65536)]


def test_shape_pca_q50_lists_against_a_hand_count():
    import convectionkernels_tpu_torch as ckt
    from convectionkernels_tpu_torch.tables import bc7_geometry
    plan = ckt.plan_from_quality(50)
    masks = bc7_geometry.shape_masks()
    rgb = bc7_kernel.shape_mask_bits(masks[np.asarray(plan.rgb_shape_list)])
    rgba = bc7_kernel.shape_mask_bits(masks[np.asarray(plan.rgba_shape_list)])
    n = 65536
    # RGB list: 215 shapes, 1,448 member pixels, 3 channels and the alpha
    # error. Per shape: centroid 3 + 3, power iteration 8 x 22, direction
    # 11, endpoints 21, alpha 2; per member 3 + 15 + 10 + 3.
    assert (len(rgb), int(chip_smoke._popcount(rgb).sum())) == (215, 1448)
    rgb_ops = n * (215 * (6 + 176 + 11 + 21 + 2) + 1448 * 31)
    assert pca_ops(n, rgb, 3, True) == rgb_ops
    # RGBA list: 81 shapes, 656 member pixels, 4 channels. Per shape:
    # centroid 4 + 3, power iteration 8 x 37, direction 14, endpoints 28;
    # per member 4 + 24 + 13.
    assert (len(rgba), int(chip_smoke._popcount(rgba).sum())) == (81, 656)
    rgba_ops = n * (81 * (7 + 296 + 14 + 28) + 656 * 41)
    assert pca_ops(n, rgba, 4, False) == rgba_ops
    # both launches bound by operations: about 0.286 ms at the issue rate
    ms = (rgb_ops + rgba_ops) / chip_smoke.H100_ISSUE_LANE_OPS_PER_S * 1e3
    assert abs(ms - 0.2863) < 1e-3
    pix = torch.zeros((n, 64), dtype=torch.int32)
    for masks_, nch, alpha in ((rgb, 3, True), (rgba, 4, False)):
        nbytes, ops = chip_smoke.work_shape_pca(
            (pix, torch.as_tensor(masks_), nch, [1.0] * 4, False, alpha))
        assert chip_smoke.bound_ms(nbytes, ops) == (
            ops / chip_smoke.H100_ISSUE_LANE_OPS_PER_S * 1e3, "operations")


def single_group_args(n, is_signed=False, fast=False, uniform=False,
                      tweaks=4, refines=3):
    """The argument tuple of bc6h_kernel.single_group_meta_rounds at n
    blocks."""
    return (torch.zeros((n, 48), dtype=torch.int32), torch.zeros((n, 3)),
            torch.zeros((n, 3)), 16, is_signed, fast, uniform, [1.0] * 3,
            tweaks, refines)


def test_bc6h_single_is_linear_in_blocks_and_counts_its_outputs():
    for kw in ({}, {"fast": True}, {"is_signed": True, "uniform": True},
               {"tweaks": 1, "refines": 1}):
        nbytes, ops = chip_smoke.work_bc6h_single(single_group_args(1, **kw))
        rounds = kw.get("tweaks", 4) * kw.get("refines", 3)
        # pixels and the block's line in; err, valid, 6 endpoints and 16
        # indexes a round out
        assert nbytes == 48 * 4 + 6 * 4 + rounds * 24 * 4
        for n in (2, 37, 65536):
            assert chip_smoke.work_bc6h_single(single_group_args(n, **kw)) \
                == (n * nbytes, n * ops)


def test_bc6h_single_slow_scan_outweighs_fast_projection():
    """The slow path scans 16 interpolants a pixel, the fast one projects
    once; weighting adds a multiply per channel and pixel; refine rounds
    add the refiner's totals and solve."""
    def ops(**kw):
        return chip_smoke.work_bc6h_single(single_group_args(1, **kw))[1]
    assert ops(fast=False) > 3 * ops(fast=True)
    assert ops() - ops(uniform=True) == 12 * 16 * 3
    assert ops(tweaks=1, refines=2) - ops(tweaks=2, refines=1) > 16 * 26 - 7


def pack_work(modes):
    """chip_smoke.work_bc7_pack of blocks of the given modes."""
    fields = torch.zeros((bc7_kernel.PACK_FIELDS, len(modes)),
                         dtype=torch.int32)
    fields[bc7_kernel.FIELD_MODE] = torch.as_tensor(modes, dtype=torch.int32)
    return chip_smoke.work_bc7_pack((fields,))


def test_bc7_pack_counts_each_blocks_own_mode():
    tables = 5 * 64 * 4
    # mode 6: the mode, 2 endpoints of 4 channels, 16 indexes (25 int32
    # rows); mode 4: the mode, rotation and selector, 8 endpoint channels
    # and 32 indexes (43); mode 1: the mode, the partition, 4 endpoints of
    # 3 channels and 16 indexes (30); each block writes 16 bytes
    for n in (1, 37, 65536):
        assert pack_work([6] * n)[0] == n * (25 * 4 + 16) + tables
    assert pack_work([4])[0] == 43 * 4 + 16 + tables
    assert pack_work([1])[0] == 30 * 4 + 16 + tables
    # mode 4: the mode, rotation and selector, 6 colour and 2 alpha
    # endpoints (11 static fields), 32 index fields; mode 1: the mode, the
    # partition, 12 colour endpoints and 2 p-bits (16), 16 index fields
    ops4, ops1 = 3 * 11 + 12 * 32, 3 * 16 + 12 * 16
    assert pack_work([4])[1] == ops4
    assert pack_work([1])[1] == ops1
    # a block outside modes 0-7 reads its mode, writes zeros, needs nothing
    assert pack_work([4, 1, 1, 9, -1]) == (
        (43 + 2 * 30 + 2) * 4 + 5 * 16 + tables, ops4 + 2 * ops1)
    # a 65,536-block chunk is bound by its bytes in any mode: 2.3-3.7 us
    for m in range(8):
        ms, bound = chip_smoke.bound_ms(*pack_work([m] * 65536))
        assert bound == "bytes" and 0.0022 < ms < 0.0037
    ms, _ = chip_smoke.bound_ms(*pack_work([0] * 65536))
    assert abs(ms - (36 * 4 + 16) * 65536 / 3.35e12 * 1e3) < 1e-6


def alpha_work(n, dtype=torch.uint8, is_signed=False, tweaks=4, refines=8):
    """chip_smoke.work_s3tc_alpha of n blocks, the arguments as
    models/s3tc.py s3tc_alpha takes them."""
    return chip_smoke.work_s3tc_alpha(
        (torch.zeros((n, 16, 4), dtype=dtype), 3, is_signed, tweaks,
         refines))


def test_s3tc_alpha_reads_16_values_and_writes_8_bytes_a_block():
    for n in (1, 37, 65536):
        assert alpha_work(n)[0] == n * (16 + 8)
        assert alpha_work(n, torch.int32, True)[0] == n * (16 * 4 + 8)
        assert alpha_work(n)[1] == n * alpha_work(1)[1]


def test_s3tc_alpha_counts_the_chains_rounds():
    # one tweak, one refine: 5 rounds (the full range, 4 reduced seeds), no
    # refit; 367 a full-range round, 415 a reduced one, 1,512 a block
    # outside the rounds and 18 a chain's seed
    assert alpha_work(1, tweaks=1, refines=1)[1] == 367 + 4 * 415 + 1512 + 90
    # each refine round past the first refits: 158 a chain
    assert (alpha_work(1, tweaks=1, refines=2)[1]
            - alpha_work(1, tweaks=1, refines=1)[1]) == 367 + 4 * 415 + 5 * 158
    # the default Options, 160 rounds: 88,856 operations a block, so a
    # 65,536-block chunk is bound by its operations at 0.17 ms
    assert alpha_work(1)[1] == 88856
    ms, bound = chip_smoke.bound_ms(*alpha_work(65536))
    assert bound == "operations" and 0.17 < ms < 0.18
    # tweaks stop at 4 (TweakRoundsForRange); the signed clamp adds 2 a round
    assert alpha_work(1, tweaks=9) == alpha_work(1)
    assert alpha_work(1, is_signed=True)[1] - alpha_work(1)[1] == 160 * 2
