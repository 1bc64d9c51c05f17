"""The port's plain kernel versions against the JAX package's Pallas
kernels, run in interpret mode on the CPU, on identical packed inputs.

The port's kernels take un-padded candidate lanes and, for the
single-plane search, per-shape PCA lines; the helpers here build the
JAX kernels' padded [N, K] inputs from the same values. Tolerance 0: f32
outputs are compared as int32 bits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convectionkernels_tpu.bc7_plan import plan_from_quality as jax_plan
from convectionkernels_tpu.models import bc7 as jax_bc7
from convectionkernels_tpu.models import bc7_kernel as jax_kernel
from convectionkernels_tpu_torch import Options
from convectionkernels_tpu_torch.bc7_plan import plan_from_quality
from convectionkernels_tpu_torch.models import bc7 as port_bc7
from convectionkernels_tpu_torch.models import bc7_kernel as port_kernel
from convectionkernels_tpu_torch.models.bc7_common import MODE_INFO
from convectionkernels_tpu_torch.tables import bc7_geometry as geom
from tests import blockgen


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    machine's cores, where the intra-op threads of several workers
    oversubscribe them (the port's encodes pad small batches to 256-block
    buckets, so each call here does a bucket's work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CW = [np.float32(w) for w in Options().channel_weights()]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(port, ref, what):
    port, ref = bits(port), bits(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    bad = np.argwhere(port != ref)
    assert bad.size == 0, (f"{what}: {len(bad)} of {port.size} differ; "
                           f"first at {bad[0].tolist()}")


def corpus(n=8, seed=11):
    """n blocks: gradient, alpha and punch-through."""
    px = np.concatenate([blockgen.gradient_blocks(n, seed),
                         blockgen.alpha_blocks(n, seed + 1)])
    px[n // 2:n, :, 3] = np.where(px[n // 2:n, :, 3] < 128, 0, 255)
    rng = np.random.default_rng(seed)
    return px[rng.permutation(len(px))[:n]].reshape(n, 64).astype(np.int32)


def port_shape_pca(pix, shape_ids, nch, with_alpha, uniform=False):
    masks = geom.shape_masks()[shape_ids]
    return port_kernel.shape_pca(
        torch.as_tensor(pix),
        torch.as_tensor(port_kernel.shape_mask_bits(masks)), nch, CW,
        uniform, with_alpha)


@pytest.mark.parametrize("nch,with_alpha", [(3, True), (4, False)])
def test_shape_pca(nch, with_alpha):
    pix = corpus()
    plan = plan_from_quality(5)
    ids = np.asarray(plan.rgb_shape_list if nch == 3
                     else plan.rgba_shape_list, dtype=np.int32)
    base, offset, alpha = port_shape_pca(pix, ids, nch, with_alpha)
    ref = jax_kernel.shape_pca(jnp.asarray(pix), geom.shape_masks()[ids],
                               nch, CW, False, with_alpha, interpret=True)
    for ch in range(nch):
        assert_bits_equal(base[..., ch].numpy(), ref[0][ch], f"base {ch}")
        assert_bits_equal(offset[..., ch].numpy(), ref[1][ch],
                          f"offset {ch}")
    if with_alpha:
        assert_bits_equal(alpha.numpy(), ref[2], "alpha")


# --- the member walk of csrc/shape_pca.cu -----------------------------------------

FLT_MAX = float(np.float32(3.4028234663852886e38))


def member_walk_pca(pix, mask_bits, nch, cw, uniform):
    """shape_pca as csrc/shape_pca.cu computes it, op by op in float32:
    every pass walks only a shape's member pixels, in ascending order, and
    adds a member's terms without the multiply by its weight (exactly 1).
    Vectorized over shapes: step k visits each shape's k-th member and
    leaves the shapes with fewer members as they are."""
    n, s = pix.shape[0], len(mask_bits)
    members = [[px for px in range(16) if (int(m) >> px) & 1]
               for m in mask_bits]
    steps = max(len(ms) for ms in members)
    idx = torch.tensor([ms + [0] * (steps - len(ms)) for ms in members])
    live = torch.tensor([[k < len(ms) for k in range(steps)]
                         for ms in members])
    ipx = torch.as_tensor(pix).reshape(n, 16, 4)
    pw = ipx.to(torch.float32) * torch.tensor(np.asarray(cw, np.float32))
    walk = [(live[:, k], pw[:, idx[:, k], :]) for k in range(steps)]
    zero = torch.zeros((n, s), dtype=torch.float32)

    centroid = [zero] * nch
    for on, v in walk:
        centroid = [torch.where(on, c + v[..., ch], c)
                    for ch, c in enumerate(centroid)]
    count = torch.tensor([float(len(ms)) for ms in members])
    denom = torch.where(count == 0, torch.ones_like(count), count)
    centroid = [c / denom for c in centroid]

    cov = [zero] * (nch * (nch + 1) // 2)
    for on, v in walk:
        diff = [v[..., ch] - centroid[ch] for ch in range(nch)]
        terms = [diff[r] * diff[c] for r in range(nch) for c in range(r + 1)]
        cov = [torch.where(on, a + t, a) for a, t in zip(cov, terms)]

    approx = [torch.ones_like(zero)] * nch
    for _ in range(8):
        product = []
        for row in range(nch):
            index, total = row * (row + 1) // 2, None
            for col in range(nch):
                term = approx[col] * cov[index]
                total = term if total is None else total + term
                index += col + 1 if col >= row else 1
            product.append(total)
        largest = product[0]
        for p in product[1:]:
            largest = torch.maximum(largest, p)
        largest = torch.where(largest == 0, torch.ones_like(largest), largest)
        approx = [p / largest for p in product]
    length = approx[0] * approx[0]
    for a in approx[1:]:
        length = length + a * a
    length = torch.from_numpy(np.sqrt(length.numpy()))   # correctly rounded
    length = torch.where(length == 0, torch.ones_like(length), length)
    direction = [a / length for a in approx]

    lo = torch.full_like(zero, FLT_MAX)
    hi = torch.full_like(zero, -FLT_MAX)
    for on, v in walk:
        dist = direction[0] * (v[..., 0] - centroid[0])
        for ch in range(1, nch):
            dist = dist + direction[ch] * (v[..., ch] - centroid[ch])
        lo = torch.where(on, torch.minimum(lo, dist), lo)
        hi = torch.where(on, torch.maximum(hi, dist), hi)
    base, offset = [], []
    for ch in range(nch):
        mn = centroid[ch] + direction[ch] * lo
        mx = centroid[ch] + direction[ch] * hi
        base.append(mn / float(cw[ch]))
        offset.append((mx - mn) / float(cw[ch]))

    agg = torch.zeros((n, s), dtype=torch.int32)
    for k in range(steps):
        d = 255 - ipx[:, idx[:, k], 3]
        agg = torch.where(live[:, k], agg + d * d, agg)
    alpha = agg.to(torch.float32)
    if not uniform:
        alpha = alpha * float(np.float32(cw[3]) * np.float32(cw[3]))
    pad = [zero] * (4 - nch)
    return (torch.stack(base + pad, -1), torch.stack(offset + pad, -1),
            alpha)


def extreme_blocks(n, seed):
    """Blocks whose every channel value is 0 or 255."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(n, 16, 4)) * 255).astype(np.uint8)


PREMISE_BLOCKS = {
    "random": lambda: blockgen.random_blocks(32, seed=31),
    # covariance 0 and the power iteration's largest 0: safe_denom applies
    "flat": lambda: blockgen.flat_blocks(32, seed=32),
    "extremes": lambda: extreme_blocks(32, seed=33),
}


@pytest.mark.parametrize("uniform", (False, True), ids=("weighted", "uniform"))
@pytest.mark.parametrize("nch", (3, 4))
@pytest.mark.parametrize("blocks", sorted(PREMISE_BLOCKS))
def test_member_walk_equals_shape_pca_plain(blocks, nch, uniform):
    """The redesigned kernel's premise: walking only the member pixels,
    without the multiply by a weight of 1, gives shape_pca_plain's bits
    (its 16-pixel walk with weights 0 and 1) on all 243 shapes and on the
    16 one-member shapes."""
    pix = PREMISE_BLOCKS[blocks]().reshape(32, 64).astype(np.int32)
    cw = ([np.float32(1.0)] * 4 if uniform else CW)
    bits_ = np.concatenate([port_kernel.shape_mask_bits(geom.shape_masks()),
                            (1 << np.arange(16)).astype(np.int32)])
    assert len(bits_) == 243 + 16
    want = port_kernel.shape_pca_plain(torch.as_tensor(pix),
                                       torch.as_tensor(bits_), nch, cw,
                                       uniform, True)
    got = member_walk_pca(pix, bits_, nch, cw, uniform)
    for name, g, w in zip(("base", "offset", "alpha"), got, want):
        assert_bits_equal(g.numpy(), w.numpy(), name)


def single_plane_inputs(mode, pix, plan, flags_fast=True, respect_pt=True):
    """The port's inputs of one mode's single-plane launch (as models/bc7.py
    builds them), plus the JAX kernel's padded equivalents."""
    info = MODE_INFO[mode]
    is_rgb = mode < 4
    parity_max = {"per_ep": 4, "per_subset": 2}.get(info["pbit"], 1)
    shape_list = {1: geom.SHAPE_LIST_1, 2: geom.SHAPE_LIST_2}.get(
        info["num_subsets"], geom.SHAPE_LIST_3_SHORT
        if info["partition_bits"] == 4 else geom.SHAPE_LIST_3)
    seeds_all = (plan.seed_points_for_shape_rgb if is_rgb
                 else plan.seed_points_for_shape_rgba)
    ids = np.asarray([s for s in shape_list if seeds_all[s] > 0], np.int32)
    seeds = np.asarray([min(seeds_all[s], 4) for s in ids], np.int32)
    masks = geom.shape_masks()[ids]
    base, offset, alpha = port_shape_pca(pix, ids, 3 if is_rgb else 4,
                                         is_rgb)
    n = pix.shape[0]
    alpha_px = pix[:, 3::4]
    is_pt = ((alpha_px == 0) | (alpha_px == 255)).all(axis=1)
    pti = np.zeros((n, 4), np.int32)
    if respect_pt and mode in (6, 7):
        pti[:, 0] = is_pt & (alpha_px.max(axis=1) > 0)
        pti[:, 1:parity_max - 1] = is_pt[:, None]
        pti[:, parity_max - 1] = is_pt & (alpha_px.min(axis=1) < 255)
    lane_i, tweakf, c_max = port_kernel.single_plane_lanes(
        seeds, parity_max, 1 << info["index_bits"], masks)
    if alpha is None:
        alpha = torch.zeros(base.shape[:2])
    cfg = dict(fast_indexing=flags_fast, uniform=False,
               cw_sq=[float(w * w) for w in CW],
               num_real_channels=3 if is_rgb else 4,
               index_range=1 << info["index_bits"])
    port_args = (mode, torch.as_tensor(pix), base, offset, alpha,
                 torch.as_tensor(pti), torch.as_tensor(lane_i),
                 torch.as_tensor(tweakf), c_max, cfg, CW)

    # the JAX kernel's layout: [N, K] lanes padded to a multiple of 128
    k = lane_i.shape[1]
    k_pad = max(-(-k // 128) * 128, 128)
    s_of_k = lane_i[0]

    def lanes_of(arr, fill=0.0):
        out = np.full((n, k_pad), fill, np.float32)
        out[:, :k] = arr[:, s_of_k]
        return jnp.asarray(out)

    base_k = [lanes_of(base[..., ch].numpy()) for ch in range(4)]
    offset_k = [lanes_of(offset[..., ch].numpy()) for ch in range(4)]
    invalid = (lane_i[2][None, :] == 0) | (pti[:, lane_i[1]] != 0)
    alpha_k = np.full((n, k_pad), np.inf, np.float32)
    alpha_k[:, :k] = np.where(invalid, np.inf, alpha.numpy()[:, s_of_k])
    consts = np.zeros((19, k_pad), np.int32)
    consts[0, :k] = lane_i[1] & 1
    consts[1, :k] = (lane_i[1] >> 1) & 1
    for px in range(16):
        consts[2 + px, :k] = (lane_i[3] >> px) & 1
    consts[18, :k] = lane_i[4]
    tweak_pad = np.zeros((2, k_pad), np.float32)
    tweak_pad[:, :k] = tweakf
    jax_args = (mode, jnp.asarray(pix), base_k, offset_k, tweak_pad,
                jnp.asarray(alpha_k), consts, c_max, cfg, CW)
    return port_args, jax_args, k


@pytest.mark.parametrize("mode", [1, 6])
def test_single_plane_mode_best(mode):
    pix = corpus()
    port_args, jax_args, k = single_plane_inputs(mode, pix,
                                                 plan_from_quality(5))
    got = port_kernel.single_plane_mode_best(*port_args, 2)
    ref = jax_kernel.single_plane_mode_best(*jax_args, 2, interpret=True)
    for name, g, r in zip(("err", "rank", "pk0", "pk1"), got, ref):
        assert_bits_equal(g.numpy(), np.asarray(r)[:, :k], name)


def test_dual_plane_best():
    pix = corpus()
    combos = port_bc7._dual_plane_combos(plan_from_quality(5))
    assert combos == jax_bc7._dual_plane_combos(jax_plan(5))
    ci, cf = port_kernel.dual_plane_consts(combos, CW)
    got = port_kernel.dual_plane_best(torch.as_tensor(pix),
                                      torch.as_tensor(ci),
                                      torch.as_tensor(cf), 2, False, False,
                                      port_kernel.dual_plane_work(ci, cf,
                                                                  "cpu"))
    ref = jax_kernel.dual_plane_best(jnp.asarray(pix), combos, CW, 2, False,
                                     False, interpret=True)
    lanes = ci.shape[1]
    for key, value in got.items():
        r = np.asarray(ref[key])
        if value.dim() == 3:
            r = r.reshape(r.shape[0], value.shape[1], -1)
        assert_bits_equal(value.numpy(), r[..., :lanes], key)
