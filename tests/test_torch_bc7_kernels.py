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
                                      torch.as_tensor(cf), 2, False, False)
    ref = jax_kernel.dual_plane_best(jnp.asarray(pix), combos, CW, 2, False,
                                     False, interpret=True)
    lanes = ci.shape[1]
    for key, value in got.items():
        r = np.asarray(ref[key])
        if value.dim() == 3:
            r = r.reshape(r.shape[0], value.shape[1], -1)
        assert_bits_equal(value.numpy(), r[..., :lanes], key)
