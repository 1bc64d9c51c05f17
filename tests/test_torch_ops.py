"""The port's ops (convectionkernels_tpu_torch.ops, models/bc7_common)
against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
(run op by op) and its PyTorch counterpart. Tolerance 0: float32 results
are compared as int32 bits, integers as integers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convectionkernels_tpu.models import bc7_common as jax_common
from convectionkernels_tpu.ops import exact_math as jax_exact
from convectionkernels_tpu.ops import index_select as jax_index
from convectionkernels_tpu.ops import lanes as jax_lanes
from convectionkernels_tpu.ops import pca as jax_pca
from convectionkernels_tpu.ops import refine as jax_refine
from convectionkernels_tpu_torch import Options
from convectionkernels_tpu_torch.models import bc7_common as port_common
from convectionkernels_tpu_torch.ops import exact_math as port_exact
from convectionkernels_tpu_torch.ops import index_select as port_index
from convectionkernels_tpu_torch.ops import lanes as port_lanes
from convectionkernels_tpu_torch.ops import pca as port_pca
from convectionkernels_tpu_torch.ops import refine as port_refine
from convectionkernels_tpu_torch.tables import bc7_geometry as geom
from tests import blockgen

CW = [np.float32(w) for w in Options().channel_weights()]
N = 96


def bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(port, ref, what=""):
    p, r = bits(port), bits(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    bad = np.argwhere(p != r)
    assert bad.size == 0, f"{what}: {len(bad)} of {p.size} differ, first at {bad[0]}"


def assert_lists_same(port, ref, what=""):
    assert len(port) == len(ref), what
    for i, (p, r) in enumerate(zip(port, ref)):
        assert_same(p, r, f"{what}[{i}]")


def both(a):
    """numpy array -> (torch tensor, jnp array)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def pixels(seed=3):
    """[N, 16, 4] int32 block pixels: mixed, alpha and punch-through."""
    px = np.concatenate([blockgen.mixed_blocks(N // 2, seed),
                         blockgen.alpha_blocks(N // 2, seed + 1)])
    px[N // 4:N // 2, :, 3] = np.where(px[N // 4:N // 2, :, 3] < 128, 0, 255)
    return px.astype(np.int32)


def pixel_lists(px):
    """16 x 4 int tensors / arrays and their float views, both sides."""
    ti = [[both(px[:, p, c]) for c in range(4)] for p in range(16)]
    port_i = [[t for t, _ in row] for row in ti]
    jax_i = [[j for _, j in row] for row in ti]
    port_f = [[port_lanes.to_float(v) for v in row] for row in port_i]
    jax_f = [[jax_lanes.to_float(v) for v in row] for row in jax_i]
    return port_i, jax_i, port_f, jax_f


# --- lanes --------------------------------------------------------------------

def test_lanes_rounding_and_clamp():
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.uniform(-300, 600, 4096).astype(np.float32),
        np.arange(-8, 520, dtype=np.float32) + np.float32(0.5),
        np.float32([-0.0, 0.0, 254.5, 255.49998, 0.49999997, -0.5]),
    ])
    tv, jv = both(v)
    assert_same(port_lanes.round_and_convert_to_int_nearest(tv),
                jax_lanes.round_and_convert_to_int_nearest(jv))
    assert port_lanes.round_and_convert_to_int_nearest(tv).dtype == torch.int32
    # by value: max(-0.0, 0.0) is -0.0 in torch and +0.0 in XLA; every
    # clamp of the encoder feeds floor(x + 0.5), where the sign of a zero
    # cannot show
    np.testing.assert_array_equal(port_lanes.clamp(tv, 0.0, 255.0).numpy(),
                                  np.asarray(jax_lanes.clamp(jv, 0.0, 255.0)))
    assert_same(port_lanes.make_safe_denominator(tv),
                jax_lanes.make_safe_denominator(jv))
    a = rng.integers(0, 256, 4096).astype(np.int32)
    b = rng.integers(0, 256, 4096).astype(np.int32)
    (ta, ja), (tb, jb) = both(a), both(b)
    assert_same(port_lanes.sq_diff_int(ta, tb), jax_lanes.sq_diff_int(ja, jb))
    for range_ in (3, 4, 8, 16):
        for tweak in range(jax_lanes.tweak_rounds_for_range(range_)):
            assert port_lanes.compute_tweak_factors(tweak, range_) == \
                jax_lanes.compute_tweak_factors(tweak, range_)


def test_lanes_lex_min_with_index():
    rng = np.random.default_rng(6)
    # few distinct values so ties are common; +inf marks invalid candidates
    x = rng.integers(0, 6, (N, 37)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf
    x[:4] = np.inf
    tx, jx = both(x)
    pv, pi = port_lanes.lex_min_with_index(tx, 1)
    jv, ji = jax_lanes.lex_min_with_index(jx, 1)
    assert_same(pv, jv, "value")
    assert_same(pi, ji, "index")
    assert_same(pi, jax_lanes.first_argmin(jx, 1), "first_argmin")


# --- exact_math ---------------------------------------------------------------

EDGES = np.float32([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 3.4028235e38, -3.4028235e38,
                    1.17549435e-38, -1.17549435e-38, 2.0 ** -126, 2.0 ** 127,
                    2.0 ** -100, 2.0 ** 100, 65536.0, 255.0, 1e-45, -1e-45,
                    1e-40, 5.877472e-39, 1.5, 3.0])


def exact_inputs(n=1 << 20, seed=8):
    """n f32 pairs over the whole exponent range (every edge value against
    every other too); b is never 0 where a is 0 (no 0/0)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    a = a.view(np.float32).copy()
    b = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    b = b.view(np.float32).copy()
    a[: n // 4] = rng.standard_normal(n // 4).astype(np.float32) * 300
    b[: n // 4] = rng.standard_normal(n // 4).astype(np.float32) * 300
    a[~np.isfinite(a)] = 1.5
    b[~np.isfinite(b)] = 3.0
    ea, eb = np.meshgrid(EDGES, EDGES)
    a[: ea.size], b[: eb.size] = ea.ravel(), eb.ravel()
    b[(a == 0) & (b == 0)] = 3.0
    return a, b


def subnormal(x):
    return (x != 0) & (np.abs(x) < np.float32(1.17549435e-38))


def test_exact_math_matches_jax_and_ieee():
    """Native torch divide, reciprocal and (corrected) sqrt are bit-equal
    to the JAX package's integer emulation wherever no subnormal is an
    input or a result, and equal to numpy's IEEE results everywhere."""
    a, b = exact_inputs()
    (ta, ja), (tb, jb) = both(a), both(b)
    with np.errstate(all="ignore"):
        ieee = {"divide": a / b, "reciprocal": np.float32(1.0) / b,
                "sqrt": np.sqrt(np.abs(a))}
    port = {"divide": port_exact.exact_divide(ta, tb),
            "reciprocal": port_exact.exact_reciprocal(tb),
            "sqrt": port_exact.exact_sqrt(torch.abs(ta))}
    ref = {"divide": jax_exact.exact_divide(ja, jb),
           "reciprocal": jax_exact.exact_reciprocal(jb),
           "sqrt": jax_exact.exact_sqrt(jnp.abs(ja))}
    ins = {"divide": (a, b), "reciprocal": (b,), "sqrt": (a,)}
    for name in port:
        assert_same(port[name], ieee[name], f"{name} vs IEEE")
        normal = ~subnormal(ieee[name])
        for x in ins[name]:
            normal &= ~subnormal(x)
        assert normal.sum() > 900_000
        assert_same(bits(port[name])[normal], bits(ref[name])[normal],
                    f"{name} vs JAX")


# --- pca ----------------------------------------------------------------------

@pytest.mark.parametrize("nch,masked", [(3, True), (4, True), (3, False)])
def test_pca_endpoints(nch, masked):
    px = pixels(11)
    rng = np.random.default_rng(12)
    shapes = rng.integers(0, len(geom.shape_masks()), N)
    member = geom.shape_masks()[shapes]                    # [N, 16] bool
    port_i, jax_i, port_f, jax_f = pixel_lists(px)
    port_pw = [[port_f[p][c] * float(CW[c]) for c in range(nch)]
               for p in range(16)]
    jax_pw = [[jax_f[p][c] * CW[c] for c in range(nch)] for p in range(16)]
    if masked:
        masks = [both(member[:, p]) for p in range(16)]
        port_w = [m.to(torch.float32) for m, _ in masks]
        jax_w = [j.astype(jnp.float32) for _, j in masks]
        port_m, jax_m = [m for m, _ in masks], [j for _, j in masks]
    else:
        port_w = [torch.ones(N)] * 16
        jax_w = [jnp.ones(N, jnp.float32)] * 16
        port_m = jax_m = None
    port_sel = port_pca.endpoint_selector(port_pw, port_w, nch,
                                          member_mask=port_m)
    jax_sel = jax_pca.endpoint_selector(jax_pw, jax_w, nch, member_mask=jax_m)
    assert_lists_same(port_sel[0], jax_sel[0], "centroid")
    assert_lists_same(port_sel[1], jax_sel[1], "direction")
    assert_same(port_sel[2], jax_sel[2], "min_dist")
    assert_same(port_sel[3], jax_sel[3], "max_dist")
    port_bo = port_pca.get_endpoints(*port_sel, [float(w) for w in CW], nch)
    jax_bo = jax_pca.get_endpoints(*jax_sel, CW, nch)
    assert_lists_same(port_bo[0], jax_bo[0], "base")
    assert_lists_same(port_bo[1], jax_bo[1], "offset")
    for range_ in (4, 8, 16):
        for tweak in range(4):
            p0, p1 = port_pca.finish_ldr(*port_bo, tweak, range_, nch)
            j0, j1 = jax_pca.finish_ldr(*jax_bo, tweak, range_, nch)
            assert_lists_same(p0 + p1, j0 + j1, f"finish_ldr {tweak} {range_}")


# --- IndexSelector ------------------------------------------------------------

def random_endpoints(rng, nch):
    eps = rng.integers(0, 256, (2, nch, N)).astype(np.int32)
    eps[:, :, :8] = eps[0:1, :, :8]                        # degenerate lines
    return ([[both(eps[j, c]) for c in range(nch)] for j in range(2)])


@pytest.mark.parametrize("nch,range_", [(4, 4), (4, 8), (4, 16), (3, 4),
                                        (3, 8), (1, 4)])
def test_index_selector(nch, range_):
    rng = np.random.default_rng(20 + nch * range_)
    eps = random_endpoints(rng, nch)
    port_ep = [[t for t, _ in row] for row in eps]
    jax_ep = [[j for _, j in row] for row in eps]
    cw = CW[:nch] if nch > 1 else [np.float32(1.0)]
    port_sel = port_index.IndexSelector(cw, port_ep, range_, nch)
    jax_sel = jax_index.IndexSelector(cw, jax_ep, range_, nch)
    _, _, port_f, jax_f = pixel_lists(pixels(21))
    for p in range(16):
        pi = port_sel.select_index_ldr(port_f[p][:nch])
        ji = jax_sel.select_index_ldr(jax_f[p][:nch])
        assert_same(pi, ji, f"index px {p}")
        assert_lists_same(port_sel.reconstruct_ldr_bc7(pi),
                          jax_sel.reconstruct_ldr_bc7(ji), "reconstruct")
        assert_lists_same(port_sel.reconstruct_ldr_bc7_f32(pi),
                          jax_sel.reconstruct_ldr_bc7_f32(ji), "reconstruct f32")


def test_index_selector_per_lane_range():
    """The dual-plane form: range and weights vary per lane."""
    rng = np.random.default_rng(30)
    eps = random_endpoints(rng, 3)
    port_ep = [[t for t, _ in row] for row in eps]
    jax_ep = [[j for _, j in row] for row in eps]
    ranges = rng.choice([4, 8], N)
    mv = both((ranges - 1).astype(np.float32))
    recip = both(np.float32([port_index.WEIGHT_RECIPROCALS[r]
                             for r in ranges]))
    cw = [both(rng.permutation(np.float32(CW[:3] * (N // 3)))) for _ in range(3)]
    port_sel = port_index.IndexSelector([t for t, _ in cw], port_ep,
                                        (mv[0], recip[0]), 3)
    jax_sel = jax_index.IndexSelector([j for _, j in cw], jax_ep,
                                      (mv[1], recip[1]), 3)
    _, _, port_f, jax_f = pixel_lists(pixels(31))
    for p in range(16):
        pi = port_sel.select_index_ldr(port_f[p][:3])
        ji = jax_sel.select_index_ldr(jax_f[p][:3])
        assert_same(pi, ji, f"index px {p}")
        assert_lists_same(port_sel.reconstruct_ldr_bc7_f32(pi),
                          jax_sel.reconstruct_ldr_bc7_f32(ji), "reconstruct")


# --- EndpointRefiner ----------------------------------------------------------

@pytest.mark.parametrize("nch,range_,masked", [(4, 4, True), (4, 16, False),
                                               (3, 8, True), (3, 4, False)])
def test_endpoint_refiner(nch, range_, masked):
    rng = np.random.default_rng(40 + range_)
    _, _, port_f, jax_f = pixel_lists(pixels(41))
    idx = rng.integers(0, range_, (16, N)).astype(np.int32)
    idx[:, :6] = 0                                  # adenom == 0 lanes
    member = rng.random((16, N)) < 0.6
    member[:, 6:8] = False                          # empty lanes: w == 0
    port_r = port_refine.EndpointRefiner(torch.zeros(N), nch, range_, CW)
    jax_r = jax_refine.EndpointRefiner(jnp.zeros(N, jnp.float32), nch, range_,
                                       CW)
    for p in range(16):
        ti, ji = both(idx[p])
        tm, jm = both(member[p]) if masked else (None, None)
        port_r.contribute_unweighted_pw(
            [port_f[p][c] * float(CW[c]) for c in range(4)], ti, nch, mask=tm)
        jax_r.contribute_unweighted_pw(
            [jax_f[p][c] * CW[c] for c in range(4)], ji, nch, mask=jm)
    p0, p1 = port_r.get_refined_endpoints_ldr(nch)
    j0, j1 = jax_r.get_refined_endpoints_ldr(nch)
    assert_lists_same(p0 + p1, j0 + j1, "refined endpoints")


def test_endpoint_refiner_per_lane_rcp():
    """The dual-plane form: per-lane rcp_max_index and channel weights."""
    rng = np.random.default_rng(50)
    _, _, port_f, jax_f = pixel_lists(pixels(51))
    ranges = rng.choice([4, 8], N)
    rcp = both(np.float32(1.0) / (ranges - 1).astype(np.float32))
    cw = [both(rng.permutation(np.float32(CW[:3] * (N // 3)))) for _ in range(3)]
    rcw = [both(np.float32(1.0) / w.numpy()) for w, _ in cw]
    port_r = port_refine.EndpointRefiner(
        torch.zeros(N), 3, 2, [t for t, _ in cw], rcp_max_index=rcp[0],
        rcp_channel_weights=[t for t, _ in rcw])
    jax_r = jax_refine.EndpointRefiner(
        jnp.zeros(N, jnp.float32), 3, 2, [j for _, j in cw],
        rcp_max_index=rcp[1], rcp_channel_weights=[j for _, j in rcw])
    for p in range(16):
        ti, ji = both((rng.integers(0, 8, N) % ranges).astype(np.int32))
        port_r.contribute_unweighted_pw(
            [port_f[p][c] * cw[c][0] for c in range(3)], ti)
        jax_r.contribute_unweighted_pw(
            [jax_f[p][c] * cw[c][1] for c in range(3)], ji)
    p0, p1 = port_r.get_refined_endpoints_ldr()
    j0, j1 = jax_r.get_refined_endpoints_ldr(stacked=False)
    assert_lists_same(p0 + p1, j0 + j1, "refined endpoints")


# --- bc7_common -----------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2, 3, 6, 7])
def test_compress_endpoints(mode):
    rng = np.random.default_rng(60 + mode)
    eps = rng.integers(0, 256, (2, 4, N)).astype(np.int32)
    par = rng.integers(0, 2, (2, N)).astype(np.int32)
    full = both(np.full(N, 255, np.int32))
    te = [[both(eps[j, c]) for c in range(4)] for j in range(2)]
    (tp0, jp0), (tp1, jp1) = both(par[0]), both(par[1])
    port = port_common.compress_endpoints(
        mode, [[t for t, _ in row] for row in te], tp0, tp1, full[0])
    ref = jax_common.compress_endpoints(
        mode, [[j for _, j in row] for row in te], jp0, jp1, full[1])
    for j in range(2):
        assert_lists_same(port[j], ref[j], f"endpoint {j}")


@pytest.mark.parametrize("fast,uniform,masked,nrc", [
    (True, False, True, 3), (True, True, False, 4), (False, False, True, 4),
    (False, True, False, 3)])
def test_accumulate_error(fast, uniform, masked, nrc):
    rng = np.random.default_rng(70 + 2 * nrc + fast)
    index_range = 8 if nrc == 3 else 16
    px = pixels(71)
    port_i, jax_i, port_f, jax_f = pixel_lists(px)
    eps = rng.integers(0, 256, (2, 4, N)).astype(np.int32)
    if nrc == 3:
        eps[:, 3] = 255
    te = [[both(eps[j, c]) for c in range(4)] for j in range(2)]
    cw = [np.float32(1.0)] * 4 if uniform else CW
    port_sel = port_index.IndexSelector(cw, [[t for t, _ in r] for r in te],
                                        index_range, 4)
    jax_sel = jax_index.IndexSelector(cw, [[j for _, j in r] for r in te],
                                      index_range, 4)
    cfg = dict(fast_indexing=fast, uniform=uniform,
               cw_sq=[float(w * w) for w in cw], num_real_channels=nrc,
               index_range=index_range)
    member = geom.shape_masks()[rng.integers(0, 243, N)]
    port_m = [torch.from_numpy(member[:, p].copy()) for p in range(16)] \
        if masked else None
    # the port takes None for "every pixel"; the JAX function takes masks
    jax_m = [jnp.asarray(member[:, p] | (not masked)) for p in range(16)]
    port_r = port_refine.EndpointRefiner(torch.zeros(N), 4, index_range, cw)
    jax_r = jax_refine.EndpointRefiner(jnp.zeros(N, jnp.float32), 4,
                                       index_range, cw)
    port_pw = [[port_f[p][c] * float(cw[c]) for c in range(4)]
               for p in range(16)]
    jax_pw = [[jax_f[p][c] * cw[c] for c in range(4)] for p in range(16)]
    p_err, p_idx = port_common.accumulate_error(
        port_sel, torch.zeros(N), port_m, port_f, port_i, cfg,
        with_refiner=port_r, pwps=port_pw, keep_indexes=True)
    j_err, j_idx = jax_common.accumulate_error(
        jax_sel, jnp.zeros(N, jnp.float32), jax_m, jax_f, jax_i, cfg,
        with_refiner=jax_r, pwps=jax_pw, keep_indexes=True)
    assert_same(p_err, j_err, "error")
    assert_lists_same(p_idx, j_idx, "indexes")
    p0, p1 = port_r.get_refined_endpoints_ldr(nrc)
    j0, j1 = jax_r.get_refined_endpoints_ldr(nrc)
    assert_lists_same(p0 + p1, j0 + j1, "refined endpoints")
