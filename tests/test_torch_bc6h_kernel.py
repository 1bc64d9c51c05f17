"""The port's BC6H elementwise helpers against the JAX package's, and the
plain version of its kernel against the JAX package's Pallas kernel on
identical inputs: its body run op by op, and the whole of it run in
interpret mode on the CPU.

The port's kernel takes block-major tensors ([N, 48] pixels, [N, 3, 64]
PCA lines) and returns block-major outputs; the JAX kernel takes and
returns block-minor arrays, so the helpers here transpose between the two.
Tolerance 0: float32 outputs are compared as int32 bits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convectionkernels_tpu.models import bc6h as jax_bc6h
from convectionkernels_tpu.models import bc6h_kernel as jax_kernel
from convectionkernels_tpu.ops import lanes as jax_lanes
from convectionkernels_tpu.ops.refine import EndpointRefiner as JaxRefiner
from convectionkernels_tpu.tables import bc6h_layout as jax_layout
from convectionkernels_tpu_torch import Options, cuda_lib
from convectionkernels_tpu_torch.models import bc6h as port_bc6h
from convectionkernels_tpu_torch.models import bc6h_common, bc6h_kernel
from convectionkernels_tpu_torch.ops import lanes as port_lanes
from convectionkernels_tpu_torch.ops.refine import EndpointRefiner
from convectionkernels_tpu_torch.tables import bc6h_layout
from tests.test_torch_goldens import hdr_blocks, hdr_signed_blocks


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


# --- elementwise ---------------------------------------------------------------

def test_twoscl_half_to_float_all_int16():
    v = np.arange(-32768, 32768, dtype=np.int32)
    port = port_lanes.twoscl_half_to_float(torch.as_tensor(v)).numpy()
    ref = np.asarray(jax_lanes.twoscl_half_to_float(jnp.asarray(v)))
    assert_bits_equal(port, ref, "twoscl_half_to_float")


@pytest.mark.parametrize("is_signed", [False, True],
                         ids=["unsigned", "signed"])
def test_quantize_unquantize_every_precision(is_signed):
    lo = -31743 if is_signed else 0
    v = np.arange(lo, 31744, dtype=np.int32)
    for aprec in sorted({m[3] for m in bc6h_common.HDR_MODES}):
        q_port = bc6h_common.quantize_element(torch.as_tensor(v), aprec,
                                              is_signed)
        q_ref = jax_bc6h._quantize_element(jnp.asarray(v), aprec, is_signed)
        assert_bits_equal(q_port.numpy(), q_ref, f"quantize aprec {aprec}")
        u_port, f_port = bc6h_common.unquantize_element(q_port, aprec,
                                                        is_signed)
        u_ref, f_ref = jax_bc6h._unquantize_element(q_ref, aprec, is_signed)
        assert_bits_equal(u_port.numpy(), u_ref, f"unquantize aprec {aprec}")
        assert_bits_equal(f_port.numpy(), f_ref, f"finished aprec {aprec}")


def test_unscale_hdr():
    v = np.arange(-65536, 65536, dtype=np.int32)
    assert_bits_equal(
        bc6h_common.unscale_hdr_signed(torch.as_tensor(v)).numpy(),
        jax_bc6h._unscale_hdr_signed(jnp.asarray(v)), "unscale signed")
    assert_bits_equal(
        bc6h_common.unscale_hdr_unsigned(torch.as_tensor(v)).numpy(),
        jax_bc6h._unscale_hdr_unsigned(jnp.asarray(v)), "unscale unsigned")


def test_hdr_modes_and_layouts_equal():
    assert bc6h_common.HDR_MODES == jax_bc6h.HDR_MODES
    assert bc6h_layout.LAYOUTS == jax_layout.LAYOUTS
    assert (bc6h_layout.HEADER_BITS_PARTITIONED
            == jax_layout.HEADER_BITS_PARTITIONED)
    assert bc6h_layout.HEADER_BITS_SINGLE == jax_layout.HEADER_BITS_SINGLE
    # single modes pack no second-subset field
    for mode_idx, mode in enumerate(bc6h_common.HDR_MODES):
        if not mode[1]:
            assert all(f[0] == "m" or f[0][1] in "wx"
                       for f in bc6h_layout.LAYOUTS[mode_idx])


@pytest.mark.parametrize("is_signed", [False, True],
                         ids=["unsigned", "signed"])
def test_get_refined_endpoints_hdr(is_signed):
    """Masked contributions of 16 pixels, then the HDR solve and clamp."""
    rng = np.random.default_rng(31)
    n, q = 64, 8
    lo = -40000.0 if is_signed else -2000.0
    pw = rng.uniform(lo, 40000.0, size=(16, 3, n, 1)).astype(np.float32)
    index = rng.integers(0, 8, size=(16, n, q)).astype(np.int32)
    mask = rng.random(size=(16, n, q)) < 0.6
    mask[:, :4] = False                    # empty lanes: the adenom == 0 arm
    index[:, 4:8] = 3                      # constant index: adenom == 0 too
    port = EndpointRefiner(torch.zeros((n, q)), 3, 8, CW)
    ref = JaxRefiner(jnp.zeros((n, q), dtype=jnp.float32), 3, 8, CW)
    for px in range(16):
        port.contribute_unweighted_pw(
            [torch.as_tensor(pw[px, ch]) for ch in range(3)],
            torch.as_tensor(index[px]), mask=torch.as_tensor(mask[px]))
        ref.contribute_unweighted_pw(
            [jnp.asarray(pw[px, ch]) for ch in range(3)],
            jnp.asarray(index[px]), mask=jnp.asarray(mask[px]))
    p0, p1 = port.get_refined_endpoints_hdr(is_signed)
    r0, r1 = ref.get_refined_endpoints_hdr(is_signed, stacked=False)
    for ch in range(3):
        assert_bits_equal(p0[ch].numpy(), r0[ch], f"ep0 ch {ch}")
        assert_bits_equal(p1[ch].numpy(), r1[ch], f"ep1 ch {ch}")
    limit = 31743
    assert int(torch.stack(p0 + p1).max()) <= limit
    assert int(torch.stack(p0 + p1).min()) >= (-limit if is_signed else 0)


def test_lex_min_with_index_over_axes():
    """The flat index is row-major over the axes in the order given, and
    ties go to the first index in that order."""
    rng = np.random.default_rng(37)
    x = rng.integers(0, 4, size=(5, 3, 4, 6)).astype(np.float32)
    x[0] = np.inf                                   # no finite candidate
    for axes in ((3, 1, 2), (1, 2), (2,), (-1, 1)):
        pv, pi = port_lanes.lex_min_with_index(torch.as_tensor(x), axes)
        rv, ri = jax_lanes.lex_min_with_index(jnp.asarray(x), axes)
        assert_bits_equal(pv.numpy(), rv, f"value over {axes}")
        assert_bits_equal(pi.numpy(), ri, f"index over {axes}")
        assert pi.dtype == torch.int32
    pv, pi = port_lanes.lex_min_with_index(torch.as_tensor(x), 2)
    rv, ri = jax_lanes.lex_min_with_index(jnp.asarray(x), 2)
    assert_bits_equal(pv.numpy(), rv, "value over one dim")
    assert_bits_equal(pi.numpy(), ri, "index over one dim")
    y = torch.as_tensor(x[1:])
    assert_bits_equal(port_lanes.first_argmin(y, 1).numpy(),
                      jax_lanes.first_argmin(jnp.asarray(x[1:]), 1),
                      "first_argmin")


def test_subset_tables_match_the_reference_group_setup():
    """SUBSET_MEMBER / SUBSET_FIXUPS are the subset-major masks and fixups
    the JAX encoder builds for a partitioned group (bc6h.pack)."""
    from convectionkernels_tpu.tables import bc7_geometry as jax_geom
    sub_mask = np.zeros((32, 2, 16), dtype=bool)
    fixups = np.zeros((32, 2), dtype=np.int32)
    for pp in range(32):
        b = int(jax_geom.PARTITION_MAP_2[pp])
        for px in range(16):
            sub_mask[pp, (b >> px) & 1, px] = True
        fixups[pp, 1] = int(jax_geom.FIXUP_INDEXES_2[pp])
    np.testing.assert_array_equal(
        bc6h_kernel.SUBSET_MEMBER, sub_mask.transpose(1, 0, 2).reshape(64, 16))
    np.testing.assert_array_equal(bc6h_kernel.SUBSET_FIXUPS,
                                  fixups.T.reshape(64))


# --- the kernel's module ---------------------------------------------------------

def group_inputs(px_bits, is_signed):
    """(pix [N, 48] int32, base, offset [N, 3, 64] float32) as the port's
    encoder hands them to the kernel."""
    cw = [float(w) for w in CW[:3]]
    pix = port_bc6h.prepare_pixels(torch.as_tensor(px_bits), is_signed)
    ufep_base, ufep_offset = port_bc6h.pca_lines(pix, cw)
    cols = [2 * p + s for s in range(2) for p in range(32)]
    base = torch.stack([b[:, cols] for b in ufep_base], dim=1).contiguous()
    offset = torch.stack([o[:, cols] for o in ufep_offset],
                         dim=1).contiguous()
    return pix, base, offset


def jax_kernel_args(pix, base, offset, cw, tweaks, refines):
    """The JAX kernel's block-minor inputs and its static round list."""
    cwf = [np.float32(w) for w in cw[:3]]
    active = tuple((t * 3 + r, t, r, r == refines - 1)
                   for t in range(tweaks) for r in range(refines))
    arrays = ([pix.numpy().T]
              + [base[:, ch].numpy().T for ch in range(3)]
              + [offset[:, ch].numpy().T for ch in range(3)])
    return cwf, [w * w for w in cwf], active, arrays


def to_block_major(err, valid, eps, idx, a_count):
    """The JAX kernel's [rows, N] outputs in the port's layout."""
    n = np.asarray(err).shape[-1]
    return (np.asarray(err).reshape(a_count, 64, n).transpose(2, 0, 1),
            np.asarray(valid).astype(np.int32).reshape(
                a_count, 64, n).transpose(2, 0, 1),
            np.asarray(eps).reshape(a_count, 6, 64, n).transpose(3, 0, 1, 2),
            np.asarray(idx).reshape(a_count, 2, 64, n).transpose(3, 0, 1, 2))


def jax_group_interpret(pix, base, offset, aprec, is_signed, fast, uniform,
                        cw, tweaks, refines):
    """The JAX Pallas kernel in interpret mode (one jitted program)."""
    cwf, cw_sq, active, arrays = jax_kernel_args(pix, base, offset, cw,
                                                 tweaks, refines)
    out = jax_kernel.partitioned_group_meta_rounds(
        jnp.asarray(arrays[0]), [jnp.asarray(a) for a in arrays[1:4]],
        [jnp.asarray(a) for a in arrays[4:7]], aprec, is_signed, fast,
        uniform, cwf, cw_sq, active, refines, 8, bc6h_kernel.SUBSET_MEMBER,
        bc6h_kernel.SUBSET_FIXUPS.astype(np.int32), interpret=True)
    return to_block_major(*out, len(active))


class ArrayRef:
    """A kernel ref over a numpy array: reads give JAX arrays."""

    def __init__(self, array):
        self.array = np.array(array)

    def __getitem__(self, key):
        return jnp.asarray(self.array[key])

    def __setitem__(self, key, value):
        self.array[key] = np.asarray(value)


def jax_group_op_by_op(pix, base, offset, aprec, is_signed, fast, uniform,
                       cw, tweaks, refines):
    """The JAX kernel's body called directly, outside pallas_call and jit:
    every operation is dispatched and rounded on its own."""
    cwf, cw_sq, active, arrays = jax_kernel_args(pix, base, offset, cw,
                                                 tweaks, refines)
    a_count, n = len(active), pix.shape[0]
    outs = [ArrayRef(np.zeros((a_count * rows * 64, n), dtype=dtype))
            for rows, dtype in ((1, np.float32), (1, np.int32),
                                (6, np.int32), (2, np.int32))]
    jax_kernel._group_kernel_body(
        aprec, is_signed, fast, uniform, tuple(cwf), tuple(cw_sq), active,
        refines, 8, bc6h_kernel.SUBSET_MEMBER,
        bc6h_kernel.SUBSET_FIXUPS.astype(np.int32),
        *[ArrayRef(a) for a in arrays], *outs)
    return to_block_major(*[o.array for o in outs], a_count)


KERNEL_CASES = (
    # name, signed, fast indexing, uniform, aPrec
    ("unsigned_slow_aprec10", False, False, False, 10),
    ("signed_fast_aprec6", True, True, False, 6),
    ("signed_slow_uniform_aprec11", True, False, True, 11),
)
NAMES = ("err", "valid", "eps", "idx")


def kernel_case_inputs(case):
    _, is_signed, _, uniform, _ = case
    px = (hdr_signed_blocks(128, seed=41) if is_signed
          else hdr_blocks(128, seed=11))
    return group_inputs(px, is_signed), ([1.0, 1.0, 1.0] if uniform else CW)


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_plain_matches_kernel_body_op_by_op(case):
    """2 tweaks x 2 refines (tweak seeding, refinement, dedup and inversion
    all run): every output of the plain version equals the JAX kernel
    body's, bit for bit."""
    _, is_signed, fast, uniform, aprec = case
    (pix, base, offset), cw = kernel_case_inputs(case)
    port = bc6h_kernel.partitioned_group_meta_rounds(
        pix, base, offset, aprec, is_signed, fast, uniform, cw, 2, 2)
    ref = jax_group_op_by_op(pix, base, offset, aprec, is_signed, fast,
                             uniform, cw, 2, 2)
    for name, p, r in zip(NAMES, port, ref):
        assert_bits_equal(p.numpy(), r, name)
    assert port[1].dtype == torch.int32
    # the corpus does exercise dedup
    assert 0 < int(port[1].sum()) < port[1].numel()


@pytest.mark.parametrize("case", KERNEL_CASES[:2],
                         ids=[c[0] for c in KERNEL_CASES[:2]])
def test_plain_matches_pallas_interpret(case):
    """Against the JAX kernel as its own tests run it on the CPU: through
    pallas_call in interpret mode, N = 128 (it needs a multiple of 128).

    That compiled program does not round every float32 operation on its
    own: the refiner's sum of t * value products comes out differently from
    the op-by-op run of the same body (which the test above holds the port
    to), so a refined endpoint can land on the other side of a quantization
    step. Such rows are few (10 of 8,192 in the first case), and each one
    first departs at a refined round, in its endpoints, by one quantized
    step; everything else is equal bit for bit."""
    _, is_signed, fast, uniform, aprec = case
    (pix, base, offset), cw = kernel_case_inputs(case)
    port = [t.numpy() for t in bc6h_kernel.partitioned_group_meta_rounds(
        pix, base, offset, aprec, is_signed, fast, uniform, cw, 2, 2)]
    ref = jax_group_interpret(pix, base, offset, aprec, is_signed, fast,
                              uniform, cw, 2, 2)
    differs = (bits(port[0]) != bits(ref[0])) | (port[1] != ref[1])
    differs |= (port[2] != ref[2]).any(axis=2)
    differs |= (port[3] != ref[3]).any(axis=2)              # [N, A, Q]
    rows = np.argwhere(differs.any(axis=1))
    assert len(rows) <= 82, f"{len(rows)} of {128 * 64} rows differ"  # 1%
    for block, q in rows:
        first = int(np.argmax(differs[block, :, q]))
        assert first % 2 == 1, (block, q, first)     # a refined round
        step = np.abs(port[2][block, first, :, q]
                      - ref[2][block, first, :, q])
        assert step.max() == 1, (block, q, step)


def single_inputs(px_bits, is_signed):
    """(pix [N, 48] int32, base, offset [N, 3] float32) as the port's
    encoder hands them to the single-mode kernel, and the chain's own
    arguments (the whole block's line, column 64 of each channel)."""
    cw = [float(w) for w in CW[:3]]
    pix = port_bc6h.prepare_pixels(torch.as_tensor(px_bits), is_signed)
    ufep_base, ufep_offset = port_bc6h.pca_lines(pix, cw)
    base = torch.stack([b[:, 64] for b in ufep_base], dim=1)
    offset = torch.stack([o[:, 64] for o in ufep_offset], dim=1)
    return pix, base, offset, ([b[:, 64:65] for b in ufep_base],
                               [o[:, 64:65] for o in ufep_offset])


@pytest.mark.parametrize("group", ["partitioned", "single"])
def test_wrapper_takes_any_n_and_counts_no_cpu_launch(group, monkeypatch):
    """On the CPU the wrapper takes any N through its plain version; a
    kernel launch raises."""
    monkeypatch.setattr(cuda_lib, "launch", lambda name, what, *args:
                        pytest.fail(f"{what} launched on the CPU"))
    px = hdr_blocks(12, seed=43)[:5]
    if group == "single":
        pix, base, offset, _ = single_inputs(px, False)
        run, aprec, rows, idx_words = (bc6h_kernel.single_group_meta_rounds,
                                       12, 1, 16)
    else:
        pix, base, offset = group_inputs(px, False)
        run, aprec, rows, idx_words = (
            bc6h_kernel.partitioned_group_meta_rounds, 9, 64, 2)
    err, valid, eps, idx = run(pix, base, offset, aprec, False, False, False,
                               CW, 1, 3)
    assert err.shape == (5, 3, rows) and valid.shape == (5, 3, rows)
    assert eps.shape == (5, 3, 6, rows)
    assert idx.shape == (5, 3, idx_words, rows)
    # each block's rows depend on that block alone
    one = run(pix[2:3], base[2:3], offset[2:3], aprec, False, False, False,
              CW, 1, 3)
    for whole, part in zip((err, valid, eps, idx), one):
        assert_bits_equal(whole[2:3].numpy(), part.numpy(), "block 2")


# --- the single-mode groups' kernel ----------------------------------------------

def test_single_launch_constants_equal_the_jax_packages():
    """The range-16 constants the wrapper hands csrc/bc6h_single.cu: the
    weight reciprocal of 16, the tweak factor pairs of the 4 tweaks at
    range 16 and 1/15, as the JAX package computes them; the channel
    weights' floats as a partitioned group's launch has them."""
    from convectionkernels_tpu.ops.index_select import (
        WEIGHT_RECIPROCALS as JAX_WEIGHT_RECIPROCALS)
    floats, weight_reciprocal = bc6h_kernel._single_launch_constants(CW)
    assert weight_reciprocal == JAX_WEIGHT_RECIPROCALS[16] == 2185
    got = np.array(floats[:], dtype=np.float32)
    tweaks = [jax_lanes.compute_tweak_factors(t, 16) for t in range(4)]
    want_tweaks = np.array([t[0] for t in tweaks] + [t[1] for t in tweaks],
                           dtype=np.float32)
    assert_bits_equal(got[9:17], want_tweaks, "tweak factors at range 16")
    rcp = JaxRefiner(jnp.zeros((1,), dtype=jnp.float32), 3, 16,
                     CW).rcp_max_index
    assert_bits_equal(got[17:18], np.array([rcp], dtype=np.float32),
                      "1/15")
    partitioned, _ = bc6h_kernel._launch_constants(CW)
    assert_bits_equal(got[:9], np.array(partitioned[:9], dtype=np.float32),
                      "channel weights")


SINGLE_CASES = [(aprec, signed, fast) for aprec in (16, 12, 11, 10)
                for signed in (False, True) for fast in (False, True)]


@pytest.mark.parametrize("case", SINGLE_CASES, ids=[
    f"aprec{a}_{'signed' if s else 'unsigned'}_{'fast' if f else 'slow'}"
    for a, s, f in SINGLE_CASES])
def test_single_wrapper_on_cpu_is_the_chain(case, monkeypatch):
    """On the CPU the wrapper returns meta_round_chain's outputs for the
    block's one row (index range 16, every pixel a member, fixup pixel 0)
    as the encoder called it before the kernel, at N = 0, 1 and 37, and
    launches nothing (a kernel launch raises)."""
    monkeypatch.setattr(cuda_lib, "launch", lambda name, what, *args:
                        pytest.fail(f"{what} launched on the CPU"))
    aprec, is_signed, fast = case
    px_all = (hdr_signed_blocks(40, seed=61) if is_signed
              else hdr_blocks(40, seed=67))
    for n in (0, 1, 37):
        pix, base, offset, (cols_b, cols_o) = single_inputs(px_all[:n],
                                                            is_signed)
        got = bc6h_kernel.single_group_meta_rounds(
            pix, base, offset, aprec, is_signed, fast, False, CW, 4, 3)
        want = bc6h_common.meta_round_chain(
            pix, cols_b, cols_o, aprec, is_signed, fast, False, CW, 4, 3, 16,
            torch.ones((1, 16), dtype=torch.bool),
            torch.zeros((1,), dtype=torch.int64))
        shapes = ((n, 12, 1), (n, 12, 1), (n, 12, 6, 1), (n, 12, 16, 1))
        for name, g, w, shape in zip(NAMES, got, want, shapes):
            assert tuple(g.shape) == shape, (name, n)
            assert g.dtype == w.dtype, (name, n)
            assert_bits_equal(g.numpy(), w.numpy(), f"{name} at N = {n}")


def test_single_wrapper_refuses_bad_values():
    px = hdr_blocks(4, seed=71)
    pix, base, offset, _ = single_inputs(px, False)
    run = bc6h_kernel.single_group_meta_rounds
    for aprec in (9, 13, 15, 17):
        with pytest.raises(ValueError):
            run(pix, base, offset, aprec, False, False, False, CW, 4, 3)
    for rounds in ((0, 3), (5, 3), (4, 0), (4, 4)):
        with pytest.raises(ValueError):
            run(pix, base, offset, 16, False, False, False, CW, *rounds)
