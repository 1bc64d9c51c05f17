"""BC6H's combine (bc6h_kernel.combine, BC67.cpp:2914-2986) on the CPU.

The plain version, which materialises the (partition, meta0, meta1) grid, is
held against a scalar transliteration of the reference's loop: for each
partition, meta0 and meta1 in order, a valid pair whose summed error is
strictly less than the best so far commits with the first mode of the group
that can encode its endpoints, legality tested by truncating each delta and
reconstructing it (EvaluatePartitioned/SingleLegality) rather than by the
plain version's bit test. The oracle shares nothing with the grid
formulation, so it also stands for the CUDA kernel, which the card tests
hold bit for bit against the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from convectionkernels_tpu_torch import Options, cuda_lib
from convectionkernels_tpu_torch.models import bc6h, bc6h_kernel
from convectionkernels_tpu_torch.models.bc6h_common import HDR_MODES
from convectionkernels_tpu_torch.tables import bc7_geometry as geom
from tests.test_torch_goldens import load_bc6h

GROUPS = bc6h.precision_groups()    # (partitioned, aPrec, modes)
MAX_META = bc6h_kernel.MAX_META


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, as for the other BC6H modules:
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int32(v):
    return ((int(v) + 2**31) % 2**32) - 2**31


def _truncate(v, bits):
    """TruncateToPrecisionSigned of an int32 value."""
    half = 1 << (bits - 1)
    return ((_int32(v) + half) % (1 << bits)) - half


def _encode(mode_idx, cand, used, a_mask):
    """EvaluatePartitioned/SingleLegality and the encoded endpoints of
    cand[subset * 2 + endpoint][channel] under one mode, or None where the
    mode cannot encode them."""
    _, _, transformed, _, bprec = HDR_MODES[mode_idx]
    enc = [list(e) for e in cand]
    if not transformed:
        return enc
    for e in range(1, used):
        for c in range(3):
            delta = _truncate(cand[e][c] - cand[0][c], bprec[c])
            if (_int32(delta + cand[0][c]) & a_mask) != (cand[e][c] & a_mask):
                return None
            enc[e][c] = delta
    return enc


def scalar_combine(err, valid, eps, idx, aprec, mode_list, meta_ids,
                   rank_base):
    """The reference's combine, one block at a time, on numpy arrays in the
    chain's layouts; returns numpy arrays of combine's outputs."""
    n, m_count, q_count = err.shape
    partitioned = q_count == 64
    parts, m1_count, used = (32, m_count, 4) if partitioned else (1, 1, 2)
    a_mask = (1 << aprec) - 1
    err_l, valid_l = err.tolist(), valid.tolist()
    eps_l, idx_l = eps.tolist(), idx.tolist()
    out = {k: [] for k in ("err", "rank", "mode", "partition", "ep", "idx")}
    for b in range(n):
        e_b, v_b, ep_b = err_l[b], valid_l[b], eps_l[b]

        def endpoints(p, i0, i1):
            row1 = (i1, 32 + p) if partitioned else (i0, p)
            return [[ep_b[i0][ch][p] for ch in range(3)],
                    [ep_b[i0][3 + ch][p] for ch in range(3)],
                    [ep_b[row1[0]][ch][row1[1]] for ch in range(3)],
                    [ep_b[row1[0]][3 + ch][row1[1]] for ch in range(3)]]

        best, found = np.float32(np.inf), None
        for p in range(parts):
            for i0 in range(m_count):
                for i1 in range(m1_count):
                    if not v_b[i0][p] or (partitioned
                                          and not v_b[i1][32 + p]):
                        continue
                    total = np.float32(e_b[i0][p])
                    if partitioned:
                        total = total + np.float32(e_b[i1][32 + p])
                    if not total < best:
                        continue
                    cand = endpoints(p, i0, i1)
                    for mode_idx in mode_list:
                        enc = _encode(mode_idx, cand, used, a_mask)
                        if enc is not None:
                            best, found = total, (p, i0, i1, mode_idx, enc)
                            break
        if found is None:
            # no candidate: candidate 0 with error +inf, its mode and
            # endpoints worked out all the same
            cand = endpoints(0, 0, 0)
            mode, enc = -1, [[0] * 3 for _ in range(4)]
            for mode_idx in mode_list:
                e = _encode(mode_idx, cand, used, a_mask)
                if e is not None:
                    mode, enc = mode_idx, e
                    break
            found = (0, 0, 0, mode, enc)
        p, i0, i1, mode, enc = found
        pixels = []
        for px in range(16):
            if partitioned:
                s = (int(geom.PARTITION_MAP_2[p]) >> px) & 1
                w = 1 if px >= 10 else 0
                word = idx_l[b][i1 if s else i0][w][s * 32 + p]
                pixels.append((word >> (3 * (px - 10 * w))) & 7)
            else:
                pixels.append(idx_l[b][i0][px][0])
        out["err"].append(best)
        out["rank"].append(rank_base + p * MAX_META * MAX_META
                           + meta_ids[i0] * MAX_META
                           + (meta_ids[i1] if partitioned else 0))
        out["mode"].append(mode)
        out["partition"].append(p)
        out["ep"].append(enc)
        out["idx"].append(pixels)
    return (np.array(out["err"], dtype=np.float32).reshape(n),
            np.array(out["rank"], dtype=np.int32).reshape(n),
            {"mode": np.array(out["mode"], dtype=np.int32).reshape(n),
             "partition": np.array(out["partition"],
                                   dtype=np.int32).reshape(n),
             "ep": np.array(out["ep"], dtype=np.int32).reshape(n, 2, 2, 3),
             "idx": np.array(out["idx"], dtype=np.int32).reshape(n, 16)})


def synthetic_chain(n, m_count, group, seed):
    """Chain outputs of one group for n blocks: errors on a grid of
    quarters, a coarse one in every third block so that sums tie across
    partitions and rounds, some +inf; valid flags at random, with whole
    blocks of invalid rows and of +inf errors; endpoints near a centre per
    block, so that deltas fit some modes' precision and not others."""
    partitioned, aprec, mode_list = group
    rng = np.random.default_rng(seed)
    q = 64 if partitioned else 1
    err = (rng.integers(0, 4000, size=(n, m_count, q)) * 0.25).astype(
        np.float32)
    err[::3] = np.floor(err[::3] / 250.0) * 0.25     # many ties
    err[rng.random(size=err.shape) < 0.05] = np.inf
    valid = (rng.random(size=(n, m_count, q)) < 0.7).astype(np.int32)
    valid[3::7] = 0                                  # no valid pair
    err[5::11] = np.inf                              # every error +inf
    bprecs = [b for m in mode_list for b in HDR_MODES[m][4]]
    centre = rng.integers(-(1 << aprec), 1 << aprec, size=(n, 1, 1, 3, 1))
    spread = rng.choice([1 << (min(bprecs) - 2), 1 << max(bprecs),
                         1 << (aprec + 1)], p=[0.7, 0.2, 0.1],
                        size=(n, m_count, 1, 1, q))        # a row's spread
    offset = rng.integers(-spread, spread + 1, size=(n, m_count, 2, 3, q))
    eps = (centre + offset).reshape(n, m_count, 6, q).astype(np.int32)
    if partitioned:
        idx = rng.integers(-2**31, 2**31, size=(n, m_count, 2, q),
                           dtype=np.int64).astype(np.int32)
    else:
        idx = rng.integers(0, 16, size=(n, m_count, 16, 1), dtype=np.int32)
    return err, valid, eps, idx


def meta_ids_of(tweaks, refines):
    return [t * bc6h.MAX_REFINE_ROUNDS + r for t in range(tweaks)
            for r in range(refines)]


def assert_same(got, want):
    """combine's outputs as tensors against numpy arrays, float32 as bits."""
    g_err, g_rank, g_pay = got
    w_err, w_rank, w_pay = want
    np.testing.assert_array_equal(g_err.numpy().view(np.int32),
                                  w_err.view(np.int32))
    np.testing.assert_array_equal(g_rank.numpy(), w_rank)
    assert g_err.dtype == torch.float32 and g_rank.dtype == torch.int32
    for k in ("mode", "partition", "ep", "idx"):
        assert g_pay[k].dtype == torch.int32, k
        np.testing.assert_array_equal(g_pay[k].numpy(), w_pay[k], err_msg=k)


def as_tensors(chain):
    return [torch.as_tensor(a) for a in chain]


@pytest.mark.parametrize("rounds", [(1, 1), (2, 3), (4, 3)],
                         ids=["1x1", "2x3", "4x3"])
@pytest.mark.parametrize("g", range(len(GROUPS)),
                         ids=[f"{'p' if g[0] else 's'}{g[1]}" for g in GROUPS])
def test_plain_equals_scalar_reference(g, rounds):
    """Every precision group, on synthetic chain outputs with planted ties,
    rows with no valid pair and +inf errors."""
    group = GROUPS[g]
    meta_ids = meta_ids_of(*rounds)
    n = 24 if group[0] else 96
    chain = synthetic_chain(n, len(meta_ids), group, seed=100 + 7 * g
                            + rounds[0])
    rank_base = 3 * 144 + g
    want = scalar_combine(*chain, group[1], group[2], meta_ids, rank_base)
    got = bc6h_kernel.combine_plain(*as_tensors(chain), group[1], group[2],
                                    meta_ids, rank_base)
    assert_same(got, want)
    # the synthetic data reaches every kind of outcome
    mode = want[2]["mode"]
    assert np.isinf(want[0]).any() and np.isfinite(want[0]).any()
    assert (mode >= 0).any()
    if group[0]:
        assert len(set(want[2]["partition"].tolist())) > 4


def test_ties_keep_the_first_in_visitation_order():
    """Equal errors everywhere: the winner is candidate 0 of the first
    encodable pair in (partition, meta0, meta1) order, in both versions."""
    group = GROUPS[4]                       # partitioned, aPrec 11, 3 modes
    meta_ids = meta_ids_of(4, 3)
    err, valid, eps, idx = synthetic_chain(8, 12, group, seed=5)
    err[:] = np.float32(1.5)
    valid[:] = 1
    eps[:] = 100                            # every delta 0: always legal
    valid[1, :, :3] = 0                     # block 1: partitions 0-2 out
    valid[2, :2, 32:] = 0                   # block 2: meta1 0 and 1 out
    want = scalar_combine(err, valid, eps, idx, 11, group[2], meta_ids, 0)
    got = bc6h_kernel.combine_plain(*as_tensors((err, valid, eps, idx)), 11,
                                    group[2], meta_ids, 0)
    assert_same(got, want)
    assert want[2]["partition"][:3].tolist() == [0, 3, 0]
    assert want[1][0] == 0 and want[1][2] == 2      # meta1 id 2 at meta0 0


@pytest.mark.parametrize("n", [0, 1])
def test_plain_takes_any_n(n):
    for group in (GROUPS[0], GROUPS[4]):
        chain = synthetic_chain(max(n, 1), 6, group, seed=9)
        chain = [a[:n] for a in chain]
        meta_ids = meta_ids_of(2, 3)
        want = scalar_combine(*chain, group[1], group[2], meta_ids, 7)
        got = bc6h_kernel.combine_plain(*as_tensors(chain), group[1],
                                        group[2], meta_ids, 7)
        assert_same(got, want)


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On a CPU tensor the wrapper returns the plain version's answer and
    launches nothing (a kernel launch raises)."""
    monkeypatch.setattr(cuda_lib, "launch", lambda name, what, *args:
                        pytest.fail(f"{what} launched on the CPU"))
    group = GROUPS[7]                       # partitioned, aPrec 8, 3 modes
    meta_ids = meta_ids_of(4, 3)
    chain = as_tensors(synthetic_chain(16, 12, group, seed=11))
    got = bc6h_kernel.combine(*chain, group[1], group[2], meta_ids, 5)
    want = bc6h_kernel.combine_plain(*chain, group[1], group[2], meta_ids, 5)
    assert_same(got, (want[0].numpy(), want[1].numpy(),
                      {k: v.numpy() for k, v in want[2].items()}))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_scalar_reference_on_the_encoder_chains(signed, monkeypatch):
    """Every group's real chain outputs in an encode of golden blocks
    (4 x 3 rounds): the combine the encoder calls equals the scalar
    reference, and the bytes stay the golden's."""
    name = "edge_signed" if signed else "default"
    px, blocks, _ = load_bc6h(name)
    px, blocks = px[:6], blocks[:6]
    seen = []
    real = bc6h_kernel.combine

    def checked(*args):
        got = real(*args)
        want = scalar_combine(*[a.numpy() for a in args[:4]], *args[4:])
        assert_same(got, want)
        seen.append(args[4])
        return got

    monkeypatch.setattr(bc6h_kernel, "combine", checked)
    opts = Options()
    out = bc6h.pack(torch.as_tensor(px), opts.flags, opts.channel_weights(),
                    signed, 4, 3)
    assert seen == [g[1] for g in GROUPS]
    if name == "default":
        np.testing.assert_array_equal(out.numpy(), blocks)
