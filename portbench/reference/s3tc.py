"""The benchmark's plain reference encoder of BC1 and BC3: PackRGB
(ConvectionKernels_S3TC.cpp:717-1052) with its exhaustive cluster fit,
and PackInterpolatedAlpha (S3TC.cpp:343-715), composed as
cvtt::Kernels::EncodeBC1 and EncodeBC3 compose them (API.cpp:86-99,
117-131).

It is written for this benchmark from the JAX package's
convectionkernels_tpu/models/s3tc.py, ops/ (lanes, index_select, pca,
refine) and tables/make_tables.py (s3tc_single_color_table), read and not
imported, and shares no code with the program's models/s3tc.py. It
imports torch and numpy only: nothing of the program and nothing of JAX.
Where the program reshapes the work, this file keeps the plain form of
the JAX source, which is CVTT's:

- a block's values are a list of 16 pixels of 3 or 4 [N] tensors, and
  every float32 sum runs pixel by pixel in the reference's order;
- the exhaustive fit's sort keys go through CVTT's insertion-sort
  comparator network (S3TC.cpp:830-843), the alpha values through its
  bubble-sort network (S3TC.cpp:372-385), where the program calls
  torch.sort;
- each count partition's TestEndpoints keeps its own 16 indexes, and the
  winner's are gathered, where the program recomputes the winner's;
- the clipping heuristic is CVTT's loop over (first, last) pairs, the last
  passing pair winning, where the program takes a masked maximum;
- every refine round of the colour search contributes to its refiner,
  the last one too (its refit is never read), as the JAX source does.

Departures from the JAX source, none of which changes a byte:

- the count partitions of the exhaustive fit run over a trailing [N, P]
  axis as there, but the per-element masks are built from the counts
  table in torch on the blocks' device;
- the single-colour tables are derived here (MakeTables, Program.cs:95-148:
  least error in double, then least span, then the first candidate),
  where the JAX package derives them the same way in NumPy;
- the square root is the float64 root rounded to float32, a double
  rounding that cannot miss for a square root; divides and reciprocals are
  torch's float32 `/`, IEEE round-to-nearest on the CPU and on CUDA. Each
  has both operands as tensors: CUDA's divide by a host scalar multiplies
  by its reciprocal. There is no barrier against fused multiply-adds:
  torch runs each multiply and add as its own rounded operation.

Every divide, reciprocal and square root of a float goes through
exact_divide, exact_reciprocal and exact_sqrt below (the output check's
control rounds them to bfloat16). float32 throughout; no matmul, so no
TF32 setting matters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .options import Flags, Options

F = np.float32
F32 = torch.float32
I32 = torch.int32
FLT_MAX = float(np.finfo(np.float32).max)
PARANOIA = F(0.03)         # ParanoidFactorForSpan (S3TC.cpp:71-74)

# g_weightReciprocals (ConvectionKernels_IndexSelector.cpp:43-62): entry r
# is the 2^15 fixed-point reciprocal of r - 1
WEIGHT_RECIPROCALS = (0, 0, 32768, 16384, 10923, 8192, 6554, 5461, 4681,
                      4096, 3641, 3277, 2979, 2731, 2521, 2341, 2185)

# indexOrder of the final BC1 pack (S3TC.cpp:980-1030), by case: 0 range 4
# with equal endpoints, 1 range 4 swapped, 2 range 4 unswapped, 3 range 3
# swapped, 4 range 3 unswapped
INDEX_ORDER = ((0, 0, 0, 0), (1, 3, 2, 0), (0, 2, 3, 1), (1, 2, 0, 3),
               (0, 2, 1, 3))


# --- float helpers the control replaces --------------------------------------

def exact_divide(a, b):
    """float32 a / b, rounded to nearest (IEEE on the CPU and on CUDA);
    both tensors."""
    return a / b


def exact_reciprocal(v):
    """float32 1 / v, rounded to nearest (the scalar build's Reciprocal)."""
    return exact_divide(torch.ones_like(v), v)


def exact_sqrt(x):
    """float32 square root rounded to nearest: the float64 root rounded to
    float32."""
    return torch.sqrt(x.double()).float()


# --- lane math (ParallelMath.h, scalar build) --------------------------------

def to_float(v):
    return v.to(F32)


def round_to_int(v):
    """RoundAndConvert under round-to-nearest: floor(v + 0.5f)."""
    return torch.floor(v + 0.5).to(I32)


def clamp(v, lo: float, hi: float):
    """ParallelMath::Clamp: the minimum first, then the maximum."""
    return torch.clamp_min(torch.clamp_max(v, hi), lo)


def safe_denominator(v):
    """MakeSafeDenominator: 0 -> 1."""
    return torch.where(v == 0.0, torch.ones_like(v), v)


def sq_diff(a, b):
    d = a - b
    return d * d


def full(like, value, dtype=I32):
    return torch.full(like.shape, value, dtype=dtype, device=like.device)


def tweak_factors(tweak: int, range_: int):
    """Util::ComputeTweakFactors (Util.cpp:75-84) in float32."""
    total = range_ - 1
    lo_out = (tweak >> 1) & 1
    hi_out = tweak & 1
    inside = F(total - lo_out - hi_out)
    return -(F(lo_out)) / inside, F(hi_out) / inside + F(1.0)


def tweak_rounds(range_: int) -> int:
    """BCCommon::TweakRoundsForRange (BCCommon.cpp:39-44)."""
    return 3 if range_ == 3 else 4


def first_min(x):
    """The first position of the least value along the last axis: the
    least value, then the least index that holds it."""
    m = x.amin(dim=-1, keepdim=True)
    iota = torch.arange(x.shape[-1], dtype=I32, device=x.device)
    return torch.where(x == m, iota, full(x, x.shape[-1])).amin(dim=-1)


# --- IndexSelector (IndexSelector.h:13-142) ----------------------------------

class IndexSelector:
    """Projection of pixels onto the endpoints' axis: endpoints are two
    lists of `nch` int32 tensors; channel weights are float32 scalars."""

    def __init__(self, weights, endpoints, range_: int, nch: int):
        self.nch, self.range, self.endpoints = nch, range_, endpoints
        self.origin = [to_float(endpoints[0][ch]) for ch in range(nch)]
        diff = [(to_float(endpoints[1][ch]) - self.origin[ch]) * weights[ch]
                for ch in range(nch)]
        len_sq = diff[0] * diff[0]
        for ch in range(1, nch):
            len_sq = len_sq + diff[ch] * diff[ch]
        len_sq = safe_denominator(len_sq)
        mv_over = exact_divide(full(len_sq, F(range_ - 1), F32), len_sq)
        self.axis = [diff[ch] * weights[ch] * mv_over for ch in range(nch)]

    def select(self, float_pixel):
        """SelectIndexLDR (IndexSelector.h:124-131)."""
        dist = (float_pixel[0] - self.origin[0]) * self.axis[0]
        for ch in range(1, self.nch):
            dist = dist + (float_pixel[ch] - self.origin[ch]) * self.axis[ch]
        return round_to_int(clamp(dist, 0.0, float(self.range - 1)))

    def reconstruct(self, index):
        """ReconstructLDRPrecise (IndexSelector.h:102-112)."""
        weight = (WEIGHT_RECIPROCALS[self.range] * index + 64) >> 7
        return [((256 - weight) * self.endpoints[0][ch]
                 + weight * self.endpoints[1][ch] + 128) >> 8
                for ch in range(self.nch)]


def finalize_error(agg, uniform: bool, weights_sq):
    """AggregatedError::Finalize (AggregatedError.h:30-46)."""
    if uniform:
        total = agg[0]
        for ch in range(1, len(agg)):
            total = total + agg[ch]
        return to_float(total)
    total = to_float(agg[0]) * weights_sq[0]
    for ch in range(1, len(agg)):
        total = total + to_float(agg[ch]) * weights_sq[ch]
    return total


# --- EndpointSelector (EndpointSelector.h:13-149) ----------------------------

def endpoint_line(pw_pixels, pixel_weights, weights, nch: int):
    """The three passes, the power iteration and GetEndpoints: the
    unfinished endpoints (base, offset), each a list of `nch` [N]."""
    zero = torch.zeros_like(pixel_weights[0])
    centroid = [zero] * nch
    total = zero
    for px in range(16):
        w = pixel_weights[px]
        for ch in range(nch):
            centroid[ch] = centroid[ch] + pw_pixels[px][ch] * w
        total = total + w
    denom = safe_denominator(total)
    centroid = [exact_divide(c, denom) for c in centroid]

    cov = [zero] * (nch * (nch + 1) // 2)
    for px in range(16):
        diff = [pw_pixels[px][ch] - centroid[ch] for ch in range(nch)]
        i = 0
        for row in range(nch):
            for col in range(row + 1):
                cov[i] = cov[i] + diff[row] * diff[col] * pixel_weights[px]
                i += 1

    approx = [torch.ones_like(zero)] * nch
    for _ in range(8):
        product = []
        for row in range(nch):
            i = (row * (row + 1)) >> 1
            total = None
            for col in range(nch):
                term = approx[col] * cov[i]
                total = term if total is None else total + term
                i += col + 1 if col >= row else 1
            product.append(total)
        largest = product[0]
        for ch in range(1, nch):
            largest = torch.maximum(largest, product[ch])
        largest = safe_denominator(largest)
        approx = [exact_divide(p, largest) for p in product]
    length = approx[0] * approx[0]
    for ch in range(1, nch):
        length = length + approx[ch] * approx[ch]
    length = safe_denominator(exact_sqrt(length))
    direction = [exact_divide(a, length) for a in approx]

    lo = full(zero, FLT_MAX, F32)
    hi = full(zero, -FLT_MAX, F32)
    for px in range(16):
        dist = direction[0] * (pw_pixels[px][0] - centroid[0])
        for ch in range(1, nch):
            dist = dist + direction[ch] * (pw_pixels[px][ch] - centroid[ch])
        lo = torch.minimum(lo, dist)
        hi = torch.maximum(hi, dist)

    # GetEndpoints divides by the raw channel weight
    base, offset = [], []
    for ch in range(nch):
        mn = centroid[ch] + direction[ch] * lo
        mx = centroid[ch] + direction[ch] * hi
        w = full(mn, weights[ch], F32)
        base.append(exact_divide(mn, w))
        offset.append(exact_divide(mx - mn, w))
    return base, offset


def finish_ldr(base, offset, tweak: int, range_: int, nch: int):
    """UnfinishedEndpoints::FinishLDR (UnfinishedEndpoints.h:84-99)."""
    f0, f1 = tweak_factors(tweak, range_)
    return ([round_to_int(clamp(base[ch] + offset[ch] * f0, 0.0, 255.0))
             for ch in range(nch)],
            [round_to_int(clamp(base[ch] + offset[ch] * f1, 0.0, 255.0))
             for ch in range(nch)])


# --- EndpointRefiner (EndpointRefiner.h:16-176) ------------------------------

class Refiner:
    """Least-squares refit of endpoints from pixels and their indexes."""

    def __init__(self, zero, nch: int, range_: int, weights):
        self.nch = nch
        self.tv = [zero] * nch
        self.v = [zero] * nch
        self.tt = self.t = zero
        self.wu = torch.zeros_like(zero, dtype=I32)
        self.rcp_max = F(1.0) / F(range_ - 1)
        self.rcp_weights = [F(1.0) if w == 0.0 else F(1.0) / F(w)
                            for w in weights[:nch]]

    def contribute(self, pw_pixel, index, mask=None):
        """ContributeUnweightedPW (EndpointRefiner.h:79-93); a lane off
        `mask` adds nothing."""
        t = to_float(index) * self.rcp_max

        def m(x):
            return x if mask is None else torch.where(
                mask, x, torch.zeros_like(x))
        for ch in range(self.nch):
            self.tv[ch] = self.tv[ch] + m(t * pw_pixel[ch])
            self.v[ch] = self.v[ch] + m(pw_pixel[ch])
        self.tt = self.tt + m(t * t)
        self.t = self.t + m(t)
        self.wu = self.wu + (1 if mask is None else mask.to(I32))

    def refined_ldr(self):
        """GetRefinedEndpoints then GetRefinedEndpointsLDR
        (EndpointRefiner.h:100-157)."""
        # the weighted total w is 0: every contribution here is unweighted
        w = safe_denominator(to_float(self.wu))
        w_rcp = exact_reciprocal(w)
        adenom = (self.tt * w - self.t * self.t) * w_rcp
        adenom_zero = adenom == 0.0
        adenom = torch.where(adenom_zero, torch.ones_like(adenom), adenom)
        ep0, ep1 = [], []
        for ch in range(self.nch):
            a = exact_divide(self.tv[ch] - self.t * self.v[ch] * w_rcp,
                             adenom)
            b = (self.v[ch] - a * self.t) * w_rcp
            p1 = torch.where(adenom_zero, self.v[ch] * w_rcp, b)
            p2 = torch.where(adenom_zero, p1, a + b)
            ep0.append(round_to_int(clamp(p1 * self.rcp_weights[ch],
                                          0.0, 255.0)))
            ep1.append(round_to_int(clamp(p2 * self.rcp_weights[ch],
                                          0.0, 255.0)))
        return ep0, ep1


# --- single-colour tables (MakeTables, Program.cs:95-148) --------------------

@functools.lru_cache(maxsize=None)
def single_color_table(bits: int, max_index: int, paranoid: bool):
    """[256, 4] int32 (min, max, interpolated colour, span) of the
    endpoint pair of `bits`-bit values whose colour (min * (max_index - 1)
    + max) // max_index lies nearest each target value, the span weighed
    in when paranoid: the least error in double, then the least span, then
    the first pair, min-major."""
    values = np.arange(1 << bits)
    values = (values << (8 - bits)) | ((values << (8 - bits)) >> bits)
    mn = np.repeat(values, len(values))
    mx = np.tile(values, len(values))
    colour = (mn * (max_index - 1) + mx) // max_index
    span = np.abs(mn - mx)
    out = np.zeros((256, 4), dtype=np.int32)
    for target in range(256):
        delta = np.abs(colour - target).astype(np.float64) \
            + span * (0.03 if paranoid else 0.0)
        error = delta * delta
        least = error == error.min()
        least &= span == span[least].min()
        i = int(np.flatnonzero(least)[0])
        out[target] = (mn[i], mx[i], colour[i], span[i])
    return out


# --- PackRGB (S3TC.cpp:717-1052) ---------------------------------------------

def paranoid_factor(span):
    return torch.abs(to_float(span)) * PARANOIA


def paranoid_diff(a, b, d):
    diff = torch.abs(to_float(a - b)) + d
    return diff * diff


def quantize_565(ep):
    """QuantizeTo565 (S3TC.cpp:52-69)."""
    def q5(v):
        r = (v * 249 + 1024) >> 11
        return (r << 3) | (r >> 2)

    def q6(v):
        r = (v * 253 + 512) >> 10
        return (r << 2) | (r >> 4)
    return [q5(ep[0]), q6(ep[1]), q5(ep[2])]


class _Best:
    """The best candidate of each block so far."""

    def __init__(self, zero_i, zero_f):
        self.error = full(zero_f, FLT_MAX, F32)
        self.endpoints = [[zero_i] * 3 for _ in range(2)]
        self.indexes = [zero_i] * 16
        self.range = zero_i

    def update(self, error, endpoints, indexes, range_: int):
        better = error < self.error
        self.error = torch.where(better, error, self.error)
        self.endpoints = [[torch.where(better, endpoints[e][ch],
                                       self.endpoints[e][ch])
                           for ch in range(3)] for e in range(2)]
        self.indexes = [torch.where(better, indexes[px], self.indexes[px])
                        for px in range(16)]
        self.range = torch.where(better, full(self.range, range_),
                                 self.range)


def _test_endpoints(flags, pixels, float_pixels, pw_pixels, unquantized,
                    range_, weights, weights_sq, refiner):
    """TestEndpoints (S3TC.cpp:190-258) of one candidate a block, or of
    [N, P] candidates against pixels broadcast as [N, 1] (refiner None):
    (error, quantized endpoints, 16 indexes)."""
    endpoints = [quantize_565(unquantized[0]), quantize_565(unquantized[1])]
    selector = IndexSelector(weights, endpoints, range_, 3)
    paranoid = bool(flags & Flags.S3TC_PARANOID)
    if paranoid:
        factors = [paranoid_factor(endpoints[0][ch] - endpoints[1][ch])
                   for ch in range(3)]
    error = torch.zeros_like(endpoints[0][0], dtype=F32)
    agg = [torch.zeros_like(endpoints[0][0])] * 3
    indexes = []
    for px in range(16):
        index = selector.select(float_pixels[px])
        indexes.append(index)
        if refiner is not None:
            refiner.contribute(pw_pixels[px], index)
        recon = selector.reconstruct(index)
        for ch in range(3):
            if paranoid:
                error = error + paranoid_diff(recon[ch], pixels[px][ch],
                                              factors[ch]) * weights_sq[ch]
            else:
                agg[ch] = agg[ch] + sq_diff(recon[ch], pixels[px][ch])
    if not paranoid:
        error = finalize_error(agg, bool(flags & Flags.UNIFORM), weights_sq)
    return error, endpoints, indexes


def _test_single_color(flags, pixels, range_, weights_sq, best):
    """TestSingleColor (S3TC.cpp:83-188)."""
    paranoid = bool(flags & Flags.S3TC_PARANOID)
    dev = pixels[0][0].device
    totals = [torch.zeros_like(best.range)] * 3
    for px in range(16):
        for ch in range(3):
            totals[ch] = totals[ch] + pixels[px][ch]
    eps, colour, span = [[None] * 3, [None] * 3], [None] * 3, [None] * 3
    for ch in range(3):
        table = torch.from_numpy(single_color_table(
            6 if ch == 1 else 5, range_ - 1, paranoid)).to(dev)
        entry = table[((totals[ch] + 8) >> 4).long()]
        eps[0][ch], eps[1][ch] = entry[:, 0], entry[:, 1]
        colour[ch], span[ch] = entry[:, 2], entry[:, 3]
    error = torch.zeros_like(best.error)
    factors = [paranoid_factor(span[ch]) for ch in range(3)]
    for px in range(16):
        for ch in range(3):
            if paranoid:
                term = paranoid_diff(colour[ch], pixels[px][ch], factors[ch])
            else:
                term = to_float(sq_diff(colour[ch], pixels[px][ch]))
            error = error + term * weights_sq[ch]
    best.update(error, eps, [torch.ones_like(best.range)] * 16, range_)


def _count_partitions(n_counts: int) -> np.ndarray:
    """The count partitions in the reference's visitation order
    (S3TC.cpp:885-935): 965 of 4 counts, 150 of 3."""
    out = []
    for n0 in range(16):
        for n1 in range((15 if n0 == 0 else 16 - n0) + 1):
            if n_counts == 3:
                if 16 - n1 - n0 != 16:
                    out.append((n0, n1, 16 - n1 - n0))
                continue
            rest = 16 - n1 - n0
            for n2 in range((15 if rest == 16 else rest) + 1):
                if 16 - n2 - n1 - n0 != 16:
                    out.append((n0, n1, n2, 16 - n2 - n1 - n0))
    return np.asarray(out, dtype=np.int32)


def _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements,
                 n_counts, weights, weights_sq, best):
    """TestCounts (S3TC.cpp:260-301) of every count partition at once, on
    a trailing [N, P] axis: element e of the sorted pixels adds to its
    group while every group before it fits within the block's element
    count and its place in the group is below that count."""
    counts = _count_partitions(n_counts)
    p_count = counts.shape[0]
    dev = num_elements.device
    group = np.zeros((p_count, 16), dtype=np.int32)
    place = np.zeros((p_count, 16), dtype=np.int32)
    for p in range(p_count):
        e = 0
        for i in range(n_counts):
            for k in range(counts[p, i]):
                group[p, e], place[p, e] = i, k
                e += 1
    counts_t = torch.from_numpy(counts).to(dev)
    group_t = torch.from_numpy(group).to(dev)
    place_t = torch.from_numpy(place).to(dev)
    ne = num_elements[:, None]
    fits = [torch.ones((ne.shape[0], p_count), dtype=torch.bool, device=dev)]
    for i in range(n_counts - 1):
        fits.append(fits[-1] & (counts_t[None, :, i] <= ne))

    rcp_max = F(1.0) / F(n_counts - 1)
    zero = torch.zeros((ne.shape[0], p_count), dtype=F32, device=dev)
    refiner = Refiner(zero, 3, n_counts, weights)
    for e in range(16):
        g = group_t[None, :, e]
        ok = fits[0]
        for i in range(1, n_counts):
            ok = torch.where(g == i, fits[i], ok)
        mask = ok & (place_t[None, :, e] < ne)
        t = to_float(g) * rcp_max
        for ch in range(3):
            v = pw_sorted[e][ch][:, None]
            refiner.tv[ch] = refiner.tv[ch] + torch.where(mask, t * v, zero)
            refiner.v[ch] = refiner.v[ch] + torch.where(mask, v, zero)
        refiner.tt = refiner.tt + torch.where(mask, t * t, zero)
        refiner.t = refiner.t + torch.where(mask, t, zero)
        refiner.wu = refiner.wu + mask.to(I32)
    e0, e1 = refiner.refined_ldr()

    error, eps, indexes = _test_endpoints(
        flags, [[c[:, None] for c in px] for px in pixels],
        [[c[:, None] for c in px] for px in float_pixels], None, [e0, e1],
        n_counts, weights, weights_sq, None)
    win = first_min(error).long()[:, None]

    def at_win(x):
        return torch.gather(x, 1, win)[:, 0]
    best.update(at_win(error),
                [[at_win(eps[e][ch]) for ch in range(3)] for e in range(2)],
                [at_win(indexes[px]) for px in range(16)], n_counts)


def _pack_rgb_exhaustive(flags, pixels, float_pixels, base, offset, weights,
                         weights_sq, alpha_test, best, zero_i):
    """The exhaustive cluster fit (S3TC.cpp:798-935): sort the pixels
    along an 11-bit projection and fit every count partition of the
    sorted order."""
    sort_ep = finish_ldr(base, offset, 0, 1 << 11, 3)
    selector = IndexSelector(weights, sort_ep, 1 << 11, 3)
    keys = []
    for px in range(16):
        key = selector.select(float_pixels[px][:3]) << 4
        if alpha_test:
            key = torch.where(pixels[px][3] < 255, full(key, -16), key)
        keys.append(key + px)
    # the insertion-sort network, comparator by comparator
    for end in range(1, 16):
        for loc in range(end, 0, -1):
            a, b = keys[loc], keys[loc - 1]
            keys[loc], keys[loc - 1] = torch.maximum(a, b), torch.minimum(a, b)
    first = zero_i
    for e in range(16):
        first = torch.where(keys[e] < 0, full(first, e + 1), first)
    num_elements = 16 - first

    # sortedInputs[15 - e] = pixels[key[e] & 15] from the first element on,
    # zero before it (S3TC.cpp:845-878)
    stacked = [torch.stack([pixels[px][ch] for px in range(16)], dim=1)
               for ch in range(4)]
    pw_sorted = [None] * 16
    for e in range(16):
        valid = e >= first
        src = (keys[e] & 15).long()[:, None]
        pw_sorted[15 - e] = [
            to_float(torch.where(valid,
                                 torch.gather(stacked[ch], 1, src)[:, 0],
                                 zero_i)) * weights[ch]
            for ch in range(4)]

    _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements, 4,
                 weights, weights_sq, best)
    _test_single_color(flags, pixels, 4, weights_sq, best)
    if alpha_test:
        _test_counts(flags, pixels, float_pixels, pw_sorted, num_elements, 3,
                     weights, weights_sq, best)
        _test_single_color(flags, pixels, 3, weights_sq, best)


def pack_rgb(blocks, options: Options, alpha_test: bool):
    """PackRGB: uint8 [N, 16, 4] -> uint8 [N, 8] BC1 colour blocks, with
    CVTT's alpha test (BC1) or without (the colour half of BC3)."""
    flags = options.flags
    refine_rounds = max(options.refine_rounds_s3tc, 1)
    max_tweaks = max(options.seed_points, 1)
    weights = [F(w) for w in options.channel_weights()]
    weights_sq = [w * w for w in weights]
    p = blocks.to(I32)
    n, dev = p.shape[0], p.device
    zero_i = torch.zeros((n,), dtype=I32, device=dev)
    zero_f = torch.zeros((n,), dtype=F32, device=dev)
    pixels = [[p[:, px, ch] for ch in range(4)] for px in range(16)]
    if alpha_test:
        threshold = int(np.floor(F(options.threshold) * F(255.0) + F(0.5)))
        for px in range(16):
            pixels[px][3] = torch.where(pixels[px][3] < threshold, zero_i,
                                        full(zero_i, 255))
    float_pixels = [[to_float(c) for c in px] for px in pixels]
    pw_pixels = [[px[ch] * weights[ch] for ch in range(4)]
                 for px in float_pixels]
    pixel_weights = []
    for px in range(16):
        w = full(zero_f, 1.0, F32)
        if alpha_test:
            w = torch.where(pixels[px][3] < 255, zero_f, w)
        pixel_weights.append(w)

    base, offset = endpoint_line(pw_pixels, pixel_weights, weights, 3)
    best = _Best(zero_i, zero_f)
    if flags & Flags.S3TC_EXHAUSTIVE:
        _pack_rgb_exhaustive(flags, pixels, float_pixels, base, offset,
                             weights, weights_sq, alpha_test, best, zero_i)
    else:
        for range_ in range(3 if alpha_test else 4, 5):
            for tweak in range(min(tweak_rounds(range_), max_tweaks)):
                endpoints = list(finish_ldr(base, offset, tweak, range_, 3))
                for refine in range(refine_rounds):
                    refiner = Refiner(zero_f, 3, range_, weights)
                    error, eps, indexes = _test_endpoints(
                        flags, pixels, float_pixels, pw_pixels, endpoints,
                        range_, weights, weights_sq, refiner)
                    best.update(error, eps, indexes, range_)
                    if refine != refine_rounds - 1:
                        endpoints = list(refiner.refined_ldr())
    return _pack_bc1(best)


def _pack_bc1(best: _Best):
    """The final pack (S3TC.cpp:966-1051)."""
    cep = []
    for e in range(2):
        ep = best.endpoints[e]
        cep.append(((ep[0] & 0xF8) << 8) | ((ep[1] & 0xFC) << 3)
                   | ((ep[2] & 0xF8) >> 3))
    zero = torch.zeros_like(cep[0])
    case = torch.where(
        best.range == 4,
        torch.where(cep[0] == cep[1], zero,
                    torch.where(cep[0] < cep[1], zero + 1, zero + 2)),
        torch.where(cep[0] > cep[1], zero + 3, zero + 4))
    swap = (case == 1) | (case == 3)
    a = torch.where(swap, cep[1], cep[0])
    b = torch.where(swap, cep[0], cep[1])
    order = torch.tensor(INDEX_ORDER, dtype=I32,
                         device=case.device).reshape(-1)
    cols = [a & 0xFF, (a >> 8) & 0xFF, b & 0xFF, (b >> 8) & 0xFF]
    for i in range(0, 16, 4):
        packed = zero
        for k in range(4):
            packed = packed | (order[(case * 4 + best.indexes[i + k]).long()]
                               << (2 * k))
        cols.append(packed)
    return torch.stack(cols, dim=-1).to(torch.uint8)


# --- PackInterpolatedAlpha (S3TC.cpp:343-715) --------------------------------

def pack_interpolated_alpha(blocks, channel: int, options: Options):
    """The BC3 alpha block of one unsigned channel: uint8 [N, 16, 4] ->
    uint8 [N, 8]."""
    max_tweaks = max(options.seed_points, 1)
    refine_rounds = max(options.refine_rounds_iic, 1)
    p = blocks.to(I32)
    n, dev = p.shape[0], p.device
    zero_i = torch.zeros((n,), dtype=I32, device=dev)
    zero_f = torch.zeros((n,), dtype=F32, device=dev)
    high = 255
    pixels = [p[:, px, channel] for px in range(16)]
    float_pixels = [to_float(v) for v in pixels]

    # the bubble-sort network, comparator by comparator
    ordered = list(pixels)
    for end in range(15, 0, -1):
        for k in range(end):
            a, b = ordered[k], ordered[k + 1]
            ordered[k] = torch.minimum(a, b)
            ordered[k + 1] = torch.maximum(a, b)

    best = {"error": full(zero_f, FLT_MAX, F32), "full": zero_i,
            "ep": [zero_i, zero_i], "indexes": [zero_i] * 16}

    def update(error, is_full: int, indexes, ep):
        better = error < best["error"]
        best["error"] = torch.minimum(error, best["error"])
        best["full"] = torch.where(better, full(zero_i, is_full), best["full"])
        best["indexes"] = [torch.where(better, i, cur)
                           for i, cur in zip(indexes, best["indexes"])]
        best["ep"] = [torch.where(better, e, cur)
                      for e, cur in zip(ep, best["ep"])]

    # the full-precision phase, 8 values (S3TC.cpp:400-469)
    base = [to_float(ordered[0])]
    offset = [to_float(ordered[15] - ordered[0])]
    for tweak in range(min(tweak_rounds(8), max_tweaks)):
        e0, e1 = finish_ldr(base, offset, tweak, 8, 1)
        ep = [e0[0], e1[0]]
        for refine in range(refine_rounds):
            refiner = Refiner(zero_f, 1, 8, [1.0])
            selector = IndexSelector([F(1.0)], [[ep[0]], [ep[1]]], 8, 1)
            indexes = []
            agg = zero_i
            for px in range(16):
                index = selector.select([float_pixels[px]])
                agg = agg + sq_diff(selector.reconstruct(index)[0],
                                    pixels[px])
                if refine != refine_rounds - 1:
                    refiner.contribute([float_pixels[px]], index)
                indexes.append(index)
            update(to_float(agg), 1, indexes, ep)
            if refine != refine_rounds - 1:
                r0, r1 = refiner.refined_ldr()
                ep = [r0[0], r1[0]]

    # the reduced phase, 6 values and the reserved 0 and 255
    # (S3TC.cpp:471-649); the clipping heuristic first
    heur_min, heur_max = ordered[0], ordered[15]
    clearance = torch.minimum(heur_min, high - heur_max)
    can_clip = (clearance << 2) + (clearance << 4) < heur_max - heur_min
    low_clear = [zero_i] + [ordered[px - 1] for px in range(1, 16)]
    high_clear = [zero_i] + [high - ordered[16 - px] for px in range(1, 16)]
    # the reference's bestSkipCount is never updated: the last passing pair
    # wins
    for first in range(16):
        for last in range(first, 16):
            if first + (15 - last) <= 0:
                continue
            c = torch.maximum(high_clear[15 - last], low_clear[first])
            passes = can_clip & ((c << 2) + (c << 4)
                                 < ordered[last] - ordered[first])
            heur_min = torch.where(passes, ordered[first], heur_min)
            heur_max = torch.where(passes, ordered[last], heur_max)
    simple_min = full(zero_i, 1)
    simple_max = full(zero_i, high - 1)
    for px in range(16):
        simple_min = torch.where(ordered[15 - px] > 0, ordered[15 - px],
                                 simple_min)
        simple_max = torch.where(ordered[px] < high, ordered[px], simple_max)

    for lo in (simple_min, heur_min):
        for hi in (simple_max, heur_max):
            base, offset = [to_float(lo)], [to_float(hi - lo)]
            for tweak in range(min(tweak_rounds(6), max_tweaks)):
                # FinishLDR at range 8, the selector at range 6, as the
                # reference does (S3TC.cpp:567)
                e0, e1 = finish_ldr(base, offset, tweak, 8, 1)
                ep = [e0[0], e1[0]]
                for refine in range(refine_rounds):
                    refiner = Refiner(zero_f, 1, 6, [1.0])
                    selector = IndexSelector([F(1.0)], [[ep[0]], [ep[1]]], 6,
                                             1)
                    indexes = []
                    error = zero_f
                    for px in range(16):
                        sel = selector.select([float_pixels[px]])
                        sel_err = to_float(sq_diff(
                            selector.reconstruct(sel)[0], pixels[px]))
                        zero_err = to_float(sq_diff(zero_i, pixels[px]))
                        high_err = to_float(sq_diff(full(zero_i, high),
                                                    pixels[px]))
                        index = torch.where(high_err < zero_err,
                                            full(zero_i, 7), full(zero_i, 6))
                        px_err = torch.minimum(zero_err, high_err)
                        sel_better = sel_err < px_err
                        if refine != refine_rounds - 1:
                            refiner.contribute([float_pixels[px]], sel,
                                               mask=sel_better)
                        index = torch.where(sel_better, sel, index)
                        error = error + torch.minimum(px_err, sel_err)
                        indexes.append(index)
                    update(error, 0, indexes, ep)
                    if refine != refine_rounds - 1:
                        r0, r1 = refiner.refined_ldr()
                        ep = [r0[0], r1[0]]
    return _pack_alpha(best["ep"], best["full"], best["indexes"])


def _pack_alpha(ep, is_full_range, indexes):
    """The final pack (S3TC.cpp:651-714)."""
    is_full = is_full_range != 0
    swap = is_full != (ep[0] > ep[1])
    ep0 = torch.where(swap, ep[1], ep[0])
    ep1 = torch.where(swap, ep[0], ep[1])
    max_value = torch.where(is_full, full(ep0, 7), full(ep0, 5))
    stream = torch.zeros_like(ep0, dtype=torch.int64)
    for px in range(16):
        index = indexes[px]
        index = torch.where(swap & (index <= max_value), max_value - index,
                            index)
        remapped = torch.where(index < max_value, index + 1, index)
        remapped = torch.where(index == max_value, torch.ones_like(index),
                               remapped)
        index = torch.where(index != 0, remapped, index)
        stream = stream | (index.to(torch.int64) << (3 * px))
    cols = [ep0 & 0xFF, ep1 & 0xFF] + [((stream >> (8 * k)) & 0xFF).to(I32)
                                       for k in range(6)]
    return torch.stack(cols, dim=-1).to(torch.uint8)


# --- the entry points --------------------------------------------------------

def encode_bc1(blocks: torch.Tensor, **options) -> torch.Tensor:
    """Kernels::EncodeBC1 with Options(**options): uint8 [N, 16, 4] ->
    uint8 [N, 8] on the blocks' device."""
    return pack_rgb(blocks, Options(**options), True)


def encode_bc3(blocks: torch.Tensor, **options) -> torch.Tensor:
    """Kernels::EncodeBC3 with Options(**options): the interpolated alpha
    then the BC1 colour half, uint8 [N, 16, 4] -> uint8 [N, 16] on the
    blocks' device."""
    opts = Options(**options)
    return torch.cat([pack_interpolated_alpha(blocks, 3, opts),
                      pack_rgb(blocks, opts, False)], dim=-1)
