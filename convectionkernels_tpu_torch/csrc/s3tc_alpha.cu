// s3tc_alpha: S3TC's interpolated alpha, one 8-byte block a texture block
// (PackInterpolatedAlpha, S3TC.cpp:343-715): BC3's alpha half, BC4's block
// and each of BC5's two.
//
// Replaces no TPU kernel: the JAX package runs the chain in XLA ops
// (convectionkernels_tpu/models/s3tc.py pack_interpolated_alpha); the port
// ran it as about 14,800 torch ops a call at the default Options (160
// select-and-refit rounds, each a handful of [N]- and [N, 16]-wide ops),
// graph nodes of a microsecond or more each whatever the block count.
// Mirrors, operation for operation, models/s3tc.py s3tc_alpha_plain: the
// sort; the full-range chain (8 interpolants, FinishLDR's tweaks x
// EndpointRefiner rounds); the clipping heuristic and the simple min/max;
// the reserved endpoints' errors; the reduced-range chains (6
// interpolants) of the four (lo, hi) seeds; the final packing.
//
// Exactness: float32 operations in the plain version's order, one rounding
// each (built with -fmad=false -prec-div=true -ftz=false); the refiner's
// totals a chain over the pixels in order, a masked pixel skipped (it
// would add +0.0 to a total that is never -0.0: a no-op). Errors sum over
// the pixels in int32: for values in 0-255 every term is the square of a
// difference below 256, 16 of them stay below 2^24, so the plain version's
// float32 sums and compares are exact and give the same results. A round
// replaces the best only with a strictly smaller error (update_best); the
// clipping heuristic's last passing candidate wins (its bestSkipCount is
// never updated).
//
// Design: one thread a texture block. Its 16 values, their sorted copy and
// each round's indexes (3 bits a pixel in a 64-bit word) stay in
// registers: every loop over pixels or clipping candidates is unrolled, so
// no array is indexed at run time. The channel, the pixel layout, the
// signed flag and the loop counts are run-time arguments, uniform over the
// grid: BC3, BC4U/S and BC5U/S take the one kernel.
//
// Bound on an H100: operations (about 800 a round, 160 rounds a block at
// the default Options; chip_smoke.py's work_s3tc_alpha), against 16 bytes
// read and 8 written a block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float FLT_MAX_F = 3.40282347e+38f;
// g_weightReciprocals (IndexSelector.cpp:43-62) of the two ranges
constexpr int RECIP_8 = 4681, RECIP_6 = 6554;

// RoundAndConvertToInt under round-to-nearest: floor(x + 0.5f)
__device__ __forceinline__ int round_nearest(float x) {
    return (int)floorf(x + 0.5f);
}

// ParallelMath::Clamp(x, 0, 255): the min, then the max
__device__ __forceinline__ float clamp_255(float x) {
    return fmaxf(fminf(x, 255.0f), 0.0f);
}

// IndexSelector<1> with channel weight 1 (IndexSelector.h:39-131)
struct Selector {
    int ep0, ep1, recip;
    float origin, axis, max_value;
};

__device__ __forceinline__ Selector make_selector(int ep0, int ep1, int range,
                                                  int recip) {
    Selector s;
    s.ep0 = ep0;
    s.ep1 = ep1;
    s.recip = recip;
    s.origin = (float)ep0;
    s.max_value = (float)(range - 1);
    const float diff = (float)ep1 - s.origin;
    float len_sq = diff * diff;
    if (len_sq == 0.0f) len_sq = 1.0f;
    s.axis = diff * (s.max_value / len_sq);
    return s;
}

// SelectIndexLDR: project, clamp, round
__device__ __forceinline__ int select_index(const Selector& s, float value) {
    const float dist = (value - s.origin) * s.axis;
    return round_nearest(fmaxf(fminf(dist, s.max_value), 0.0f));
}

// ReconstructLDRPrecise: 255ths weights
__device__ __forceinline__ int reconstruct(const Selector& s, int index) {
    const int w = (s.recip * index + 64) >> 7;
    return ((256 - w) * s.ep0 + w * s.ep1 + 128) >> 8;
}

// EndpointRefiner<1> with channel weight 1 (EndpointRefiner.h:38-157)
struct Refiner {
    float tv, v, tt, t;
    int wu;
};

__device__ __forceinline__ void contribute(Refiner& r, float value, int index,
                                           float rcp_max_index) {
    const float t = (float)index * rcp_max_index;
    r.tv = r.tv + t * value;
    r.v = r.v + value;
    r.tt = r.tt + t * t;
    r.t = r.t + t;
    r.wu += 1;
}

// GetRefinedEndpointsLDR
__device__ __forceinline__ void refined_endpoints(const Refiner& r, int& ep0,
                                                  int& ep1) {
    float w = (float)r.wu;
    if (w == 0.0f) w = 1.0f;
    const float w_rcp = 1.0f / w;
    float adenom = (r.tt * w - r.t * r.t) * w_rcp;
    const bool adenom_zero = adenom == 0.0f;
    if (adenom_zero) adenom = 1.0f;
    const float a = (r.tv - r.t * r.v * w_rcp) / adenom;
    const float b = (r.v - a * r.t) * w_rcp;
    const float p1 = adenom_zero ? r.v * w_rcp : b;
    const float p2 = adenom_zero ? p1 : a + b;
    ep0 = round_nearest(clamp_255(p1));
    ep1 = round_nearest(clamp_255(p2));
}

struct Best {
    float error;
    int full_range, ep0, ep1;
    uint64_t indexes;      // 3 bits a pixel, pixel 0 lowest
};

// The tweak x refine chain of one (base, offset) seed: FinishLDR's endpoints
// at range 8 for each tweak (both phases seed so, S3TC.cpp:567), then
// rounds of select, score, keep the best and refit. FULL: the 8-interpolant
// range (S3TC.cpp:400-469); else the 6-interpolant range with the reserved
// endpoints 0 (index 6) and the high terminal (index 7) (S3TC.cpp:554-649).
template <bool FULL>
__device__ __forceinline__ void chain(const int (&v)[16], float base,
                                      float offset, int num_tweak,
                                      int num_refine, bool is_signed,
                                      int high_terminal, Best& best) {
    constexpr int RANGE = FULL ? 8 : 6;
    constexpr int RECIP = FULL ? RECIP_8 : RECIP_6;
    const float rcp_max_index = 1.0f / (float)(RANGE - 1);
    for (int tweak = 0; tweak < num_tweak; ++tweak) {
        // ComputeTweakFactors(tweak, 8) and FinishLDR
        const int min_outside = (tweak >> 1) & 1, max_outside = tweak & 1;
        const float inside = (float)(7 - min_outside - max_outside);
        const float f0 = -(float)min_outside / inside;
        const float f1 = (float)max_outside / inside + 1.0f;
        int ep0 = round_nearest(clamp_255(base + offset * f0));
        int ep1 = round_nearest(clamp_255(base + offset * f1));
        for (int refine = 0; refine < num_refine; ++refine) {
            if (is_signed) {
                ep0 = min(ep0, high_terminal);
                ep1 = min(ep1, high_terminal);
            }
            const Selector s = make_selector(ep0, ep1, RANGE, RECIP);
            const bool refit = refine != num_refine - 1;
            Refiner r = {0.0f, 0.0f, 0.0f, 0.0f, 0};
            int error = 0;
            uint64_t indexes = 0;
#pragma unroll
            for (int px = 0; px < 16; ++px) {
                const float value = (float)v[px];
                const int selected = select_index(s, value);
                const int diff = reconstruct(s, selected) - v[px];
                int index = selected, err = diff * diff;
                bool contributes = true;
                if (!FULL) {
                    const int high = high_terminal - v[px];
                    const int zero_err = v[px] * v[px], high_err = high * high;
                    const int reserved = min(zero_err, high_err);
                    contributes = err < reserved;
                    if (!contributes) index = high_err < zero_err ? 7 : 6;
                    err = min(reserved, err);
                }
                error += err;
                indexes |= (uint64_t)index << (3 * px);
                if (refit && contributes)
                    contribute(r, value, selected, rcp_max_index);
            }
            const float error_f = (float)error;
            if (error_f < best.error)
                best = Best{error_f, FULL ? 1 : 0, ep0, ep1, indexes};
            if (refit) refined_endpoints(r, ep0, ep1);
        }
    }
}

// the clearance times 10 of the clipping heuristic, as the reference
// writes it
__device__ __forceinline__ int clearance_x10(int c) {
    return (c << 2) + (c << 4);
}

// PackInterpolatedAlpha of one block's 16 values (0-255; signed ones biased
// into 0-254): the 8 bytes, little-endian in a 64-bit word
__device__ __forceinline__ uint64_t encode_block(int (&v)[16], bool is_signed,
                                                 int max_tweak_rounds,
                                                 int num_refine_rounds) {
    const int high_terminal = is_signed ? 254 : 255;
    if (is_signed) {
#pragma unroll
        for (int px = 0; px < 16; ++px) v[px] = min(v[px], high_terminal);
    }
    // the ascending values: an unrolled exchange network
    int s[16];
#pragma unroll
    for (int px = 0; px < 16; ++px) s[px] = v[px];
#pragma unroll
    for (int i = 0; i < 15; ++i) {
#pragma unroll
        for (int j = 0; j < 15 - i; ++j) {
            const int lo = min(s[j], s[j + 1]), hi = max(s[j], s[j + 1]);
            s[j] = lo;
            s[j + 1] = hi;
        }
    }
    const int num_tweak = min(4, max_tweak_rounds);   // TweakRoundsForRange

    Best best = {FLT_MAX_F, 0, 0, 0, 0};
    chain<true>(v, (float)s[0], (float)(s[15] - s[0]), num_tweak,
                num_refine_rounds, is_signed, high_terminal, best);

    // the clipping heuristic over the (first, last) pairs that skip a pixel
    int heuristic_min = s[0], heuristic_max = s[15];
    const int lowest_clearance = min(s[0], high_terminal - s[15]);
    if (clearance_x10(lowest_clearance) < s[15] - s[0]) {
#pragma unroll
        for (int first = 0; first < 16; ++first) {
#pragma unroll
            for (int last = first; last < 16; ++last) {
                if (first + (15 - last) == 0) continue;
                const int low = first == 0 ? 0 : s[first - 1];
                const int high = last == 15 ? 0 : high_terminal - s[last + 1];
                if (clearance_x10(max(high, low)) < s[last] - s[first]) {
                    heuristic_min = s[first];
                    heuristic_max = s[last];
                }
            }
        }
    }
    // the least value above 0 (else 1), the greatest below the high
    // terminal (else high_terminal - 1)
    int simple_min = 1, simple_max = high_terminal - 1;
#pragma unroll
    for (int px = 0; px < 16; ++px) {
        if (s[15 - px] > 0) simple_min = s[15 - px];
        if (s[px] < high_terminal) simple_max = s[px];
    }

    for (int seed = 0; seed < 4; ++seed) {   // lo outer, hi inner
        const int lo = seed < 2 ? simple_min : heuristic_min;
        const int hi = (seed & 1) ? heuristic_max : simple_max;
        chain<false>(v, (float)lo, (float)(hi - lo), num_tweak,
                     num_refine_rounds, is_signed, high_terminal, best);
    }

    // the final packing (S3TC.cpp:651-714)
    int ep0 = best.ep0, ep1 = best.ep1;
    if (is_signed) {
        ep0 -= 127;
        ep1 -= 127;
    }
    const bool full_range = best.full_range != 0;
    const bool swap = full_range != (ep0 > ep1);
    const int max_value = full_range ? 7 : 5;
    uint64_t stream = 0;
#pragma unroll
    for (int px = 0; px < 16; ++px) {
        int index = (int)((best.indexes >> (3 * px)) & 7);
        if (swap && index <= max_value) index = max_value - index;
        if (index != 0)
            index = index == max_value ? 1
                  : index < max_value ? index + 1 : index;
        stream |= (uint64_t)index << (3 * px);
    }
    const int out0 = swap ? ep1 : ep0, out1 = swap ? ep0 : ep1;
    return (uint64_t)(out0 & 0xFF) | ((uint64_t)(out1 & 0xFF) << 8)
         | (stream << 16);
}

__global__ void __launch_bounds__(THREADS)
s3tc_alpha_kernel(const void* __restrict__ pixels, int wide, int channels,
                  int channel, int is_signed, int max_tweak_rounds,
                  int num_refine_rounds, int n_blocks,
                  uint64_t* __restrict__ out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_blocks) return;
    const size_t at = (size_t)i * 16 * channels + channel;
    int v[16];
#pragma unroll
    for (int px = 0; px < 16; ++px) {
        const size_t k = at + (size_t)px * channels;
        v[px] = wide ? __ldg(static_cast<const int*>(pixels) + k)
                     : (int)__ldg(static_cast<const uint8_t*>(pixels) + k);
    }
    out[i] = encode_block(v, is_signed != 0, max_tweak_rounds,
                          num_refine_rounds);
}

}  // namespace

// pixels [n, 16, channels] contiguous, uint8 (wide 0) or int32 (wide 1),
// values 0-255; the loop counts at least 1. Output out [n, 8] u8, 8-byte
// aligned.
extern "C" int ck_s3tc_alpha(const void* pixels, int wide, int channels,
                             int channel, int is_signed, int max_tweak_rounds,
                             int num_refine_rounds, int n, void* out,
                             void* stream) {
    if (n == 0) return 0;
    s3tc_alpha_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(
        pixels, wide, channels, channel, is_signed, max_tweak_rounds,
        num_refine_rounds, n, static_cast<uint64_t*>(out));
    return (int)cudaGetLastError();
}
