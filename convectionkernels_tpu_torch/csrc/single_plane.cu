// BC7 single-plane candidate search (modes 0-3, 6, 7).
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// single_plane_mode_best (_kernel_body, pallas_call at :349): for every
// packed (shape, tweak, parity) candidate lane of one mode, seed the
// tweaked endpoints from the shape's PCA line, then per refine round
// compress the endpoints, select indexes (with the +-1 retest when fast
// indexing is off), accumulate the error over the shape's member pixels,
// refit the endpoints by least squares, and keep the lexicographic
// (error, rank) best over rounds. A butterfly over each power-of-two
// segment of cpow lanes then leaves the shape's winner on every lane of
// its segment, the contract models/bc7.py _combine_partitions reads.
//
// What bounds it on an H100: operations, at the issue rate (one lane
// operation per scheduler and clock, 33.45e12 a second: the kernel is
// built with -fmad=false, so no multiply-add counts twice). A valid lane
// does about 1,100 operations at q50 default options (fast indexing, 2
// rounds: 310-360 for the lane, and 100 for each member pixel of an RGB
// mode, 127 of an RGBA one); its inputs are 256 bytes of pixels per
// texture block, shared by thousands of lanes. Tensor cores
// do not apply (no matrix product, and every multiply and add must round
// on its own), and neither does TMA (the input is 256 bytes a texture
// block, so copies are not the limit).
//
// Layout: one CUDA block per texture block put 2-8 shapes in a warp, so
// the warp ran the union of their member pixels (55% of its lane slots did
// needed work at q50), and padding each texture block's lanes to 256
// threads left mode 6 with 240 idle threads a texture block. Now a warp is
// one shape's segment (its cpow slots; the lane table is shape-major) for
// 32/cpow texture blocks: warp task t is (texture-block group t / segments,
// segment t % segments). Members depend only on the shape, so the member
// loop is warp-uniform and walks the set bits in ascending pixel order
// (__ffs), which keeps the reference's chained-sum order and tests no pixel
// outside the shape. The grid is flat over warp tasks, with no padding per
// texture block. Shapes run fastest, so the warps in flight fill whole
// output rows of a few texture blocks (ordered shape-major, their 16-byte
// pieces would scatter over thousands of rows).
// Slots that are invalid (a tweak past the shape's seed count, or a
// punch-through parity) skip their search: their error would be +inf,
// which never beats the FLT_MAX start, so they keep the start state, as
// before. A CUDA block stages the pixels of the texture blocks its warps
// cover once, with one __syncthreads (as float, and as int for fast
// indexing): its warps share one group unless they straddle two, or a
// mode has fewer shapes than a CUDA block has warps. 68 words a block, so
// that the same pixel of different blocks falls in different banks, one
// 16-byte load a pixel. An RGB mode selects over 3 channels:
// the alpha channel's axis is 0, and its term (+-0) cannot move an index.
// The round's selector and compressed endpoints are pinned in registers
// (ck::opaque), where ptxas would recompute them for every pixel. The
// per-shape winner is a __shfl_xor_sync butterfly within cpow-aligned
// lanes (cpow <= 32). The mode and the indexing kind are template
// parameters, so the index range and channel count are compile-time
// constants.
#include "bc7_common.cuh"

namespace {

constexpr int kMaxWarps = 4;
// shared-memory words a staged texture block takes: its 64 pixel values and
// 4 of padding, so that the same pixel of a warp's texture blocks falls in
// different banks, and each pixel's 4 channels are one 16-byte load
constexpr int kTbStride = 68;

struct Weights {
    float cw[4];
    float cw_sq[4];
    float rcp_cw[4];
};

template <int MODE>
struct ModeConst {
    static constexpr int kIndexBits = MODE == 0 || MODE == 1 ? 3 : MODE == 6 ? 4 : 2;
    static constexpr int kRange = 1 << kIndexBits;
    static constexpr int kNrc = MODE < 4 ? 3 : 4;
    // WEIGHT_RECIPROCALS[kRange]
    static constexpr int kRecip = kRange == 4 ? 10923 : kRange == 8 ? 4681 : 2185;
};

// four u8 endpoint channels as one int32 word (channel ch at bits 8*ch)
__device__ __forceinline__ int pack4(const int* c) {
    return (int)((unsigned)c[0] | ((unsigned)c[1] << 8) | ((unsigned)c[2] << 16)
                 | ((unsigned)c[3] << 24));
}

// Warps per CUDA block: fewer when a warp covers many texture blocks.
__host__ __forceinline__ int warps_per_block(int cpow) {
    return 2 * cpow < kMaxWarps ? 2 * cpow : kMaxWarps;
}

// The most texture-block groups (a warp's texture blocks) the `warps` tasks
// of one CUDA block touch, when a group has `segments` tasks: block starts
// fall on multiples of gcd(warps, segments) within a group, so the last
// start is segments - gcd into it.
__host__ __forceinline__ int staged_groups(int warps, int segments) {
    int a = warps, b = segments;
    while (b != 0) {
        const int r = a % b;
        a = b;
        b = r;
    }
    return 1 + (warps - a + segments - 1) / segments;
}

// The search of candidate lane k for texture block b, whose staged pixels
// are fpx (floats) and ipx (ints, for fast indexing): the tweaked seeds,
// then per refine round compress, select, accumulate, refit; the
// lexicographic (error, rank) best over rounds goes to best_*.
template <int MODE, bool FAST>
__device__ __forceinline__ void search_lane(
    const float4* fpx, const int4* ipx, const float* __restrict__ base,
    const float* __restrict__ offset, const float* __restrict__ alpha,
    const int* __restrict__ lane_i, const float* __restrict__ tweakf, int b, int k,
    int s_count, int k_len, int rounds, int uniform, const Weights& wt,
    float& best_err, int& best_rank, int& best_pk0, int& best_pk1) {
    using MC = ModeConst<MODE>;
    constexpr int NRC = MC::kNrc;
    constexpr int RANGE = MC::kRange;
    const int s = lane_i[k];
    const int p = lane_i[k_len + k];
    const unsigned members = (unsigned)lane_i[3 * k_len + k];
    const int rank_k = lane_i[4 * k_len + k];
    const float f0 = tweakf[k];
    const float f1 = tweakf[k_len + k];
    const int p0 = p & 1, p1 = (p >> 1) & 1;

    const float4 b4 = reinterpret_cast<const float4*>(base)[(size_t)b * s_count + s];
    const float4 o4 = reinterpret_cast<const float4*>(offset)[(size_t)b * s_count + s];
    const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
    const float os[4] = {o4.x, o4.y, o4.z, o4.w};
    int ep[2][4];
    for (int ch = 0; ch < 4; ++ch) {
        if (NRC == 3 && ch == 3) {
            ep[0][ch] = 255;
            ep[1][ch] = 255;
        } else {
            ep[0][ch] = ck::round_int(ck::clampf(bs[ch] + os[ch] * f0, 0.0f, 255.0f));
            ep[1][ch] = ck::round_int(ck::clampf(bs[ch] + os[ch] * f1, 0.0f, 255.0f));
        }
    }
    const float al = alpha[(size_t)b * s_count + s];
    const float rcp_max_index = 1.0f / (float)(RANGE - 1);

    for (int refine = 0; refine < rounds; ++refine) {
        const bool last = refine == rounds - 1;
        int c[2][4];
        ck::compress_endpoints<MODE>(ep, p0, p1, c);
        ck::Selector<NRC> sel;
        sel.init(c[0], c[1], wt.cw, (float)(RANGE - 1));
        float ep_f[2][4];
        for (int j = 0; j < 2; ++j)
            for (int ch = 0; ch < 4; ++ch) ep_f[j][ch] = (float)c[j][ch];
        // kept in registers across the member loop
        for (int ch = 0; ch < NRC; ++ch) {
            sel.origin[ch] = ck::opaque(sel.origin[ch]);
            sel.axis[ch] = ck::opaque(sel.axis[ch]);
            for (int j = 0; j < 2; ++j) {
                if (FAST) c[j][ch] = ck::opaque(c[j][ch]);
                else ep_f[j][ch] = ck::opaque(ep_f[j][ch]);
            }
        }

        ck::Refiner<4> ref;
        ref.reset();
        float shape_error = 0.0f;
        int agg[4] = {0, 0, 0, 0};

        // the shape's member pixels, ascending
        for (unsigned m = members; m != 0u; m &= m - 1u) {
            const int px = __ffs(m) - 1;
            const float4 f4 = fpx[px];
            const float fp[4] = {f4.x, f4.y, f4.z, f4.w};
            int index = sel.select(fp);
            if (FAST) {
                const int4 i4 = ipx[px];
                const int ip[4] = {i4.x, i4.y, i4.z, i4.w};
                int w = (MC::kRecip * index + 256) >> 9;
                for (int ch = 0; ch < NRC; ++ch) {
                    int rec = ((64 - w) * c[0][ch] + w * c[1][ch] + 32) >> 6;
                    int d = rec - ip[ch];
                    agg[ch] = agg[ch] + d * d;
                }
            } else {
                auto px_error = [&](int iv) {
                    float w = ck::recon_weight_f32(iv, (float)MC::kRecip);
                    float errs[NRC];
                    for (int ch = 0; ch < NRC; ++ch) {
                        float d = ck::recon_f32(w, ep_f[0][ch], ep_f[1][ch]) - fp[ch];
                        errs[ch] = d * d;
                    }
                    float tot;
                    if (uniform) {
                        tot = errs[0];
                        for (int ch = 1; ch < NRC; ++ch) tot = tot + errs[ch];
                    } else {
                        tot = errs[0] * wt.cw_sq[0];
                        for (int ch = 1; ch < NRC; ++ch) tot = tot + errs[ch] * wt.cw_sq[ch];
                    }
                    return tot;
                };
                float error = px_error(index);
                const int alt0 = max(index, 1) - 1;
                const int alt1 = min(index + 1, RANGE - 1);
                for (int a = 0; a < 2; ++a) {
                    const int alt = a == 0 ? alt0 : alt1;
                    float alt_error = px_error(alt);
                    if (alt_error < error) index = alt;
                    error = fminf(error, alt_error);
                }
                shape_error = shape_error + error;
            }
            if (!last) {
                float pw[NRC];
                for (int ch = 0; ch < NRC; ++ch) pw[ch] = fp[ch] * wt.cw[ch];
                ref.contribute(pw, index, rcp_max_index, NRC);
            }
        }

        if (FAST) {
            if (uniform) {
                shape_error = (float)(agg[0] + agg[1] + agg[2] + agg[3]);
            } else {
                shape_error = (float)agg[0] * wt.cw_sq[0];
                for (int ch = 1; ch < 4; ++ch)
                    shape_error = shape_error + (float)agg[ch] * wt.cw_sq[ch];
            }
        }

        const float err_r = shape_error + al;
        const int rank_r = rank_k * rounds + refine;
        if (ck::lex_better(err_r, rank_r, best_err, best_rank)) {
            best_err = err_r;
            best_rank = rank_r;
            best_pk0 = pack4(c[0]);
            best_pk1 = pack4(c[1]);
        }
        if (!last) ref.refined_ldr(wt.rcp_cw, NRC, ep[0], ep[1]);
    }
}

template <int MODE, bool FAST>
__global__ void __launch_bounds__(kMaxWarps * 32)
single_plane_kernel(const int* __restrict__ pix, const float* __restrict__ base,
                    const float* __restrict__ offset, const float* __restrict__ alpha,
                    const int* __restrict__ pti, const int* __restrict__ lane_i,
                    const float* __restrict__ tweakf, int n, int s_count, int k_len,
                    int cpow, int staged, int rounds, int uniform, Weights wt,
                    float* __restrict__ err_out, int* __restrict__ rank_out,
                    int* __restrict__ pk0_out, int* __restrict__ pk1_out) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned tbs = 32 / cpow;            // texture blocks of a warp
    const unsigned segments = k_len / cpow;    // shapes
    const unsigned tasks = (n + tbs - 1) / tbs * segments;  // < 2^32 - 32
    const unsigned task = blockIdx.x * (blockDim.x >> 5) + warp;
    const unsigned group = task / segments;
    const unsigned seg = task - group * segments;

    // this CUDA block's groups: its first warp's to its last busy warp's
    __shared__ unsigned s_group[kMaxWarps];
    if (lane == 0) s_group[warp] = task < tasks ? group : 0u;
    __syncthreads();
    const unsigned g0 = s_group[0];
    unsigned g1 = g0;
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) g1 = max(g1, s_group[w]);

    // the texture blocks of those groups: float pixels, then (fast
    // indexing) ints, staged once for all the CUDA block's warps
    extern __shared__ float4 smem4[];
    float* s_fp = reinterpret_cast<float*>(smem4);
    int* s_ip = reinterpret_cast<int*>(s_fp + staged * tbs * kTbStride);
    const int tb_first = (int)(g0 * tbs);
    for (int i = threadIdx.x; i < (int)((g1 - g0 + 1) * tbs * 64); i += blockDim.x) {
        const int v = tb_first + i / 64 < n ? pix[(size_t)tb_first * 64 + i] : 0;
        const int at = i / 64 * kTbStride + i % 64;
        s_fp[at] = (float)v;
        if (FAST) s_ip[at] = v;
    }
    __syncthreads();

    if (task >= tasks) return;  // whole warp
    const int tb = lane / cpow;
    const int b = (int)(group * tbs) + tb;
    const int k = (int)seg * cpow + (lane - tb * cpow);
    const int at = ((int)(group - g0) * (int)tbs + tb) * kTbStride;
    const float4* fpx = reinterpret_cast<const float4*>(s_fp + at);
    const int4* ipx = reinterpret_cast<const int4*>(s_ip + at);

    float best_err = CK_FLT_MAX;
    int best_rank = CK_BIG_RANK;
    int best_pk0 = 0, best_pk1 = 0;

    const bool valid = b < n && lane_i[2 * k_len + k] != 0
                       && pti[(size_t)b * 4 + lane_i[k_len + k]] == 0;
    if (valid)
        search_lane<MODE, FAST>(fpx, ipx, base, offset, alpha, lane_i, tweakf, b, k,
                                s_count, k_len, rounds, uniform, wt, best_err,
                                best_rank, best_pk0, best_pk1);

    // per-shape winner: butterfly over the cpow-aligned segment
    for (int step = 1; step < cpow; step <<= 1) {
        float pe = __shfl_xor_sync(0xffffffffu, best_err, step);
        int pr = __shfl_xor_sync(0xffffffffu, best_rank, step);
        int q0 = __shfl_xor_sync(0xffffffffu, best_pk0, step);
        int q1 = __shfl_xor_sync(0xffffffffu, best_pk1, step);
        if (ck::lex_better(pe, pr, best_err, best_rank)) {
            best_err = pe;
            best_rank = pr;
            best_pk0 = q0;
            best_pk1 = q1;
        }
    }

    if (b < n) {
        size_t o = (size_t)b * k_len + k;
        err_out[o] = best_err;
        rank_out[o] = best_rank;
        pk0_out[o] = best_pk0;
        pk1_out[o] = best_pk1;
    }
}

template <int MODE, bool FAST>
cudaError_t launch(const int* pix, const float* base, const float* offset,
                   const float* alpha, const int* pti, const int* lane_i,
                   const float* tweakf, int n, int s_count, int k_len, int cpow,
                   int rounds, int uniform, const Weights& wt, float* err,
                   int* rank, int* pk0, int* pk1, cudaStream_t stream) {
    const int tbs = 32 / cpow;
    const int warps = warps_per_block(cpow);
    const int segments = k_len / cpow;
    const long long tasks = (long long)((n + tbs - 1) / tbs) * segments;
    if (tasks > 0xffffffffLL - 32) return cudaErrorInvalidConfiguration;
    const long long blocks = (tasks + warps - 1) / warps;
    const int staged = staged_groups(warps, segments);
    const size_t smem = (size_t)staged * tbs * kTbStride * sizeof(float) * (FAST ? 2 : 1);
    single_plane_kernel<MODE, FAST><<<(unsigned)blocks, warps * 32, smem, stream>>>(
        pix, base, offset, alpha, pti, lane_i, tweakf, n, s_count, k_len, cpow,
        staged, rounds, uniform, wt, err, rank, pk0, pk1);
    return cudaGetLastError();
}

template <bool FAST>
cudaError_t launch_mode(int mode, const int* pix, const float* base,
                        const float* offset, const float* alpha, const int* pti,
                        const int* lane_i, const float* tweakf, int n, int s_count,
                        int k_len, int cpow, int rounds, int uniform,
                        const Weights& wt, float* err, int* rank, int* pk0,
                        int* pk1, cudaStream_t stream) {
#define CK_MODE_CASE(M)                                                         \
    case M:                                                                     \
        return launch<M, FAST>(pix, base, offset, alpha, pti, lane_i, tweakf, n, \
                               s_count, k_len, cpow, rounds, uniform, wt, err,  \
                               rank, pk0, pk1, stream);
    switch (mode) {
        CK_MODE_CASE(0)
        CK_MODE_CASE(1)
        CK_MODE_CASE(2)
        CK_MODE_CASE(3)
        CK_MODE_CASE(6)
        CK_MODE_CASE(7)
        default:
            return cudaErrorInvalidValue;
    }
#undef CK_MODE_CASE
}

}  // namespace

// pix [n, 64] i32; base, offset [n, s_count, 4] f32; alpha [n, s_count] f32;
// pti [n, 4] i32; lane_i [5, k_len] i32 (shape, parity, slot valid,
// member bits, rank), shape-major in segments of cpow lanes that share one
// shape; tweakf [2, k_len] f32; cw [4] f32 channel weights.
// Outputs err, rank, pk0, pk1 [n, k_len].
extern "C" int ck_single_plane_mode_best(
    int mode, const int* pix, const float* base, const float* offset,
    const float* alpha, const int* pti, const int* lane_i, const float* tweakf,
    int n, int s_count, int k_len, int cpow, int rounds, int fast_indexing,
    int uniform, const float* cw, float* err, int* rank, int* pk0, int* pk1,
    void* stream) {
    if (n == 0 || k_len == 0) return 0;
    if (cpow < 1 || cpow > 32 || (cpow & (cpow - 1)) != 0 || k_len % cpow != 0)
        return (int)cudaErrorInvalidValue;
    Weights wt;
    for (int ch = 0; ch < 4; ++ch) {
        wt.cw[ch] = cw[ch];
        wt.cw_sq[ch] = cw[ch] * cw[ch];
        wt.rcp_cw[ch] = cw[ch] == 0.0f ? 1.0f : 1.0f / cw[ch];
    }
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = fast_indexing
        ? launch_mode<true>(mode, pix, base, offset, alpha, pti, lane_i, tweakf, n,
                            s_count, k_len, cpow, rounds, uniform, wt, err, rank,
                            pk0, pk1, st)
        : launch_mode<false>(mode, pix, base, offset, alpha, pti, lane_i, tweakf,
                             n, s_count, k_len, cpow, rounds, uniform, wt, err,
                             rank, pk0, pk1, st);
    return (int)e;
}
