// BC7 single-plane candidate search (modes 0-3, 6, 7).
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// single_plane_mode_best (_kernel_body): for every packed (shape, tweak,
// parity) candidate lane of one mode, seed the tweaked endpoints from the
// shape's PCA line, then per refine round compress the endpoints, select
// indexes (with the +-1 retest when fast indexing is off), accumulate the
// error, refit the endpoints by least squares, and keep the lexicographic
// (error, rank) best over rounds. A butterfly over each power-of-two
// segment of cpow lanes then leaves the shape's winner on every lane of
// its segment, the contract models/bc7.py _combine_partitions reads.
//
// What bounds it on an H100: operations. Each lane runs 16 pixels x
// rounds of f32 and int32 arithmetic (about 2,300 operations a lane at
// q50 default options) on 64 bytes of pixels shared by a few thousand
// lanes, so the bytes it moves are negligible next to the arithmetic.
// Design: one thread per (block, candidate lane) with the refine loop,
// the endpoints and the refiner's accumulators in registers; the block's
// 64 pixels sit in shared memory, read by every thread of the block as a
// broadcast; per-lane statics are read once, coalesced; the per-shape
// winner is a __shfl_xor_sync butterfly, which never leaves a warp since
// cpow <= 16. The mode and the indexing kind are template parameters, so
// the index range and channel count are compile-time constants.
#include "bc7_common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <int MODE, bool FAST>
__global__ void __launch_bounds__(kThreads)
single_plane_kernel(const int* __restrict__ pix, const float* __restrict__ base,
                    const float* __restrict__ offset, const float* __restrict__ alpha,
                    const int* __restrict__ pti, const int* __restrict__ lane_i,
                    const float* __restrict__ tweakf, int s_count, int k_len,
                    int cpow, int rounds, int uniform, Weights wt,
                    float* __restrict__ err_out, int* __restrict__ rank_out,
                    int* __restrict__ pk0_out, int* __restrict__ pk1_out) {
    using MC = ModeConst<MODE>;
    constexpr int NRC = MC::kNrc;
    constexpr int RANGE = MC::kRange;

    __shared__ float s_fp[64];
    __shared__ float s_pw[64];
    __shared__ int s_ip[64];

    const int b = blockIdx.x;
    const int k = blockIdx.y * kThreads + threadIdx.x;
    if (threadIdx.x < 64) {
        int v = pix[(size_t)b * 64 + threadIdx.x];
        float f = (float)v;
        s_ip[threadIdx.x] = v;
        s_fp[threadIdx.x] = f;
        s_pw[threadIdx.x] = f * wt.cw[threadIdx.x & 3];
    }
    __syncthreads();

    float best_err = CK_FLT_MAX;
    int best_rank = CK_BIG_RANK;
    int best_pk0 = 0, best_pk1 = 0;

    if (k < k_len) {
        const int s = lane_i[k];
        const int p = lane_i[k_len + k];
        const bool slot_valid = lane_i[2 * k_len + k] != 0;
        const unsigned members = (unsigned)lane_i[3 * k_len + k];
        const int rank_k = lane_i[4 * k_len + k];
        const float f0 = tweakf[k];
        const float f1 = tweakf[k_len + k];
        const int p0 = p & 1, p1 = (p >> 1) & 1;

        const float* bs = base + ((size_t)b * s_count + s) * 4;
        const float* os = offset + ((size_t)b * s_count + s) * 4;
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
        const bool invalid = !slot_valid || pti[(size_t)b * 4 + p] != 0;
        const float al = invalid ? __int_as_float(0x7f800000)
                                 : alpha[(size_t)b * s_count + s];
        const float rcp_max_index = 1.0f / (float)(RANGE - 1);

        for (int refine = 0; refine < rounds; ++refine) {
            const bool last = refine == rounds - 1;
            int c[2][4];
            ck::compress_endpoints<MODE>(ep, p0, p1, c);
            ck::Selector<4> sel;
            sel.init(c[0], c[1], wt.cw, (float)(RANGE - 1));
            float ep_f[2][4];
            for (int j = 0; j < 2; ++j)
                for (int ch = 0; ch < 4; ++ch) ep_f[j][ch] = (float)c[j][ch];

            ck::Refiner<4> ref;
            ref.reset();
            float shape_error = 0.0f;
            int agg[4] = {0, 0, 0, 0};

            for (int px = 0; px < 16; ++px) {
                if (!((members >> px) & 1u)) continue;
                const float* fp = s_fp + px * 4;
                int index = sel.select(fp);
                if (FAST) {
                    int w = (MC::kRecip * index + 256) >> 9;
                    for (int ch = 0; ch < NRC; ++ch) {
                        int rec = ((64 - w) * c[0][ch] + w * c[1][ch] + 32) >> 6;
                        int d = rec - s_ip[px * 4 + ch];
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
                if (!last) ref.contribute(s_pw + px * 4, index, rcp_max_index, NRC);
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

    if (k < k_len) {
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
    dim3 grid(n, (k_len + kThreads - 1) / kThreads);
    single_plane_kernel<MODE, FAST><<<grid, kThreads, 0, stream>>>(
        pix, base, offset, alpha, pti, lane_i, tweakf, s_count, k_len, cpow,
        rounds, uniform, wt, err, rank, pk0, pk1);
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
// member bits, rank); tweakf [2, k_len] f32; cw [4] f32 channel weights.
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
