// BC7 dual-plane search (modes 4 and 5).
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// dual_plane_best (_dual_kernel_body, pallas_call at :716): TryDualPlane
// for every live (mode, rotation, index selector, tweak) lane — rotated
// channels, the rotation's RGB PCA line and alpha min/max, tweaked
// endpoints, then per refine round the per-lane-bits quantize/unquantize,
// RGB and alpha index selection (with the +-1 retest when fast indexing is
// off), the errors, the least-squares refit, and the lexicographic
// (error, rank) best per plane with its endpoints and 16 indexes.
//
// What bounds it on an H100: operations, at the issue rate (one lane
// operation per scheduler and clock, 33.45e12 a second: the kernel is
// built with -fmad=false, so no multiply-add counts twice). A live lane
// does about 2,650 operations at q50 default options (fast indexing, 2
// rounds: 16 pixels x 2 planes of index selection a round) and writes 176
// bytes; each rotation's pixels and PCA line, about 1,060 operations, are
// needed once per texture block. Tensor cores do not apply (no matrix product, and every
// multiply and add must round on its own), and neither does TMA (the
// input is 256 bytes a texture block).
//
// Layout: what used to hold it back was one 128-thread CUDA block per
// texture block with 48 lanes (39 live at q50), 255 registers a thread
// (64-float copies of the rotated pixels, four int[16] index arrays) and
// so 3 working warps an SM, each lane redoing its rotation's PCA. Now a
// CUDA block covers several texture blocks: its threads are the
// (texture block, live lane) pairs, so no thread idles but the last few.
// The work order comes with the launch (bc7_kernel.dual_plane_order
// derives it from the lane constants, once per plan): the live lanes, the
// dead ones (their +inf error never beats the FLT_MAX start, so their
// outputs are the start state), each live lane's rotation slot and each
// rotation's first lane. One thread per (texture block, rotation) computes
// the rotation's PCA line and alpha range into shared memory, from the
// same inputs as each lane had, so bit for bit the same. Lanes read the
// pixels and that line from shared memory as broadcasts, keep their
// current and winning indexes packed 4 bits each in 64-bit words, and
// write once at the end. A thread takes at most 128 registers and no
// stack, so an SM holds 2 CUDA blocks, 16 warps.
#include "bc7_common.cuh"

namespace {

constexpr int kThreads = 256;
// CUDA blocks an SM must hold: caps the registers at 128 a thread, so 16
// warps an SM, with no stack (a cap of 80, 3 blocks an SM, spills)
constexpr int kMinBlocks = 2;
constexpr int kMaxLanes = 256;
constexpr int kMaxTexBlocks = 64;   // texture blocks a CUDA block may cover
// shared-memory words a staged texture block takes: its 64 pixel values and
// 4 of padding, so that the same pixel of two texture blocks falls in
// different banks, and each pixel's 4 channels are one 16-byte load
constexpr int kTbStride = 68;

// ci rows (bc7_kernel.py dual-plane constant layout)
enum { CI_CH0_IS3, CI_CH1_IS3, CI_CH2_IS3, CI_A_SRC0, CI_A_SRC1, CI_A_SRC2,
       CI_RANKT, CI_A_RAW, CI_RGB_BITS, CI_A_BITS, CI_RGB_MAXI, CI_A_MAXI };
// cf rows
enum { CF_INV, CF_RGB_MV, CF_RGB_RECIP, CF_A_MV, CF_A_RECIP, CF_RGB_RCPMAX,
       CF_A_RCPMAX, CF_CW0, CF_CW1, CF_CW2, CF_CWSQ0, CF_CWSQ1, CF_CWSQ2,
       CF_A_CWSQ, CF_RCW0, CF_RCW1, CF_RCW2, CF_RF0, CF_RF1, CF_AF0, CF_AF1 };
// order rows (bc7_kernel.dual_plane_order)
enum { ORDER_LANE, ORDER_SLOT, ORDER_ROTATION_LANE };

// a rotation's RGB PCA line and alpha range, per texture block
struct RotationLine {
    float base[3], offset[3], amin, amax;
};

// Texture blocks a CUDA block covers: as many as its threads have live
// lanes for.
__host__ __forceinline__ int tex_blocks(int n_live) {
    const int g = n_live > 0 ? kThreads / n_live : kMaxTexBlocks;
    return g < 1 ? 1 : g > kMaxTexBlocks ? kMaxTexBlocks : g;
}

__device__ __forceinline__ int quant_unquant(int c, int bits) {
    return ck::unquantize(ck::quantize(c, bits), bits);
}

template <bool FAST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dual_plane_kernel(const int* __restrict__ pix, const int* __restrict__ ci,
                  const float* __restrict__ cf, const int* __restrict__ order,
                  int n, int lanes, int n_live, int n_rot, int tbs, int rounds,
                  int uniform, float* __restrict__ rgb_err_out,
                  int* __restrict__ rgb_rank_out, int* __restrict__ rgb_ep_out,
                  int* __restrict__ rgb_idx_out, float* __restrict__ a_err_out,
                  int* __restrict__ a_rank_out, int* __restrict__ a_ep_out,
                  int* __restrict__ a_idx_out) {
    extern __shared__ float4 smem4[];
    float* s_fp = reinterpret_cast<float*>(smem4);                // [tbs][kTbStride]
    RotationLine* s_line =
        reinterpret_cast<RotationLine*>(s_fp + tbs * kTbStride);  // [tbs][n_rot]

    const int t = threadIdx.x;
    const int tb0 = blockIdx.x * tbs;
    auto I = [&](int row, int k) { return ci[row * lanes + k]; };
    auto F = [&](int row, int k) { return cf[row * lanes + k]; };
    auto O = [&](int row, int i) { return order[row * lanes + i]; };

    // 1. the pixels of the texture blocks, as floats
    for (int i = t; i < tbs * 64; i += blockDim.x)
        s_fp[i / 64 * kTbStride + i % 64] =
            tb0 + i / 64 < n ? (float)pix[(size_t)tb0 * 64 + i] : 0.0f;
    __syncthreads();

    // 2. per (texture block, rotation): the rotated RGB PCA line and the
    // rotated alpha's min and max
    for (int task = t; task < tbs * n_rot; task += blockDim.x) {
        const int g = task / n_rot, r = task - g * n_rot;
        if (tb0 + g >= n) continue;
        const int k = O(ORDER_ROTATION_LANE, r);
        int chan[3];
        float cw[3];
        for (int c = 0; c < 3; ++c) {
            chan[c] = I(CI_CH0_IS3 + c, k) != 0 ? 3 : c;
            cw[c] = F(CF_CW0 + c, k);
        }
        const int a_chan = I(CI_A_SRC0, k) != 0 ? 0 : I(CI_A_SRC1, k) != 0 ? 1
                           : I(CI_A_SRC2, k) != 0 ? 2 : 3;
        const float* fp = s_fp + g * kTbStride;
        RotationLine line;
        ck::pca_endpoints_at<3>(
            [&](int px, int c) { return fp[px * 4 + chan[c]] * cw[c]; },
            [](int) { return 1.0f; }, 0xFFFFu, cw, line.base, line.offset);
        float amin = fp[a_chan], amax = fp[a_chan];
        for (int px = 1; px < 16; ++px) {
            amin = fminf(fp[px * 4 + a_chan], amin);
            amax = fmaxf(fp[px * 4 + a_chan], amax);
        }
        line.amin = amin;
        line.amax = amax;
        s_line[g * n_rot + r] = line;
    }
    __syncthreads();

    // dead lanes keep the start state
    const int n_dead = lanes - n_live;
    for (int d = t; d < tbs * n_dead; d += blockDim.x) {
        const int g = d / n_dead;
        const int k = O(ORDER_LANE, n_live + d - g * n_dead);
        const size_t b = (size_t)tb0 + g;
        if (b >= (size_t)n) continue;
        const size_t o = b * lanes + k;
        rgb_err_out[o] = CK_FLT_MAX;
        rgb_rank_out[o] = CK_BIG_RANK;
        a_err_out[o] = CK_FLT_MAX;
        a_rank_out[o] = CK_BIG_RANK;
        for (int i = 0; i < 6; ++i) rgb_ep_out[(b * 6 + i) * lanes + k] = 0;
        for (int i = 0; i < 2; ++i) a_ep_out[(b * 2 + i) * lanes + k] = 0;
        for (int px = 0; px < 16; ++px) {
            rgb_idx_out[(b * 16 + px) * lanes + k] = 0;
            a_idx_out[(b * 16 + px) * lanes + k] = 0;
        }
    }

    // 3. one thread per (texture block, live lane)
    if (t >= tbs * n_live) return;
    const int g = t / n_live;
    const int i_live = t - g * n_live;
    const int k = O(ORDER_LANE, i_live);
    if (tb0 + g >= n) return;
    const size_t b = (size_t)tb0 + g;
    const float4* fpx = reinterpret_cast<const float4*>(s_fp + g * kTbStride);

    const float inv = F(CF_INV, k);
    const float rgb_mv = F(CF_RGB_MV, k), rgb_recip = F(CF_RGB_RECIP, k);
    const float a_mv = F(CF_A_MV, k), a_recip = F(CF_A_RECIP, k);
    const float cw[3] = {F(CF_CW0, k), F(CF_CW1, k), F(CF_CW2, k)};
    const float cwsq[3] = {F(CF_CWSQ0, k), F(CF_CWSQ1, k), F(CF_CWSQ2, k)};
    const float a_cwsq = F(CF_A_CWSQ, k);
    const float rcw[3] = {F(CF_RCW0, k), F(CF_RCW1, k), F(CF_RCW2, k)};
    const float one[1] = {1.0f};
    const float rgb_rcpmax = F(CF_RGB_RCPMAX, k), a_rcpmax = F(CF_A_RCPMAX, k);
    const int rankt = I(CI_RANKT, k);
    const bool a_raw = I(CI_A_RAW, k) != 0;
    const int rgb_bits = I(CI_RGB_BITS, k), a_bits = I(CI_A_BITS, k);
    const int rgb_maxi = I(CI_RGB_MAXI, k), a_maxi = I(CI_A_MAXI, k);
    bool is3[3];
    for (int c = 0; c < 3; ++c) is3[c] = I(CI_CH0_IS3 + c, k) != 0;
    const int a_chan = I(CI_A_SRC0, k) != 0 ? 0 : I(CI_A_SRC1, k) != 0 ? 1
                       : I(CI_A_SRC2, k) != 0 ? 2 : 3;

    const RotationLine& line = s_line[g * n_rot + O(ORDER_SLOT, i_live)];
    const float rf0 = F(CF_RF0, k), rf1 = F(CF_RF1, k);
    const float af0 = F(CF_AF0, k), af1 = F(CF_AF1, k);
    int rgb_ep[2][3], alpha_ep[2];
    for (int ch = 0; ch < 3; ++ch) {
        rgb_ep[0][ch] = ck::round_int(ck::clampf(line.base[ch] + line.offset[ch] * rf0, 0.0f, 255.0f));
        rgb_ep[1][ch] = ck::round_int(ck::clampf(line.base[ch] + line.offset[ch] * rf1, 0.0f, 255.0f));
    }
    const float a_base = line.amin;
    const float a_offs = line.amax - a_base;
    alpha_ep[0] = ck::round_int(ck::clampf(a_base + a_offs * af0, 0.0f, 255.0f));
    alpha_ep[1] = ck::round_int(ck::clampf(a_base + a_offs * af1, 0.0f, 255.0f));

    float rgb_best_err = CK_FLT_MAX, a_best_err = CK_FLT_MAX;
    int rgb_best_rank = CK_BIG_RANK, a_best_rank = CK_BIG_RANK;
    int rgb_best_ep[6] = {0, 0, 0, 0, 0, 0}, a_best_ep[2] = {0, 0};
    // 16 indexes, 4 bits each (index px at bits 4*px)
    unsigned long long rgb_best_idx = 0ull, a_best_idx = 0ull;

    for (int refine = 0; refine < rounds; ++refine) {
        const bool last = refine == rounds - 1;
        // CompressEndpoints4/5 with per-lane bit counts
        for (int j = 0; j < 2; ++j) {
            for (int ch = 0; ch < 3; ++ch) rgb_ep[j][ch] = quant_unquant(rgb_ep[j][ch], rgb_bits);
            if (!a_raw) alpha_ep[j] = quant_unquant(alpha_ep[j], a_bits);
        }

        ck::Selector<3> rgb_sel;
        rgb_sel.init(rgb_ep[0], rgb_ep[1], cw, rgb_mv);
        ck::Selector<1> a_sel;
        a_sel.init(&alpha_ep[0], &alpha_ep[1], one, a_mv);
        float rgb_ep_f[2][3], a_ep_f[2];
        for (int j = 0; j < 2; ++j) {
            for (int ch = 0; ch < 3; ++ch) rgb_ep_f[j][ch] = (float)rgb_ep[j][ch];
            a_ep_f[j] = (float)alpha_ep[j];
        }
        ck::Refiner<3> rgb_ref;
        rgb_ref.reset();
        ck::Refiner<1> a_ref;
        a_ref.reset();

        float error_rgb = 0.0f, error_a = 0.0f;
        float agg_rgb[3] = {0.0f, 0.0f, 0.0f};
        float agg_a = 0.0f;
        unsigned long long rgb_idx = 0ull, a_idx = 0ull;

        for (int px = 0; px < 16; ++px) {
            const float4 p = fpx[px];
            const float fp[3] = {is3[0] ? p.w : p.x, is3[1] ? p.w : p.y,
                                 is3[2] ? p.w : p.z};
            const float af = a_chan == 0 ? p.x : a_chan == 1 ? p.y
                             : a_chan == 2 ? p.z : p.w;
            int ri = rgb_sel.select(fp);
            int ai = a_sel.select(&af);

            if (FAST) {
                float rw = ck::recon_weight_f32(ri, rgb_recip);
                for (int ch = 0; ch < 3; ++ch) {
                    float d = ck::recon_f32(rw, rgb_ep_f[0][ch], rgb_ep_f[1][ch]) - fp[ch];
                    agg_rgb[ch] = agg_rgb[ch] + d * d;
                }
                float aw = ck::recon_weight_f32(ai, a_recip);
                float da = ck::recon_f32(aw, a_ep_f[0], a_ep_f[1]) - af;
                agg_a = agg_a + da * da;
            } else {
                auto rgb_err = [&](int iv) {
                    float w = ck::recon_weight_f32(iv, rgb_recip);
                    float errs[3];
                    for (int c2 = 0; c2 < 3; ++c2) {
                        float d = ck::recon_f32(w, rgb_ep_f[0][c2], rgb_ep_f[1][c2]) - fp[c2];
                        errs[c2] = d * d;
                    }
                    if (uniform) {
                        float e = errs[0] + errs[1];
                        return e + errs[2];
                    }
                    float e = errs[0] * cwsq[0];
                    for (int c2 = 1; c2 < 3; ++c2) e = e + errs[c2] * cwsq[c2];
                    return e;
                };
                auto a_err = [&](int iv) {
                    float w = ck::recon_weight_f32(iv, a_recip);
                    float d = ck::recon_f32(w, a_ep_f[0], a_ep_f[1]) - af;
                    float e = d * d;
                    return uniform ? e : e * a_cwsq;
                };
                float re = rgb_err(ri);
                float ae = a_err(ai);
                const int r_alt[2] = {max(ri, 1) - 1, min(ri + 1, rgb_maxi)};
                const int a_alt[2] = {max(ai, 1) - 1, min(ai + 1, a_maxi)};
                for (int ii = 0; ii < 2; ++ii) {
                    float are = rgb_err(r_alt[ii]);
                    float aae = a_err(a_alt[ii]);
                    const bool rb = are < re;
                    const bool ab = aae < ae;
                    re = fminf(are, re);
                    ae = fminf(aae, ae);
                    if (rb) ri = r_alt[ii];
                    if (ab) ai = a_alt[ii];
                }
                error_rgb = error_rgb + re;
                error_a = error_a + ae;
            }

            if (!last) {
                const float pw[3] = {fp[0] * cw[0], fp[1] * cw[1], fp[2] * cw[2]};
                rgb_ref.contribute(pw, ri, rgb_rcpmax, 3);
                a_ref.contribute(&af, ai, a_rcpmax, 1);
            }
            rgb_idx |= (unsigned long long)(ri & 15) << (4 * px);
            a_idx |= (unsigned long long)(ai & 15) << (4 * px);
        }

        if (FAST) {
            if (uniform) {
                float e = agg_rgb[0] + agg_rgb[1];
                error_rgb = e + agg_rgb[2];
                error_a = agg_a;
            } else {
                error_rgb = agg_rgb[0] * cwsq[0];
                for (int c2 = 1; c2 < 3; ++c2) error_rgb = error_rgb + agg_rgb[c2] * cwsq[c2];
                error_a = agg_a * a_cwsq;
            }
        }

        const int rank_r = rankt * rounds + refine;
        const float rgb_e = error_rgb + inv;
        if (ck::lex_better(rgb_e, rank_r, rgb_best_err, rgb_best_rank)) {
            rgb_best_err = rgb_e;
            rgb_best_rank = rank_r;
            for (int j = 0; j < 2; ++j)
                for (int ch = 0; ch < 3; ++ch) rgb_best_ep[j * 3 + ch] = rgb_ep[j][ch];
            rgb_best_idx = rgb_idx;
        }
        const float a_e = error_a + inv;
        if (ck::lex_better(a_e, rank_r, a_best_err, a_best_rank)) {
            a_best_err = a_e;
            a_best_rank = rank_r;
            a_best_ep[0] = alpha_ep[0];
            a_best_ep[1] = alpha_ep[1];
            a_best_idx = a_idx;
        }

        if (!last) {
            rgb_ref.refined_ldr(rcw, 3, rgb_ep[0], rgb_ep[1]);
            a_ref.refined_ldr(one, 1, &alpha_ep[0], &alpha_ep[1]);
        }
    }

    const size_t o = b * lanes + k;
    rgb_err_out[o] = rgb_best_err;
    rgb_rank_out[o] = rgb_best_rank;
    a_err_out[o] = a_best_err;
    a_rank_out[o] = a_best_rank;
    for (int i = 0; i < 6; ++i) rgb_ep_out[(b * 6 + i) * lanes + k] = rgb_best_ep[i];
    for (int i = 0; i < 2; ++i) a_ep_out[(b * 2 + i) * lanes + k] = a_best_ep[i];
    for (int px = 0; px < 16; ++px) {
        rgb_idx_out[(b * 16 + px) * lanes + k] = (int)((rgb_best_idx >> (4 * px)) & 15u);
        a_idx_out[(b * 16 + px) * lanes + k] = (int)((a_best_idx >> (4 * px)) & 15u);
    }
}

}  // namespace

// pix [n, 64] i32; ci [12, lanes] i32 and cf [21, lanes] f32 per-lane
// constants (lanes <= 256; index ranges <= 16); order [3, lanes] i32, the
// work order of bc7_kernel.dual_plane_order: its n_live live lanes, then
// the dead ones; each live lane's rotation slot; each of the n_rot
// rotations' first lane. Outputs rgb_err, a_err [n, lanes] f32; rgb_rank,
// a_rank [n, lanes] i32; rgb_ep [n, 6, lanes], a_ep [n, 2, lanes], rgb_idx
// and a_idx [n, 16, lanes] i32.
extern "C" int ck_dual_plane_best(const int* pix, const int* ci, const float* cf,
                                  const int* order, int n, int lanes, int n_live,
                                  int n_rot, int rounds, int uniform,
                                  int fast_indexing, float* rgb_err, int* rgb_rank,
                                  int* rgb_ep, int* rgb_idx, float* a_err,
                                  int* a_rank, int* a_ep, int* a_idx, void* stream) {
    if (n == 0 || lanes == 0) return 0;
    if (lanes > kMaxLanes || n_live < 0 || n_live > lanes || n_rot < 0
        || n_rot > n_live)
        return (int)cudaErrorInvalidValue;
    const int tbs = tex_blocks(n_live);
    // tbs * n_live <= kThreads; the dead lanes' writes stride over these
    const int threads = n_live > 0 ? (tbs * n_live + 31) / 32 * 32 : 32;
    const int blocks = (n + tbs - 1) / tbs;
    const size_t smem = (size_t)tbs * kTbStride * sizeof(float)
                        + (size_t)tbs * n_rot * sizeof(RotationLine);
    cudaStream_t st = (cudaStream_t)stream;
    if (fast_indexing)
        dual_plane_kernel<true><<<blocks, threads, smem, st>>>(
            pix, ci, cf, order, n, lanes, n_live, n_rot, tbs, rounds, uniform,
            rgb_err, rgb_rank, rgb_ep, rgb_idx, a_err, a_rank, a_ep, a_idx);
    else
        dual_plane_kernel<false><<<blocks, threads, smem, st>>>(
            pix, ci, cf, order, n, lanes, n_live, n_rot, tbs, rounds, uniform,
            rgb_err, rgb_rank, rgb_ep, rgb_idx, a_err, a_rank, a_ep, a_idx);
    return (int)cudaGetLastError();
}
