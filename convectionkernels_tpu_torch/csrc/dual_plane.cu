// BC7 dual-plane search (modes 4 and 5).
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// dual_plane_best (_dual_kernel_body): TryDualPlane for every live
// (mode, rotation, index selector, tweak) lane — rotated channels, the
// rotation's RGB PCA line and alpha min/max, tweaked endpoints, then per
// refine round the per-lane-bits quantize/unquantize, RGB and alpha index
// selection (with the +-1 retest when fast indexing is off), the errors,
// the least-squares refit, and the lexicographic (error, rank) best per
// plane with its endpoints and 16 indexes.
//
// What bounds it on an H100: operations. Each lane runs the 3-channel PCA
// and 16 pixels x rounds of index selection for two planes (about 4,000
// operations a lane at q50 default options) and writes 176 bytes; the
// inputs are 256 bytes of pixels per block and the per-lane constant rows.
// Design: one thread per (block, live lane) — only the len(combos) * 4
// live lanes, not the TPU's 128 padded ones; the block's pixels sit in
// shared memory, read as a broadcast; the per-lane constant rows are read
// once; winners' indexes stay in registers until the single write.
#include "bc7_common.cuh"

namespace {

constexpr int kThreads = 128;

// ci rows (bc7_kernel.py dual-plane constant layout)
enum { CI_CH0_IS3, CI_CH1_IS3, CI_CH2_IS3, CI_A_SRC0, CI_A_SRC1, CI_A_SRC2,
       CI_RANKT, CI_A_RAW, CI_RGB_BITS, CI_A_BITS, CI_RGB_MAXI, CI_A_MAXI };
// cf rows
enum { CF_INV, CF_RGB_MV, CF_RGB_RECIP, CF_A_MV, CF_A_RECIP, CF_RGB_RCPMAX,
       CF_A_RCPMAX, CF_CW0, CF_CW1, CF_CW2, CF_CWSQ0, CF_CWSQ1, CF_CWSQ2,
       CF_A_CWSQ, CF_RCW0, CF_RCW1, CF_RCW2, CF_RF0, CF_RF1, CF_AF0, CF_AF1 };

__device__ __forceinline__ int quant_unquant(int c, int bits) {
    return ck::unquantize(ck::quantize(c, bits), bits);
}

template <bool FAST>
__global__ void __launch_bounds__(kThreads)
dual_plane_kernel(const int* __restrict__ pix, const int* __restrict__ ci,
                  const float* __restrict__ cf, int lanes, int rounds,
                  int uniform, float* __restrict__ rgb_err_out,
                  int* __restrict__ rgb_rank_out, int* __restrict__ rgb_ep_out,
                  int* __restrict__ rgb_idx_out, float* __restrict__ a_err_out,
                  int* __restrict__ a_rank_out, int* __restrict__ a_ep_out,
                  int* __restrict__ a_idx_out) {
    __shared__ int s_pix[64];
    const int b = blockIdx.x;
    const int k = blockIdx.y * kThreads + threadIdx.x;
    if (threadIdx.x < 64) s_pix[threadIdx.x] = pix[(size_t)b * 64 + threadIdx.x];
    __syncthreads();
    if (k >= lanes) return;

    auto I = [&](int row) { return ci[row * lanes + k]; };
    auto F = [&](int row) { return cf[row * lanes + k]; };

    const float inv = F(CF_INV);
    const float rgb_mv = F(CF_RGB_MV), rgb_recip = F(CF_RGB_RECIP);
    const float a_mv = F(CF_A_MV), a_recip = F(CF_A_RECIP);
    const float cw[3] = {F(CF_CW0), F(CF_CW1), F(CF_CW2)};
    const float cwsq[3] = {F(CF_CWSQ0), F(CF_CWSQ1), F(CF_CWSQ2)};
    const float a_cwsq = F(CF_A_CWSQ);
    const float rcw[3] = {F(CF_RCW0), F(CF_RCW1), F(CF_RCW2)};
    const float one[1] = {1.0f};
    const float rgb_rcpmax = F(CF_RGB_RCPMAX), a_rcpmax = F(CF_A_RCPMAX);
    const int rankt = I(CI_RANKT);
    const bool a_raw = I(CI_A_RAW) != 0;
    const int rgb_bits = I(CI_RGB_BITS), a_bits = I(CI_A_BITS);
    const int rgb_maxi = I(CI_RGB_MAXI), a_maxi = I(CI_A_MAXI);
    const bool is3[3] = {I(CI_CH0_IS3) != 0, I(CI_CH1_IS3) != 0, I(CI_CH2_IS3) != 0};
    const bool a_src[3] = {I(CI_A_SRC0) != 0, I(CI_A_SRC1) != 0, I(CI_A_SRC2) != 0};

    // rotated pixels: rgb_f/pw_rot in the pca layout (px*4 + ch), alpha
    float rgb_f[64], pw_rot[64], a_f[16];
    int amin = 0, amax = 0;
    for (int px = 0; px < 16; ++px) {
        const int* col = s_pix + px * 4;
        for (int ch = 0; ch < 3; ++ch) {
            float f = (float)(is3[ch] ? col[3] : col[ch]);
            rgb_f[px * 4 + ch] = f;
            pw_rot[px * 4 + ch] = f * cw[ch];
        }
        rgb_f[px * 4 + 3] = 0.0f;
        pw_rot[px * 4 + 3] = 0.0f;
        int av = a_src[0] ? col[0] : a_src[1] ? col[1] : a_src[2] ? col[2] : col[3];
        a_f[px] = (float)av;
        if (px == 0) {
            amin = av;
            amax = av;
        } else {
            amin = min(av, amin);
            amax = max(av, amax);
        }
    }

    float ones[16];
    for (int px = 0; px < 16; ++px) ones[px] = 1.0f;
    float base[3], offset[3];
    ck::pca_endpoints<3>(pw_rot, ones, 0xFFFFu, cw, base, offset);

    const float rf0 = F(CF_RF0), rf1 = F(CF_RF1), af0 = F(CF_AF0), af1 = F(CF_AF1);
    int rgb_ep[2][3], alpha_ep[2];
    for (int ch = 0; ch < 3; ++ch) {
        rgb_ep[0][ch] = ck::round_int(ck::clampf(base[ch] + offset[ch] * rf0, 0.0f, 255.0f));
        rgb_ep[1][ch] = ck::round_int(ck::clampf(base[ch] + offset[ch] * rf1, 0.0f, 255.0f));
    }
    const float a_base = (float)amin;
    const float a_offs = (float)amax - a_base;
    alpha_ep[0] = ck::round_int(ck::clampf(a_base + a_offs * af0, 0.0f, 255.0f));
    alpha_ep[1] = ck::round_int(ck::clampf(a_base + a_offs * af1, 0.0f, 255.0f));

    float rgb_best_err = CK_FLT_MAX, a_best_err = CK_FLT_MAX;
    int rgb_best_rank = CK_BIG_RANK, a_best_rank = CK_BIG_RANK;
    int rgb_best_ep[6] = {0, 0, 0, 0, 0, 0}, a_best_ep[2] = {0, 0};
    int rgb_best_idx[16], a_best_idx[16];
    for (int px = 0; px < 16; ++px) {
        rgb_best_idx[px] = 0;
        a_best_idx[px] = 0;
    }

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
        int rgb_idx[16], a_idx[16];

        for (int px = 0; px < 16; ++px) {
            const float* fp = rgb_f + px * 4;
            int ri = rgb_sel.select(fp);
            int ai = a_sel.select(a_f + px);

            if (FAST) {
                float rw = ck::recon_weight_f32(ri, rgb_recip);
                for (int ch = 0; ch < 3; ++ch) {
                    float d = ck::recon_f32(rw, rgb_ep_f[0][ch], rgb_ep_f[1][ch]) - fp[ch];
                    agg_rgb[ch] = agg_rgb[ch] + d * d;
                }
                float aw = ck::recon_weight_f32(ai, a_recip);
                float da = ck::recon_f32(aw, a_ep_f[0], a_ep_f[1]) - a_f[px];
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
                        float t = errs[0] + errs[1];
                        return t + errs[2];
                    }
                    float t = errs[0] * cwsq[0];
                    for (int c2 = 1; c2 < 3; ++c2) t = t + errs[c2] * cwsq[c2];
                    return t;
                };
                auto a_err = [&](int iv) {
                    float w = ck::recon_weight_f32(iv, a_recip);
                    float d = ck::recon_f32(w, a_ep_f[0], a_ep_f[1]) - a_f[px];
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
                rgb_ref.contribute(pw_rot + px * 4, ri, rgb_rcpmax, 3);
                a_ref.contribute(a_f + px, ai, a_rcpmax, 1);
            }
            rgb_idx[px] = ri;
            a_idx[px] = ai;
        }

        if (FAST) {
            if (uniform) {
                float t = agg_rgb[0] + agg_rgb[1];
                error_rgb = t + agg_rgb[2];
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
            for (int px = 0; px < 16; ++px) rgb_best_idx[px] = rgb_idx[px];
        }
        const float a_e = error_a + inv;
        if (ck::lex_better(a_e, rank_r, a_best_err, a_best_rank)) {
            a_best_err = a_e;
            a_best_rank = rank_r;
            a_best_ep[0] = alpha_ep[0];
            a_best_ep[1] = alpha_ep[1];
            for (int px = 0; px < 16; ++px) a_best_idx[px] = a_idx[px];
        }

        if (!last) {
            rgb_ref.refined_ldr(rcw, 3, rgb_ep[0], rgb_ep[1]);
            a_ref.refined_ldr(one, 1, &alpha_ep[0], &alpha_ep[1]);
        }
    }

    const size_t o = (size_t)b * lanes + k;
    rgb_err_out[o] = rgb_best_err;
    rgb_rank_out[o] = rgb_best_rank;
    a_err_out[o] = a_best_err;
    a_rank_out[o] = a_best_rank;
    for (int i = 0; i < 6; ++i) rgb_ep_out[((size_t)b * 6 + i) * lanes + k] = rgb_best_ep[i];
    for (int i = 0; i < 2; ++i) a_ep_out[((size_t)b * 2 + i) * lanes + k] = a_best_ep[i];
    for (int px = 0; px < 16; ++px) {
        rgb_idx_out[((size_t)b * 16 + px) * lanes + k] = rgb_best_idx[px];
        a_idx_out[((size_t)b * 16 + px) * lanes + k] = a_best_idx[px];
    }
}

}  // namespace

// pix [n, 64] i32; ci [12, lanes] i32 and cf [21, lanes] f32 per-lane
// constants. Outputs rgb_err, a_err [n, lanes] f32; rgb_rank, a_rank
// [n, lanes] i32; rgb_ep [n, 6, lanes], a_ep [n, 2, lanes], rgb_idx and
// a_idx [n, 16, lanes] i32.
extern "C" int ck_dual_plane_best(const int* pix, const int* ci, const float* cf,
                                  int n, int lanes, int rounds, int uniform,
                                  int fast_indexing, float* rgb_err, int* rgb_rank,
                                  int* rgb_ep, int* rgb_idx, float* a_err,
                                  int* a_rank, int* a_ep, int* a_idx, void* stream) {
    if (n == 0 || lanes == 0) return 0;
    dim3 grid(n, (lanes + kThreads - 1) / kThreads);
    cudaStream_t st = (cudaStream_t)stream;
    if (fast_indexing)
        dual_plane_kernel<true><<<grid, kThreads, 0, st>>>(
            pix, ci, cf, lanes, rounds, uniform, rgb_err, rgb_rank, rgb_ep,
            rgb_idx, a_err, a_rank, a_ep, a_idx);
    else
        dual_plane_kernel<false><<<grid, kThreads, 0, st>>>(
            pix, ci, cf, lanes, rounds, uniform, rgb_err, rgb_rank, rgb_ep,
            rgb_idx, a_err, a_rank, a_ep, a_idx);
    return (int)cudaGetLastError();
}
