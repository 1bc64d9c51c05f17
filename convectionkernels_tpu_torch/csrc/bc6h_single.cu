// single_group_meta_rounds: every meta round (tweak x refine) of one
// single-mode BC6H precision group (aPrec 16, 12, 11 or 10: one subset of
// all 16 pixels, 4-bit indexes, fixup pixel 0).
//
// Replaces no TPU kernel: the JAX package runs these groups as XLA ops in
// convectionkernels_tpu/models/bc6h.py, and the port ran them as about
// 7,300 torch ops a group, graph nodes of a few microseconds each whatever
// the block count. Mirrors, operation for operation,
// models/bc6h_common.py meta_round_chain with index range 16, as
// models/bc6h_kernel.py single_group_meta_rounds_plain calls it.
//
// Design: 16 lanes a texture block, one a pixel, so a warp holds two blocks
// and a CUDA block of 64 threads four. The buckets this kernel serves are
// mostly small (256 and 1,024 blocks in every mip-tail replay and tile), so
// its time is set by latency: one thread a block would put a 256-block
// bucket on two SMs and run 12 rounds of 16 x 16 interpolant scans
// serially. Here lane r computes interpolant r of the round and lane px
// scans its pixel's 16 interpolants (strict <, first index wins) and
// computes its error. Where the chain sums in pixel order (the subset
// error, the refiner's totals), every lane of the block gathers the 16
// values through __shfl_sync and adds them in that order, so all 16 lanes
// hold the same totals and the same refined endpoints, bit for bit as the
// chain has them, without a broadcast. The dedup keeps each earlier round's
// stored endpoints in the registers of the lane whose number is the round's
// position (at most 12 rounds, 16 lanes) and asks the block's lanes with a
// ballot. Blocks past N in the last CUDA block compute block N-1 again and
// store nothing, so every lane of a warp reaches every shuffle.
//
// Exactness (see bc7_common.cuh): no FMA contraction, IEEE divide,
// subnormals kept; the chained sums keep the reference's order (len_sq,
// dist, the per-interpolant error, the pixel errors, the subset error and
// the refiner's totals over pixels 0..15); >> on negative ints is
// arithmetic; the integer square of the fast path wraps in 32 bits.
//
// Bound on an H100: operations (about 60 thousand float32/int32 operations
// a texture block at 12 rounds against 1.4 KB moved; chip_smoke.py's
// work_bc6h_single has the counts), with latency ruling the small buckets.
#include "bc6h_common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int LANES = 16;            // one lane a pixel
constexpr int BLOCKS_PER_CTA = 4;    // texture blocks a CUDA block holds
constexpr int THREADS = LANES * BLOCKS_PER_CTA;
constexpr int INDEX_RANGE = 16;
constexpr int MAX_ROUNDS = 12;

struct Params {
    float cw[3], cw_sq[3], rcp_cw[3];
    float tweak0[4], tweak1[4];
    float rcp_max_index;
    int weight_reciprocal;           // g_weightReciprocals[16]
};

template <bool SIGNED, bool FAST>
__global__ void __launch_bounds__(THREADS)
bc6h_single_kernel(const int* __restrict__ pix, const float* __restrict__ base,
                   const float* __restrict__ offset, int n_blocks, int aprec,
                   int uniform, int num_tweaks, int num_refines, Params prm,
                   float* err_out, int* valid_out, int* eps_out, int* idx_out) {
    __shared__ float s_pw[BLOCKS_PER_CTA][48];   // ToFloat * cw

    const int slot = threadIdx.x / LANES;
    const int px = threadIdx.x % LANES;
    const long long n_raw = (long long)blockIdx.x * BLOCKS_PER_CTA + slot;
    const bool live = n_raw < n_blocks;
    const size_t n = live ? (size_t)n_raw : (size_t)(n_blocks - 1);
    // this block's lanes in a ballot of the warp
    const unsigned block_lanes = 0xFFFFu << (threadIdx.x & 16);

    // this lane's pixel
    int p2cl[3];
    float f2cl[3], unw[3], linw[3];
    for (int ch = 0; ch < 3; ++ch) {
        int v = pix[n * 48 + px * 3 + ch];
        float f = (float)v;
        float tw = bc6h::twoscl_half_to_float(v);
        p2cl[ch] = v;
        f2cl[ch] = f;
        unw[ch] = tw;
        linw[ch] = tw * prm.cw[ch];
        s_pw[slot][px * 3 + ch] = f * prm.cw[ch];
    }
    __syncwarp();

    const float lo = SIGNED ? -31743.0f : 0.0f;
    const float max_value = (float)(INDEX_RANGE - 1);
    const int half_range_m1 = INDEX_RANGE / 2 - 1;
    const int a_count = num_tweaks * num_refines;
    // the weight of index px: lane px computes interpolant px
    const int own_weight = (prm.weight_reciprocal * px + 256) >> 9;

    float b[3], o[3];
    for (int ch = 0; ch < 3; ++ch) {
        b[ch] = base[n * 3 + ch];
        o[ch] = offset[n * 3 + ch];
    }

    int prev_eps[6] = {0, 0, 0, 0, 0, 0};   // the stored endpoints of round px
    ck::Refiner<3> refiner;
    refiner.reset();

    for (int pos = 0; pos < a_count; ++pos) {
        const int tweak = pos / num_refines;
        const int refine_pass = pos - tweak * num_refines;

        // endpoints: tweak-seeded from the PCA line, or the last round's refit
        int eps_cs[6];
        if (refine_pass == 0) {
            float f0 = prm.tweak0[tweak], f1 = prm.tweak1[tweak];
            for (int ch = 0; ch < 3; ++ch) {
                eps_cs[ch] = ck::round_int(ck::clampf(b[ch] + o[ch] * f0, lo, 31743.0f));
                eps_cs[3 + ch] = ck::round_int(ck::clampf(b[ch] + o[ch] * f1, lo, 31743.0f));
            }
        } else {
            bc6h::refined_endpoints_hdr(refiner, prm.rcp_cw, lo, eps_cs);
        }
        refiner.reset();

        int q_els[6], unq[6], fin[6];
        for (int j = 0; j < 6; ++j) {
            q_els[j] = bc6h::quantize_element<SIGNED>(eps_cs[j], aprec);
            bc6h::unquantize_element<SIGNED, true>(q_els[j], aprec, unq[j], fin[j]);
        }

        // this pixel's uninverted index and error
        int idx_unv;
        float err;
        if (FAST) {
            float origin[3], axis[3], diff_w[3];
            for (int ch = 0; ch < 3; ++ch) {
                origin[ch] = (float)fin[ch];
                diff_w[ch] = ((float)fin[3 + ch] - origin[ch]) * prm.cw[ch];
            }
            float len_sq = diff_w[0] * diff_w[0];
            for (int ch = 1; ch < 3; ++ch) len_sq = len_sq + diff_w[ch] * diff_w[ch];
            len_sq = ck::safe_denom(len_sq);
            float mv = max_value / len_sq;
            for (int ch = 0; ch < 3; ++ch) axis[ch] = diff_w[ch] * prm.cw[ch] * mv;
            float dist = (f2cl[0] - origin[0]) * axis[0];
            for (int ch = 1; ch < 3; ++ch) dist = dist + (f2cl[ch] - origin[ch]) * axis[ch];
            idx_unv = ck::round_int(ck::clampf(dist, 0.0f, max_value));
            int w = (prm.weight_reciprocal * idx_unv + 256) >> 9;
            err = 0.0f;
            for (int ch = 0; ch < 3; ++ch) {
                int d = bc6h::reconstruct<SIGNED>(unq[ch], unq[3 + ch], w) - p2cl[ch];
                float t = (float)(int)((unsigned)d * (unsigned)d);
                if (!uniform) t = t * prm.cw_sq[ch];
                err = ch == 0 ? t : err + t;
            }
        } else {
            float own[3];
            for (int ch = 0; ch < 3; ++ch)
                own[ch] = bc6h::twoscl_half_to_float(
                    bc6h::reconstruct<SIGNED>(unq[ch], unq[3 + ch], own_weight));
            float best_e = 0.0f;
            float sel[3] = {0.0f, 0.0f, 0.0f};
            idx_unv = 0;
#pragma unroll
            for (int r = 0; r < INDEX_RANGE; ++r) {
                float interp[3];
                for (int ch = 0; ch < 3; ++ch)
                    interp[ch] = __shfl_sync(FULL, own[ch], r, LANES);
                float d0 = linw[0] - interp[0] * prm.cw[0];
                float d1 = linw[1] - interp[1] * prm.cw[1];
                float d2 = linw[2] - interp[2] * prm.cw[2];
                float e_r = d0 * d0;
                e_r = e_r + d1 * d1;
                e_r = e_r + d2 * d2;
                if (r == 0 || e_r < best_e) {
                    best_e = e_r;
                    idx_unv = r;
                    for (int ch = 0; ch < 3; ++ch) sel[ch] = interp[ch];
                }
            }
            // ComputeErrorHDRSlow at the selected interpolant
            err = 0.0f;
            for (int ch = 0; ch < 3; ++ch) {
                float d = sel[ch] - unw[ch];
                float t = d * d;
                if (!uniform) t = t * prm.cw_sq[ch];
                err = ch == 0 ? t : err + t;
            }
        }

        // the subset error, in pixel order
        float subset_error = 0.0f;
#pragma unroll
        for (int r = 0; r < LANES; ++r)
            subset_error = subset_error + __shfl_sync(FULL, err, r, LANES);

        // inversion at the fixup pixel (pixel 0), endpoint swap
        const bool invert = __shfl_sync(FULL, idx_unv, 0, LANES) > half_range_m1;
        const int idx = invert ? (INDEX_RANGE - 1) - idx_unv : idx_unv;
        int q_sw[6];
        for (int ch = 0; ch < 3; ++ch) {
            q_sw[ch] = invert ? q_els[3 + ch] : q_els[ch];
            q_sw[3 + ch] = invert ? q_els[ch] : q_els[3 + ch];
        }

        // dedup against every earlier round: lane p < pos holds round p's
        bool same = px < pos;
        for (int j = 0; j < 6; ++j) same = same && prev_eps[j] == q_sw[j];
        const bool valid = (__ballot_sync(FULL, same) & block_lanes) == 0u;
        if (px == pos)
            for (int j = 0; j < 6; ++j) prev_eps[j] = q_sw[j];

        // the refiner's totals, in pixel order, unless this is the tweak's
        // last refine pass
        if (refine_pass != num_refines - 1) {
            const float ti_own = (float)idx * prm.rcp_max_index;
#pragma unroll
            for (int r = 0; r < LANES; ++r) {
                float ti = __shfl_sync(FULL, ti_own, r, LANES);
                for (int ch = 0; ch < 3; ++ch) {
                    float val = s_pw[slot][r * 3 + ch];
                    refiner.tv[ch] = refiner.tv[ch] + (valid ? ti * val : 0.0f);
                    refiner.v[ch] = refiner.v[ch] + (valid ? val : 0.0f);
                }
                refiner.tt = refiner.tt + (valid ? ti * ti : 0.0f);
                refiner.t = refiner.t + (valid ? ti : 0.0f);
                refiner.wu += valid ? 1 : 0;
            }
        }

        if (live) {
            const size_t row = n * a_count + pos;
            idx_out[row * LANES + px] = idx;
            if (px == 0) {
                err_out[row] = subset_error;
                valid_out[row] = valid ? 1 : 0;
                for (int j = 0; j < 6; ++j) eps_out[row * 6 + j] = q_sw[j];
            }
        }
    }
}

}  // namespace

// floats: cw[3], cw_sq[3], rcp_cw[3], tweak0[4], tweak1[4], rcp_max_index
// at index range 16; weight_reciprocal: g_weightReciprocals[16]
extern "C" int ck_bc6h_single(const int* pix, const float* base, const float* offset,
                              int n, int aprec, int is_signed, int fast_indexing,
                              int uniform, int num_tweaks, int num_refines,
                              const float* floats, int weight_reciprocal,
                              float* err, int* valid, int* eps, int* idx,
                              cudaStream_t stream) {
    if (n <= 0) return 0;
    if (num_tweaks * num_refines > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
    Params prm;
    for (int i = 0; i < 3; ++i) {
        prm.cw[i] = floats[i];
        prm.cw_sq[i] = floats[3 + i];
        prm.rcp_cw[i] = floats[6 + i];
    }
    for (int i = 0; i < 4; ++i) {
        prm.tweak0[i] = floats[9 + i];
        prm.tweak1[i] = floats[13 + i];
    }
    prm.rcp_max_index = floats[17];
    prm.weight_reciprocal = weight_reciprocal;
    const int grid = (n + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
#define CK_LAUNCH(S, F)                                                        \
    bc6h_single_kernel<S, F><<<grid, THREADS, 0, stream>>>(                    \
        pix, base, offset, n, aprec, uniform, num_tweaks, num_refines, prm,    \
        err, valid, eps, idx)
    if (is_signed) {
        if (fast_indexing) CK_LAUNCH(true, true); else CK_LAUNCH(true, false);
    } else {
        if (fast_indexing) CK_LAUNCH(false, true); else CK_LAUNCH(false, false);
    }
#undef CK_LAUNCH
    return (int)cudaGetLastError();
}
