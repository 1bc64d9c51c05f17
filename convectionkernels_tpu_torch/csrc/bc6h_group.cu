// partitioned_group_meta_rounds: every meta round (tweak x refine) of one
// partitioned BC6H precision group.
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc6h_kernel.py
// partitioned_group_meta_rounds (body _group_kernel_body); mirrors, operation
// for operation, models/bc6h_common.py meta_round_chain as
// models/bc6h_kernel.py partitioned_group_meta_rounds_plain calls it.
//
// Design: one CUDA block of 64 threads per texture block, one thread per
// (partition, subset) row q (subset-major, q = subset * 32 + partition). The
// block's 48 pixel values and the floats derived from them (ToFloat, the
// TwosCL linearization, and both times the channel weight) are staged once in
// shared memory; every thread reads the same address at a time, a broadcast.
// A thread keeps the whole tweak x refine chain in registers: the PCA line,
// the 8 interpolants per channel (unweighted and weighted), the uninverted
// indexes of the 16 pixels packed in 48 bits, and the refiner's totals.
// Outputs are block-major ([N, A, 64] rows), so the 64 threads of a block
// store 256 contiguous bytes at a time.
//
// Dedup state: the stored endpoints of the rounds already emitted are kept in
// a per-thread local array (12 rounds x 6 ints); the round loop has a run-time
// trip count, so the array lives in local memory (the stack ptxas reports),
// which the L1 cache serves. The thread's own earlier stores to `eps` are not
// read back.
//
// Exactness (see bc7_common.cuh): no FMA contraction, IEEE divide, subnormals
// kept; every chained sum is in the reference's order (len_sq, dist, the
// per-interpolant error, the slow and fast pixel errors, the subset error over
// pixels 0..15 with +0.0 for non-members); the slow selection is the
// strict-less scan over r = 0..7 (first occurrence wins); >> on negative ints
// is arithmetic; the integer square of the fast path wraps in 32 bits.
//
// Bound on an H100: operations (about 2.4 million float32/int32 operations a
// texture block at 12 rounds against 32 KB moved).
#include "bc7_common.cuh"

namespace {

constexpr int Q = 64;
constexpr int INDEX_RANGE = 8;
constexpr int MAX_ROUNDS = 12;
constexpr int WEIGHT_RECIPROCAL_8 = 4681;  // g_weightReciprocals[8]

struct Params {
    float cw[3], cw_sq[3], rcp_cw[3];
    float tweak0[4], tweak1[4];
    float rcp_max_index;
    int member_bits[Q];
    int fixup[Q];
};

// lanes.twoscl_half_to_float
__device__ __forceinline__ float twoscl_half_to_float(int v) {
    unsigned abs_v = (unsigned)(v < 0 ? -v : v);
    unsigned sign_bits = abs_v & 0xFFFF8000u;
    unsigned mantissa = abs_v & 0x03FFu;
    unsigned exponent = abs_v & 0x7C00u;
    bool is_denormal = exponent == 0;
    exponent = (exponent >> 3) + 14336u;
    unsigned corr_bits = (is_denormal ? (sign_bits | 14336u) : 0u) << 16;
    unsigned f_bits = ((exponent | sign_bits) << 16) | (mantissa << 13);
    return __uint_as_float(f_bits) - __uint_as_float(corr_bits);
}

template <bool SIGNED>
__device__ __forceinline__ int unscale_hdr(int v) {
    if (SIGNED) {
        bool negative = v < 0;
        int abs_v = negative ? -v : v;
        int scaled = (abs_v * 31) >> 5;
        return negative ? (scaled | (-32768)) : scaled;
    }
    return (v * 31) >> 6;
}

template <bool SIGNED>
__device__ __forceinline__ int quantize_element(int v, int precision) {
    if (SIGNED) {
        bool negative = v < 0;
        int abs_elem = negative ? -v : v;
        int q = ((abs_elem * 32 + 30) / 31) >> (16 - precision);
        return negative ? -q : q;
    }
    int q = min((v * 64 + 30) / 31, 65535);
    return q >> (16 - precision);
}

// unquantize_element: only the unquantized value feeds the slow path; the
// finished value feeds the fast path's selector
template <bool SIGNED>
__device__ __forceinline__ void unquantize_element(int comp, int precision,
                                                   int& unq, int& fin) {
    if (SIGNED) {
        bool negative = comp < 0;
        int abs_comp = negative ? -comp : comp;
        int abs_unq;
        // partitioned groups have precision <= 11, so never the >= 16 case
        int max_comp_m1 = (1 << (precision - 1)) - 2;
        abs_unq = (abs_comp << (16 - precision)) + (0x4000 >> (precision - 1));
        if (comp == 0) abs_unq = 0;
        if (comp > max_comp_m1) abs_unq = 0x7FFF;
        unq = negative ? -abs_unq : abs_unq;
        int funq = (abs_unq * 31) >> 5;
        fin = negative ? -funq : funq;
    } else {
        int max_comp_m1 = (1 << precision) - 2;
        int u = (comp << (16 - precision)) + (0x8000 >> precision);
        if (comp == 0) u = 0;
        if (comp > max_comp_m1) u = 0xFFFF;
        unq = u;
        fin = (u * 31) >> 6;
    }
}

// reconstruct_uninverted for one channel
template <bool SIGNED>
__device__ __forceinline__ int reconstruct(int ep0, int ep1, int weight) {
    int px32 = ((64 - weight) * ep0 + weight * ep1 + 32) >> 6;
    return unscale_hdr<SIGNED>(px32);
}

__device__ __forceinline__ int index_weight(int index) {
    return (WEIGHT_RECIPROCAL_8 * index + 256) >> 9;
}

template <bool SIGNED, bool FAST>
__global__ void __launch_bounds__(Q)
bc6h_group_kernel(const int* __restrict__ pix, const float* __restrict__ base,
                  const float* __restrict__ offset, int aprec, int uniform,
                  int num_tweaks, int num_refines, Params prm,
                  float* err_out, int* valid_out, int* eps_out, int* idx_out) {
    __shared__ int s_p2cl[48];       // clamped 2CL pixels
    __shared__ float s_f2cl[48];     // ToFloat
    __shared__ float s_unw[48];      // TwosCLHalfToFloat
    __shared__ float s_linw[48];     // TwosCLHalfToFloat * cw
    __shared__ float s_pw[48];       // ToFloat * cw

    const size_t n = blockIdx.x;
    const int q = threadIdx.x;
    if (q < 48) {
        int v = pix[n * 48 + q];
        float w = prm.cw[q % 3];
        float f = (float)v;
        float tw = twoscl_half_to_float(v);
        s_p2cl[q] = v;
        s_f2cl[q] = f;
        s_unw[q] = tw;
        s_linw[q] = tw * w;
        s_pw[q] = f * w;
    }
    __syncthreads();

    const unsigned member = (unsigned)prm.member_bits[q];
    const int fixup = prm.fixup[q];
    const float lo = SIGNED ? -31743.0f : 0.0f;
    const float max_value = (float)(INDEX_RANGE - 1);
    const int half_range_m1 = INDEX_RANGE / 2 - 1;
    const int a_count = num_tweaks * num_refines;

    float b[3], o[3];
    for (int ch = 0; ch < 3; ++ch) {
        b[ch] = base[(n * 3 + ch) * Q + q];
        o[ch] = offset[(n * 3 + ch) * Q + q];
    }

    int prev_eps[MAX_ROUNDS][6];
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
            // get_refined_endpoints_hdr
            float w = ck::safe_denom((float)refiner.wu);
            float w_rcp = 1.0f / w;
            float adenom = (refiner.tt * w - refiner.t * refiner.t) * w_rcp;
            bool az = adenom == 0.0f;
            if (az) adenom = 1.0f;
            for (int ch = 0; ch < 3; ++ch) {
                float a = (refiner.tv[ch] - refiner.t * refiner.v[ch] * w_rcp) / adenom;
                float bb = (refiner.v[ch] - a * refiner.t) * w_rcp;
                float p1 = az ? refiner.v[ch] * w_rcp : bb;
                float p2 = az ? p1 : a + bb;
                eps_cs[ch] = ck::round_int(ck::clampf(p1 * prm.rcp_cw[ch], lo, 31743.0f));
                eps_cs[3 + ch] = ck::round_int(ck::clampf(p2 * prm.rcp_cw[ch], lo, 31743.0f));
            }
        }
        refiner.reset();

        int q_els[6], unq[6], fin[6];
        for (int j = 0; j < 6; ++j) {
            q_els[j] = quantize_element<SIGNED>(eps_cs[j], aprec);
            unquantize_element<SIGNED>(q_els[j], aprec, unq[j], fin[j]);
        }

        // pass 1: uninverted index of every pixel (3 bits each, 48 bits in
        // all) and the subset error in pixel order
        unsigned long long idx_unv = 0;
        float subset_error = 0.0f;
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
#pragma unroll
            for (int px = 0; px < 16; ++px) {
                float dist = (s_f2cl[px * 3] - origin[0]) * axis[0];
                for (int ch = 1; ch < 3; ++ch)
                    dist = dist + (s_f2cl[px * 3 + ch] - origin[ch]) * axis[ch];
                int iv = ck::round_int(ck::clampf(dist, 0.0f, max_value));
                idx_unv |= (unsigned long long)iv << (3 * px);
                int w = index_weight(iv);
                float e = 0.0f;
                for (int ch = 0; ch < 3; ++ch) {
                    int d = reconstruct<SIGNED>(unq[ch], unq[3 + ch], w) - s_p2cl[px * 3 + ch];
                    float t = (float)(int)((unsigned)d * (unsigned)d);
                    if (!uniform) t = t * prm.cw_sq[ch];
                    e = ch == 0 ? t : e + t;
                }
                subset_error = subset_error + (((member >> px) & 1u) ? e : 0.0f);
            }
        } else {
            float interp[3][INDEX_RANGE], interp_w[3][INDEX_RANGE];
#pragma unroll
            for (int r = 0; r < INDEX_RANGE; ++r) {
                int w = index_weight(r);
                for (int ch = 0; ch < 3; ++ch) {
                    float v = twoscl_half_to_float(
                        reconstruct<SIGNED>(unq[ch], unq[3 + ch], w));
                    interp[ch][r] = v;
                    interp_w[ch][r] = v * prm.cw[ch];
                }
            }
#pragma unroll
            for (int px = 0; px < 16; ++px) {
                float p0 = s_linw[px * 3], p1 = s_linw[px * 3 + 1], p2 = s_linw[px * 3 + 2];
                float best_e = 0.0f;
                int best_i = 0;
                float sel0 = interp[0][0], sel1 = interp[1][0], sel2 = interp[2][0];
#pragma unroll
                for (int r = 0; r < INDEX_RANGE; ++r) {
                    float d0 = p0 - interp_w[0][r];
                    float d1 = p1 - interp_w[1][r];
                    float d2 = p2 - interp_w[2][r];
                    float e_r = d0 * d0;
                    e_r = e_r + d1 * d1;
                    e_r = e_r + d2 * d2;
                    if (r == 0 || e_r < best_e) {
                        best_e = e_r;
                        best_i = r;
                        sel0 = interp[0][r];
                        sel1 = interp[1][r];
                        sel2 = interp[2][r];
                    }
                }
                idx_unv |= (unsigned long long)best_i << (3 * px);
                // ComputeErrorHDRSlow at the selected interpolant
                float sel[3] = {sel0, sel1, sel2};
                float e2 = 0.0f;
                for (int ch = 0; ch < 3; ++ch) {
                    float d = sel[ch] - s_unw[px * 3 + ch];
                    float t = d * d;
                    if (!uniform) t = t * prm.cw_sq[ch];
                    e2 = ch == 0 ? t : e2 + t;
                }
                subset_error = subset_error + (((member >> px) & 1u) ? e2 : 0.0f);
            }
        }

        // inversion at the fixup pixel, endpoint swap
        const int fix_idx = (int)((idx_unv >> (3 * fixup)) & 7ull);
        const bool invert = fix_idx > half_range_m1;
        int q_sw[6];
        for (int ch = 0; ch < 3; ++ch) {
            q_sw[ch] = invert ? q_els[3 + ch] : q_els[ch];
            q_sw[3 + ch] = invert ? q_els[ch] : q_els[3 + ch];
        }

        // dedup against every earlier round
        bool valid = true;
        for (int pe = 0; pe < pos; ++pe) {
            bool eq = true;
            for (int j = 0; j < 6; ++j) eq = eq && prev_eps[pe][j] == q_sw[j];
            valid = valid && !eq;
        }
        for (int j = 0; j < 6; ++j) prev_eps[pos][j] = q_sw[j];

        // pass 2: stored (inverted) indexes, packed; refiner contributions
        // unless this is the tweak's last refine pass
        const bool contribute = refine_pass != num_refines - 1;
        int idx_lo = 0, idx_hi = 0;
#pragma unroll
        for (int px = 0; px < 16; ++px) {
            int iu = (int)((idx_unv >> (3 * px)) & 7ull);
            int iv = invert ? (INDEX_RANGE - 1) - iu : iu;
            if (px < 10) idx_lo |= iv << (3 * px);
            else idx_hi |= iv << (3 * (px - 10));
            if (contribute) {
                bool m = ((member >> px) & 1u) && valid;
                float ti = (float)iv * prm.rcp_max_index;
                for (int ch = 0; ch < 3; ++ch) {
                    float val = s_pw[px * 3 + ch];
                    refiner.tv[ch] = refiner.tv[ch] + (m ? ti * val : 0.0f);
                    refiner.v[ch] = refiner.v[ch] + (m ? val : 0.0f);
                }
                refiner.tt = refiner.tt + (m ? ti * ti : 0.0f);
                refiner.t = refiner.t + (m ? ti : 0.0f);
                refiner.wu += m ? 1 : 0;
            }
        }

        const size_t row = n * a_count + pos;
        err_out[row * Q + q] = subset_error;
        valid_out[row * Q + q] = valid ? 1 : 0;
        for (int j = 0; j < 6; ++j) eps_out[(row * 6 + j) * Q + q] = q_sw[j];
        idx_out[(row * 2) * Q + q] = idx_lo;
        idx_out[(row * 2 + 1) * Q + q] = idx_hi;
    }
}

}  // namespace

// floats: cw[3], cw_sq[3], rcp_cw[3], tweak0[4], tweak1[4], rcp_max_index;
// ints: member_bits[64], fixup[64] (host arrays)
extern "C" int ck_bc6h_group(const int* pix, const float* base, const float* offset,
                             int n, int aprec, int is_signed, int fast_indexing,
                             int uniform, int num_tweaks, int num_refines,
                             const float* floats, const int* ints,
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
    for (int i = 0; i < Q; ++i) {
        prm.member_bits[i] = ints[i];
        prm.fixup[i] = ints[Q + i];
    }
#define CK_LAUNCH(S, F)                                                        \
    bc6h_group_kernel<S, F><<<n, Q, 0, stream>>>(                              \
        pix, base, offset, aprec, uniform, num_tweaks, num_refines, prm, err,  \
        valid, eps, idx)
    if (is_signed) {
        if (fast_indexing) CK_LAUNCH(true, true); else CK_LAUNCH(true, false);
    } else {
        if (fast_indexing) CK_LAUNCH(false, true); else CK_LAUNCH(false, false);
    }
#undef CK_LAUNCH
    return (int)cudaGetLastError();
}
