// Device helpers shared by the BC7 kernels: the lane math of ops/lanes.py,
// the PCA of ops/pca.py, IndexSelector (ops/index_select.py),
// EndpointRefiner (ops/refine.py) and endpoint compression
// (models/bc7_common.py), operation for operation.
//
// Exactness: every file that includes this header is compiled with
// -fmad=false -prec-div=true -prec-sqrt=true -ftz=false, so each float
// multiply and add rounds on its own (no FMA contraction), divide and sqrt
// are IEEE round-to-nearest, and subnormals are kept, which is what eager
// PyTorch does on the CPU. Rounding is floorf(x + 0.5f), clamps are min
// then max, integer lanes are int32, and chained sums keep the reference's
// order (no tree reductions).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define CK_FLT_MAX 3.4028234663852886e38f
#define CK_BIG_RANK (1 << 30)

namespace ck {

__device__ __forceinline__ int round_int(float v) {
    return (int)floorf(v + 0.5f);
}

// lanes.clamp: maximum(minimum(v, hi), lo)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fmaxf(fminf(v, hi), lo);
}

__device__ __forceinline__ float safe_denom(float v) {
    return v == 0.0f ? 1.0f : v;
}

// pca.endpoint_selector + pca.get_endpoints for one pixel set.
// pw[px*4 + ch] are pre-weighted pixels, w[px] the pixel weights, member
// the pass-2 mask bits (all ones when there is no mask). cw holds the
// channel weights the endpoints are divided by.
template <int NCH>
__device__ __forceinline__ void pca_endpoints(const float* pw, const float* w,
                                              unsigned member, const float* cw,
                                              float* base, float* offset) {
    float centroid[NCH];
    for (int ch = 0; ch < NCH; ++ch) centroid[ch] = 0.0f;
    float weight_total = 0.0f;
    for (int px = 0; px < 16; ++px) {
        for (int ch = 0; ch < NCH; ++ch)
            centroid[ch] = centroid[ch] + pw[px * 4 + ch] * w[px];
        weight_total = weight_total + w[px];
    }
    float denom = safe_denom(weight_total);
    for (int ch = 0; ch < NCH; ++ch) centroid[ch] = centroid[ch] / denom;

    constexpr int NCOV = NCH * (NCH + 1) / 2;
    float cov[NCOV];
    for (int i = 0; i < NCOV; ++i) cov[i] = 0.0f;
    for (int px = 0; px < 16; ++px) {
        float diff[NCH];
        for (int ch = 0; ch < NCH; ++ch) diff[ch] = pw[px * 4 + ch] - centroid[ch];
        int index = 0;
        for (int row = 0; row < NCH; ++row)
            for (int col = 0; col <= row; ++col) {
                cov[index] = cov[index] + diff[row] * diff[col] * w[px];
                ++index;
            }
    }

    float approx[NCH];
    for (int ch = 0; ch < NCH; ++ch) approx[ch] = 1.0f;
    for (int it = 0; it < 8; ++it) {
        float product[NCH];
        for (int row = 0; row < NCH; ++row) {
            int index = (row * (row + 1)) >> 1;
            float total = 0.0f;
            for (int col = 0; col < NCH; ++col) {
                float term = approx[col] * cov[index];
                total = col == 0 ? term : total + term;
                index += col >= row ? col + 1 : 1;
            }
            product[row] = total;
        }
        float largest = product[0];
        for (int ch = 1; ch < NCH; ++ch) largest = fmaxf(largest, product[ch]);
        largest = safe_denom(largest);
        for (int ch = 0; ch < NCH; ++ch) approx[ch] = product[ch] / largest;
    }
    float approx_len = approx[0] * approx[0];
    for (int ch = 1; ch < NCH; ++ch) approx_len = approx_len + approx[ch] * approx[ch];
    approx_len = safe_denom(sqrtf(approx_len));
    float direction[NCH];
    for (int ch = 0; ch < NCH; ++ch) direction[ch] = approx[ch] / approx_len;

    float min_dist = CK_FLT_MAX, max_dist = -CK_FLT_MAX;
    for (int px = 0; px < 16; ++px) {
        float dist = direction[0] * (pw[px * 4] - centroid[0]);
        for (int ch = 1; ch < NCH; ++ch)
            dist = dist + direction[ch] * (pw[px * 4 + ch] - centroid[ch]);
        bool in = (member >> px) & 1u;
        min_dist = fminf(min_dist, in ? dist : CK_FLT_MAX);
        max_dist = fmaxf(max_dist, in ? dist : -CK_FLT_MAX);
    }
    for (int ch = 0; ch < NCH; ++ch) {
        float mn = centroid[ch] + direction[ch] * min_dist;
        float mx = centroid[ch] + direction[ch] * max_dist;
        base[ch] = mn / cw[ch];
        offset[ch] = (mx - mn) / cw[ch];
    }
}

// bc7_common.quantize / quantize_p / unquantize on one channel value
__device__ __forceinline__ int quantize(int c, int bits) {
    return ((c << bits) - c + (127 + (1 << (7 - bits)))) >> 8;
}

__device__ __forceinline__ int quantize_p(int c, int bits, int p) {
    int addend = p != 0 ? (1 << (8 - bits)) - 1 : 255;
    int q = ((c << (bits + 1)) - c + addend) >> 9;
    return (q << 1) | p;
}

__device__ __forceinline__ int unquantize(int c, int bits) {
    int cc = c << (8 - bits);
    return cc | (cc >> bits);
}

// bc7_common.compress_endpoints for one endpoint pair of a single-plane mode
template <int MODE>
__device__ __forceinline__ void compress_endpoints(const int ep[2][4], int p0,
                                                   int p1, int out[2][4]) {
    for (int j = 0; j < 2; ++j) {
        int p = j == 0 ? p0 : p1;
        for (int ch = 0; ch < 4; ++ch) {
            int c = ep[j][ch];
            int v;
            if (MODE == 0) v = ch < 3 ? unquantize(quantize_p(c, 4, p), 5) : 255;
            else if (MODE == 1) v = ch < 3 ? unquantize(quantize_p(c, 6, p0), 7) : 255;
            else if (MODE == 2) v = ch < 3 ? unquantize(quantize(c, 5), 5) : 255;
            else if (MODE == 3) v = ch < 3 ? quantize_p(c, 7, p) : 255;
            else if (MODE == 6) v = quantize_p(c, 7, p);
            else v = unquantize(quantize_p(c, 5, p), 6);  // MODE 7
            out[j][ch] = v;
        }
    }
}

// IndexSelector: origin and axis from integer endpoints (index_select.py)
template <int NCH>
struct Selector {
    float origin[NCH];
    float axis[NCH];
    float max_value;

    __device__ __forceinline__ void init(const int* ep0, const int* ep1,
                                         const float* cw, float mv) {
        max_value = mv;
        float edw[NCH];
        for (int ch = 0; ch < NCH; ++ch) {
            origin[ch] = (float)ep0[ch];
            edw[ch] = ((float)ep1[ch] - origin[ch]) * cw[ch];
        }
        float len_sq = edw[0] * edw[0];
        for (int ch = 1; ch < NCH; ++ch) len_sq = len_sq + edw[ch] * edw[ch];
        len_sq = safe_denom(len_sq);
        float mv_div = mv / len_sq;
        for (int ch = 0; ch < NCH; ++ch) axis[ch] = edw[ch] * cw[ch] * mv_div;
    }

    // SelectIndexLDR: project, clamp, round
    __device__ __forceinline__ int select(const float* fp) const {
        float dist = (fp[0] - origin[0]) * axis[0];
        for (int ch = 1; ch < NCH; ++ch) dist = dist + (fp[ch] - origin[ch]) * axis[ch];
        return round_int(fmaxf(fminf(dist, max_value), 0.0f));
    }
};

// IndexSelector.reconstruct_ldr_bc7_f32 weight and channel value
__device__ __forceinline__ float recon_weight_f32(int index, float recip) {
    return floorf(((float)index * recip + 256.0f) * 0.001953125f);
}

__device__ __forceinline__ float recon_f32(float w, float ep0, float ep1) {
    return floorf(((64.0f - w) * ep0 + w * ep1 + 32.0f) * 0.015625f);
}

// EndpointRefiner accumulators and solve (refine.py)
template <int NCH>
struct Refiner {
    float tv[NCH], v[NCH], tt, t;
    int wu;

    __device__ __forceinline__ void reset() {
        for (int ch = 0; ch < NCH; ++ch) { tv[ch] = 0.0f; v[ch] = 0.0f; }
        tt = 0.0f; t = 0.0f; wu = 0;
    }

    // ContributeUnweightedPW over the first nrc channels
    __device__ __forceinline__ void contribute(const float* pw, int index,
                                               float rcp_max_index, int nrc) {
        float ti = (float)index * rcp_max_index;
        for (int ch = 0; ch < nrc; ++ch) {
            tv[ch] = tv[ch] + ti * pw[ch];
            v[ch] = v[ch] + pw[ch];
        }
        tt = tt + ti * ti;
        t = t + ti;
        wu += 1;
    }

    // GetRefinedEndpointsLDR for the first nrc channels
    __device__ __forceinline__ void refined_ldr(const float* rcp_cw, int nrc,
                                                int* ep0, int* ep1) const {
        float w = safe_denom((float)wu);
        float w_rcp = 1.0f / w;
        float adenom = (tt * w - t * t) * w_rcp;
        bool az = adenom == 0.0f;
        if (az) adenom = 1.0f;
        for (int ch = 0; ch < nrc; ++ch) {
            float a = (tv[ch] - t * v[ch] * w_rcp) / adenom;
            float b = (v[ch] - a * t) * w_rcp;
            float p1 = az ? v[ch] * w_rcp : b;
            float p2 = az ? p1 : a + b;
            ep0[ch] = round_int(clampf(p1 * rcp_cw[ch], 0.0f, 255.0f));
            ep1[ch] = round_int(clampf(p2 * rcp_cw[ch], 0.0f, 255.0f));
        }
    }
};

// LexBest rule: strictly smaller error, or equal error and smaller rank
__device__ __forceinline__ bool lex_better(float e, int r, float be, int br) {
    return e < be || (e == be && r < br);
}

}  // namespace ck
