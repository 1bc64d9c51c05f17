// Device helpers shared by the BC6H chain kernels (bc6h_group.cu for the
// partitioned precision groups, bc6h_single.cu for the single-mode ones):
// the HDR arithmetic of models/bc6h_common.py and the refiner's HDR
// endpoints (ops/refine.py), operation for operation.
//
// Exactness as in bc7_common.cuh: no FMA contraction, IEEE divide,
// subnormals kept; >> on negative ints is arithmetic and int products wrap
// in 32 bits, as in the reference's scalar build.
#pragma once

#include "bc7_common.cuh"

namespace bc6h {

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

// unquantize_element: the unquantized value feeds the slow path, the
// finished value the fast path's selector. WIDE admits the precisions that
// pass components through unchanged (16 signed, 15 and 16 unsigned), which
// only the single-mode groups reach.
template <bool SIGNED, bool WIDE>
__device__ __forceinline__ void unquantize_element(int comp, int precision,
                                                   int& unq, int& fin) {
    if (SIGNED) {
        bool negative = comp < 0;
        int abs_comp = negative ? -comp : comp;
        int abs_unq;
        if (WIDE && precision >= 16) {
            abs_unq = abs_comp;
        } else {
            int max_comp_m1 = (1 << (precision - 1)) - 2;
            abs_unq = (abs_comp << (16 - precision)) + (0x4000 >> (precision - 1));
            if (comp == 0) abs_unq = 0;
            if (comp > max_comp_m1) abs_unq = 0x7FFF;
        }
        unq = negative ? -abs_unq : abs_unq;
        int funq = (abs_unq * 31) >> 5;
        fin = negative ? -funq : funq;
    } else {
        int u;
        if (WIDE && precision >= 15) {
            u = comp;
        } else {
            int max_comp_m1 = (1 << precision) - 2;
            u = (comp << (16 - precision)) + (0x8000 >> precision);
            if (comp == 0) u = 0;
            if (comp > max_comp_m1) u = 0xFFFF;
        }
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

// EndpointRefiner.get_refined_endpoints_hdr: the least-squares endpoints of
// the refiner's totals, unweighted, clamped to [lo, 31743] and rounded
// (ep0 rgb, then ep1 rgb)
__device__ __forceinline__ void refined_endpoints_hdr(const ck::Refiner<3>& refiner,
                                                      const float* rcp_cw, float lo,
                                                      int* eps_cs) {
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
        eps_cs[ch] = ck::round_int(ck::clampf(p1 * rcp_cw[ch], lo, 31743.0f));
        eps_cs[3 + ch] = ck::round_int(ck::clampf(p2 * rcp_cw[ch], lo, 31743.0f));
    }
}

}  // namespace bc6h
