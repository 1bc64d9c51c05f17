// Per-shape PCA endpoints for BC7.
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// shape_pca (_pca_kernel_body): for every shape of the plan's RGB or RGBA
// list, the 3-pass EndpointSelector (centroid, covariance, 8 power
// iterations, min/max projection over the shape's pixels) and
// GetEndpoints, giving the shape's base/offset line; for RGB lists also
// the static alpha error sum over member pixels of (255 - a)^2, weighted.
//
// What bounds it on an H100: operations. Each (block, shape) pair does
// about 1,300 f32 operations (about 1,900 for 4 channels) on 256 bytes of
// pixels and writes 36 bytes. Design: one thread per (block, shape) pair,
// with the covariance, the power iteration and the projection in
// registers; the block's pixels, converted and weighted once, sit in
// shared memory and every thread reads them as a broadcast. A thread block
// covers one BC7 block and up to 256 of its shapes.
#include "bc7_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
    float cw[4];
    float alpha_weight_sq;
};

template <int NCH>
__global__ void __launch_bounds__(kThreads)
shape_pca_kernel(const int* __restrict__ pix, const int* __restrict__ masks,
                 int s_count, int uniform, int with_alpha, Params prm,
                 float* __restrict__ base, float* __restrict__ offset,
                 float* __restrict__ alpha) {
    __shared__ float s_pw[64];
    __shared__ int s_alpha[16];
    const int b = blockIdx.x;
    const int s = blockIdx.y * kThreads + threadIdx.x;
    if (threadIdx.x < 64) {
        int v = pix[(size_t)b * 64 + threadIdx.x];
        s_pw[threadIdx.x] = (float)v * prm.cw[threadIdx.x & 3];
        if ((threadIdx.x & 3) == 3) s_alpha[threadIdx.x >> 2] = v;
    }
    __syncthreads();
    if (s >= s_count) return;

    const unsigned member = (unsigned)masks[s];
    float w[16];
    for (int px = 0; px < 16; ++px) w[px] = (float)((member >> px) & 1u);

    float bs[NCH], os[NCH];
    ck::pca_endpoints<NCH>(s_pw, w, member, prm.cw, bs, os);
    float* bo = base + ((size_t)b * s_count + s) * 4;
    float* oo = offset + ((size_t)b * s_count + s) * 4;
    for (int ch = 0; ch < 4; ++ch) {
        bo[ch] = ch < NCH ? bs[ch] : 0.0f;
        oo[ch] = ch < NCH ? os[ch] : 0.0f;
    }

    if (with_alpha) {
        int agg = 0;
        for (int px = 0; px < 16; ++px) {
            int d = 255 - s_alpha[px];
            if ((member >> px) & 1u) agg = agg + d * d;
        }
        float e = (float)agg;
        alpha[(size_t)b * s_count + s] = uniform ? e : e * prm.alpha_weight_sq;
    }
}

}  // namespace

// pix [n, 64] i32 (px*4+ch); masks [s_count] i32 membership bits;
// cw [4] f32. Outputs base, offset [n, s_count, 4] f32 (channels >= nch
// are 0) and, when with_alpha, alpha [n, s_count] f32.
extern "C" int ck_shape_pca(const int* pix, const int* masks, int n,
                            int s_count, int nch, const float* cw, int uniform,
                            int with_alpha, float* base, float* offset,
                            float* alpha, void* stream) {
    if (n == 0 || s_count == 0) return 0;
    Params prm;
    for (int ch = 0; ch < 4; ++ch) prm.cw[ch] = cw[ch];
    prm.alpha_weight_sq = cw[3] * cw[3];
    dim3 grid(n, (s_count + kThreads - 1) / kThreads);
    cudaStream_t st = (cudaStream_t)stream;
    if (nch == 3)
        shape_pca_kernel<3><<<grid, kThreads, 0, st>>>(
            pix, masks, s_count, uniform, with_alpha, prm, base, offset, alpha);
    else if (nch == 4)
        shape_pca_kernel<4><<<grid, kThreads, 0, st>>>(
            pix, masks, s_count, uniform, with_alpha, prm, base, offset, alpha);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
