// Per-shape PCA endpoints for BC7.
//
// Replaces the TPU kernel convectionkernels_tpu/models/bc7_kernel.py
// shape_pca (_pca_kernel_body): for every shape of the plan's RGB or RGBA
// list, the 3-pass EndpointSelector (centroid, covariance, 8 power
// iterations, min/max projection over the shape's pixels) and
// GetEndpoints, giving the shape's base/offset line; for RGB lists also
// the static alpha error sum over member pixels of (255 - a)^2, weighted.
//
// What bounds it on an H100: operations, at the issue rate. A (block,
// shape) pair needs about 230 operations (370 for 4 channels) and 31 (41)
// more for each member pixel (6.7 a shape in q50's RGB list, 8.1 in its
// RGBA list), on 256 bytes of pixels, and writes 32-36 bytes. 36-48 of
// those operations are IEEE divides, each about 10 instructions with
// -prec-div=true (a reciprocal, its refinement, a range check and a branch
// around the slow path), which the bound charges as one.
//
// Layout: one thread per (block, shape) pair left most lanes idle (175 of
// 256 threads in the RGBA launch), started a CUDA block per BC7 block, and
// walked all 16 pixels, multiplying non-members by a weight of 0. Now a
// CUDA block covers 32 BC7 blocks, one a lane, and a warp computes one
// shape for all 32: the member mask is warp-uniform, so the passes walk
// only the shape's member pixels (ck::pca_endpoints_members, which also
// sums the alpha error in its first pass) and every lane is live but those
// past the ragged end of the last group. The warps take chunks of 1, 2 or 4
// consecutive shapes from a counter in shared memory, so a warp that drew
// small shapes takes more. The 32 blocks' pixels are converted and
// weighted once into shared memory, 68 words a block, so that a warp's 32
// lanes read one pixel's 4 channels as one conflict-free 16-byte load
// each. A chunk's results are staged in the warp's shared memory (float4
// slots swizzled against bank conflicts) and leave as row pieces of
// [N, S, 4], 16 bytes a shape; a lane's own float4 stores, 32 rows
// S x 16 bytes apart, ran slower. The chunk (1, 2 or 4 shapes) is a launch argument,
// which chip_smoke.py --pca-chunks times at each list length: 4 writes
// the longest row pieces (the wrapper's choice with the alpha error), 2
// balances the warps better (its choice without). The shape loop keeps one copy of its body: unrolled, the code
// outgrew the instruction cache. At most 64 registers
// (__launch_bounds__) and no stack: 4 CUDA blocks (32 warps) an SM, as
// the 47.7 KB of shared memory a block also allows.
#include "bc7_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 32;          // BC7 blocks a CUDA block covers, one a lane
constexpr int kPxRow = 17;          // float4 slots a staged BC7 block takes
constexpr int kAlphaRow = kGroup + 1;  // words a staged pixel's alpha row takes
constexpr int kMaxChunk = 4;        // the most consecutive shapes a warp takes at once

struct Params {
    float cw[4];
    float alpha_weight_sq;
};

// slot of (row, shape j of a chunk of 1 << lg shapes) in a warp's staged
// float4 results: the 8 >> lg rows that share a swizzle fill the 8 4-bank
// groups, so 8 lanes storing one j, or reading 8 consecutive slots, hit 8
// distinct groups
__device__ __forceinline__ int out_slot(int row, int j, int lg) {
    return (row << lg) + (j ^ ((row >> (3 - lg)) & ((1 << lg) - 1)));
}

// the same for the staged alpha errors (one word each): 32 rows storing
// one j, or 32 consecutive words read together, hit 32 distinct banks
__device__ __forceinline__ int err_slot(int row, int j, int lg) {
    return (row << lg) + (j ^ ((row >> (5 - lg)) & ((1 << lg) - 1)));
}

// lg: log2 of the chunk, the consecutive shapes a warp takes at once
template <int NCH>
__global__ void __launch_bounds__(kThreads, 4)
shape_pca_kernel(const int4* __restrict__ pix, const int* __restrict__ masks,
                 int n, int s_count, int lg, int uniform, int with_alpha,
                 Params prm,
                 float4* __restrict__ base, float4* __restrict__ offset,
                 float* __restrict__ alpha) {
    __shared__ float4 s_px[kGroup * kPxRow];
    __shared__ int s_alpha[16 * kAlphaRow];         // [px][lane]
    __shared__ float4 s_base[kWarps][kGroup * kMaxChunk];
    __shared__ float4 s_offset[kWarps][kGroup * kMaxChunk];
    __shared__ float s_err[kWarps][kGroup * kMaxChunk];
    __shared__ int s_next_chunk;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b0 = blockIdx.x * kGroup;
    const int rows = min(kGroup, n - b0);

    // the group's pixels, converted and weighted once; zeros past its end
    for (int i = threadIdx.x; i < kGroup * 16; i += kThreads) {
        const int b = i >> 4, px = i & 15;
        const int4 v = b < rows ? pix[(size_t)b0 * 16 + i] : make_int4(0, 0, 0, 0);
        s_px[b * kPxRow + px] =
            make_float4((float)v.x * prm.cw[0], (float)v.y * prm.cw[1],
                        (float)v.z * prm.cw[2], (float)v.w * prm.cw[3]);
        s_alpha[px * kAlphaRow + b] = v.w;
    }
    if (threadIdx.x == 0) s_next_chunk = kWarps;
    __syncthreads();

    const float4* my_px = s_px + lane * kPxRow;
    float4* my_base = s_base[warp];
    float4* my_offset = s_offset[warp];
    float* my_err = s_err[warp];
    for (int chunk = warp; (chunk << lg) < s_count;) {
        const int s0 = chunk << lg;
        const int count = min(1 << lg, s_count - s0);
        // one copy of the body: unrolled, the kernel outgrows the
        // instruction cache and runs slower
#pragma unroll 1
        for (int j = 0; j < count; ++j) {
            // pixels 0-15: the plain version ignores higher bits
            const unsigned member = (unsigned)__ldg(masks + s0 + j) & 0xFFFFu;
            float bs[NCH], os[NCH];
            int agg = 0;        // the alpha error, summed in the centroid pass
            ck::pca_endpoints_members<NCH>(
                [&](int px) { return my_px[px]; },
                [&](int px) {
                    const int d = 255 - s_alpha[px * kAlphaRow + lane];
                    agg = agg + d * d;
                },
                member, prm.cw, bs, os);
            my_base[out_slot(lane, j, lg)] =
                make_float4(bs[0], bs[1], bs[2], NCH == 4 ? bs[NCH - 1] : 0.0f);
            my_offset[out_slot(lane, j, lg)] =
                make_float4(os[0], os[1], os[2], NCH == 4 ? os[NCH - 1] : 0.0f);
            if (with_alpha) {
                const float e = (float)agg;
                my_err[err_slot(lane, j, lg)] = uniform ? e : e * prm.alpha_weight_sq;
            }
        }
        __syncwarp();
        // the chunk's [32 rows, count shapes] results, 32 >> lg rows a
        // store, each row's shapes contiguous in the outputs
#pragma unroll
        for (int i = 0; i < kMaxChunk; ++i) {
            const int q = lane + 32 * i;
            const int row = q >> lg, j = q & ((1 << lg) - 1);
            if (i < (1 << lg) && row < rows && j < count) {
                const size_t o = (size_t)(b0 + row) * s_count + s0 + j;
                base[o] = my_base[out_slot(row, j, lg)];
                offset[o] = my_offset[out_slot(row, j, lg)];
                if (with_alpha) alpha[o] = my_err[err_slot(row, j, lg)];
            }
        }
        __syncwarp();
        if (lane == 0) chunk = atomicAdd(&s_next_chunk, 1);
        chunk = __shfl_sync(0xffffffffu, chunk, 0);
    }
}

}  // namespace

// pix [n, 64] i32 (px*4+ch); masks [s_count] i32 membership bits (0-15);
// cw [4] f32; chunk 1, 2 or 4 shapes a warp takes at once. Outputs base,
// offset [n, s_count, 4] f32 (channels >= nch are 0) and, when
// with_alpha, alpha [n, s_count] f32.
extern "C" int ck_shape_pca(const int* pix, const int* masks, int n,
                            int s_count, int nch, const float* cw, int uniform,
                            int with_alpha, int chunk, float* base,
                            float* offset, float* alpha, void* stream) {
    if (n == 0 || s_count == 0) return 0;
    if (((size_t)pix | (size_t)base | (size_t)offset) & 15)
        return (int)cudaErrorMisalignedAddress;
    const int lg = chunk == 1 ? 0 : chunk == 2 ? 1 : chunk == 4 ? 2 : -1;
    if (lg < 0 || (nch != 3 && nch != 4)) return (int)cudaErrorInvalidValue;
    Params prm;
    for (int ch = 0; ch < 4; ++ch) prm.cw[ch] = cw[ch];
    prm.alpha_weight_sq = cw[3] * cw[3];
    const dim3 grid((n + kGroup - 1) / kGroup);
    cudaStream_t st = (cudaStream_t)stream;
    const int4* pix4 = reinterpret_cast<const int4*>(pix);
    float4* base4 = reinterpret_cast<float4*>(base);
    float4* offset4 = reinterpret_cast<float4*>(offset);
    if (nch == 3)
        shape_pca_kernel<3><<<grid, kThreads, 0, st>>>(
            pix4, masks, n, s_count, lg, uniform, with_alpha, prm, base4, offset4, alpha);
    else
        shape_pca_kernel<4><<<grid, kThreads, 0, st>>>(
            pix4, masks, n, s_count, lg, uniform, with_alpha, prm, base4, offset4, alpha);
    return (int)cudaGetLastError();
}
