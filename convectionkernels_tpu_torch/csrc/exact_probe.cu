// Exactness probe: the card-side counterpart of the feasibility probe
// convectionkernels_tpu/tools/pallas_feasibility.py. It runs the operations
// the BC7 kernels depend on — divide, sqrt, floorf(x + 0.5f), the
// min-then-max clamp, a `v - a*t` product chain and int32 shift/multiply
// chains — so that a caller can compare the results bit for bit with
// PyTorch on the CPU. Compiled with the same flags as the kernels, it
// fails first and clearly if a flag lets nvcc contract a multiply-add,
// approximate a divide or flush a subnormal.
//
// What bounds it: bytes (a handful of operations per element). One thread
// per element; it runs once, on a small array.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void exact_probe_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b, int n,
                                   float* __restrict__ f_out,
                                   int* __restrict__ i_out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float x = a[i], y = b[i];
    // [6, n] f32: divide, sqrt of |x|, round-to-nearest, clamp, the
    // refiner's v - a*t chain, and reciprocal
    f_out[0 * n + i] = x / y;
    f_out[1 * n + i] = sqrtf(fabsf(x));
    f_out[2 * n + i] = floorf(x + 0.5f);
    f_out[3 * n + i] = fmaxf(fminf(x, 255.0f), 0.0f);
    f_out[4 * n + i] = (y - x * y) * x;
    f_out[5 * n + i] = 1.0f / y;
    // [2, n] i32: index reconstruction (int mul/shift) and a quantize
    // chain on clamped, rounded values
    int ia = (int)floorf(fmaxf(fminf(x, 255.0f), 0.0f) + 0.5f);
    int ib = (int)floorf(fmaxf(fminf(y, 255.0f), 0.0f) + 0.5f);
    int w = ((ia & 15) * 4681 + 256) >> 9;
    i_out[0 * n + i] = ((64 - w) * ia + w * ib + 32) >> 6;
    int q = ((ia << 7) - ia + 255) >> 9;
    i_out[1 * n + i] = ((((q << 1) | (ib & 1)) << 1) | (q >> 6));
}

}  // namespace

// a, b [n] f32. Outputs f_out [6, n] f32 and i_out [2, n] i32.
extern "C" int ck_exact_probe(const float* a, const float* b, int n,
                              float* f_out, int* i_out, void* stream) {
    if (n == 0) return 0;
    exact_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        a, b, n, f_out, i_out);
    return (int)cudaGetLastError();
}
