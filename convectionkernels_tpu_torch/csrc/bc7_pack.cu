// bc7_pack: BC7's bit packing, each texture block under its own mode
// (BC67.cpp:2003-2203).
//
// Replaces no TPU kernel: the JAX package packs in XLA ops
// (convectionkernels_tpu/models/bc7.py:1303-1459, _pack_mode_bits and
// _pack_bits), which lay out every block under all 8 modes and keep its own
// mode's words; the port ran that as about 13,400 torch ops a call, graph
// nodes of a microsecond or more each whatever the block count. Mirrors,
// operation for operation, models/bc7_kernel.py _pack_mode_bits for the
// block's mode: the separate-alpha modes' index flips and endpoint swaps
// with the index-selector exchange, the anchor flips at the fixup pixels
// of the partition, each pixel's subset from the partition map, the static
// fields and p-bits, and the index fields at offsets that depend on the
// fixups. Integer operations only; shifts as torch's int32 shifts (<< on
// the 32 bits, >> arithmetic), so the bytes equal the plain version's for
// any int32 input whose partition lies in 0-63.
//
// Design: one thread a texture block. The input is pack's merged work,
// field-major (int32 [60, N], models/bc7_kernel.py pack_fields), so a warp
// reads 32 neighbouring words of each field it needs, and a block reads
// only its own mode's fields; the output, 4 words a block, goes out as one
// 16-byte store. The mode is a template argument: every field width and
// static offset is a constant, the loops unroll and the block's 128 bits
// stay in 4 registers. A warp whose blocks hold k modes runs k of the 8
// bodies in turn.
//
// Bound on an H100: bytes (116-188 a block: 25-43 of the 60 rows read by
// the mode, 16 bytes written, against a few hundred integer operations;
// chip_smoke.py's work_bc7_pack), 2.3-3.7 us at 65,536 blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// rows of the input (models/bc7_kernel.py FIELD_*)
constexpr int F_MODE = 0, F_PARTITION = 1, F_ROTATION = 2, F_ISEL = 3;
constexpr int F_EP = 4, F_INDEXES = 28, F_INDEXES2 = 44;
// rows of the lookup tables (models/bc7_kernel.py PACK_TABLES), 64 each
constexpr int T_MAP2 = 0, T_MAP3 = 1, T_FIX2 = 2, T_FIX3A = 3, T_FIX3B = 4;
constexpr int PARTITIONS = 64;
constexpr int THREADS = 128;

enum { PBIT_NONE, PBIT_PER_SUBSET, PBIT_PER_EP };
enum { ALPHA_NONE, ALPHA_SEPARATE, ALPHA_COMBINED };

struct ModeInfo {      // models/bc7_common.py MODE_INFO
    int pbit, alpha, rgb_bits, alpha_bits, partition_bits, num_subsets,
        index_bits, alpha_index_bits;
    bool has_index_selector;
};

__host__ __device__ constexpr ModeInfo mode_info(int m) {
    return m == 0 ? ModeInfo{PBIT_PER_EP, ALPHA_NONE, 4, 0, 4, 3, 3, 0, false}
         : m == 1 ? ModeInfo{PBIT_PER_SUBSET, ALPHA_NONE, 6, 0, 6, 2, 3, 0, false}
         : m == 2 ? ModeInfo{PBIT_NONE, ALPHA_NONE, 5, 0, 6, 3, 2, 0, false}
         : m == 3 ? ModeInfo{PBIT_PER_EP, ALPHA_NONE, 7, 0, 6, 2, 2, 0, false}
         : m == 4 ? ModeInfo{PBIT_NONE, ALPHA_SEPARATE, 5, 6, 0, 1, 2, 3, true}
         : m == 5 ? ModeInfo{PBIT_NONE, ALPHA_SEPARATE, 7, 8, 0, 1, 2, 2, false}
         : m == 6 ? ModeInfo{PBIT_PER_EP, ALPHA_COMBINED, 7, 7, 0, 1, 4, 0, false}
         :          ModeInfo{PBIT_PER_EP, ALPHA_COMBINED, 5, 5, 6, 2, 2, 0, false};
}

__device__ __forceinline__ int wrap_sub(int a, int b) {   // int32 a - b, wrapping
    return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ void swap_if(bool flag, int& a, int& b) {
    const int x = flag ? b : a, y = flag ? a : b;
    a = x;
    b = y;
}

// pack_static: `value` at the constant bit offset `off`, its bits past the
// word's end into the next word
__device__ __forceinline__ void put_static(uint32_t w[4], int& off, int value,
                                           int bits) {
    if (bits == 0) return;
    const int j = off / 32, sh = off % 32;
    w[j] |= (uint32_t)value << sh;
    if (sh + bits > 32) w[j + 1] |= (uint32_t)(value >> (32 - sh));
    off += bits;
}

// _pack_var: `value` (bits wide) at a per-block bit offset
__device__ __forceinline__ void put_var(uint32_t w[4], int value, int offset,
                                        int bits) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int sh = offset - 32 * j;
        if (sh >= 0 && sh < 32) w[j] |= (uint32_t)value << sh;
        if (sh < 0 && sh > -bits) w[j] |= (uint32_t)(value >> -sh);
    }
}

template <int MODE>
__device__ __forceinline__ void pack_mode(const int* __restrict__ f, size_t n,
                                          const int* __restrict__ tables,
                                          uint32_t w[4]) {
    constexpr ModeInfo I = mode_info(MODE);
    constexpr int NS = I.num_subsets, IB = I.index_bits;
    constexpr int AIB = I.alpha_index_bits;
    constexpr bool SEPARATE = I.alpha == ALPHA_SEPARATE;
    constexpr bool COMBINED = I.alpha == ALPHA_COMBINED;
    constexpr int INDEX_TOP = 1 << (IB - 1), INDEX_HI = (1 << IB) - 1;

    // only the fields the mode packs: no partition in a 1-subset mode, no
    // alpha endpoints in modes 0-3
    constexpr int CHANNELS = I.alpha == ALPHA_NONE ? 3 : 4;
    const int partition = NS > 1 ? f[F_PARTITION * n] : 0;
    int ep[NS][2][4] = {};
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int ch = 0; ch < CHANNELS; ++ch)
                ep[s][e][ch] = f[(F_EP + 8 * s + 4 * e + ch) * n];
    int idx[16], idx2[16];
#pragma unroll
    for (int px = 0; px < 16; ++px) idx[px] = f[(F_INDEXES + px) * n];

    int fix1 = 0, fix2 = 0;
    if constexpr (SEPARATE) {
        constexpr int ALPHA_TOP = 1 << (AIB - 1), ALPHA_HI = (1 << AIB) - 1;
#pragma unroll
        for (int px = 0; px < 16; ++px) idx2[px] = f[(F_INDEXES2 + px) * n];
        bool flip_rgb = (idx[0] & INDEX_TOP) != 0;
        bool flip_alpha = (idx2[0] & ALPHA_TOP) != 0;
#pragma unroll
        for (int px = 0; px < 16; ++px) {
            if (flip_rgb) idx[px] = wrap_sub(INDEX_HI, idx[px]);
            if (flip_alpha) idx2[px] = wrap_sub(ALPHA_HI, idx2[px]);
        }
        if constexpr (I.has_index_selector) {
            if (f[F_ISEL * n] != 0) {
                const bool t = flip_rgb;
                flip_rgb = flip_alpha;
                flip_alpha = t;
            }
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            swap_if(flip_rgb, ep[0][0][ch], ep[0][1][ch]);
        swap_if(flip_alpha, ep[0][0][3], ep[0][1][3]);
    } else {
        // the plain version's lookups raise past partition 63
        const int p = partition & (PARTITIONS - 1);
        uint32_t pmap = 0;
        if constexpr (NS == 2) {
            fix1 = __ldg(&tables[T_FIX2 * PARTITIONS + p]);
            pmap = (uint32_t)__ldg(&tables[T_MAP2 * PARTITIONS + p]);
        } else if constexpr (NS == 3) {
            fix1 = __ldg(&tables[T_FIX3A * PARTITIONS + p]);
            fix2 = __ldg(&tables[T_FIX3B * PARTITIONS + p]);
            pmap = (uint32_t)__ldg(&tables[T_MAP3 * PARTITIONS + p]);
        }
        // each subset's anchor index: pixel 0, fix1, fix2
        int at_fix1 = 0, at_fix2 = 0;
#pragma unroll
        for (int px = 0; px < 16; ++px) {
            at_fix1 = px == fix1 ? idx[px] : at_fix1;
            at_fix2 = px == fix2 ? idx[px] : at_fix2;
        }
        const bool flip0 = (idx[0] & INDEX_TOP) != 0;
        const bool flip1 = NS > 1 && (at_fix1 & INDEX_TOP) != 0;
        const bool flip2 = NS > 2 && (at_fix2 & INDEX_TOP) != 0;
#pragma unroll
        for (int px = 0; px < 16; ++px) {
            const int owner = NS == 2 ? (int)((pmap >> px) & 1)
                            : NS == 3 ? (int)((pmap >> (2 * px)) & 3) : 0;
            const bool flip = owner == 0 ? flip0 : owner == 1 ? flip1
                            : owner == 2 ? flip2 : false;
            if (flip) idx[px] = wrap_sub(INDEX_HI, idx[px]);
        }
        const bool flips[3] = {flip0, flip1, flip2};
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int ch = 0; ch < (COMBINED ? 4 : 3); ++ch)
                swap_if(flips[s], ep[s][0][ch], ep[s][1][ch]);
    }

    int off = 0;
    put_static(w, off, 1 << MODE, MODE + 1);
    if constexpr (I.partition_bits != 0)
        put_static(w, off, partition, I.partition_bits);
    if constexpr (SEPARATE) put_static(w, off, f[F_ROTATION * n], 2);
    if constexpr (I.has_index_selector) put_static(w, off, f[F_ISEL * n], 1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                put_static(w, off, ep[s][e][ch] >> (8 - I.rgb_bits),
                           I.rgb_bits);
    if constexpr (I.alpha_bits != 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                put_static(w, off, ep[s][e][3] >> (8 - I.alpha_bits),
                           I.alpha_bits);
    }
    if constexpr (I.pbit == PBIT_PER_SUBSET) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
            put_static(w, off, (ep[s][0][0] >> (7 - I.rgb_bits)) & 1, 1);
    } else if constexpr (I.pbit == PBIT_PER_EP) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                put_static(w, off, (ep[s][e][0] >> (7 - I.rgb_bits)) & 1, 1);
    }

    // index fields: an anchor is a bit narrower, so offsets depend on the
    // fixup pixels
    int cum = off;
#pragma unroll
    for (int px = 0; px < 16; ++px) {
        put_var(w, idx[px], cum, IB);
        cum += px == 0 ? IB - 1 : IB - (fix1 == px) - (fix2 == px);
    }
    if constexpr (SEPARATE) {
#pragma unroll
        for (int px = 0; px < 16; ++px) {
            put_var(w, idx2[px], cum, AIB);
            cum += AIB - (px == 0 ? 1 : 0);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
bc7_pack_kernel(const int* __restrict__ fields, const int* __restrict__ tables,
                int n_blocks, uint8_t* __restrict__ out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_blocks) return;
    const int* f = fields + i;
    const size_t n = (size_t)n_blocks;
    uint32_t w[4] = {0, 0, 0, 0};     // a mode outside 0-7 packs to zeros
    switch (f[F_MODE * n]) {
        case 0: pack_mode<0>(f, n, tables, w); break;
        case 1: pack_mode<1>(f, n, tables, w); break;
        case 2: pack_mode<2>(f, n, tables, w); break;
        case 3: pack_mode<3>(f, n, tables, w); break;
        case 4: pack_mode<4>(f, n, tables, w); break;
        case 5: pack_mode<5>(f, n, tables, w); break;
        case 6: pack_mode<6>(f, n, tables, w); break;
        case 7: pack_mode<7>(f, n, tables, w); break;
        default: break;
    }
    // byte b of word j is block byte 4j + b: the words' little-endian bytes
    reinterpret_cast<uint4*>(out)[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

// fields [60, n] i32 (field-major), tables [5, 64] i32. Output out [n, 16]
// u8, 16-byte aligned.
extern "C" int ck_bc7_pack(const int* fields, const int* tables, int n,
                           uint8_t* out, void* stream) {
    if (n == 0) return 0;
    bc7_pack_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(fields, tables, n, out);
    return (int)cudaGetLastError();
}
