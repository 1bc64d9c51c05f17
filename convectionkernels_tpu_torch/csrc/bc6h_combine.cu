// combine: the meta0 x meta1 x first-legal-mode combine of one BC6H
// precision group (ConvectionKernels_BC67.cpp:2914-2986).
//
// Replaces no TPU kernel: the JAX package leaves the combine to XLA, as a
// candidate grid over (partition, meta0, meta1) resolved by a lexicographic
// minimum (convectionkernels_tpu/models/bc6h.py). Mirrors, for every field
// it returns, models/bc6h_kernel.py combine_plain, that grid formulation in
// PyTorch.
//
// Why it was added: on the card the plain version materialised, for each of
// the six partitioned groups, a float32 and a bool grid [N, 12, 12, 32] and
// three int32 delta grids [N, 12, 12, 3, 32] (about 3.6 GB each at 65,536
// blocks), and added, masked, compared and reduced them once per mode of the
// group. Run op by op at 65,536 blocks those grid ops took about 280 of 426
// ms of a BC6H encode's device time, the grids set the encoder's peak memory,
// and in a 1024x1024 HDR bake with mips the torch ops of models/ held 93% of
// the device time against the bc6h_group kernel's 6.5%.
//
// Bound on an H100: bytes. A block's chain outputs are read once: err, valid
// and the 6 endpoint words of 64 rows over 12 rounds, 24.6 KB (the index
// words of the two winning rows only). At 65,536 blocks that is 1.61 GB a
// group, 0.48 ms at 3.35 TB/s. The candidates are 4,608 a block (32
// partitions x 12 x 12 rounds); each costs a valid bit, one float add and one
// compare, about 0.04 ms at 65,536 blocks and 33.45e12 lane operations a
// second, and the legality tests run only for a candidate that would improve
// its lane's best (at most 3 modes x 6 deltas x 3 operations).
//
// Design (partitioned group, Q = 64 rows, subset-major q = subset * 32 + p):
// one warp per texture block, lane p = partition p. The lane's subset-1 rows
// of every round (error, 6 endpoints) are staged once in shared memory, with
// loads coalesced over the 32 partitions, and their valid flags kept as a
// bit mask; lane p only reads its own column, so no barrier is needed. The
// lane then scans meta0 (subset 0, read once from device memory) and meta1
// in the reference's order with a strict-less compare, so it keeps the first
// least candidate of its partition. Subset 0's delta, and so which modes can
// still encode the pair, depends on meta0 alone and is hoisted out of the
// meta1 loop. A warp butterfly on (error, flat index p*M*M + meta0*M + meta1)
// then gives every lane the block's first least candidate in (partition,
// meta0, meta1) order. The winner's two endpoint rows are read as broadcasts,
// every lane works out the first legal mode and its encoded endpoints (deltas
// truncated as TruncateToPrecisionSigned does), and lanes 0-15 unpack one
// index each from the winning rows' packed words.
//
// Single-mode group (Q = 1, indexes unpacked [N, M, 16, 1]): 12 candidates a
// block, one thread per texture block.
//
// A row with no valid legal pair gives the plain version's answer: error
// +inf, candidate 0, and the mode and endpoints worked out for it (mode -1
// and zero endpoints where no mode can encode them), which the caller's
// running best rejects. The kernel never writes the candidate grid.
//
// Exactness: compiled with -fmad=false (cuda_lib.NVCC_FLAGS); the one float
// operation is err0 + err1, a single float32 add. Integer differences wrap
// in 32 bits, as int32 tensors do.
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;              // rows of a partitioned group
constexpr int PARTS = 32;
constexpr int MAX_ROUNDS = 12;     // tweak x refine rounds
constexpr int MAX_META = 12;       // rank stride of a meta round
constexpr int MAX_MODES = 3;
constexpr int WARPS = 4;           // texture blocks per CUDA block, partitioned
constexpr int THREADS = 128;

struct Params {
    int m_count;                   // rounds that ran, M
    int meta_ids[MAX_ROUNDS];      // their meta round ids, in order
    int rank_base;
    int a_mask;                    // (1 << aPrec) - 1
    int num_modes;
    int filter;                    // every mode of the group is transformed
    int mode_index[MAX_MODES];
    int transformed[MAX_MODES];
    int bprec[MAX_MODES][3];
    int half[MAX_MODES][3];        // 1 << (bPrec - 1)
    int hi_mask[MAX_MODES][3];     // (1 << aPrec) - (1 << bPrec)
    int partition_map[PARTS];      // bit px: pixel px is in subset 1
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// a delta of `bprec` bits reconstructs it under the aPrec mask: bits
// bPrec..aPrec-1 of (d + 2^(bPrec-1)) are zero
__device__ __forceinline__ bool fits(int d, int half, int hi_mask) {
    return (((unsigned)d + (unsigned)half) & (unsigned)hi_mask) == 0u;
}

// TruncateToPrecisionSigned (ParallelMath.h:1410-1414)
__device__ __forceinline__ int truncate_signed(int v, int precision) {
    const int shift = 32 - precision;
    return (int)((unsigned)v << shift) >> shift;
}

// which of the `candidates` modes (bit k) fit every delta d[j], an endpoint
// channel j % 3 less subset 0's first endpoint
template <int NDELTA>
__device__ __forceinline__ unsigned modes_fitting(const Params& prm,
                                                  const int* d,
                                                  unsigned candidates) {
    unsigned out = 0;
#pragma unroll
    for (int k = 0; k < MAX_MODES; ++k) {
        if (k >= prm.num_modes || !((candidates >> k) & 1u)) continue;
        bool ok = true;
#pragma unroll
        for (int j = 0; j < NDELTA; ++j)
            ok = ok && fits(d[j], prm.half[k][j % 3], prm.hi_mask[k][j % 3]);
        out |= (ok ? 1u : 0u) << k;
    }
    return out;
}

// The first mode of the group that can encode the winner's endpoints
// cand[subset * 2 + endpoint][channel], and its encoded endpoints: subset
// 0's first endpoint as it is, the other used endpoints as truncated deltas
// (a single-subset group uses 2), the rest as they are.
__device__ __forceinline__ void encode_winner(const Params& prm,
                                              const int (&cand)[4][3],
                                              int used, int& mode,
                                              int (&enc)[4][3]) {
    mode = -1;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c) enc[e][c] = 0;
#pragma unroll
    for (int k = 0; k < MAX_MODES; ++k) {
        if (k >= prm.num_modes) continue;
        int out[4][3];
        bool legal = true;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                out[e][c] = cand[e][c];
                if (prm.transformed[k] && e > 0 && e < used) {
                    const int delta = truncate_signed(
                        wrap_sub(cand[e][c], cand[0][c]), prm.bprec[k][c]);
                    const int recon = (int)((unsigned)delta
                                            + (unsigned)cand[0][c])
                                      & prm.a_mask;
                    legal = legal && recon == (cand[e][c] & prm.a_mask);
                    out[e][c] = delta;
                }
            }
        }
        if (mode < 0 && legal) {
            mode = prm.mode_index[k];
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int c = 0; c < 3; ++c) enc[e][c] = out[e][c];
        }
    }
}

// value j (< 12) of the winner's encoded endpoints, by a select chain (no
// dynamic register index)
__device__ __forceinline__ int enc_value(const int (&enc)[4][3], int j) {
    int v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            if (e * 3 + c == j) v = enc[e][c];
    return v;
}

__device__ __forceinline__ int rank_of(const Params& prm, int part, int m0,
                                       int m1_id) {
    return prm.rank_base + part * (MAX_META * MAX_META)
           + prm.meta_ids[m0] * MAX_META + m1_id;
}

template <bool PARTITIONED>
__global__ void __launch_bounds__(THREADS)
bc6h_combine_kernel(const float* __restrict__ err,
                    const int* __restrict__ valid,
                    const int* __restrict__ eps,
                    const int* __restrict__ idx, int n_blocks, Params prm,
                    float* __restrict__ win_err, int* __restrict__ win_rank,
                    int* __restrict__ win_mode, int* __restrict__ win_part,
                    int* __restrict__ win_ep, int* __restrict__ win_idx) {
    const int M = prm.m_count;
    if constexpr (PARTITIONED) {
        __shared__ float s_err1[WARPS][MAX_ROUNDS][PARTS];
        __shared__ int s_ep1[WARPS][MAX_ROUNDS][6][PARTS];
        const int warp = threadIdx.x >> 5;
        const int lane = threadIdx.x & 31;
        const size_t n = (size_t)blockIdx.x * WARPS + warp;
        if (n >= (size_t)n_blocks) return;     // the whole warp
        const size_t row0 = n * M;             // row (n, m) is row0 + m

        // subset 1 of every round: lane p stages row 32 + p
        unsigned valid1 = 0;
        for (int m = 0; m < M; ++m) {
            const size_t r = row0 + m;
            s_err1[warp][m][lane] = err[r * Q + PARTS + lane];
            if (valid[r * Q + PARTS + lane] != 0) valid1 |= 1u << m;
#pragma unroll
            for (int j = 0; j < 6; ++j)
                s_ep1[warp][m][j][lane] = eps[(r * 6 + j) * Q + PARTS + lane];
        }

        // the first least candidate of partition `lane`, (meta0, meta1)
        float best = __int_as_float(0x7f800000);   // +inf
        int best_pos = 0;
        const unsigned all_modes = (1u << prm.num_modes) - 1u;
        for (int m0 = 0; m0 < M; ++m0) {
            const size_t r = row0 + m0;
            if (valid[r * Q + lane] == 0) continue;
            const float e0 = err[r * Q + lane];
            int ep0[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) ep0[j] = eps[(r * 6 + j) * Q + lane];
            unsigned ok0 = all_modes;
            if (prm.filter) {
                int d0[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) d0[c] = wrap_sub(ep0[3 + c], ep0[c]);
                ok0 = modes_fitting<3>(prm, d0, all_modes);
                if (ok0 == 0u) continue;
            }
            for (int m1 = 0; m1 < M; ++m1) {
                if (!((valid1 >> m1) & 1u)) continue;
                const float total = e0 + s_err1[warp][m1][lane];
                if (!(total < best)) continue;
                if (prm.filter) {
                    int d[6];
#pragma unroll
                    for (int j = 0; j < 6; ++j)
                        d[j] = wrap_sub(s_ep1[warp][m1][j][lane], ep0[j % 3]);
                    if (modes_fitting<6>(prm, d, ok0) == 0u) continue;
                }
                best = total;
                best_pos = m0 * M + m1;
            }
        }

        // the block's first least candidate in (partition, meta0, meta1)
        int flat = lane * M * M + best_pos;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float other = __shfl_xor_sync(0xffffffffu, best, off);
            const int other_flat = __shfl_xor_sync(0xffffffffu, flat, off);
            if (other < best || (other == best && other_flat < flat)) {
                best = other;
                flat = other_flat;
            }
        }
        const int part = flat / (M * M);
        const int m0 = (flat / M) % M;
        const int m1 = flat % M;
        const size_t r0 = row0 + m0, r1 = row0 + m1;
        int cand[4][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            cand[0][c] = eps[(r0 * 6 + c) * Q + part];
            cand[1][c] = eps[(r0 * 6 + 3 + c) * Q + part];
            cand[2][c] = eps[(r1 * 6 + c) * Q + PARTS + part];
            cand[3][c] = eps[(r1 * 6 + 3 + c) * Q + PARTS + part];
        }
        int mode, enc[4][3];
        encode_winner(prm, cand, 4, mode, enc);
        if (lane == 0) {
            win_err[n] = best;
            win_rank[n] = rank_of(prm, part, m0, prm.meta_ids[m1]);
            win_mode[n] = mode;
            win_part[n] = part;
        }
        if (lane < 12) win_ep[n * 12 + lane] = enc_value(enc, lane);
        if (lane < 16) {
            // pixel `lane`: its subset's winning row, word 0 (pixels 0-9)
            // or 1 (10-15), 3 bits each
            const int px = lane;
            const int w = px >= 10 ? 1 : 0;
            const bool in1 = (prm.partition_map[part] >> px) & 1;
            const int word = in1 ? idx[(r1 * 2 + w) * Q + PARTS + part]
                                 : idx[(r0 * 2 + w) * Q + part];
            win_idx[n * 16 + px] = (word >> (3 * (px - 10 * w))) & 7;
        }
    } else {
        const size_t n = (size_t)blockIdx.x * THREADS + threadIdx.x;
        if (n >= (size_t)n_blocks) return;
        const size_t row0 = n * M;
        const unsigned all_modes = (1u << prm.num_modes) - 1u;
        float best = __int_as_float(0x7f800000);   // +inf
        int best_m = 0;
        for (int m = 0; m < M; ++m) {
            const size_t r = row0 + m;
            if (valid[r] == 0) continue;
            const float total = err[r];
            if (!(total < best)) continue;
            if (prm.filter) {
                int d0[3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    d0[c] = wrap_sub(eps[r * 6 + 3 + c], eps[r * 6 + c]);
                if (modes_fitting<3>(prm, d0, all_modes) == 0u) continue;
            }
            best = total;
            best_m = m;
        }
        const size_t r = row0 + best_m;
        int cand[4][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            cand[0][c] = cand[2][c] = eps[r * 6 + c];
            cand[1][c] = cand[3][c] = eps[r * 6 + 3 + c];
        }
        int mode, enc[4][3];
        encode_winner(prm, cand, 2, mode, enc);
        win_err[n] = best;
        win_rank[n] = rank_of(prm, 0, best_m, 0);
        win_mode[n] = mode;
        win_part[n] = 0;
#pragma unroll
        for (int j = 0; j < 12; ++j) win_ep[n * 12 + j] = enc_value(enc, j);
#pragma unroll
        for (int px = 0; px < 16; ++px) win_idx[n * 16 + px] = idx[r * 16 + px];
    }
}

}  // namespace

// meta_ids: m_count ints; modes: num_modes x (mode index, transformed,
// bPrec r, g, b); partition_map: 32 ints (host arrays)
extern "C" int ck_bc6h_combine(const float* err, const int* valid,
                               const int* eps, const int* idx, int n,
                               int m_count, int partitioned, int aprec,
                               int rank_base, const int* meta_ids,
                               int num_modes, const int* modes,
                               const int* partition_map, float* win_err,
                               int* win_rank, int* win_mode, int* win_part,
                               int* win_ep, int* win_idx,
                               cudaStream_t stream) {
    if (n <= 0) return 0;
    if (m_count < 1 || m_count > MAX_ROUNDS || num_modes < 1 ||
        num_modes > MAX_MODES || aprec < 1 || aprec > 16)
        return (int)cudaErrorInvalidValue;
    Params prm;
    prm.m_count = m_count;
    for (int i = 0; i < MAX_ROUNDS; ++i)
        prm.meta_ids[i] = i < m_count ? meta_ids[i] : 0;
    prm.rank_base = rank_base;
    prm.a_mask = (1 << aprec) - 1;
    prm.num_modes = num_modes;
    prm.filter = 1;
    for (int k = 0; k < MAX_MODES; ++k) {
        const int* m = modes + 5 * (k < num_modes ? k : 0);
        prm.mode_index[k] = m[0];
        prm.transformed[k] = m[1];
        if (k < num_modes && !m[1]) prm.filter = 0;
        for (int c = 0; c < 3; ++c) {
            const int b = m[2 + c];
            if (b < 1 || b > aprec) return (int)cudaErrorInvalidValue;
            prm.bprec[k][c] = b;
            prm.half[k][c] = 1 << (b - 1);
            prm.hi_mask[k][c] = (1 << aprec) - (1 << b);
        }
    }
    for (int i = 0; i < PARTS; ++i) prm.partition_map[i] = partition_map[i];
    if (partitioned) {
        bc6h_combine_kernel<true><<<(n + WARPS - 1) / WARPS, THREADS, 0,
                                    stream>>>(
            err, valid, eps, idx, n, prm, win_err, win_rank, win_mode,
            win_part, win_ep, win_idx);
    } else {
        bc6h_combine_kernel<false><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                     stream>>>(
            err, valid, eps, idx, n, prm, win_err, win_rank, win_mode,
            win_part, win_ep, win_idx);
    }
    return (int)cudaGetLastError();
}
