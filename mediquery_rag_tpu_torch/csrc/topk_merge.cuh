// The top-k pieces shared by the scan kernels (scan.cuh for flat_topk.cu and
// quant_topk.cu, ivf_topk.cu).
//
// The TPU kernels carry one running top-k across sequential grid steps; blocks
// on Hopper run in no order, so every scan here is two passes:
//   pass 1: each block keeps a sorted per-query top-k of its part of the
//           corpus in shared memory (scan.cuh's filter and merge by rank,
//           which the IVF scans of ivf_scan.cuh share);
//   pass 2: one block per query merges the blocks' lists (topk_merge_pass2;
//           topk_merge_heads, a k-way merge, for the IVF scans' many lists).
// Both keep the order (score desc, row asc), the order of lax.top_k.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

namespace topk {

constexpr int KMAX = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

// One block of 256 threads per query: k rounds of a block-wide arg-best over
// the query's nchunks*k partial entries under (score desc, row asc). Rows are
// unique across chunks, so "already taken" is "ordered before the last pick"
// (ivf_topk.cu passes doc ids, also unique: a doc sits in one slot).
// Fewer than k finite entries: the rest of the row is (-inf, 0).
__global__ void __launch_bounds__(256)
topk_merge_pass2(const float* __restrict__ part_s, const int* __restrict__ part_i,
                 int nchunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
    __shared__ float ws[8];
    __shared__ int wi[8];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n = nchunks * k;
    const float* ps = part_s + (size_t)b * n;
    const int* pi = part_i + (size_t)b * n;

    float prev_s = CUDART_INF_F;
    int prev_i = -1;
    for (int t = 0; t < k; ++t) {
        float bs = -CUDART_INF_F;
        int bi = INT_MAX;
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const float s = ps[j];
            const int i = pi[j];
            if (s == -CUDART_INF_F) continue;                      // short list padding
            if (!(s < prev_s || (s == prev_s && i > prev_i))) continue;   // already taken
            if (better(s, i, bs, bi)) { bs = s; bi = i; }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float os = __shfl_xor_sync(FULL, bs, o);
            const int oi = __shfl_xor_sync(FULL, bi, o);
            if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
        }
        if (lane == 0) { ws[warp] = bs; wi[warp] = bi; }
        __syncthreads();
        if (warp == 0) {
            bs = lane < (int)(blockDim.x >> 5) ? ws[lane] : -CUDART_INF_F;
            bi = lane < (int)(blockDim.x >> 5) ? wi[lane] : INT_MAX;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const float os = __shfl_xor_sync(FULL, bs, o);
                const int oi = __shfl_xor_sync(FULL, bi, o);
                if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
            }
            if (lane == 0) { ws[0] = bs; wi[0] = bi; }
        }
        __syncthreads();
        bs = ws[0];
        bi = wi[0];
        __syncthreads();                   // ws reused next round
        if (bs == -CUDART_INF_F) {         // fewer than k valid rows
            for (int j = t + threadIdx.x; j < k; j += blockDim.x) {
                out_s[(size_t)b * k + j] = -CUDART_INF_F;
                out_i[(size_t)b * k + j] = 0;
            }
            return;
        }
        if (threadIdx.x == 0) {
            out_s[(size_t)b * k + t] = bs;
            out_i[(size_t)b * k + t] = bi;
        }
        prev_s = bs;
        prev_i = bi;
    }
}

// The best head among this thread's lists (c = threadIdx.x mod blockDim.x),
// as (score, id, list); (-inf, INT_MAX, -1) when they are all spent.
__device__ __forceinline__ void best_head(const float* ps, const int* pi, const int* head,
                                          int nchunks, int k, float& bs, int& bi, int& bc) {
    bs = -CUDART_INF_F;
    bi = INT_MAX;
    bc = -1;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
        const int h = head[c];
        if (h >= k) continue;
        const float s = ps[(size_t)c * k + h];
        const int i = pi[(size_t)c * k + h];
        if (s != -CUDART_INF_F && better(s, i, bs, bi)) { bs = s; bi = i; bc = c; }
    }
}

// Pass 2 as a k-way merge (ivf_topk.cu, whose pass 1 may leave a thousand
// lists per query): one block of 256 threads per query. Thread t owns lists
// t, t + 256, ...; it keeps their read positions in dynamic shared memory
// (nchunks ints) and the best of their heads in registers. Each of the k
// rounds takes the block's best head, and only its owner advances that list
// and looks at its own heads again, so a round reads nchunks / 256 entries
// where topk_merge_pass2 reads all nchunks * k. Same output as
// topk_merge_pass2: (score desc, id asc), short rows end in (-inf, 0).
__global__ void __launch_bounds__(256)
topk_merge_heads(const float* __restrict__ part_s, const int* __restrict__ part_i,
                 int nchunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ int head[];
    __shared__ float ws[8];
    __shared__ int wi[8];
    __shared__ int wt[8];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* ps = part_s + (size_t)b * nchunks * k;
    const int* pi = part_i + (size_t)b * nchunks * k;

    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) head[c] = 0;   // own lists only
    float bs;
    int bi, bc;
    best_head(ps, pi, head, nchunks, k, bs, bi, bc);
    for (int t = 0; t < k; ++t) {
        float rs = bs;
        int ri = bi, rt = threadIdx.x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float os = __shfl_xor_sync(FULL, rs, o);
            const int oi = __shfl_xor_sync(FULL, ri, o);
            const int ot = __shfl_xor_sync(FULL, rt, o);
            if (better(os, oi, rs, ri)) { rs = os; ri = oi; rt = ot; }
        }
        if (lane == 0) { ws[warp] = rs; wi[warp] = ri; wt[warp] = rt; }
        __syncthreads();
        if (warp == 0) {
            const bool in = lane < (int)(blockDim.x >> 5);
            rs = in ? ws[lane] : -CUDART_INF_F;
            ri = in ? wi[lane] : INT_MAX;
            rt = in ? wt[lane] : -1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const float os = __shfl_xor_sync(FULL, rs, o);
                const int oi = __shfl_xor_sync(FULL, ri, o);
                const int ot = __shfl_xor_sync(FULL, rt, o);
                if (better(os, oi, rs, ri)) { rs = os; ri = oi; rt = ot; }
            }
            if (lane == 0) { ws[0] = rs; wi[0] = ri; wt[0] = rt; }
        }
        __syncthreads();
        rs = ws[0];
        ri = wi[0];
        rt = wt[0];
        __syncthreads();                   // ws reused next round
        if (rs == -CUDART_INF_F) {         // fewer than k finite entries
            for (int j = t + threadIdx.x; j < k; j += blockDim.x) {
                out_s[(size_t)b * k + j] = -CUDART_INF_F;
                out_i[(size_t)b * k + j] = 0;
            }
            return;
        }
        if (threadIdx.x == 0) {
            out_s[(size_t)b * k + t] = rs;
            out_i[(size_t)b * k + t] = ri;
        }
        if (threadIdx.x == rt) {
            ++head[bc];
            best_head(ps, pi, head, nchunks, k, bs, bi, bc);
        }
    }
}

}  // namespace topk
