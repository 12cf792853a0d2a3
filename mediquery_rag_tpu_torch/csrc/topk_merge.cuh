// The two top-k pieces shared by the scan kernels (flat_topk.cu, quant_topk.cu).
//
// The TPU kernels carry one running top-k across sequential grid steps; blocks
// on Hopper run in no order, so every scan here is two passes:
//   pass 1: one block per (query tile, corpus chunk) scores the chunk and folds
//           the scores, in corpus-row order, into a sorted per-query top-k in
//           shared memory (fold32);
//   pass 2: one block per query merges the per-chunk lists (topk_merge_pass2).
// Both keep the order (score desc, row asc), the order of lax.top_k: a
// candidate enters only if strictly greater than the current k-th score and
// is placed after every incumbent of equal score.

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

// One warp folds 32 candidates (lane l holds score sv of row base + l; -inf if
// masked) into the sorted list ls/li[0..k) in shared memory, lowest row first.
__device__ __forceinline__ void fold32(float* ls, int* li, int k, float sv, int base) {
    const int lane = threadIdx.x & 31;
    unsigned m = __ballot_sync(FULL, sv > ls[k - 1]);
    while (m) {                       // ascending corpus row order
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cs = __shfl_sync(FULL, sv, src);
        if (!(cs > ls[k - 1])) continue;   // the k-th score only grows
        const int cid = base + src;
        int cnt = 0;                  // entries that stay ahead: >= cs
        for (int b0 = 0; b0 < k; b0 += 32) {
            const int j = b0 + lane;
            cnt += __popc(__ballot_sync(FULL, j < k && ls[j] >= cs));
        }
        float tv[KMAX / 32];
        int ti[KMAX / 32];
#pragma unroll
        for (int t = 0; t < KMAX / 32; ++t) {
            const int j = cnt + t * 32 + lane;
            if (j < k - 1) { tv[t] = ls[j]; ti[t] = li[j]; }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < KMAX / 32; ++t) {
            const int j = cnt + t * 32 + lane;
            if (j < k - 1) { ls[j + 1] = tv[t]; li[j + 1] = ti[t]; }
        }
        if (lane == 0) { ls[cnt] = cs; li[cnt] = cid; }
        __syncwarp();
    }
}

// One block of 256 threads per query: k rounds of a block-wide arg-best over
// the query's nchunks*k partial entries under (score desc, row asc). Rows are
// unique across chunks, so "already taken" is "ordered before the last pick".
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

}  // namespace topk
