// Exact top-k dot-product search over a padded bf16 corpus, in two passes.
//
// Replaces the Pallas kernel mediquery_rag_tpu/ops/scoring.py:_flat_topk_kernel
// (:303, launched at :370 by flat_search :388): Q . C^T fused with a running
// top-k, rows >= n_valid masked, short results (-inf, id 0).
//
// The TPU kernel walks the corpus tiles in order on one core and carries the
// running top-k in VMEM from one grid step to the next. Blocks on Hopper run
// in no order, so the work is split in two hand-written passes:
//   pass 1: one block per (query tile of 16, corpus chunk). Four warps score
//           64 corpus rows at a time with bf16 WMMA (f32 accumulate), reading
//           the fragments straight from device memory; the 16 x 64 scores go
//           to shared memory and each warp folds them, in corpus-row order,
//           into the sorted per-query top-k of the chunk (shared memory).
//           A candidate enters only if strictly greater than the current k-th
//           score, and is placed after every incumbent of equal score, so
//           among equal scores the lower row wins and == never displaces.
//   pass 2: one block per query merges the per-chunk lists into the sorted
//           [B, k] result, k rounds of a block-wide arg-best under the order
//           (score desc, row asc).
// The fold and the merge live in topk_merge.cuh, shared with quant_topk.cu.
// What bounds it on an H100: at B = 64 each corpus byte feeds 64 multiply-adds,
// below the card's compute/bandwidth balance, so the scan is bound by reading
// the corpus (N*D*2 bytes). Query tiles of one chunk are adjacent in the grid
// (blockIdx.x) so the chunk is re-read from L2, not from device memory.
// Requires D % 16 == 0, N_pad % 64 == 0, chunk % 64 == 0, k <= 128, queries
// padded to a multiple of 16 rows, 32-byte aligned pointers (wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "topk_merge.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 16;            // queries per block (WMMA M)
constexpr int WARPS = 4;
constexpr int SUB = WARPS * 16;   // corpus rows scored per sub-tile
constexpr int KMAX = topk::KMAX;

__global__ void __launch_bounds__(WARPS * 32)
flat_topk_pass1(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
                int D, int n_pad, int n_valid, int chunk, int k, int nchunks,
                float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ __align__(32) float sc[QT * SUB];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int qt = blockIdx.x;
    const int ch = blockIdx.y;
    const int row_begin = ch * chunk;
    const int row_end = min(n_pad, row_begin + chunk);

    for (int t = threadIdx.x; t < QT * KMAX; t += blockDim.x) {
        ls[t / KMAX][t % KMAX] = -CUDART_INF_F;
        li[t / KMAX][t % KMAX] = 0;
    }
    __syncthreads();

    const __nv_bfloat16* qbase = q + (size_t)qt * QT * D;
    for (int r0 = row_begin; r0 < row_end; r0 += SUB) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        const __nv_bfloat16* cb = c + (size_t)(r0 + warp * 16) * D;
        for (int d = 0; d < D; d += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
            wmma::load_matrix_sync(a, qbase + d, D);
            wmma::load_matrix_sync(b, cb + d, D);
            wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(sc + warp * 16, acc, SUB, wmma::mem_row_major);
        __syncthreads();

        for (int qi = warp; qi < QT; qi += WARPS) {
            for (int half = 0; half < SUB / 32; ++half) {
                const int col = half * 32 + lane;
                const float sv = (r0 + col < n_valid) ? sc[qi * SUB + col] : -CUDART_INF_F;
                topk::fold32(ls[qi], li[qi], k, sv, r0 + half * 32);
            }
        }
        __syncthreads();
    }

    for (int t = threadIdx.x; t < QT * k; t += blockDim.x) {
        const int qi = t / k, j = t % k;
        const size_t o = ((size_t)(qt * QT + qi) * nchunks + ch) * k + j;
        part_s[o] = ls[qi][j];
        part_i[o] = li[qi][j];
    }
}

}  // namespace

extern "C" int flat_topk(const void* q, const void* c, int b_pad, int D, int n_pad,
                         int n_valid, int chunk, int k, void* part_s, void* part_i,
                         void* out_s, void* out_i, void* stream) {
    const int nchunks = (n_pad + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 g1(b_pad / QT, nchunks);
    flat_topk_pass1<<<g1, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)c, D, n_pad, n_valid, chunk, k,
        nchunks, (float*)part_s, (int*)part_i);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    topk::topk_merge_pass2<<<b_pad, 256, 0, st>>>((const float*)part_s, (const int*)part_i,
                                           nchunks, k, (float*)out_s, (int*)out_i);
    return (int)cudaGetLastError();
}
