// Exact top-k dot-product search over a padded bf16 or f32 corpus, in two passes.
//
// Replaces the Pallas kernel mediquery_rag_tpu/ops/scoring.py:_flat_topk_kernel
// (:303, launched at :370 by flat_search :388): Q . C^T fused with a running
// top-k, rows >= n_valid masked, short results (-inf, id 0). flat_topk takes
// bf16 (tensor cores, below); flat_topk_f32 the f32 case (CUDA cores, further
// down).
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
// padded to a multiple of 16 rows, 32-byte aligned pointers (wrapper checks);
// the same for f32 (16-byte aligned suffices).

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

// f32 pass 1 (flat_topk_f32): the f32 case of _flat_topk_kernel, f32 x f32
// with f32 sums, on CUDA cores (fmaf), no TF32: TF32 keeps about three
// decimal digits and the plain version is full f32. One block of 128 threads
// per (16-query tile, corpus chunk); thread t scores corpus row r0 + t
// against the 16 queries, reading its row with 16-byte float4 loads and the
// queries from shared memory in pieces of QD columns (a broadcast: every
// thread reads the same address), 64 multiply-adds per float4 of the row.
// What bounds it on an H100: at B = 64 each 4-byte corpus value feeds 64
// multiply-adds, 32 operations per byte, above the card's f32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s = 20): operations, not bytes.
constexpr int SUB_F32 = 128;      // corpus rows per f32 sub-tile, one per thread
constexpr int QD = 256;           // query columns staged in shared memory at a time

__global__ void __launch_bounds__(SUB_F32)
flat_topk_f32_pass1(const float* __restrict__ q, const float* __restrict__ c, int D,
                    int n_pad, int n_valid, int chunk, int k, int nchunks,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ __align__(16) float qs[QT][QD];
    __shared__ float sc[QT][SUB_F32];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int qt = blockIdx.x;
    const int ch = blockIdx.y;
    const int row_begin = ch * chunk;
    const int row_end = min(n_pad, row_begin + chunk);

    for (int t = tid; t < QT * KMAX; t += blockDim.x) {
        ls[t / KMAX][t % KMAX] = -CUDART_INF_F;
        li[t / KMAX][t % KMAX] = 0;
    }
    const float* qbase = q + (size_t)qt * QT * D;
    for (int r0 = row_begin; r0 < row_end; r0 += SUB_F32) {
        const int r = r0 + tid;
        const bool live = r < row_end;
        const float* row = c + (size_t)(live ? r : r0) * D;
        float acc[QT];
#pragma unroll
        for (int i = 0; i < QT; ++i) acc[i] = 0.f;
        for (int c0 = 0; c0 < D; c0 += QD) {
            const int w = min(QD, D - c0);
            __syncthreads();              // the previous piece is read
            for (int t = tid; t < QT * w / 4; t += blockDim.x) {
                const int qi = t / (w / 4), e = t % (w / 4);
                *reinterpret_cast<float4*>(&qs[qi][4 * e]) =
                    *reinterpret_cast<const float4*>(qbase + (size_t)qi * D + c0 + 4 * e);
            }
            __syncthreads();
            if (live) {
                for (int e = 0; e < w; e += 4) {
                    const float4 x = __ldg(reinterpret_cast<const float4*>(row + c0 + e));
#pragma unroll
                    for (int i = 0; i < QT; ++i) {
                        const float4 y = *reinterpret_cast<const float4*>(&qs[i][e]);
                        acc[i] = fmaf(x.x, y.x, acc[i]);
                        acc[i] = fmaf(x.y, y.y, acc[i]);
                        acc[i] = fmaf(x.z, y.z, acc[i]);
                        acc[i] = fmaf(x.w, y.w, acc[i]);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < QT; ++i) sc[i][tid] = acc[i];
        __syncthreads();

        for (int qi = warp; qi < QT; qi += SUB_F32 / 32) {
            for (int part = 0; part < SUB_F32 / 32; ++part) {
                const int col = part * 32 + lane;
                const int rr = r0 + col;
                const float sv = (rr < row_end && rr < n_valid) ? sc[qi][col] : -CUDART_INF_F;
                topk::fold32(ls[qi], li[qi], k, sv, r0 + part * 32);
            }
        }
    }
    __syncthreads();

    for (int t = tid; t < QT * k; t += blockDim.x) {
        const int qi = t / k, j = t % k;
        const size_t o = ((size_t)(qt * QT + qi) * nchunks + ch) * k + j;
        part_s[o] = ls[qi][j];
        part_i[o] = li[qi][j];
    }
}

int merge(void* part_s, void* part_i, int b_pad, int nchunks, int k, void* out_s,
          void* out_i, cudaStream_t st) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    topk::topk_merge_pass2<<<b_pad, 256, 0, st>>>((const float*)part_s, (const int*)part_i,
                                                  nchunks, k, (float*)out_s, (int*)out_i);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flat_topk(const void* q, const void* c, int b_pad, int D, int n_pad,
                         int n_valid, int chunk, int k, void* part_s, void* part_i,
                         void* out_s, void* out_i, void* stream) {
    const int nchunks = (n_pad + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    flat_topk_pass1<<<dim3(b_pad / QT, nchunks), WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)c, D, n_pad, n_valid, chunk, k,
        nchunks, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b_pad, nchunks, k, out_s, out_i, st);
}

// q [b_pad, D] f32, c [n_pad, D] f32 -> [b_pad, k]
extern "C" int flat_topk_f32(const void* q, const void* c, int b_pad, int D, int n_pad,
                             int n_valid, int chunk, int k, void* part_s, void* part_i,
                             void* out_s, void* out_i, void* stream) {
    const int nchunks = (n_pad + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    flat_topk_f32_pass1<<<dim3(b_pad / QT, nchunks), SUB_F32, 0, st>>>(
        (const float*)q, (const float*)c, D, n_pad, n_valid, chunk, k, nchunks,
        (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b_pad, nchunks, k, out_s, out_i, st);
}
