// Exact top-k over an int8 or a row-pair-packed int4 corpus, in two passes.
//
// Replaces the Pallas kernels of mediquery_rag_tpu/ops/quant.py:
//   int8_topk: _int8_topk_kernel (:43, launched by int8_flat_search :368):
//              score = float(q8 . c8[row]) * cscale[row];
//   int4_topk: _int4_topk_kernel (:220, launched by int4_flat_search :311):
//              byte-row r holds logical row 2r in its low nibble, biased +8,
//              and row 2r+1 signed in its high nibble. With ulo = p & 15,
//              dotU = q8 . ulo and dotP = q8 . p (p as signed bytes),
//                even = (dotU - corr) * s0[r],   corr = 8 * sum(q8),
//                odd  = (dotP - dotU) * (s1[r] * 0.0625)
//              in the f32 operation order of quant.py:250-252.
// The per-query scale is applied by the wrapper to the k returned scores.
//
// Pass 1: one block per (16-query tile, corpus chunk); four warps score 64
// byte-rows per sub-tile with the s8 x s8 -> s32 tensor-core product
// (mma.sync.m16n8k32, fragments loaded as 4-byte words straight from device
// memory, the int4 nibble mask applied to those words in registers); the f32
// scores go to shared memory and each warp folds them, in logical-row order,
// into the sorted per-query top-k of the chunk. Rows at or past n_valid never
// enter. Pass 2 merges the chunks' lists under (score desc, row asc). Both
// pieces are in topk_merge.cuh, shared with flat_topk.cu.
//
// The integer sums are exact and each f32 operation is the one the plain
// version does (__fmul_rn/__fsub_rn: no contraction), so scores equal the
// plain version's bit for bit.
//
// What bounds it on an H100: at B = 64 each corpus byte feeds 64 int8
// multiply-adds (int4: 128), far below the card's int8 compute/bandwidth
// balance, so the scan is bound by reading the codes and scales once
// (int8: N*D + 4N bytes; int4: N*D/2 + 4N). Query tiles of one chunk are
// adjacent in the grid (blockIdx.x), so the chunk is re-read from L2.
// Requires D % 32 == 0, byte-rows % 64 == 0, chunk % 64 == 0, 1 <= k <= 128,
// queries padded to a multiple of 16 rows, 4-byte aligned pointers (the
// wrapper checks).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

constexpr int QT = 16;            // queries per block (mma M)
constexpr int WARPS = 4;
constexpr int SUB = WARPS * 16;   // byte-rows scored per sub-tile (two n8 tiles a warp)
constexpr int KMAX = topk::KMAX;

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16-query tile at depth kb: lane (g, t) holds rows g and
// g + 8, bytes kb + 4t .. +3 and kb + 16 + 4t .. +3.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const int8_t* qbase, int D,
                                       int kb, int g, int t) {
    a[0] = ld32(qbase + (size_t)g * D + kb + 4 * t);
    a[1] = ld32(qbase + (size_t)(g + 8) * D + kb + 4 * t);
    a[2] = ld32(qbase + (size_t)g * D + kb + 16 + 4 * t);
    a[3] = ld32(qbase + (size_t)(g + 8) * D + kb + 16 + 4 * t);
}

template <bool INT4>
__global__ void __launch_bounds__(WARPS * 32)
quant_topk_pass1(const int8_t* __restrict__ q, const float* __restrict__ corr,
                 const int8_t* __restrict__ c, const float* __restrict__ s0,
                 const float* __restrict__ s1, int D, int rows, int n_valid, int chunk,
                 int k, int nchunks, float* __restrict__ part_s, int* __restrict__ part_i) {
    constexpr int PER = INT4 ? 2 : 1;          // logical rows per byte-row
    constexpr int W = SUB * PER;               // logical columns per sub-tile
    __shared__ float sc[QT][W];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qt = blockIdx.x;
    const int ch = blockIdx.y;
    const int row_begin = ch * chunk;
    const int row_end = min(rows, row_begin + chunk);

    for (int i = threadIdx.x; i < QT * KMAX; i += blockDim.x) {
        ls[i / KMAX][i % KMAX] = -CUDART_INF_F;
        li[i / KMAX][i % KMAX] = 0;
    }
    float cr0 = 0.f, cr1 = 0.f;
    if constexpr (INT4) {
        cr0 = corr[qt * QT + g];
        cr1 = corr[qt * QT + g + 8];
    }
    __syncthreads();

    const int8_t* qbase = q + (size_t)qt * QT * D;
    for (int r0 = row_begin; r0 < row_end; r0 += SUB) {
        int dp[2][4] = {};                     // q8 . p   (int8: the score's integer)
        int du[2][4] = {};                     // q8 . (p & 15), int4 only
        const int8_t* cb = c + (size_t)(r0 + warp * 16 + g) * D;
        for (int kb = 0; kb < D; kb += 32) {
            unsigned a[4];
            load_a(a, qbase, D, kb, g, t);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int8_t* rowp = cb + (size_t)j * 8 * D + kb + 4 * t;
                const unsigned b0 = ld32(rowp), b1 = ld32(rowp + 16);
                mma_s8(dp[j], a, b0, b1);
                if constexpr (INT4) mma_s8(du[j], a, b0 & 0x0f0f0f0fu, b1 & 0x0f0f0f0fu);
            }
        }
        // accumulator (j, e): query g (e < 2) or g + 8, byte-row
        // r0 + warp*16 + 8j + 2t + (e & 1)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = g + (e >> 1) * 8;
                const int col = warp * 16 + j * 8 + 2 * t + (e & 1);
                const int r = r0 + col;
                if constexpr (INT4) {
                    const float fu = __int2float_rn(du[j][e]);
                    const float fp = __int2float_rn(dp[j][e]);
                    sc[qi][2 * col] = __fmul_rn(__fsub_rn(fu, e < 2 ? cr0 : cr1), s0[r]);
                    sc[qi][2 * col + 1] = __fmul_rn(__fsub_rn(fp, fu), __fmul_rn(s1[r], 0.0625f));
                } else {
                    sc[qi][col] = __fmul_rn(__int2float_rn(dp[j][e]), s0[r]);
                }
            }
        }
        __syncthreads();

        const int base = r0 * PER;             // logical row of sc[.][0]
        for (int qi = warp; qi < QT; qi += WARPS) {
            for (int part = 0; part < W / 32; ++part) {
                const int col = part * 32 + lane;
                const float sv = (base + col < n_valid) ? sc[qi][col] : -CUDART_INF_F;
                topk::fold32(ls[qi], li[qi], k, sv, base + part * 32);
            }
        }
        __syncthreads();
    }

    for (int i = threadIdx.x; i < QT * k; i += blockDim.x) {
        const int qi = i / k, j = i % k;
        const size_t o = ((size_t)(qt * QT + qi) * nchunks + ch) * k + j;
        part_s[o] = ls[qi][j];
        part_i[o] = li[qi][j];
    }
}

template <bool INT4>
int launch(const void* q8, const void* corr, const void* c, const void* s0,
           const void* s1, int b_pad, int D, int rows, int n_valid, int chunk, int k,
           void* part_s, void* part_i, void* out_s, void* out_i, void* stream) {
    const int nchunks = (rows + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 g1(b_pad / QT, nchunks);
    quant_topk_pass1<INT4><<<g1, WARPS * 32, 0, st>>>(
        (const int8_t*)q8, (const float*)corr, (const int8_t*)c, (const float*)s0,
        (const float*)s1, D, rows, n_valid, chunk, k, nchunks, (float*)part_s,
        (int*)part_i);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    topk::topk_merge_pass2<<<b_pad, 256, 0, st>>>((const float*)part_s,
                                                  (const int*)part_i, nchunks, k,
                                                  (float*)out_s, (int*)out_i);
    return (int)cudaGetLastError();
}

}  // namespace

// q8 [b_pad, D] i8, c8 [n_pad, D] i8, cscale [n_pad] f32 -> [b_pad, k]
extern "C" int int8_topk(const void* q8, const void* c8, const void* cscale, int b_pad,
                         int D, int n_pad, int n_valid, int chunk, int k, void* part_s,
                         void* part_i, void* out_s, void* out_i, void* stream) {
    return launch<false>(q8, nullptr, c8, cscale, nullptr, b_pad, D, n_pad, n_valid,
                         chunk, k, part_s, part_i, out_s, out_i, stream);
}

// q8 [b_pad, D] i8, corr [b_pad] f32, c4 [P, D] i8 packed, planes [2, P] f32
// -> [b_pad, k] over the 2P logical rows
extern "C" int int4_topk(const void* q8, const void* corr, const void* c4,
                         const void* planes, int b_pad, int D, int p_rows, int n_valid,
                         int chunk, int k, void* part_s, void* part_i, void* out_s,
                         void* out_i, void* stream) {
    const float* s = (const float*)planes;
    return launch<true>(q8, corr, c4, s, s + p_rows, b_pad, D, p_rows, n_valid, chunk,
                        k, part_s, part_i, out_s, out_i, stream);
}
