// IVF probe scans with a fused top-k, in two passes.
//
// Replaces the Pallas kernels of mediquery_rag_tpu/ops/ivf_kernel.py:
//   ivf_probe_topk       (B8a) _ivf_kernel (:30): query-major, bf16 buckets;
//   ivf_probe_topk_f32   (B8a) the same over f32 buckets, f32 sums;
//   ivf_probe_topk_int8  (B8b) _ivf_int8_kernel (:127): query-major, int8
//                        buckets, score = float(q8 . row) * scale[slot];
//   ivf_probe_topk_int4  (B8c) _ivf_int4_kernel (:218): query-major, split-half
//                        int4 buckets (below);
//   ivf_batch_topk       (B9a) _ivf_batch_kernel (:341): bucket-major, bf16;
//   ivf_batch_topk_f32   (B9a) the same over f32 buckets, f32 sums;
//   ivf_batch_topk_int8  (B9b) _ivf_batch_int8_kernel (:369): bucket-major, int8;
//   ivf_batch_topk_int4  (B9c) _ivf_batch_int4_kernel (:401): bucket-major, int4.
// Buckets are [nlist * cap, D] rows; bucket_ids [nlist, cap] hold the doc id
// of each slot, -1 for an empty or deleted slot (scored -inf). Ids are read
// from the slot, never derived from the row. The per-query int8 scale is
// applied by the wrapper to the k returned scores.
//
// int4 buckets are [nlist * cap/2, D] bytes, packed bucket by bucket: packed
// row j holds slot j in its low nibble, biased +8, and slot j + cap/2 signed
// in its high nibble (ops/quant.py:ivf_pack_slots_int4). With the packed word
// p, dotU = q8 . (p & 15) and dotP = q8 . p (__dp4a or the s8 tensor-core
// product on the word and on the word masked with 0x0F0F0F0F):
//   slot j:          (f32(dotU) - corr) * s[j],           corr = 8 * sum(q8);
//   slot j + cap/2: ((f32(dotP) - f32(dotU)) * s[j + cap/2]) * 0.0625
// in the f32 order of ivf_kernel.py:248-249, with __fsub_rn/__fmul_rn so
// nothing is contracted: int4 scores equal the plain version's bit for bit in
// both layouts. A piece of packed rows [r0, r1) folds slots [r0, r1) and
// [r0 + cap/2, r1 + cap/2), each with its own id; the scales [nlist, cap] are
// the [nlist, 2, cap/2] planes of JAX read in slot order.
//
// The TPU kernels carry one running top-k per query across a sequential grid;
// blocks on Hopper run in no order, so:
//   pass 1 scores a piece (a multiple of 64 slots) of one probed bucket and
//          folds it into a sorted list in shared memory under (score desc,
//          doc id asc) (topk::fold32_id); the list of (query b, probe slot j,
//          piece p) goes to part[b][j * npieces + p];
//   pass 2 (topk::topk_merge_heads) merges each query's nprobe * npieces lists
//          k-way, reading about nprobe * npieces / 256 entries per result: at
//          B = 1 a bucket is cut into up to 32 pieces to fill the card, and
//          topk_merge_pass2's k passes over all nprobe * npieces * k entries
//          took 1.3 ms on an H100 at k = 40, nprobe 32 (PERF.md).
// Query-major pass 1: one warp per (query, probe, piece). The query sits in
// shared memory; the warp reads each bucket row with 16-byte loads (8 bf16, 4
// f32 or 16 int8 per lane), multiplies with fmaf in f32 (bf16, f32) or with
// __dp4a (int8) and reduces across lanes. Bucket-major pass 1: one block of four warps per
// (probed bucket, 16-query tile, piece); a block whose 16 queries do not
// probe the bucket exits at once. The tile's products are tensor-core
// products straight from device memory (bf16 WMMA 16x16x16 with f32 sums, as
// flat_topk.cu; s8 mma.sync.m16n8k32, as quant_topk.cu), and only the
// queries that probe the bucket fold its scores, into the list at their own
// probe slot j. The int8 sums are exact and the one f32 product is
// __fmul_rn, so int8 scores equal the plain version's bit for bit in both
// layouts. f32 buckets take no tensor core (TF32 would keep 10 mantissa
// bits of the stored f32): a block of 128 threads scores 64 slots x 16
// queries on the CUDA cores, each thread one slot's row (float4 loads) against
// 8 queries staged 256 columns at a time in shared memory, with fmaf in f32,
// as flat_topk.cu's f32 scan.
//
// What bounds it on an H100: reading the probed rows. Query-major reads
// B * nprobe * cap * D storage bytes, bucket-major each probed bucket once;
// at B = 64 a bucket-major row feeds at most 64 multiply-adds (int4: 128 per
// packed byte, two products), below the card's compute/bandwidth balance, so
// all are bound by bytes; int4 halves int8's.
// Requires cap % 32 == 0, piece % 64 == 0 (int4: pieces of packed rows),
// 1 <= k <= 128, distinct probe ids per query, 16-byte aligned pointers;
// query-major D % 8 (bf16), D % 4 (f32) or D % 16 (int8, int4); bucket-major
// D % 16 (bf16, 32-byte aligned buckets), D % 4 (f32) or D % 32 (int8, int4),
// queries padded to a multiple of 16 rows with probe ids -1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "topk_merge.cuh"

using namespace nvcuda;

namespace {

constexpr int KMAX = topk::KMAX;
constexpr unsigned FULL = topk::FULL;
constexpr int QT = 16;            // queries per bucket-major block (mma M)
constexpr int WARPS = 4;
constexpr int SUB = WARPS * 16;   // slots scored per bucket-major sub-tile
constexpr int QG = QT * SUB / (WARPS * 32);   // f32 bucket-major: queries per thread
constexpr int DCH = 256;          // f32 bucket-major: query columns staged at a time

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// One lane's share of q . row for a bf16 row (qs: the query in f32).
__device__ __forceinline__ float dot_part(const float* qs, const __nv_bfloat16* row, int D,
                                          int lane) {
    float acc = 0.f;
    for (int c = lane * 8; c < D; c += 256) {
        const uint4 w = *reinterpret_cast<const uint4*>(row + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            acc = fmaf(qs[c + 2 * e], f.x, acc);
            acc = fmaf(qs[c + 2 * e + 1], f.y, acc);
        }
    }
    return acc;
}

// One lane's share of q . row for an f32 row (qs: the query).
__device__ __forceinline__ float dot_part(const float* qs, const float* row, int D, int lane) {
    float acc = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
        const float4 w = *reinterpret_cast<const float4*>(row + c);
        const float4 q = *reinterpret_cast<const float4*>(qs + c);
        acc = fmaf(q.x, w.x, acc);
        acc = fmaf(q.y, w.y, acc);
        acc = fmaf(q.z, w.z, acc);
        acc = fmaf(q.w, w.w, acc);
    }
    return acc;
}

// One lane's share of q8 . row for an int8 row (qs: the query bytes).
__device__ __forceinline__ int dot_part(const int8_t* qs, const int8_t* row, int D, int lane) {
    int acc = 0;
    for (int c = lane * 16; c < D; c += 512) {
        const int4 w = *reinterpret_cast<const int4*>(row + c);
        const int4 q = *reinterpret_cast<const int4*>(qs + c);
        acc = __dp4a(w.x, q.x, acc);
        acc = __dp4a(w.y, q.y, acc);
        acc = __dp4a(w.z, q.z, acc);
        acc = __dp4a(w.w, q.w, acc);
    }
    return acc;
}

// Query-major pass 1: one warp per (piece p, probe slot j, query b); T is
// the bucket element: __nv_bfloat16, float or int8_t (with scales).
template <typename T>
__global__ void __launch_bounds__(32)
ivf_probe_pass1(const void* __restrict__ q, const void* __restrict__ buckets,
                const float* __restrict__ scales, const int* __restrict__ bucket_ids,
                const int* __restrict__ probe_ids, int D, int cap, int nprobe, int piece,
                int k, int npieces, float* __restrict__ part_s, int* __restrict__ part_i) {
    constexpr bool INT8 = std::is_same<T, int8_t>::value;
    extern __shared__ __align__(16) unsigned char qsm[];   // the query: D f32 or D bytes
    __shared__ float ls[KMAX];
    __shared__ int li[KMAX];
    const int lane = threadIdx.x;
    const int p = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
    const int bucket = probe_ids[b * nprobe + j];
    const int r_begin = p * piece;
    const int r_end = min(cap, r_begin + piece);

    for (int t = lane; t < KMAX; t += 32) { ls[t] = -CUDART_INF_F; li[t] = INT_MAX; }
    if constexpr (INT8) {
        const int8_t* qb = static_cast<const int8_t*>(q) + (size_t)b * D;
        for (int t = lane * 16; t < D; t += 512)
            *reinterpret_cast<int4*>(qsm + t) = *reinterpret_cast<const int4*>(qb + t);
    } else if constexpr (std::is_same<T, float>::value) {
        const float* qb = static_cast<const float*>(q) + (size_t)b * D;
        for (int t = lane * 4; t < D; t += 128)
            *reinterpret_cast<float4*>(qsm + 4 * t) = *reinterpret_cast<const float4*>(qb + t);
    } else {
        const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q) + (size_t)b * D;
        float* qf = reinterpret_cast<float*>(qsm);
        for (int t = lane; t < D; t += 32) qf[t] = __bfloat162float(qb[t]);
    }
    __syncwarp();

    const size_t slot0 = (size_t)bucket * cap;
    const T* base = static_cast<const T*>(buckets) + slot0 * D;
    for (int r0 = r_begin; r0 < r_end; r0 += 32) {     // r_end - r_begin % 32 == 0
        using Acc = typename std::conditional<INT8, int, float>::type;
        Acc mine = 0;                                     // lane i: the sum of row r0 + i
        for (int i = 0; i < 32; i += 4) {
            Acc a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                a[u] = dot_part(reinterpret_cast<const typename std::conditional<
                                    INT8, int8_t, float>::type*>(qsm),
                                base + (size_t)(r0 + i + u) * D, D, lane);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const Acc s = warp_sum(a[u]);
                if (lane == i + u) mine = s;
            }
        }
        const size_t slot = slot0 + r0 + lane;
        const int sid = bucket_ids[slot];
        float sv = -CUDART_INF_F;
        if (sid >= 0) {
            if constexpr (INT8) sv = __fmul_rn(__int2float_rn(mine), scales[slot]);
            else sv = mine;
        }
        topk::fold32_id(ls, li, k, sv, sid);
    }

    const size_t o = (((size_t)b * nprobe + j) * npieces + p) * k;
    for (int t = lane; t < k; t += 32) { part_s[o + t] = ls[t]; part_i[o + t] = li[t]; }
}

// One lane's share of dotU = q8 . (p & 15) and dotP = q8 . p for a packed
// int4 row p (qs: the query bytes).
__device__ __forceinline__ void dot_part_int4(const int8_t* qs, const int8_t* row, int D,
                                              int lane, int& du, int& dp) {
    int u = 0, s = 0;
    for (int c = lane * 16; c < D; c += 512) {
        const int4 w = *reinterpret_cast<const int4*>(row + c);
        const int4 q = *reinterpret_cast<const int4*>(qs + c);
        s = __dp4a(w.x, q.x, s);
        s = __dp4a(w.y, q.y, s);
        s = __dp4a(w.z, q.z, s);
        s = __dp4a(w.w, q.w, s);
        u = __dp4a(w.x & 0x0F0F0F0F, q.x, u);
        u = __dp4a(w.y & 0x0F0F0F0F, q.y, u);
        u = __dp4a(w.z & 0x0F0F0F0F, q.z, u);
        u = __dp4a(w.w & 0x0F0F0F0F, q.w, u);
    }
    du = u;
    dp = s;
}

// The two int4 scores of packed row r (slots r and r + caph) from its integer
// dots, in the f32 order of the Pallas kernel.
__device__ __forceinline__ float int4_even(int du, float corr, float s) {
    return __fmul_rn(__fsub_rn(__int2float_rn(du), corr), s);
}

__device__ __forceinline__ float int4_odd(int du, int dp, float s) {
    return __fmul_rn(__fmul_rn(__fsub_rn(__int2float_rn(dp), __int2float_rn(du)), s), 0.0625f);
}

// Query-major int4 pass 1 (B8c): one warp per (piece p of packed rows, probe
// slot j, query b). Rows past the piece are never read (the bucket's packed
// rows, cap/2, are a multiple of 16, not always of 32).
__global__ void __launch_bounds__(32)
ivf_probe_int4_pass1(const int8_t* __restrict__ q, const float* __restrict__ corr,
                     const int8_t* __restrict__ buckets, const float* __restrict__ scales,
                     const int* __restrict__ bucket_ids, const int* __restrict__ probe_ids,
                     int D, int cap, int nprobe, int piece, int k, int npieces,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
    extern __shared__ __align__(16) unsigned char qsm[];   // the query bytes
    __shared__ float ls[KMAX];
    __shared__ int li[KMAX];
    const int lane = threadIdx.x;
    const int p = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
    const int bucket = probe_ids[b * nprobe + j];
    const int caph = cap >> 1;
    const int r_begin = p * piece;
    const int r_end = min(caph, r_begin + piece);

    for (int t = lane; t < KMAX; t += 32) { ls[t] = -CUDART_INF_F; li[t] = INT_MAX; }
    const int8_t* qb = q + (size_t)b * D;
    for (int t = lane * 16; t < D; t += 512)
        *reinterpret_cast<int4*>(qsm + t) = *reinterpret_cast<const int4*>(qb + t);
    __syncwarp();
    const float cr = corr[b];

    const size_t slot0 = (size_t)bucket * cap;
    const int8_t* base = buckets + (size_t)bucket * caph * D;
    const int8_t* qs = reinterpret_cast<const int8_t*>(qsm);
    for (int r0 = r_begin; r0 < r_end; r0 += 32) {
        int mu = 0, mp = 0;                               // lane i: packed row r0 + i
        for (int i = 0; i < 32; i += 4) {
            int au[4], ap[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                au[u] = ap[u] = 0;
                if (r0 + i + u < r_end)                   // warp-uniform
                    dot_part_int4(qs, base + (size_t)(r0 + i + u) * D, D, lane, au[u], ap[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int su = warp_sum(au[u]), sp = warp_sum(ap[u]);
                if (lane == i + u) { mu = su; mp = sp; }
            }
        }
        const int r = r0 + lane;
        float ev = -CUDART_INF_F, od = -CUDART_INF_F;
        int eid = -1, oid = -1;
        if (r < r_end) {
            eid = bucket_ids[slot0 + r];
            oid = bucket_ids[slot0 + caph + r];
            if (eid >= 0) ev = int4_even(mu, cr, scales[slot0 + r]);
            if (oid >= 0) od = int4_odd(mu, mp, scales[slot0 + caph + r]);
        }
        topk::fold32_id(ls, li, k, ev, eid);
        topk::fold32_id(ls, li, k, od, oid);
    }

    const size_t o = (((size_t)b * nprobe + j) * npieces + p) * k;
    for (int t = lane; t < k; t += 32) { part_s[o + t] = ls[t]; part_i[o + t] = li[t]; }
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bucket-major prologue: jslot[qi] = the first probe slot of the block's
// bucket in query qi's list (-1: not probed) and the tile's lists emptied;
// returns whether any query of the tile probes the bucket (a block-wide vote,
// so every thread of the block calls it).
__device__ __forceinline__ bool tile_probes(const int* __restrict__ probe_ids, int qt,
                                            int nprobe, int bucket, int* jslot,
                                            float (*ls)[KMAX], int (*li)[KMAX]) {
    int js = -1;
    if (threadIdx.x < QT) {
        const int* pr = probe_ids + (size_t)(qt * QT + threadIdx.x) * nprobe;
        for (int j = 0; j < nprobe; ++j)
            if (pr[j] == bucket) { js = j; break; }
        jslot[threadIdx.x] = js;
    }
    for (int t = threadIdx.x; t < QT * KMAX; t += blockDim.x) {
        ls[t / KMAX][t % KMAX] = -CUDART_INF_F;
        li[t / KMAX][t % KMAX] = INT_MAX;
    }
    return __syncthreads_or(js >= 0);
}

// Bucket-major epilogue: each query's list goes to its own probe slot(s) of
// the bucket, as list (query, slot j, piece p).
__device__ __forceinline__ void write_tile_lists(const int* __restrict__ probe_ids, int qt,
                                                 int nprobe, int bucket, int p, int k,
                                                 int npieces, const int* jslot,
                                                 float (*ls)[KMAX], int (*li)[KMAX],
                                                 float* __restrict__ part_s,
                                                 int* __restrict__ part_i) {
    for (int t = threadIdx.x; t < QT * k; t += blockDim.x) {
        const int qi = t / k, e = t % k;
        if (jslot[qi] < 0) continue;
        const size_t qrow = (size_t)qt * QT + qi;
        const int* pr = probe_ids + qrow * nprobe;
        for (int j = jslot[qi]; j < nprobe; ++j) {
            if (pr[j] != bucket) continue;
            const size_t o = ((qrow * nprobe + j) * npieces + p) * k + e;
            part_s[o] = ls[qi][e];
            part_i[o] = li[qi][e];
        }
    }
}

// Bucket-major pass 1: one block per (probed bucket u, 16-query tile, piece).
template <bool INT8>
__global__ void __launch_bounds__(WARPS * 32)
ivf_batch_pass1(const void* __restrict__ q, const void* __restrict__ buckets,
                const float* __restrict__ scales, const int* __restrict__ bucket_ids,
                const int* __restrict__ probe_ids, const int* __restrict__ uniq, int D,
                int cap, int nprobe, int piece, int k, int npieces,
                float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ __align__(32) float sc[QT][SUB];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];
    __shared__ int jslot[QT];                 // first probe slot of the bucket, -1 = none

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int bucket = uniq[blockIdx.x];
    const int qt = blockIdx.y;
    const int p = blockIdx.z;
    if (bucket < 0) return;                   // the -1 padding of the unique list

    if (!tile_probes(probe_ids, qt, nprobe, bucket, jslot, ls, li)) return;

    const int r_begin = p * piece;
    const int r_end = min(cap, r_begin + piece);
    const size_t slot0 = (size_t)bucket * cap;
    for (int r0 = r_begin; r0 < r_end; r0 += SUB) {
        const int rw = r0 + warp * 16;        // 16-slot groups lie wholly in or past r_end
        if (rw < r_end) {
            if constexpr (INT8) {
                const int8_t* qbase = static_cast<const int8_t*>(q) + (size_t)qt * QT * D;
                const int8_t* cb = static_cast<const int8_t*>(buckets) + (slot0 + rw) * D;
                const int g = lane >> 2, t = lane & 3;
                int acc[2][4] = {};
                for (int kb = 0; kb < D; kb += 32) {
                    unsigned a[4];
                    a[0] = ld32(qbase + (size_t)g * D + kb + 4 * t);
                    a[1] = ld32(qbase + (size_t)(g + 8) * D + kb + 4 * t);
                    a[2] = ld32(qbase + (size_t)g * D + kb + 16 + 4 * t);
                    a[3] = ld32(qbase + (size_t)(g + 8) * D + kb + 16 + 4 * t);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int8_t* rowp = cb + (size_t)(h * 8 + g) * D + kb + 4 * t;
                        mma_s8(acc[h], a, ld32(rowp), ld32(rowp + 16));
                    }
                }
                // accumulator (h, e): query g (e < 2) or g + 8, slot rw + 8h + 2t + (e & 1)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = warp * 16 + h * 8 + 2 * t + (e & 1);
                        sc[g + (e >> 1) * 8][col] =
                            __fmul_rn(__int2float_rn(acc[h][e]), scales[slot0 + r0 + col]);
                    }
                }
            } else {
                const __nv_bfloat16* qbase =
                    static_cast<const __nv_bfloat16*>(q) + (size_t)qt * QT * D;
                const __nv_bfloat16* cb =
                    static_cast<const __nv_bfloat16*>(buckets) + (slot0 + rw) * D;
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
                wmma::fill_fragment(acc, 0.0f);
                for (int d = 0; d < D; d += 16) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
                    wmma::load_matrix_sync(a, qbase + d, D);
                    wmma::load_matrix_sync(bf, cb + d, D);
                    wmma::mma_sync(acc, a, bf, acc);
                }
                wmma::store_matrix_sync(&sc[0][warp * 16], acc, SUB, wmma::mem_row_major);
            }
        }
        __syncthreads();

        for (int qi = warp; qi < QT; qi += WARPS) {
            if (jslot[qi] < 0) continue;      // warp-uniform
            for (int half = 0; half < SUB / 32; ++half) {
                const int col = half * 32 + lane;
                const int r = r0 + col;
                float sv = -CUDART_INF_F;
                int sid = -1;
                if (r < r_end) {
                    sid = bucket_ids[slot0 + r];
                    if (sid >= 0) sv = sc[qi][col];
                }
                topk::fold32_id(ls[qi], li[qi], k, sv, sid);
            }
        }
        __syncthreads();
    }

    write_tile_lists(probe_ids, qt, nprobe, bucket, p, k, npieces, jslot, ls, li, part_s,
                     part_i);
}

// Bucket-major f32 pass 1 (B9a over f32 buckets): one block per (probed
// bucket u, 16-query tile, piece). Thread t scores slot t % 64 of each
// 64-slot sub-tile against queries (t / 64) * 8 .. + 7: it streams the slot's
// row with float4 loads while the block stages the tile's 16 queries in
// shared memory 256 columns at a time (one broadcast read per warp), fmaf in
// f32. The fold is ivf_batch_pass1's.
__global__ void __launch_bounds__(WARPS * 32)
ivf_batch_f32_pass1(const float* __restrict__ q, const float* __restrict__ buckets,
                    const int* __restrict__ bucket_ids, const int* __restrict__ probe_ids,
                    const int* __restrict__ uniq, int D, int cap, int nprobe, int piece, int k,
                    int npieces, float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ float sc[QT][SUB];
    __shared__ __align__(16) float qs[QT][DCH];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];
    __shared__ int jslot[QT];                 // first probe slot of the bucket, -1 = none

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int bucket = uniq[blockIdx.x];
    const int qt = blockIdx.y;
    const int p = blockIdx.z;
    if (bucket < 0) return;                   // the -1 padding of the unique list

    if (!tile_probes(probe_ids, qt, nprobe, bucket, jslot, ls, li)) return;

    const int r_begin = p * piece;
    const int r_end = min(cap, r_begin + piece);
    const size_t slot0 = (size_t)bucket * cap;
    const float* qbase = q + (size_t)qt * QT * D;
    const int col = threadIdx.x % SUB;        // the thread's slot in the sub-tile
    const int q0 = (threadIdx.x / SUB) * QG;  // its first query
    for (int r0 = r_begin; r0 < r_end; r0 += SUB) {
        const bool in = r0 + col < r_end;
        const float* row = buckets + (slot0 + r0 + col) * D;
        float acc[QG];
#pragma unroll
        for (int i = 0; i < QG; ++i) acc[i] = 0.f;
        for (int d0 = 0; d0 < D; d0 += DCH) {
            const int dn4 = min(DCH, D - d0) / 4;
            __syncthreads();
            for (int t = threadIdx.x; t < QT * dn4; t += blockDim.x) {
                const int qi = t / dn4, c = (t % dn4) * 4;
                *reinterpret_cast<float4*>(&qs[qi][c]) =
                    *reinterpret_cast<const float4*>(qbase + (size_t)qi * D + d0 + c);
            }
            __syncthreads();
            if (in) {
                for (int c = 0; c < 4 * dn4; c += 4) {
                    const float4 w = __ldg(reinterpret_cast<const float4*>(row + d0 + c));
#pragma unroll
                    for (int i = 0; i < QG; ++i) {
                        const float4 qv = *reinterpret_cast<const float4*>(&qs[q0 + i][c]);
                        acc[i] = fmaf(qv.x, w.x, acc[i]);
                        acc[i] = fmaf(qv.y, w.y, acc[i]);
                        acc[i] = fmaf(qv.z, w.z, acc[i]);
                        acc[i] = fmaf(qv.w, w.w, acc[i]);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < QG; ++i) sc[q0 + i][col] = acc[i];
        __syncthreads();

        for (int qi = warp; qi < QT; qi += WARPS) {
            if (jslot[qi] < 0) continue;      // warp-uniform
            for (int half = 0; half < SUB / 32; ++half) {
                const int c = half * 32 + lane;
                const int r = r0 + c;
                float sv = -CUDART_INF_F;
                int sid = -1;
                if (r < r_end) {
                    sid = bucket_ids[slot0 + r];
                    if (sid >= 0) sv = sc[qi][c];
                }
                topk::fold32_id(ls[qi], li[qi], k, sv, sid);
            }
        }
        __syncthreads();
    }

    write_tile_lists(probe_ids, qt, nprobe, bucket, p, k, npieces, jslot, ls, li, part_s,
                     part_i);
}

// Bucket-major int4 pass 1 (B9c): one block per (probed bucket u, 16-query
// tile, piece of packed rows). Each warp scores 16 packed rows (32 slots) of
// a 64-row sub-tile with two s8 products per fragment, on the packed word and
// on the word masked to its low nibbles (the row-pair identity of
// quant_topk.cu's int4_topk); the even slots' scores go to sc[.][0, SUB), the
// odd slots' to sc[.][SUB, 2 SUB).
__global__ void __launch_bounds__(WARPS * 32)
ivf_batch_int4_pass1(const int8_t* __restrict__ q, const float* __restrict__ corr,
                     const int8_t* __restrict__ buckets, const float* __restrict__ scales,
                     const int* __restrict__ bucket_ids, const int* __restrict__ probe_ids,
                     const int* __restrict__ uniq, int D, int cap, int nprobe, int piece,
                     int k, int npieces, float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ float sc[QT][2 * SUB];
    __shared__ float ls[QT][KMAX];
    __shared__ int li[QT][KMAX];
    __shared__ int jslot[QT];                 // first probe slot of the bucket, -1 = none

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bucket = uniq[blockIdx.x];
    const int qt = blockIdx.y;
    const int p = blockIdx.z;
    if (bucket < 0) return;                   // the -1 padding of the unique list

    if (!tile_probes(probe_ids, qt, nprobe, bucket, jslot, ls, li)) return;

    const int caph = cap >> 1;
    const int r_begin = p * piece;
    const int r_end = min(caph, r_begin + piece);
    const size_t slot0 = (size_t)bucket * cap;
    const int8_t* qbase = q + (size_t)qt * QT * D;
    const int8_t* bbase = buckets + (size_t)bucket * caph * D;
    const float cr0 = corr[qt * QT + g], cr1 = corr[qt * QT + g + 8];
    for (int r0 = r_begin; r0 < r_end; r0 += SUB) {
        const int rw = r0 + warp * 16;        // 16-row groups lie wholly in or past r_end
        if (rw < r_end) {
            const int8_t* cb = bbase + (size_t)rw * D;
            int dp[2][4] = {}, du[2][4] = {};
            for (int kb = 0; kb < D; kb += 32) {
                unsigned a[4];
                a[0] = ld32(qbase + (size_t)g * D + kb + 4 * t);
                a[1] = ld32(qbase + (size_t)(g + 8) * D + kb + 4 * t);
                a[2] = ld32(qbase + (size_t)g * D + kb + 16 + 4 * t);
                a[3] = ld32(qbase + (size_t)(g + 8) * D + kb + 16 + 4 * t);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int8_t* rowp = cb + (size_t)(h * 8 + g) * D + kb + 4 * t;
                    const unsigned b0 = ld32(rowp), b1 = ld32(rowp + 16);
                    mma_s8(dp[h], a, b0, b1);
                    mma_s8(du[h], a, b0 & 0x0f0f0f0fu, b1 & 0x0f0f0f0fu);
                }
            }
            // accumulator (h, e): query g (e < 2) or g + 8, packed row
            // rw + 8h + 2t + (e & 1)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = warp * 16 + h * 8 + 2 * t + (e & 1);
                    const int qi = g + (e >> 1) * 8;
                    const size_t r = (size_t)r0 + col;
                    sc[qi][col] = int4_even(du[h][e], e < 2 ? cr0 : cr1, scales[slot0 + r]);
                    sc[qi][SUB + col] = int4_odd(du[h][e], dp[h][e], scales[slot0 + caph + r]);
                }
            }
        }
        __syncthreads();

        for (int qi = warp; qi < QT; qi += WARPS) {
            if (jslot[qi] < 0) continue;      // warp-uniform
            for (int half = 0; half < SUB / 32; ++half) {
                const int col = half * 32 + lane;
                const int r = r0 + col;
                float ev = -CUDART_INF_F, od = -CUDART_INF_F;
                int eid = -1, oid = -1;
                if (r < r_end) {
                    eid = bucket_ids[slot0 + r];
                    oid = bucket_ids[slot0 + caph + r];
                    if (eid >= 0) ev = sc[qi][col];
                    if (oid >= 0) od = sc[qi][SUB + col];
                }
                topk::fold32_id(ls[qi], li[qi], k, ev, eid);
                topk::fold32_id(ls[qi], li[qi], k, od, oid);
            }
        }
        __syncthreads();
    }

    write_tile_lists(probe_ids, qt, nprobe, bucket, p, k, npieces, jslot, ls, li, part_s,
                     part_i);
}

int merge(void* part_s, void* part_i, int b, int nchunks, int k, void* out_s, void* out_i,
          cudaStream_t st) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)nchunks * sizeof(int);   // one read position per list
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(topk::topk_merge_heads,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    topk::topk_merge_heads<<<b, 256, smem, st>>>((const float*)part_s, (const int*)part_i,
                                                 nchunks, k, (float*)out_s, (int*)out_i);
    return (int)cudaGetLastError();
}

template <typename T>
int probe(const void* q, const void* buckets, const void* scales, const void* bucket_ids,
          const void* probe_ids, int b, int D, int cap, int nprobe, int piece, int k,
          void* part_s, void* part_i, void* out_s, void* out_i, void* stream) {
    const int npieces = (cap + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = std::is_same<T, int8_t>::value ? (size_t)D : (size_t)D * sizeof(float);
    ivf_probe_pass1<T><<<dim3(npieces, nprobe, b), 32, smem, st>>>(
        q, buckets, (const float*)scales, (const int*)bucket_ids, (const int*)probe_ids, D,
        cap, nprobe, piece, k, npieces, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}

template <bool INT8>
int batch(const void* q, const void* buckets, const void* scales, const void* bucket_ids,
          const void* probe_ids, const void* uniq, int n_uniq, int b_pad, int b, int D,
          int cap, int nprobe, int piece, int k, void* part_s, void* part_i, void* out_s,
          void* out_i, void* stream) {
    const int npieces = (cap + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    ivf_batch_pass1<INT8><<<dim3(n_uniq, b_pad / QT, npieces), WARPS * 32, 0, st>>>(
        q, buckets, (const float*)scales, (const int*)bucket_ids, (const int*)probe_ids,
        (const int*)uniq, D, cap, nprobe, piece, k, npieces, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}

}  // namespace

// q8 [b, D] i8, corr [b] f32, buckets [nlist*cap/2, D] i8 split-half packed,
// scales [nlist, cap] f32; piece counts packed rows -> [b, k]
extern "C" int ivf_probe_topk_int4(const void* q8, const void* corr, const void* buckets,
                                   const void* scales, const void* bucket_ids,
                                   const void* probe_ids, int b, int D, int cap, int nprobe,
                                   int piece, int k, void* part_s, void* part_i, void* out_s,
                                   void* out_i, void* stream) {
    const int npieces = (cap / 2 + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    ivf_probe_int4_pass1<<<dim3(npieces, nprobe, b), 32, (size_t)D, st>>>(
        (const int8_t*)q8, (const float*)corr, (const int8_t*)buckets, (const float*)scales,
        (const int*)bucket_ids, (const int*)probe_ids, D, cap, nprobe, piece, k, npieces,
        (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}

// q8 [b_pad, D] i8, corr [b_pad] f32 (0 on pad rows), probe_ids [b_pad, nprobe]
// (-1 on pad rows), uniq [n_uniq] (-1 padded); int4 buckets as above -> [b, k]
extern "C" int ivf_batch_topk_int4(const void* q8, const void* corr, const void* buckets,
                                   const void* scales, const void* bucket_ids,
                                   const void* probe_ids, const void* uniq, int n_uniq,
                                   int b_pad, int b, int D, int cap, int nprobe, int piece,
                                   int k, void* part_s, void* part_i, void* out_s,
                                   void* out_i, void* stream) {
    const int npieces = (cap / 2 + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    ivf_batch_int4_pass1<<<dim3(n_uniq, b_pad / QT, npieces), WARPS * 32, 0, st>>>(
        (const int8_t*)q8, (const float*)corr, (const int8_t*)buckets, (const float*)scales,
        (const int*)bucket_ids, (const int*)probe_ids, (const int*)uniq, D, cap, nprobe,
        piece, k, npieces, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}

// q [b, D] bf16, buckets [nlist*cap, D] bf16, probe_ids [b, nprobe] -> [b, k]
extern "C" int ivf_probe_topk(const void* q, const void* buckets, const void* bucket_ids,
                              const void* probe_ids, int b, int D, int cap, int nprobe,
                              int piece, int k, void* part_s, void* part_i, void* out_s,
                              void* out_i, void* stream) {
    return probe<__nv_bfloat16>(q, buckets, nullptr, bucket_ids, probe_ids, b, D, cap,
                                nprobe, piece, k, part_s, part_i, out_s, out_i, stream);
}

// q [b, D] f32, buckets [nlist*cap, D] f32, probe_ids [b, nprobe] -> [b, k]
extern "C" int ivf_probe_topk_f32(const void* q, const void* buckets, const void* bucket_ids,
                                  const void* probe_ids, int b, int D, int cap, int nprobe,
                                  int piece, int k, void* part_s, void* part_i, void* out_s,
                                  void* out_i, void* stream) {
    return probe<float>(q, buckets, nullptr, bucket_ids, probe_ids, b, D, cap, nprobe,
                        piece, k, part_s, part_i, out_s, out_i, stream);
}

// q8 [b, D] i8, buckets i8, scales [nlist, cap] f32 -> [b, k]
extern "C" int ivf_probe_topk_int8(const void* q8, const void* buckets, const void* scales,
                                   const void* bucket_ids, const void* probe_ids, int b,
                                   int D, int cap, int nprobe, int piece, int k,
                                   void* part_s, void* part_i, void* out_s, void* out_i,
                                   void* stream) {
    return probe<int8_t>(q8, buckets, scales, bucket_ids, probe_ids, b, D, cap, nprobe,
                         piece, k, part_s, part_i, out_s, out_i, stream);
}

// q [b_pad, D] bf16, probe_ids [b_pad, nprobe] (-1 on pad rows), uniq [n_uniq]
// (-1 padded) -> [b, k]
extern "C" int ivf_batch_topk(const void* q, const void* buckets, const void* bucket_ids,
                              const void* probe_ids, const void* uniq, int n_uniq, int b_pad,
                              int b, int D, int cap, int nprobe, int piece, int k,
                              void* part_s, void* part_i, void* out_s, void* out_i,
                              void* stream) {
    return batch<false>(q, buckets, nullptr, bucket_ids, probe_ids, uniq, n_uniq, b_pad, b,
                        D, cap, nprobe, piece, k, part_s, part_i, out_s, out_i, stream);
}

// q [b_pad, D] f32, buckets [nlist*cap, D] f32; as ivf_batch_topk -> [b, k]
extern "C" int ivf_batch_topk_f32(const void* q, const void* buckets, const void* bucket_ids,
                                  const void* probe_ids, const void* uniq, int n_uniq,
                                  int b_pad, int b, int D, int cap, int nprobe, int piece,
                                  int k, void* part_s, void* part_i, void* out_s, void* out_i,
                                  void* stream) {
    const int npieces = (cap + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    ivf_batch_f32_pass1<<<dim3(n_uniq, b_pad / QT, npieces), WARPS * 32, 0, st>>>(
        (const float*)q, (const float*)buckets, (const int*)bucket_ids, (const int*)probe_ids,
        (const int*)uniq, D, cap, nprobe, piece, k, npieces, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}

extern "C" int ivf_batch_topk_int8(const void* q8, const void* buckets, const void* scales,
                                   const void* bucket_ids, const void* probe_ids,
                                   const void* uniq, int n_uniq, int b_pad, int b, int D,
                                   int cap, int nprobe, int piece, int k, void* part_s,
                                   void* part_i, void* out_s, void* out_i, void* stream) {
    return batch<true>(q8, buckets, scales, bucket_ids, probe_ids, uniq, n_uniq, b_pad, b, D,
                       cap, nprobe, piece, k, part_s, part_i, out_s, out_i, stream);
}
