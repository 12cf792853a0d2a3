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
// What bounds them on an H100: reading the probed rows. A row feeds one
// multiply-add per query that probes its bucket (1 to B; int4: two products
// per packed row), below the card's compute/bandwidth balance for every
// type, so all are bound by bytes; int4 halves int8's.
//
// The TPU kernels carry one running top-k per query across a sequential grid;
// blocks on Hopper run in no order, so every scan is two passes: pass 1
// writes per-block lists, one per (query, probe slot, piece of the bucket),
// and pass 2 (topk::topk_merge_heads) merges each query's lists k-way,
// reading about (lists / 256) entries per result (topk_merge_pass2's k
// passes over every entry took 1.3 ms on an H100 at k = 40, nprobe 32 with
// a thousand lists a query).
//
// B8a and B9a (bf16 and f32 buckets), B8b and B8c (int8 and int4 buckets,
// query-major): the Hopper IVF scan of ivf_scan.cuh, the flat scan's
// skeleton walking work items (a chunk of probers of one bucket x a piece of
// its live extent): a TMA ring of 128-byte K panels, the stages of
// float_stages.cuh (wgmma bf16; f32 fmaf on the CUDA cores, no TF32: TF32
// would keep 10 mantissa bits of the stored f32) and of int_stages.cuh (wgmma
// s8; int4: two products per panel, on the packed bytes and on their low
// nibbles), the filter in registers on (score, doc id), survivors merged by
// rank. Only each bucket's live extent is read (a bucket's live rows are
// packed at the front after a build or an add; deletes leave holes inside
// it; int4: min(extent, cap/2) packed rows), and the bucket-major layout
// reads each probed bucket once for up to QB probers. The two layouts differ
// only in their chunks: one prober each (query-major), or a bucket's probers
// QB at a time (bucket-major).
//
// B9b and B9c (int8 and int4, bucket-major): one block per (probed bucket,
// 16-query tile, piece), pieces a multiple of 64 slots of the whole cap; a
// block of four warps whose 16 queries do not probe the bucket exits at
// once; the tile's products are s8 mma.sync.m16n8k32 straight from device
// memory, and only the queries that probe the bucket fold its scores into a
// sorted list in shared memory (topk::fold32_id), at their own probe slot j.
//
// The int8 sums are exact and the one f32 product is __fmul_rn, so int8
// scores equal the plain version's bit for bit in both layouts.
//
// int4 buckets are [nlist * cap/2, D] bytes, packed bucket by bucket: packed
// row j holds slot j in its low nibble, biased +8, and slot j + cap/2 signed
// in its high nibble (ops/quant.py:ivf_pack_slots_int4). With the packed word
// p, dotU = q8 . (p & 15) and dotP = q8 . p (s8 tensor-core products on the
// word and on the word masked with 0x0F0F0F0F):
//   slot j:          (f32(dotU) - corr) * s[j],           corr = 8 * sum(q8);
//   slot j + cap/2: ((f32(dotP) - f32(dotU)) * s[j + cap/2]) * 0.0625
// in the f32 order of ivf_kernel.py:248-249 (int_stages.cuh's Int4Ivf; the
// flat B3 multiplies the scale by 0.0625 first, a last-bit difference), with
// __fsub_rn/__fmul_rn so nothing is contracted: int4 scores equal the plain
// version's bit for bit in both layouts. A piece of packed rows [r0, r1)
// scores slots [r0, r1) and [r0 + cap/2, r1 + cap/2), each with its own id;
// the scales [nlist, cap] are the [nlist, 2, cap/2] planes of JAX read in
// slot order.
//
// Requires cap % 32 == 0, 1 <= k <= 128, distinct probe ids per query,
// 16-byte aligned pointers; rows of a multiple of 16 bytes (TMA: bf16 D % 8,
// f32 D % 4, int8/int4 D % 16; the bytes of the last 128-byte panel past D
// read as 0 and add nothing); B9b/B9c: piece % 64 == 0 (int4: pieces of
// packed rows), D % 32, queries padded to a multiple of 16 rows with probe
// ids -1.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>


#include "float_stages.cuh"
#include "int_stages.cuh"
#include "ivf_scan.cuh"
#include "topk_merge.cuh"

namespace {

constexpr int KMAX = topk::KMAX;
constexpr int QT = 16;            // queries per bucket-major block (mma M)
constexpr int WARPS = 4;
constexpr int SUB = WARPS * 16;   // slots scored per bucket-major sub-tile

// The two int4 scores of packed row r (slots r and r + caph) from its integer
// dots, in the f32 order of the Pallas kernel.
__device__ __forceinline__ float int4_even(int du, float corr, float s) {
    return __fmul_rn(__fsub_rn(__int2float_rn(du), corr), s);
}

__device__ __forceinline__ float int4_odd(int du, int dp, float s) {
    return __fmul_rn(__fmul_rn(__fsub_rn(__int2float_rn(dp), __int2float_rn(du)), s), 0.0625f);
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

// Bucket-major int8 pass 1 (B9b): one block per (probed bucket u, 16-query
// tile, piece).
__global__ void __launch_bounds__(WARPS * 32)
ivf_batch_int8_pass1(const int8_t* __restrict__ q, const int8_t* __restrict__ buckets,
                     const float* __restrict__ scales, const int* __restrict__ bucket_ids,
                     const int* __restrict__ probe_ids, const int* __restrict__ uniq, int D,
                     int cap, int nprobe, int piece, int k, int npieces,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
    __shared__ float sc[QT][SUB];
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
            const int8_t* qbase = q + (size_t)qt * QT * D;
            const int8_t* cb = buckets + (slot0 + rw) * D;
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

// The IVF scans of ivf_scan.cuh (B8a and B9a over bf16 or f32 buckets, B8b
// and B8c over int8 and int4): the chunk plan (bucket-major), pass 1, pass 2.
// scales: the int8/int4 slot scales, or null; corr: int4's, or null; caph:
// cap / 2 for int4, else 0.
template <template <int> class S, int QBMAX = 128>
int ivf_scan(int esz, const void* q, int q_rows, const void* buckets, int rows,
             const void* bucket_ids, const void* extent, const void* pos_bucket,
             const void* pos_prober, void* chunk_e0, void* n_chunks, void* sched,
             const void* scales, const void* corr, int caph, int b, int D, int cap, int nprobe,
             int qb, int stages, int maxp, int grid, int k, void* part_s, void* part_i,
             void* out_s, void* out_i, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int n_pos = b * nprobe;
    if (chunk_e0) {
        ivf::chunk_plan<<<1, 1024, 0, st>>>((const int*)pos_bucket, n_pos, qb, (int*)chunk_e0,
                                            (int*)n_chunks);
        const cudaError_t ce = cudaGetLastError();
        if (ce != cudaSuccess) return (int)ce;
    }
    const ivf::Args a{(const int*)bucket_ids, (const int*)extent, (const int*)pos_bucket,
                      (const long long*)pos_prober, (const int*)chunk_e0, (const int*)n_chunks,
                      (int*)sched, (float*)part_s, (int*)part_i, (const float*)scales,
                      (const float*)corr, D * esz, cap, nprobe, n_pos, k, stages, maxp, caph};
    const int e = ivf::dispatch<S, QBMAX>(qb, q, q_rows, buckets, rows, a, grid, st);
    if (e) return e;
    return merge(part_s, part_i, b, nprobe * maxp, k, out_s, out_i, st);
}

}  // namespace

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

// Query-major over bf16 buckets: q [q_rows = b, D] bf16, buckets [rows, D]
// bf16 (rows >= nlist * cap), bucket_ids [nlist, cap], extent [nlist],
// pos_bucket [b * nprobe] i32 the probed buckets in position order (the
// probe ids, or sorted by bucket), pos_prober [b * nprobe] i64 the prober
// b * nprobe + j at each position (null: the identity); qb 16 queries a
// chunk, stages, maxp pieces per bucket, grid blocks; part_s/part_i
// [b * nprobe * maxp, k] -> [b, k]
extern "C" int ivf_probe_topk(const void* q, int q_rows, const void* buckets, int rows,
                              const void* bucket_ids, const void* extent,
                              const void* pos_bucket, const void* pos_prober, void* sched,
                              int b, int D, int cap, int nprobe, int qb, int stages, int maxp,
                              int grid, int k, void* part_s, void* part_i, void* out_s,
                              void* out_i, void* stream) {
    return ivf_scan<fstage::Bf16Stage>(2, q, q_rows, buckets, rows, bucket_ids,
                                       extent, pos_bucket, pos_prober, nullptr, nullptr,
                                       sched, nullptr, nullptr, 0, b, D, cap, nprobe, qb,
                                       stages, maxp, grid, k, part_s, part_i, out_s, out_i,
                                       stream);
}

// Query-major over f32 buckets (f32 q and buckets); as ivf_probe_topk -> [b, k]
extern "C" int ivf_probe_topk_f32(const void* q, int q_rows, const void* buckets, int rows,
                                  const void* bucket_ids, const void* extent,
                                  const void* pos_bucket, const void* pos_prober, void* sched,
                                  int b, int D, int cap, int nprobe, int qb, int stages, int maxp,
                                  int grid, int k, void* part_s, void* part_i, void* out_s,
                                  void* out_i, void* stream) {
    return ivf_scan<fstage::F32Stage>(4, q, q_rows, buckets, rows, bucket_ids,
                                      extent, pos_bucket, pos_prober, nullptr, nullptr,
                                      sched, nullptr, nullptr, 0, b, D, cap, nprobe, qb,
                                      stages, maxp, grid, k, part_s, part_i, out_s, out_i,
                                      stream);
}

// Query-major over int8 buckets: q8 [q_rows = b, D] i8, buckets [rows, D]
// i8 (rows >= nlist * cap), scales [nlist, cap] f32 slot scales; the rest as
// ivf_probe_topk -> [b, k], scores without the query scale
extern "C" int ivf_probe_topk_int8(const void* q8, int q_rows, const void* buckets, int rows,
                                   const void* bucket_ids, const void* extent,
                                   const void* pos_bucket, const void* pos_prober, void* sched,
                                   const void* scales, int b, int D, int cap, int nprobe, int qb,
                                   int stages, int maxp, int grid, int k, void* part_s,
                                   void* part_i, void* out_s, void* out_i, void* stream) {
    return ivf_scan<istage::Int8Stage, 16>(1, q8, q_rows, buckets, rows, bucket_ids, extent,
                                           pos_bucket, pos_prober, nullptr, nullptr, sched,
                                           scales, nullptr, 0, b, D, cap, nprobe, qb, stages,
                                           maxp, grid, k, part_s, part_i, out_s, out_i, stream);
}

// Query-major over split-half packed int4 buckets: q8 [q_rows = b, D] i8,
// buckets [rows, D] i8 (rows >= nlist * cap / 2: packed row r of bucket u
// at u * cap / 2 + r), scales [nlist, cap] f32 in slot order, corr [b] f32
// = 8 sum(q8); the rest as ivf_probe_topk_int8 -> [b, k]
extern "C" int ivf_probe_topk_int4(const void* q8, int q_rows, const void* buckets, int rows,
                                   const void* bucket_ids, const void* extent,
                                   const void* pos_bucket, const void* pos_prober, void* sched,
                                   const void* scales, const void* corr, int b, int D, int cap,
                                   int nprobe, int qb, int stages, int maxp, int grid, int k,
                                   void* part_s, void* part_i, void* out_s, void* out_i,
                                   void* stream) {
    return ivf_scan<istage::Int4Ivf, 16>(1, q8, q_rows, buckets, rows, bucket_ids, extent,
                                         pos_bucket, pos_prober, nullptr, nullptr, sched, scales,
                                         corr, cap / 2, b, D, cap, nprobe, qb, stages, maxp,
                                         grid, k, part_s, part_i, out_s, out_i, stream);
}

// Bucket-major over bf16 buckets: q [q_rows = b * nprobe, D] bf16, the
// queries gathered in position order (row e: prober pos_prober[e]'s query),
// pos_bucket [b * nprobe] sorted by bucket, pos_prober as ivf_probe_topk's
// (not null); chunk_e0 [b * nprobe] and n_chunks [1] i32 scratch, filled by
// the chunk plan at qb (16, 32, 64 or 128) probers a chunk; the rest as
// ivf_probe_topk -> [b, k]. Null chunk_e0 and n_chunks: a chunk per
// position, as ivf_probe_topk (at B = 1 each bucket has one prober).
extern "C" int ivf_batch_topk(const void* q, int q_rows, const void* buckets, int rows,
                              const void* bucket_ids, const void* extent,
                              const void* pos_bucket, const void* pos_prober, void* chunk_e0,
                              void* n_chunks, void* sched, int b, int D, int cap, int nprobe,
                              int qb, int stages, int maxp, int grid, int k, void* part_s,
                              void* part_i, void* out_s, void* out_i, void* stream) {
    if (!chunk_e0 != !n_chunks || (chunk_e0 && !pos_prober)) return (int)cudaErrorInvalidValue;
    return ivf_scan<fstage::Bf16Stage>(2, q, q_rows, buckets, rows, bucket_ids,
                                       extent, pos_bucket, pos_prober, chunk_e0, n_chunks,
                                       sched, nullptr, nullptr, 0, b, D, cap, nprobe, qb,
                                       stages, maxp, grid, k, part_s, part_i, out_s, out_i,
                                       stream);
}

// Bucket-major over f32 buckets; as ivf_batch_topk -> [b, k]
extern "C" int ivf_batch_topk_f32(const void* q, int q_rows, const void* buckets, int rows,
                                  const void* bucket_ids, const void* extent,
                                  const void* pos_bucket, const void* pos_prober,
                                  void* chunk_e0, void* n_chunks, void* sched, int b, int D,
                                  int cap, int nprobe, int qb, int stages, int maxp, int grid,
                                  int k, void* part_s, void* part_i, void* out_s, void* out_i,
                                  void* stream) {
    if (!chunk_e0 != !n_chunks || (chunk_e0 && !pos_prober)) return (int)cudaErrorInvalidValue;
    return ivf_scan<fstage::F32Stage>(4, q, q_rows, buckets, rows, bucket_ids,
                                      extent, pos_bucket, pos_prober, chunk_e0, n_chunks,
                                      sched, nullptr, nullptr, 0, b, D, cap, nprobe, qb,
                                      stages, maxp, grid, k, part_s, part_i, out_s, out_i,
                                      stream);
}

// The bucket-major chunk plan alone (ivf_scan.cuh: chunk_plan): sb [n_pos]
// i32 sorted bucket ids -> chunk_e0 [n_pos], n_chunks [1] i32.
extern "C" int ivf_chunk_plan(const void* sb, int n_pos, int qb, void* chunk_e0,
                              void* n_chunks, void* stream) {
    if (n_pos < 1 || qb < 1) return (int)cudaErrorInvalidValue;
    ivf::chunk_plan<<<1, 1024, 0, (cudaStream_t)stream>>>((const int*)sb, n_pos, qb,
                                                          (int*)chunk_e0, (int*)n_chunks);
    return (int)cudaGetLastError();
}

extern "C" int ivf_batch_topk_int8(const void* q8, const void* buckets, const void* scales,
                                   const void* bucket_ids, const void* probe_ids,
                                   const void* uniq, int n_uniq, int b_pad, int b, int D,
                                   int cap, int nprobe, int piece, int k, void* part_s,
                                   void* part_i, void* out_s, void* out_i, void* stream) {
    const int npieces = (cap + piece - 1) / piece;
    cudaStream_t st = (cudaStream_t)stream;
    ivf_batch_int8_pass1<<<dim3(n_uniq, b_pad / QT, npieces), WARPS * 32, 0, st>>>(
        (const int8_t*)q8, (const int8_t*)buckets, (const float*)scales,
        (const int*)bucket_ids, (const int*)probe_ids, (const int*)uniq, D, cap, nprobe,
        piece, k, npieces, (float*)part_s, (int*)part_i);
    return merge(part_s, part_i, b, nprobe * npieces, k, out_s, out_i, st);
}
