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
// All eight are one kernel, the Hopper IVF scan of ivf_scan.cuh: the flat
// scan's skeleton walking work items (a chunk of probers of one bucket x a
// piece of its live extent): a TMA ring of 128-byte K panels, the stages of
// float_stages.cuh (wgmma bf16; f32 fmaf on the CUDA cores, no TF32: TF32
// would keep 10 mantissa bits of the stored f32) and of int_stages.cuh (wgmma
// s8; int4: two products per panel, on the packed bytes and on their low
// nibbles), the filter in registers on (score, doc id), survivors merged by
// rank. Only each bucket's live extent is read (a bucket's live rows are
// packed at the front after a build or an add; deletes leave holes inside
// it; int4: min(extent, cap/2) packed rows), and the bucket-major layout
// reads each probed bucket once for up to QB probers (bf16 and f32 up to
// 128, int8 up to 64, int4 up to 32: the larger instances spill, and a
// thread filters every column of its tile, live or not). The two layouts differ
// only in their chunks: one prober each (query-major), or a bucket's probers
// QB at a time (bucket-major), whose queries (and int4's corr) the wrapper
// gathers in position order.
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
// read as 0 and add nothing).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "float_stages.cuh"
#include "int_stages.cuh"
#include "ivf_scan.cuh"
#include "topk_merge.cuh"

namespace {

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

// The IVF scans of ivf_scan.cuh (B8a and B9a over bf16 or f32 buckets, B8b,
// B8c, B9b and B9c over int8 and int4): the chunk plan (bucket-major), pass
// 1, pass 2. scales: the int8/int4 slot scales, or null; corr: int4's, in
// the order of the query rows, or null; caph: cap / 2 for int4, else 0.
// QBMAX: the most probers a chunk of the entry may take, the largest
// instance compiled (ops/ivf_kernel.py's _QB_MAX must say the same).
template <template <int> class S, int QBMAX = 128>
int ivf_scan(int esz, const void* q, int q_rows, const void* buckets, int rows,
             const void* bucket_ids, const void* extent, const void* pos_bucket,
             const void* pos_prober, void* chunk_e0, void* n_chunks, void* sched,
             const void* scales, const void* corr, int caph, int b, int D, int cap, int nprobe,
             int qb, int stages, int maxp, int grid, int k, void* part_s, void* part_i,
             void* out_s, void* out_i, void* stream) {
    if (!chunk_e0 != !n_chunks || (chunk_e0 && !pos_prober)) return (int)cudaErrorInvalidValue;
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

// Bucket-major over int8 buckets: q8 [q_rows = b * nprobe, D] i8 gathered in
// position order, scales [nlist, cap] f32 slot scales; chunks of at most 64
// probers (Int8Stage<128> spills); the rest as ivf_batch_topk -> [b, k],
// scores without the query scale
extern "C" int ivf_batch_topk_int8(const void* q8, int q_rows, const void* buckets, int rows,
                                   const void* bucket_ids, const void* extent,
                                   const void* pos_bucket, const void* pos_prober,
                                   void* chunk_e0, void* n_chunks, void* sched,
                                   const void* scales, int b, int D, int cap, int nprobe, int qb,
                                   int stages, int maxp, int grid, int k, void* part_s,
                                   void* part_i, void* out_s, void* out_i, void* stream) {
    return ivf_scan<istage::Int8Stage, 64>(1, q8, q_rows, buckets, rows, bucket_ids, extent,
                                           pos_bucket, pos_prober, chunk_e0, n_chunks, sched,
                                           scales, nullptr, 0, b, D, cap, nprobe, qb, stages,
                                           maxp, grid, k, part_s, part_i, out_s, out_i, stream);
}

// Bucket-major over split-half packed int4 buckets: q8 and corr [q_rows = b *
// nprobe] f32 (= 8 sum(q8) of each row) both gathered in position order, so
// that a chunk's column c reads the corr of its own query (row e0 + c);
// buckets as ivf_probe_topk_int4's; chunks of at most 32 probers (Int4Ivf<64>
// spills); the rest as ivf_batch_topk_int8 -> [b, k]
extern "C" int ivf_batch_topk_int4(const void* q8, int q_rows, const void* buckets, int rows,
                                   const void* bucket_ids, const void* extent,
                                   const void* pos_bucket, const void* pos_prober,
                                   void* chunk_e0, void* n_chunks, void* sched,
                                   const void* scales, const void* corr, int b, int D, int cap,
                                   int nprobe, int qb, int stages, int maxp, int grid, int k,
                                   void* part_s, void* part_i, void* out_s, void* out_i,
                                   void* stream) {
    return ivf_scan<istage::Int4Ivf, 32>(1, q8, q_rows, buckets, rows, bucket_ids, extent,
                                         pos_bucket, pos_prober, chunk_e0, n_chunks, sched,
                                         scales, corr, cap / 2, b, D, cap, nprobe, qb, stages,
                                         maxp, grid, k, part_s, part_i, out_s, out_i, stream);
}
