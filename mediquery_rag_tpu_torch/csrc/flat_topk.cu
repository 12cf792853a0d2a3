// Exact top-k dot-product search over a padded bf16 or f32 corpus, in two passes.
//
// Replaces the Pallas kernel mediquery_rag_tpu/ops/scoring.py:_flat_topk_kernel
// (:303, launched at :370 by flat_search :388): Q . C^T fused with a running
// top-k, rows >= n_valid masked, short results (-inf, id 0). flat_topk takes
// bf16 (tensor cores), flat_topk_f32 the f32 case (CUDA cores, no TF32: TF32
// keeps about three decimal digits and the plain version is full f32).
//
// The TPU kernel walks the corpus tiles in order on one core and carries the
// running top-k in VMEM from one grid step to the next. Here both are the
// Hopper scan of scan.cuh (a persistent grid of about one block per SM,
// each walking a contiguous range of 128-row tiles; the query tile loaded
// once; the corpus through a TMA ring of 128-byte K panels; the filter in
// registers against each query's running k-th (score, row); survivors
// merged by rank; pass 2 over the blocks' lists, under (score desc, row
// asc), the order of lax.top_k). This file gives its score stages.
//
// bf16 (fstage::Bf16Stage, float_stages.cuh): what bounds it on an H100: at
// B = 64 each corpus byte feeds 32 multiply-adds, far below the card's bf16
// balance (~295 a byte), so the scan is bound by reading the corpus once
// (N*D*2 bytes): wgmma m64nQBk16 from the swizzled panels.
//
// f32 (fstage::F32Stage): at B = 64 each 4-byte corpus value feeds 64
// multiply-adds, 32 operations a byte, above the card's f32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s = 20): operations, not bytes. A
// register tile of fmaf per thread (4 rows x 4 queries at QB = 32).
//
// Requires D % 16 == 0, b_pad % 16 == 0 and 16-byte aligned pointers
// (TMA); 1 <= k <= 128 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_stages.cuh"

namespace {

template <template <int> class S>
int flat_scan(const void* q, const void* c, int esz, int b_pad, int D, int n_pad, int n_valid,
              int qb, int qstream, int stages, int ranges, int k, void* part_s, void* part_i,
              void* out_s, void* out_i, void* stats, void* stream) {
    if (D % 16) return (int)cudaErrorInvalidValue;
    const scan::Args a{nullptr, nullptr, nullptr, (float*)part_s, (int*)part_i, (int*)stats,
                       D * esz, qstream, n_pad, n_valid, b_pad, k, ranges,
                       (n_pad + scan::ROWS - 1) / scan::ROWS, stages};
    return scan::dispatch<S, true>(qb, q, c, a, out_s, out_i, stream);
}

}  // namespace

// q [b_pad, D] bf16, c [n_pad, D] bf16 -> [b_pad, k]. qb (16, 32, 64 or 128)
// queries per block, ceil(b_pad / qb) groups of them; qstream: 1 to stream
// the query panels beside the corpus panels; ranges: blocks per
// group, each a contiguous range of the ceil(n_pad / 128) corpus tiles;
// stages: the ring's depth; part_s/part_i [b_pad, ranges, k] hold the
// blocks' lists; stats: null, or 2 int32 that gain the filter's survivors
// and the blocks' merge rounds.
extern "C" int flat_topk(const void* q, const void* c, int b_pad, int D, int n_pad,
                         int n_valid, int qb, int qstream, int stages, int ranges, int k,
                         void* part_s, void* part_i, void* out_s, void* out_i, void* stats,
                         void* stream) {
    return flat_scan<fstage::Bf16Stage>(q, c, 2, b_pad, D, n_pad, n_valid, qb, qstream, stages,
                                        ranges, k, part_s, part_i, out_s, out_i, stats, stream);
}

// q [b_pad, D] f32, c [n_pad, D] f32 -> [b_pad, k]; the rest as flat_topk's
extern "C" int flat_topk_f32(const void* q, const void* c, int b_pad, int D, int n_pad,
                             int n_valid, int qb, int qstream, int stages, int ranges, int k,
                             void* part_s, void* part_i, void* out_s, void* out_i,
                             void* stats, void* stream) {
    return flat_scan<fstage::F32Stage>(q, c, 4, b_pad, D, n_pad, n_valid, qb, qstream, stages,
                                       ranges, k, part_s, part_i, out_s, out_i, stats, stream);
}
