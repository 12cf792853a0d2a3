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
// The integer sums are exact and each f32 operation is the one the plain
// version does (__fmul_rn/__fsub_rn: no contraction), so scores equal the
// plain version's bit for bit.
//
// Both are the Hopper scan of scan.cuh (a persistent grid, the query tile
// loaded once, the corpus through a TMA ring of 128-byte K panels, the
// filter in registers, survivors merged by rank; pass 2 over the blocks'
// lists) with the score stages of int_stages.cuh (Int8Stage; Int4Flat, the
// high row in quant.py's order). A scan is bound by reading the
// codes and scales once (int8: N*D + 4N bytes; int4: N*D/2 + 4N): at B = 64
// each corpus byte feeds 64 int8 multiply-adds (int4: 128), far below the
// card's int8 compute/bandwidth balance (~590 ops a byte).
//
// Both take 1 <= k <= 128 (the wrapper checks) and need D % 32 == 0,
// b_pad % 16 == 0 and 16-byte aligned pointers (TMA).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_stages.cuh"

// q8 [b_pad, D] i8, c8 [n_pad, D] i8, cscale [n_pad] f32 -> [b_pad, k].
// qb (16, 32, 64 or 128) queries per block, ceil(b_pad / qb) groups of them;
// qstream: 1 to stream the query panels beside the corpus panels (the plan
// sets it where the query tile does not fit); ranges: blocks per group, each
// a contiguous range of the ceil(n_pad / 128) corpus tiles; stages: the
// ring's depth; part_s/part_i [b_pad, ranges, k] hold the blocks' lists;
// stats: null, or 2 int32 that gain the filter's survivors and the blocks'
// merge rounds. Needs D % 32 == 0, b_pad % 16 == 0
// and 16-byte aligned q8, c8.
extern "C" int int8_topk(const void* q8, const void* c8, const void* cscale, int b_pad,
                         int D, int n_pad, int n_valid, int qb, int qstream, int stages,
                         int ranges, int k, void* part_s, void* part_i, void* out_s,
                         void* out_i, void* stats, void* stream) {
    if (D % 32) return (int)cudaErrorInvalidValue;
    const scan::Args a{(const float*)cscale, nullptr, nullptr, (float*)part_s, (int*)part_i,
                       (int*)stats, D, qstream, n_pad, n_valid, b_pad, k, ranges,
                       (n_pad + scan::ROWS - 1) / scan::ROWS, stages};
    return scan::dispatch<istage::Int8Stage, true>(qb, q8, c8, a, out_s, out_i, stream);
}

// q8 [b_pad, D] i8, corr [b_pad] f32, c4 [P, D] i8 packed, planes [2, P] f32
// -> [b_pad, k] over the 2P logical rows (n_valid of them may enter); qb
// (16, 32 or 64), qstream, stages, ranges over the ceil(P / 128) tiles of byte-rows,
// part_s/part_i and stats as int8_topk's.
extern "C" int int4_topk(const void* q8, const void* corr, const void* c4,
                         const void* planes, int b_pad, int D, int p_rows, int n_valid, int qb,
                         int qstream, int stages, int ranges, int k, void* part_s,
                         void* part_i, void* out_s, void* out_i, void* stats, void* stream) {
    if (D % 32) return (int)cudaErrorInvalidValue;
    const float* s = (const float*)planes;
    const scan::Args a{s, s + p_rows, (const float*)corr, (float*)part_s, (int*)part_i,
                       (int*)stats, D, qstream, p_rows, n_valid, b_pad, k, ranges,
                       (p_rows + scan::ROWS - 1) / scan::ROWS, stages};
    return scan::dispatch<istage::Int4Flat, false>(qb, q8, c4, a, out_s, out_i, stream);
}
