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
// lists); this file gives its score stages. A scan is bound by reading the
// codes and scales once (int8: N*D + 4N bytes; int4: N*D/2 + 4N): at B = 64
// each corpus byte feeds 64 int8 multiply-adds (int4: 128), far below the
// card's int8 compute/bandwidth balance (~590 ops a byte).
//
// int8 (Int8Stage): each consumer warpgroup scores its 64 corpus rows of a
// tile against the QB queries with wgmma m64nQBk32.s32.s8.s8, corpus rows as
// A and queries as B, both K-major from the swizzled panels, the int32 sums
// in registers; score = float(sum) * cscale.
//
// int4 (Int4Stage): the ring carries the packed byte-rows. Per 32-byte K
// step the warpgroup runs two int8 products over the same panel: dotP with
// A from shared memory (wgmma ss), and dotU with A from registers (wgmma
// rs): each thread loads its mma.m16n8k32 fragment of the panel (four
// 32-bit words, conflict-free under the swizzle) and masks it with
// 0x0F0F0F0F. Each accumulator gives two logical rows, the even row 2r and
// the odd row 2r+1, so a thread filters QB entries a tile (QB <= 64).
//
// Both take 1 <= k <= 128 (the wrapper checks) and need D % 32 == 0,
// b_pad % 16 == 0 and 16-byte aligned pointers (TMA).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

template <int QB_>
struct Int8Stage {
    static constexpr int QB = QB_, NE = QB / 2, NQ = QB / 4;
    static constexpr bool ASYNC = true;
    int acc[QB / 2];
    float sA, sB;
    int w16, g, tq, rA;

    __device__ __forceinline__ Int8Stage(int w4, int lane)
        : w16(w4 * 16), g(lane >> 2), tq(lane & 3) {
#pragma unroll
        for (int e = 0; e < QB / 2; ++e) acc[e] = 0;
    }

    __device__ __forceinline__ void begin(const scan::Args& a, int row0) {
        rA = row0 + w16 + g;
        sA = rA < a.n_pad ? __ldg(a.s0 + rA) : 0.f;
        sB = rA + 8 < a.n_pad ? __ldg(a.s0 + rA + 8) : 0.f;
    }

    __device__ __forceinline__ void panel(uint32_t c_addr, uint32_t q_addr, bool first) {
        hop::wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
            hop::WgmmaS8<QB>::ss(acc, hop::desc_sw128(c_addr + ks * 32, 16),
                                 hop::desc_sw128(q_addr + ks * 32, 16), !first || ks);
        hop::wg_commit();
    }

    __device__ __forceinline__ void settle() { hop::fence_regs_s32<QB / 2>(acc); }
    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e); }
    __device__ __forceinline__ int row(int e) const { return (e & 2) ? rA + 8 : rA; }
    __device__ __forceinline__ float score(int e, const float*) const {
        return __fmul_rn(__int2float_rn(acc[e]), (e & 2) ? sB : sA);
    }
};

template <int QB_>
struct Int4Stage {
    static constexpr int QB = QB_, NE = QB, NQ = QB / 4;
    static_assert(QB <= 64, "two int32 accumulators a score and QB entries a thread");
    // the masked fragments are registers the next panel would overwrite
    // while this panel's group still reads them: wait for each group (two
    // sets by panel parity, so that two groups could be in flight, made
    // ptxas serialize the wgmma (C7513) and were slower)
    static constexpr bool ASYNC = false;
    int dp[QB / 2], du[QB / 2];          // q8 . p, q8 . (p & 15)
    float s0A, s1A, s0B, s1B;            // scale planes of byte-rows rA, rA + 8
    int w16, g, tq, rA;

    __device__ __forceinline__ Int4Stage(int w4, int lane)
        : w16(w4 * 16), g(lane >> 2), tq(lane & 3) {
#pragma unroll
        for (int e = 0; e < QB / 2; ++e) dp[e] = du[e] = 0;
    }

    __device__ __forceinline__ void begin(const scan::Args& a, int row0) {
        rA = row0 + w16 + g;
        const bool inA = rA < a.n_pad, inB = rA + 8 < a.n_pad;
        s0A = inA ? __ldg(a.s0 + rA) : 0.f;
        s1A = inA ? __ldg(a.s1 + rA) : 0.f;
        s0B = inB ? __ldg(a.s0 + rA + 8) : 0.f;
        s1B = inB ? __ldg(a.s1 + rA + 8) : 0.f;
    }

    __device__ __forceinline__ void panel(uint32_t c_addr, uint32_t q_addr, bool first) {
        // this thread's fragment of the low-nibble plane: rows w16 + g and
        // + 8, bytes 32 ks + 4 tq and + 16 (the 16-byte chunks 2 ks and
        // 2 ks + 1, swizzled by the row)
        uint32_t lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const int r = w16 + g + (h & 1) * 8, ch = 2 * ks + (h >> 1);
                lo[ks][h] = scan::lds32(c_addr + scan::sw_chunk(r, ch) + 4 * tq) & 0x0F0F0F0Fu;
            }
        hop::wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const uint64_t db = hop::desc_sw128(q_addr + ks * 32, 16);
            hop::WgmmaS8<QB>::ss(dp, hop::desc_sw128(c_addr + ks * 32, 16), db, !first || ks);
            hop::WgmmaS8<QB>::rs(du, lo[ks], db, !first || ks);
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs_s32<QB / 2>(dp);
        hop::fence_regs_s32<QB / 2>(du);
    }

    __device__ __forceinline__ void settle() {}
    // entry e: accumulator e / 2, logical row 2 r (e even) or 2 r + 1
    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e >> 1); }
    __device__ __forceinline__ int row(int e) const {
        return 2 * ((e & 4) ? rA + 8 : rA) + (e & 1);
    }
    __device__ __forceinline__ float score(int e, const float* corr) const {
        const int a = e >> 1;
        const bool hi = a & 2;
        const float fu = __int2float_rn(du[a]);
        if (e & 1)
            return __fmul_rn(__fsub_rn(__int2float_rn(dp[a]), fu),
                             __fmul_rn(hi ? s1B : s1A, 0.0625f));
        return __fmul_rn(__fsub_rn(fu, corr[query(qslot(e))]), hi ? s0B : s0A);
    }
};

}  // namespace

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
    return scan::dispatch<Int8Stage, true>(qb, q8, c8, a, out_s, out_i, stream);
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
    return scan::dispatch<Int4Stage, false>(qb, q8, c4, a, out_s, out_i, stream);
}
