// The score stages of the integer scans (scan.cuh's Stage policy): int8 rows
// and row-pair-packed int4 rows on the tensor cores (wgmma s8). Shared by the
// flat scans B2 and B3 (quant_topk.cu: int8_topk, int4_topk) and the IVF
// scans over int8 and int4 buckets in both layouts (ivf_topk.cu over
// ivf_scan.cuh: ivf_probe_topk_int8/_int4, B8b/B8c, query-major, 16 query
// columns; ivf_batch_topk_int8/_int4, B9b/B9c, bucket-major, up to 64 and
// 32).
//
// int8 (Int8Stage): each consumer warpgroup scores its 64 rows of a tile
// against the QB queries with wgmma m64nQBk32.s32.s8.s8, rows as A and
// queries as B, both K-major from the swizzled panels, the int32 sums in
// registers; score = float(sum) * scale[row].
//
// int4 (Int4Stage): the ring carries the packed byte-rows; byte-row r holds
// two rows, biased +8 in its low nibble and signed in its high one. Per
// 32-byte K step the warpgroup runs two int8 products over the same panel:
// dotP with A from shared memory (wgmma ss), and dotU with A from registers
// (wgmma rs): each thread loads its mma.m16n8k32 fragment of the panel (four
// 32-bit words, conflict-free under the swizzle) and masks it with
// 0x0F0F0F0F. Each accumulator gives two rows, so a thread filters QB
// entries a tile (QB <= 64). (Masking the panel into shared memory instead,
// so that both products read shared memory and panels pipeline, cost more
// than it saved in B8c: a copy and two warpgroup barriers a panel.) With
// s0/s1 the scales of the low/high row:
//   low  row: (dotU - corr) * s0,                 corr = 8 * sum(q8);
//   high row, flat order (quant.py:250-252):      (dotP - dotU) * (s1 * 0.0625);
//   high row, IVF order (ivf_kernel.py:248-249): ((dotP - dotU) * s1) * 0.0625.
// The two orders differ in the last bit, so the order is a template
// parameter (Int4Flat, Int4Ivf). The integer sums are exact and every f32
// operation is the plain version's (__fmul_rn/__fsub_rn: no contraction),
// so scores equal the plain versions' bit for bit.
//
// Scales come from the begin() arguments: a.s0 (int4: a.s0 and a.s1) from
// the tile's first row, rows at or past a.n_pad scaled 0 (their ids are
// dead). The flat scan passes the corpus's planes; the IVF scan passes each
// work item's bucket. int4's corr is the aux value of the entry's query
// column.
//
// Beside scan.cuh's interface each stage gives, for the IVF scans, the NR
// distinct logical rows a thread holds (rowi(i); entry e lies on row
// rsel(e)), in the numbering of row(e): int8 rows, int4 2 * byte-row + (0:
// low, 1: high); SLOTS_PER_ROW, the slots a byte-row holds (int4: 2, slots r
// and r + cap/2 of an IVF bucket); and panel_live(.., nq), which the tensor
// cores take at the cost of a whole panel whatever nq is.

#pragma once

#include <stdint.h>

#include "scan.cuh"

namespace istage {

template <int QB_>
struct Int8Stage {
    static constexpr int QB = QB_, NE = QB / 2, NQ = QB / 4, NR = 2, SLOTS_PER_ROW = 1;
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

    __device__ __forceinline__ void panel_live(uint32_t c_addr, uint32_t q_addr, bool first,
                                               int) {
        panel(c_addr, q_addr, first);
    }

    __device__ __forceinline__ void settle() { hop::fence_regs_s32<QB / 2>(acc); }
    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e); }
    __device__ __forceinline__ int row(int e) const { return (e & 2) ? rA + 8 : rA; }
    __device__ __forceinline__ int rsel(int e) const { return (e >> 1) & 1; }
    __device__ __forceinline__ int rowi(int i) const { return rA + 8 * i; }
    __device__ __forceinline__ float score(int e, const float*) const {
        return __fmul_rn(__int2float_rn(acc[e]), (e & 2) ? sB : sA);
    }
};

template <int QB_, bool IVF>
struct Int4Stage {
    static constexpr int QB = QB_, NE = QB, NQ = QB / 4, NR = 4, SLOTS_PER_ROW = 2;
    static_assert(QB <= 64, "two int32 accumulators a score and QB entries a thread");
    // the masked fragments are registers the next panel would overwrite
    // while this panel's group still reads them: wait for each group (two
    // sets by panel parity, so that two groups could be in flight, made
    // ptxas serialize the wgmma (C7513) and were slower)
    static constexpr bool ASYNC = false;
    int dp[QB / 2], du[QB / 2];          // q8 . p, q8 . (p & 15)
    float s0A, s1A, s0B, s1B;            // scales of byte-rows rA, rA + 8: low, high row
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

    __device__ __forceinline__ void panel_live(uint32_t c_addr, uint32_t q_addr, bool first,
                                               int) {
        panel(c_addr, q_addr, first);
    }

    __device__ __forceinline__ void settle() {}
    // entry e: accumulator e / 2, the low (e even) or high row of its byte-row
    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e >> 1); }
    __device__ __forceinline__ int row(int e) const {
        return 2 * ((e & 4) ? rA + 8 : rA) + (e & 1);
    }
    __device__ __forceinline__ int rsel(int e) const { return ((e >> 1) & 2) | (e & 1); }
    __device__ __forceinline__ int rowi(int i) const { return 2 * (rA + 8 * (i >> 1)) + (i & 1); }
    __device__ __forceinline__ float score(int e, const float* corr) const {
        const int a = e >> 1;
        const bool hi = a & 2;
        const float fu = __int2float_rn(du[a]);
        if (e & 1) {
            const float d = __fsub_rn(__int2float_rn(dp[a]), fu), s1 = hi ? s1B : s1A;
            if constexpr (IVF) return __fmul_rn(__fmul_rn(d, s1), 0.0625f);
            return __fmul_rn(d, __fmul_rn(s1, 0.0625f));
        }
        return __fmul_rn(__fsub_rn(fu, corr[query(qslot(e))]), hi ? s0B : s0A);
    }
};

template <int QB>
using Int4Flat = Int4Stage<QB, false>;   // B3: the flat order of the high row
template <int QB>
using Int4Ivf = Int4Stage<QB, true>;     // B8c: the IVF order

}  // namespace istage
