// The score stages of the float scans (scan.cuh's Stage policy): bf16 rows
// on the tensor cores and f32 rows on the CUDA cores. Shared by the flat
// scan B1 (flat_topk.cu: flat_topk, flat_topk_f32) and the IVF scans B8a and
// B9a (ivf_topk.cu over ivf_scan.cuh: ivf_probe_topk{,_f32},
// ivf_batch_topk{,_f32}).
//
// bf16 (Bf16Stage): each consumer warpgroup scores its 64 rows of a tile
// against the QB queries with wgmma m64nQBk16.f32.bf16.bf16 (a panel is 64
// bf16 columns), rows as A and queries as B, both K-major from the swizzled
// panels, the f32 sums in registers.
//
// f32 (F32Stage): no TF32 (it keeps about three decimal digits; the plain
// versions are full f32). A panel is 32 f32 columns. Each consumer thread
// holds a register tile of R rows x NQ queries (4 x 4 at QB = 32) of f32
// sums; per 16-byte chunk of the panel it reads its rows' and its queries'
// chunks (one ld.shared.v4 each) and does 4 R NQ fmaf, so each shared-memory
// word feeds NQ or R of them. A warp's lanes take 8 (QB = 128: 16) query
// groups and 4 (2) row groups; rows and queries of neighbouring groups are
// neighbours, so under the 128-byte swizzle a warp's loads of one chunk fall
// in distinct banks (one wavefront, the rest broadcast).
//
// Beside scan.cuh's interface each stage gives, for the IVF scans, the NR
// distinct rows a thread holds (rowi(i); entry e lies on row rsel(e)), so
// the doc id of a slot is loaded once per row, and panel_live(.., nq), a
// panel in which only the first nq query columns are live: the f32 stage
// then sums only the query groups that hold a live column (a bucket-major
// chunk has as many columns as probers, often far fewer than QB).

#pragma once

#include <stdint.h>

#include "scan.cuh"

namespace fstage {

template <int QB_>
struct Bf16Stage {
    static constexpr int QB = QB_, NE = QB / 2, NQ = QB / 4, NR = 2;
    static constexpr bool ASYNC = true;
    float acc[QB / 2];
    int w16, g, tq, rA;

    __device__ __forceinline__ Bf16Stage(int w4, int lane)
        : w16(w4 * 16), g(lane >> 2), tq(lane & 3) {
#pragma unroll
        for (int e = 0; e < QB / 2; ++e) acc[e] = 0.f;
    }

    __device__ __forceinline__ void begin(const scan::Args&, int row0) { rA = row0 + w16 + g; }

    __device__ __forceinline__ void panel(uint32_t c_addr, uint32_t q_addr, bool first) {
        hop::wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
            hop::Wgmma<QB>::ss(acc, hop::desc_sw128(c_addr + ks * 32, 16),
                               hop::desc_sw128(q_addr + ks * 32, 16), !first || ks);
        hop::wg_commit();
    }

    // the tensor cores take every column at the same cost: nq changes nothing
    __device__ __forceinline__ void panel_live(uint32_t c_addr, uint32_t q_addr, bool first,
                                               int) {
        panel(c_addr, q_addr, first);
    }

    __device__ __forceinline__ void settle() { hop::fence_regs<QB / 2>(acc); }

    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e); }
    __device__ __forceinline__ int row(int e) const { return (e & 2) ? rA + 8 : rA; }
    __device__ __forceinline__ int rsel(int e) const { return (e >> 1) & 1; }
    __device__ __forceinline__ int rowi(int i) const { return rA + 8 * i; }
    __device__ __forceinline__ float score(int e, const float*) const { return acc[e]; }
};

template <int QB_>
struct F32Stage {
    static constexpr int QB = QB_;
    static constexpr bool ASYNC = false;
    static constexpr int QG = QB >= 128 ? 16 : 8;      // query groups of a warp
    static constexpr int RG = 128 / QG;                // row groups of a warpgroup
    static constexpr int R = 64 / RG, NQ = QB / QG, NE = R * NQ, NR = R;
    float acc[R][NQ];
    int qg, rg, row0;

    __device__ __forceinline__ F32Stage(int w4, int lane)
        : qg(lane % QG), rg(w4 * (32 / QG) + lane / QG) {}

    __device__ __forceinline__ void begin(const scan::Args&, int r0) {
        row0 = r0;
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < NQ; ++j) acc[i][j] = 0.f;
    }

    // rows rg + RG i of the warpgroup's 64, queries qg + QG j for j < NJ
    template <int NJ>
    __device__ __forceinline__ void panel_n(uint32_t c_addr, uint32_t q_addr) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float4 y[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                y[j] = scan::lds128(q_addr + scan::sw_chunk(qg + QG * j, c));
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float4 x = scan::lds128(c_addr + scan::sw_chunk(rg + RG * i, c));
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
                    acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
                    acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
                    acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
                }
            }
        }
    }

    __device__ __forceinline__ void panel(uint32_t c_addr, uint32_t q_addr, bool) {
        panel_n<NQ>(c_addr, q_addr);
    }

    // the query groups up to the one holding column nq - 1, in powers of two
    // (a block-uniform branch: nq is the work item's)
    __device__ __forceinline__ void panel_live(uint32_t c_addr, uint32_t q_addr, bool, int nq) {
        if (nq <= QG) {
            panel_n<1>(c_addr, q_addr);
        } else if (nq <= 2 * QG || NQ <= 2) {
            panel_n<(NQ < 2 ? NQ : 2)>(c_addr, q_addr);
        } else if (nq <= 4 * QG || NQ <= 4) {
            panel_n<(NQ < 4 ? NQ : 4)>(c_addr, q_addr);
        } else {
            panel_n<NQ>(c_addr, q_addr);
        }
    }

    __device__ __forceinline__ void settle() {}

    __device__ __forceinline__ int query(int j) const { return qg + QG * j; }
    __device__ __forceinline__ int qslot(int e) const { return e % NQ; }
    __device__ __forceinline__ int row(int e) const { return row0 + rg + RG * (e / NQ); }
    __device__ __forceinline__ int rsel(int e) const { return e / NQ; }
    __device__ __forceinline__ int rowi(int i) const { return row0 + rg + RG * i; }
    __device__ __forceinline__ float score(int e, const float*) const {
        return acc[e / NQ][e % NQ];
    }
};

}  // namespace fstage
