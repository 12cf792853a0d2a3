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
// bf16 (Bf16Stage): what bounds it on an H100: at B = 64 each corpus byte
// feeds 32 multiply-adds, far below the card's bf16 balance (~295 a byte),
// so the scan is bound by reading the corpus once (N*D*2 bytes). Each
// consumer warpgroup scores its 64 corpus rows of a tile against the QB
// queries with wgmma m64nQBk16.f32.bf16.bf16 (a panel is 64 bf16 columns),
// corpus rows as A and queries as B, both K-major from the swizzled panels,
// the f32 sums in registers.
//
// f32 (F32Stage): at B = 64 each 4-byte corpus value feeds 64 multiply-adds,
// 32 operations a byte, above the card's f32 CUDA-core balance (67 TFLOP/s
// over 3.35 TB/s = 20): operations, not bytes. A panel is 32 f32 columns.
// Each consumer thread holds a register tile of R corpus rows x NQ queries
// (4 x 4 at QB = 32) of f32 sums; per 16-byte chunk of the panel it reads
// its rows' and its queries' chunks (one ld.shared.v4 each) and does
// 4 R NQ fmaf, so each shared-memory word feeds NQ or R of them. A warp's
// lanes take 8 (QB = 128: 16) query groups and 4 (2) row groups; rows and
// queries of neighbouring groups are neighbours, so under the 128-byte
// swizzle a warp's loads of one chunk fall in distinct banks (one wavefront,
// the rest broadcast).
//
// Requires D % 16 == 0, b_pad % 16 == 0 and 16-byte aligned pointers
// (TMA); 1 <= k <= 128 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

template <int QB_>
struct Bf16Stage {
    static constexpr int QB = QB_, NE = QB / 2, NQ = QB / 4;
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

    __device__ __forceinline__ void settle() { hop::fence_regs<QB / 2>(acc); }

    __device__ __forceinline__ int query(int j) const { return scan::wg_query(j, tq); }
    __device__ __forceinline__ int qslot(int e) const { return scan::wg_slot(e); }
    __device__ __forceinline__ int row(int e) const { return (e & 2) ? rA + 8 : rA; }
    __device__ __forceinline__ float score(int e, const float*) const { return acc[e]; }
};

template <int QB_>
struct F32Stage {
    static constexpr int QB = QB_;
    static constexpr bool ASYNC = false;
    static constexpr int QG = QB >= 128 ? 16 : 8;      // query groups of a warp
    static constexpr int RG = 128 / QG;                // row groups of a warpgroup
    static constexpr int R = 64 / RG, NQ = QB / QG, NE = R * NQ;
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

    // rows rg + RG i of the warpgroup's 64, queries qg + QG j
    __device__ __forceinline__ void panel(uint32_t c_addr, uint32_t q_addr, bool) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float4 y[NQ];
#pragma unroll
            for (int j = 0; j < NQ; ++j)
                y[j] = scan::lds128(q_addr + scan::sw_chunk(qg + QG * j, c));
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float4 x = scan::lds128(c_addr + scan::sw_chunk(rg + RG * i, c));
#pragma unroll
                for (int j = 0; j < NQ; ++j) {
                    acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
                    acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
                    acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
                    acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
                }
            }
        }
    }

    __device__ __forceinline__ void settle() {}

    __device__ __forceinline__ int query(int j) const { return qg + QG * j; }
    __device__ __forceinline__ int qslot(int e) const { return e % NQ; }
    __device__ __forceinline__ int row(int e) const { return row0 + rg + RG * (e / NQ); }
    __device__ __forceinline__ float score(int e, const float*) const {
        return acc[e / NQ][e % NQ];
    }
};

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
    return flat_scan<Bf16Stage>(q, c, 2, b_pad, D, n_pad, n_valid, qb, qstream, stages, ranges,
                                k, part_s, part_i, out_s, out_i, stats, stream);
}

// q [b_pad, D] f32, c [n_pad, D] f32 -> [b_pad, k]; the rest as flat_topk's
extern "C" int flat_topk_f32(const void* q, const void* c, int b_pad, int D, int n_pad,
                             int n_valid, int qb, int qstream, int stages, int ranges, int k,
                             void* part_s, void* part_i, void* out_s, void* out_i,
                             void* stats, void* stream) {
    return flat_scan<F32Stage>(q, c, 4, b_pad, D, n_pad, n_valid, qb, qstream, stages, ranges,
                               k, part_s, part_i, out_s, out_i, stats, stream);
}
