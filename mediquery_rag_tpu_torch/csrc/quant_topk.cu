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
// Pass 2 merges the blocks' lists under (score desc, row asc)
// (topk_merge.cuh, shared with flat_topk.cu). The integer sums are exact and
// each f32 operation is the one the plain version does (__fmul_rn/__fsub_rn:
// no contraction), so scores equal the plain version's bit for bit.
//
// What bounds both on an H100: at B = 64 each corpus byte feeds 64 int8
// multiply-adds (int4: 128), far below the card's int8 compute/bandwidth
// balance (~590 ops a byte), so a scan is bound by reading the codes and
// scales once (int8: N*D + 4N bytes; int4: N*D/2 + 4N).
//
// int8_topk, pass 1 (Hopper; int8_scan_kernel): a persistent grid of about
// one block per SM, each walking a contiguous range of 128-row corpus tiles
// for up to 128 queries (the plan's QB; more queries take more groups of
// blocks). A producer warp loads the block's [QB x D] query tile once and
// streams the corpus tiles through a ring of 128-byte K panels with TMA
// (128-byte swizzle, completion on mbarriers), so every corpus byte is read
// once from device memory when B <= QB. Two consumer warpgroups each score
// 64 corpus rows of a tile against all QB queries with wgmma
// m64nQBk32.s32.s8.s8 (corpus rows are A, queries B, both K-major), the
// int32 scores in registers. Each score is scaled as the plain version does
// and compared there with its query's running k-th (score, row) in shared
// memory; only the survivors go to per-query slots in shared memory. When a
// survivor finds its query's slots full (and at the end of the range) one
// warp per query merges the slots into the list by rank (survivors arrive in
// fragment order, so the merge orders them by (score desc, row asc); rows
// are unique, so the result does not depend on arrival order). At k = 10
// over 1M rows the k-th rises fast, so a block merges a few times in its
// range; the merges overlap the producer's loads of the next tiles. Rows at
// or past n_valid never enter.
//
// int4_topk, pass 1 (quant_topk_pass1<true>): one block per (16-query tile,
// corpus chunk); four warps score 64 byte-rows per sub-tile with
// mma.sync.m16n8k32 (fragments loaded as 4-byte words straight from device
// memory, the nibble mask applied to those words in registers); the f32
// scores go to shared memory and each warp folds them, in logical-row
// order, into the sorted per-query top-k of the chunk. Query tiles of one
// chunk are adjacent in the grid (blockIdx.x), so the chunk is re-read from
// L2. Requires D % 32 == 0, byte-rows % 64 == 0, chunk % 64 == 0, queries
// padded to a multiple of 16 rows, 4-byte aligned pointers.
//
// Both take 1 <= k <= 128 (the wrapper checks); int8_topk needs 16-byte
// aligned pointers (TMA).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
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


// ---------------- int8_topk: the Hopper scan ----------------

constexpr int S8_ROWS = 128;                      // corpus rows per tile (64 per consumer)
constexpr int S8_CONSUMERS = 2;                   // consumer warpgroups
constexpr int S8_THREADS = S8_CONSUMERS * 128 + 32;   // + one producer warp
constexpr int S8_PANEL = S8_ROWS * 128;           // one 128-byte K panel of a tile: a stage
constexpr int S8_SLOTS = 32;                      // survivors per query and fold round

struct ScanMaps {
    CUtensorMap q, c;
};

struct ScanArgs {
    const float* cscale;
    float* part_s;
    int* part_i;
    int* stats;        // null, or [survivors of the filter, merge rounds] to add to
    int D, n_pad, n_valid, b_pad, k, ranges, tiles, stages;
};

// Dynamic shared memory of int8_scan_kernel<qb>: query panels, the ring, the
// lists, the survivor slots and counts, the barriers, and 1024 bytes to align.
inline size_t scan_smem(int qb, int D, int k, int stages) {
    return 1024 + (size_t)(D + 127) / 128 * qb * 128 + (size_t)stages * S8_PANEL
           + (size_t)qb * k * 8 + (size_t)qb * S8_SLOTS * 8 + (size_t)qb * 4
           + (size_t)(2 * stages + 1) * 8;
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(S8_CONSUMERS * 128) : "memory");
}

// A barrier of the consumer threads that also tells each whether any of
// them passed p = true.
__device__ __forceinline__ bool consumers_any(bool p) {
    int r;
    asm volatile(
        "{\n.reg .pred pi, po;\nsetp.ne.b32 pi, %1, 0;\n"
        "bar.red.or.pred po, 1, %2, pi;\nselp.b32 %0, 1, 0, po;\n}\n"
        : "=r"(r) : "r"((int)p), "n"(S8_CONSUMERS * 128) : "memory");
    return r != 0;
}

// One warp merges the n <= 32 candidates cs/ci[0..n) into the sorted list
// ls/li[0..k) (all in shared memory) under (score desc, id asc); ids are
// unique, so the merged order is total and does not depend on the
// candidates' order. Lane l ranks candidate l: its new place is the count of
// list entries and of other candidates ordered before it; list entry j
// (held by lane j % 32) moves down by the count of candidates ordered before
// it; what lands at k or past falls off. Every lane reads the same slot or
// list entry at a time (broadcast), so the loops pipeline.
__device__ __forceinline__ void merge_candidates(float* ls, int* li, int k, const float* cs,
                                                 const int* ci, int n) {
    const int lane = threadIdx.x & 31;
    const bool own = lane < n;
    const float ms = own ? cs[lane] : -CUDART_INF_F;
    const int mi = own ? ci[lane] : INT_MAX;
    int pos = 0;
#pragma unroll 8
    for (int m = 0; m < n; ++m) pos += topk::better(cs[m], ci[m], ms, mi);   // not itself
#pragma unroll 8
    for (int j = 0; j < k; ++j) pos += topk::better(ls[j], li[j], ms, mi);
    float tv[KMAX / 32];
    int ti[KMAX / 32], tp[KMAX / 32];
#pragma unroll
    for (int t = 0; t < KMAX / 32; ++t) {
        const int j = t * 32 + lane;
        tv[t] = j < k ? ls[j] : -CUDART_INF_F;
        ti[t] = j < k ? li[j] : INT_MAX;
        tp[t] = j;
        if (t * 32 < k) {
#pragma unroll 8
            for (int m = 0; m < n; ++m) tp[t] += topk::better(cs[m], ci[m], tv[t], ti[t]);
        }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < KMAX / 32; ++t) {
        const int j = t * 32 + lane;
        if (j < k && tp[t] < k) {
            ls[tp[t]] = tv[t];
            li[tp[t]] = ti[t];
        }
    }
    if (own && pos < k) {
        ls[pos] = ms;
        li[pos] = mi;
    }
    __syncwarp();
}

// The consumer warps merge every query's slots into its list (warp w takes
// queries w, w + 8, ...) and empty them.
template <int QB>
__device__ __forceinline__ void merge_slots(float* ls, int* li, const float* cs, const int* ci,
                                            int* cnt, int k, int warp, int lane) {
    for (int q = warp; q < QB; q += S8_CONSUMERS * 4) {
        const int nq = min(cnt[q], S8_SLOTS);
        if (nq == 0) continue;
        merge_candidates(ls + q * k, li + q * k, k, cs + q * S8_SLOTS, ci + q * S8_SLOTS, nq);
        if (lane == 0) cnt[q] = 0;
    }
}

template <int QB>
__global__ void __launch_bounds__(S8_THREADS, 1)
int8_scan_kernel(const __grid_constant__ ScanMaps maps, const ScanArgs a) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    const int panels = (a.D + 127) / 128;
    unsigned char* Qs = smem;
    unsigned char* ring = Qs + panels * QB * 128;
    float* ls = reinterpret_cast<float*>(ring + a.stages * S8_PANEL);
    int* li = reinterpret_cast<int*>(ls + QB * a.k);
    float* cs = reinterpret_cast<float*>(li + QB * a.k);
    int* ci = reinterpret_cast<int*>(cs + QB * S8_SLOTS);
    int* cnt = ci + QB * S8_SLOTS;
    uint64_t* full = reinterpret_cast<uint64_t*>(cnt + QB);   // QB even: 8-byte aligned
    uint64_t* empty = full + a.stages;
    uint64_t* qbar = empty + a.stages;

    const int range = blockIdx.x, grp = blockIdx.y;
    const int t0 = (int)((long long)range * a.tiles / a.ranges);
    const int t1 = (int)((long long)(range + 1) * a.tiles / a.ranges);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < a.stages; ++s) {
            hop::mbar_init(&full[s], 1);
            hop::mbar_init(&empty[s], S8_CONSUMERS * 4);
        }
        hop::mbar_init(qbar, 1);
        hop::fence_barrier_init();
    }
    for (int i = threadIdx.x; i < QB * a.k; i += blockDim.x) {
        ls[i] = -CUDART_INF_F;
        li[i] = INT_MAX;
    }
    for (int i = threadIdx.x; i < QB; i += blockDim.x) cnt[i] = 0;
    __syncthreads();

    if (warp == S8_CONSUMERS * 4) {
        // ---------------- producer: the query tile once, then the corpus ring ----------------
        if (lane == 0) {
            hop::mbar_expect_tx(qbar, panels * QB * 128);
            for (int p = 0; p < panels; ++p)
                hop::tma_load_2d(Qs + p * QB * 128, &maps.q, qbar, p * 128, grp * QB);
            int i = 0;
            for (int t = t0; t < t1; ++t)
                for (int p = 0; p < panels; ++p, ++i) {
                    const int s = i % a.stages;
                    hop::mbar_wait(&empty[s], ((i / a.stages) & 1) ^ 1);
                    hop::mbar_expect_tx(&full[s], S8_PANEL);
                    hop::tma_load_2d(ring + s * S8_PANEL, &maps.c, &full[s], p * 128,
                                     t * S8_ROWS);
                }
        }
        return;
    }

    // ---------------- consumers: 64 corpus rows x QB queries each ----------------
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, tq = lane & 3;
    const uint32_t q_addr = hop::smem_u32(Qs);
    int acc[QB / 2];
#pragma unroll
    for (int e = 0; e < QB / 2; ++e) acc[e] = 0;
    hop::mbar_wait(qbar, 0);

    int i = 0;
    for (int t = t0; t < t1; ++t) {
        // this thread's rows rA, rB = rA + 8; accumulator e holds row (e & 2 ? rB : rA),
        // query 8 (e / 4) + 2 tq + (e & 1)
        const int rA = t * S8_ROWS + wg * 64 + w4 * 16 + g, rB = rA + 8;
        const float sA = rA < a.n_pad ? __ldg(a.cscale + rA) : 0.f;
        const float sB = rB < a.n_pad ? __ldg(a.cscale + rB) : 0.f;
        for (int p = 0; p < panels; ++p, ++i) {
            const int s = i % a.stages;
            hop::mbar_wait(&full[s], (i / a.stages) & 1);
            const uint32_t c_addr = hop::smem_u32(ring + s * S8_PANEL) + wg * 64 * 128;
            const uint32_t b_addr = q_addr + p * QB * 128;
            const int ksteps = min(4, (a.D - p * 128) / 32);
            hop::wg_fence();
            for (int ks = 0; ks < ksteps; ++ks)
                hop::WgmmaS8<QB>::ss(acc, hop::desc_sw128(c_addr + ks * 32, 16),
                                     hop::desc_sw128(b_addr + ks * 32, 16), p | ks);
            hop::wg_commit();
            hop::wg_wait<0>();
            hop::fence_regs_s32<QB / 2>(acc);
            __syncwarp();
            if (lane == 0) hop::mbar_arrive(&empty[s]);
        }

        // filter in registers: a score can enter only if it is ordered
        // before its query's k-th (score desc, row asc) as of the last merge
        // (QB / 4 columns a thread); the survivors, rare after the first
        // tiles, wait in their query's slots (straight-line, predicated code:
        // no per-element branch), and the slots are merged into the lists
        // only when a survivor finds its query's slots full (it then tries
        // again against the merged list) and at the end of the range
        const bool liveA = rA < a.n_valid, liveB = rB < a.n_valid;
        uint64_t todo = ~0ull;
        for (bool first = true;; first = false) {
            float kth[QB / 8][2];
            int kid[QB / 8][2];
#pragma unroll
            for (int j = 0; j < QB / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    kth[j][h] = ls[(8 * j + 2 * tq + h) * a.k + a.k - 1];
                    kid[j][h] = li[(8 * j + 2 * tq + h) * a.k + a.k - 1];
                }
            uint64_t pass = 0;
#pragma unroll
            for (int e = 0; e < QB / 2; ++e) {
                const float sc = __fmul_rn(__int2float_rn(acc[e]), (e & 2) ? sB : sA);
                pass |= (uint64_t)(((e & 2) ? liveB : liveA) &&
                                   topk::better(sc, (e & 2) ? rB : rA, kth[e >> 2][e & 1],
                                                kid[e >> 2][e & 1])) << e;
            }
            todo &= pass;
            if (a.stats && first) {
                const int c = __reduce_add_sync(topk::FULL, __popcll(todo));
                if (lane == 0) atomicAdd(a.stats, c);
            }
            if (__any_sync(topk::FULL, todo != 0)) {
#pragma unroll
                for (int e = 0; e < QB / 2; ++e) {
                    const int col = 8 * (e >> 2) + 2 * tq + (e & 1);
                    int pos = S8_SLOTS;
                    if ((todo >> e) & 1) pos = atomicAdd(&cnt[col], 1);
                    if (pos < S8_SLOTS) {
                        cs[col * S8_SLOTS + pos] =
                            __fmul_rn(__int2float_rn(acc[e]), (e & 2) ? sB : sA);
                        ci[col * S8_SLOTS + pos] = (e & 2) ? rB : rA;
                        todo &= ~(1ull << e);
                    }                             // else slots full: after the merge
                }
            }
            if (!consumers_any(todo != 0)) break;
            if (a.stats && threadIdx.x == 0) atomicAdd(a.stats + 1, 1);
            merge_slots<QB>(ls, li, cs, ci, cnt, a.k, warp, lane);
            consumers_sync();
        }
    }
    if (a.stats && threadIdx.x == 0) atomicAdd(a.stats + 1, 1);
    merge_slots<QB>(ls, li, cs, ci, cnt, a.k, warp, lane);   // after the last consumers_any
    consumers_sync();

    // every merge ended with a consumer barrier: the lists are final
    const int nq = min(QB, a.b_pad - grp * QB);
    for (int idx = threadIdx.x; idx < nq * a.k; idx += S8_CONSUMERS * 128) {
        const int q = idx / a.k, j = idx % a.k;
        const size_t o = ((size_t)(grp * QB + q) * a.ranges + range) * a.k + j;
        a.part_s[o] = ls[idx];
        a.part_i[o] = li[idx];
    }
}

template <int QB>
int scan_launch(const void* q8, const void* c8, const ScanArgs& a, int groups, float* out_s,
                int* out_i, cudaStream_t st) {
    ScanMaps maps;
    int e;
    if ((e = hop_host::map_2d_s8(&maps.q, q8, a.b_pad, a.D, QB))) return e;
    if ((e = hop_host::map_2d_s8(&maps.c, c8, a.n_pad, a.D, S8_ROWS))) return e;
    const size_t smem = scan_smem(QB, a.D, a.k, a.stages);
    cudaError_t ce = cudaFuncSetAttribute(int8_scan_kernel<QB>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ce != cudaSuccess) return (int)ce;
    int8_scan_kernel<QB><<<dim3(a.ranges, groups), S8_THREADS, smem, st>>>(maps, a);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return (int)ce;
    topk::topk_merge_pass2<<<a.b_pad, 256, 0, st>>>(a.part_s, a.part_i, a.ranges, a.k, out_s,
                                                    out_i);
    return (int)cudaGetLastError();
}

}  // namespace

// q8 [b_pad, D] i8, c8 [n_pad, D] i8, cscale [n_pad] f32 -> [b_pad, k].
// qb (16, 32, 64 or 128) queries per block, groups = ceil(b_pad / qb) of
// them; ranges: blocks per group, each a contiguous range of the
// ceil(n_pad / 128) corpus tiles; stages: the ring's depth; part_s/part_i
// [b_pad, ranges, k] hold the blocks' lists; stats: null, or 2 int32 that
// gain the filter's survivors and the blocks' merge rounds. Needs D % 32 == 0,
// n_pad % 64 == 0, b_pad % 16 == 0 and 16-byte aligned q8, c8.
extern "C" int int8_topk(const void* q8, const void* c8, const void* cscale, int b_pad,
                         int D, int n_pad, int n_valid, int qb, int stages, int ranges, int k,
                         void* part_s, void* part_i, void* out_s, void* out_i, void* stats,
                         void* stream) {
    const int tiles = (n_pad + S8_ROWS - 1) / S8_ROWS;
    if (D % 32 || b_pad % 16 || k < 1 || k > KMAX || stages < 2 || ranges < 1 ||
        ranges > tiles || scan_smem(qb, D, k, stages) > 232448)
        return (int)cudaErrorInvalidValue;
    const int groups = (b_pad + qb - 1) / qb;
    ScanArgs a{(const float*)cscale, (float*)part_s, (int*)part_i, (int*)stats, D, n_pad,
               n_valid, b_pad, k, ranges, tiles, stages};
    cudaStream_t st = (cudaStream_t)stream;
    switch (qb) {
        case 16: return scan_launch<16>(q8, c8, a, groups, (float*)out_s, (int*)out_i, st);
        case 32: return scan_launch<32>(q8, c8, a, groups, (float*)out_s, (int*)out_i, st);
        case 64: return scan_launch<64>(q8, c8, a, groups, (float*)out_s, (int*)out_i, st);
        case 128: return scan_launch<128>(q8, c8, a, groups, (float*)out_s, (int*)out_i, st);
        default: return (int)cudaErrorInvalidValue;
    }
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
