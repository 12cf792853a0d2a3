// The Hopper flat scan shared by B1 (flat_topk.cu: bf16 and f32 corpora),
// B2 and B3 (quant_topk.cu: int8 and row-pair-packed int4): exact top-k of
// a query batch over a padded corpus, in two passes.
//
// What bounds a scan on an H100: at B = 64 each corpus byte feeds 64
// multiply-adds (bf16: 32 a byte, int4: 128), below the tensor cores'
// compute/bandwidth balance, so the bf16/int8/int4 scans are bound by reading
// the corpus once (and its scales); the f32 scan does its sums on the CUDA
// cores (no TF32), whose balance is 20 operations a byte (67 TFLOP/s over
// 3.35 TB/s), so at B = 64 (32 a byte) it is bound by operations.
//
// Pass 1 (scan_kernel<Stage>): a persistent grid of about one block per SM.
// Block (r, g) walks the contiguous range r of the corpus's 128-row tiles
// (int4: byte-rows) for query group g of QB queries (the plan's qb; more
// queries take more groups). A producer warp loads the group's [QB x D]
// query tile once and streams the corpus tiles through a ring of 128-byte K
// panels with TMA (128-byte swizzle, completion on mbarriers), so every
// corpus byte is read once from device memory when B <= QB. Where even 16
// queries' tile does not fit beside the ring (f32 at D = 3072: 192 KB), the
// plan streams the queries too: each stage carries the query panel beside
// the corpus panel, re-read from the L2 for every tile (qstream). Two consumer
// warpgroups each score 64 rows of a tile against all QB queries: the Stage
// (a policy of the including file) computes the scores into registers panel
// by panel (wgmma for bf16/int8/int4, register-tiled fmaf for f32) and maps
// each of a thread's NE register entries to its (query, logical row, f32
// score). Each score is compared there with its query's running k-th
// (score, row) in shared memory; only the survivors go to per-query slots in
// shared memory. When a survivor finds its query's slots full (and at the
// end of the range) one warp per query merges the slots into the list by
// rank (survivors arrive in fragment order, so the merge orders them by
// (score desc, row asc); rows are unique, so the result does not depend on
// arrival order). At k = 10 over 1M rows the k-th rises fast, so a block
// merges a few times in its range; the merges overlap the producer's loads
// of the next tiles. Rows at or past n_valid never enter. Zero-padded query
// columns score 0 on every row, so the filter compares (score, row), never
// the score alone.
//
// Pass 2 (topk::topk_merge_pass2) merges the ranges' lists of each query
// under (score desc, row asc); short results end in (-inf, 0).
//
// The IVF scans B8a-B9c (ivf_scan.cuh) walk work items instead of a range
// on the same pieces: the ring, the stages, the filter (filter_tile, keyed
// there by doc id) and the merge by rank.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topk_merge.cuh"

namespace scan {

constexpr int ROWS = 128;                       // corpus rows per tile (64 per consumer)
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int PANEL = ROWS * 128;               // one 128-byte K panel of a tile: a stage
constexpr int SLOTS = 32;                       // survivors per query and merge round
constexpr int KMAX = topk::KMAX;
constexpr int SMEM_MAX = 232448;                // dynamic shared memory a block may use

struct Maps {
    CUtensorMap q, c;
};

struct Args {
    const float* s0;     // per-row scales (int8; int4 plane 0), or null
    const float* s1;     // int4: plane 1 (odd rows), or null
    const float* aux;    // int4: the queries' bias corrections [b_pad], or null
    float* part_s;
    int* part_i;
    int* stats;          // null, or [survivors of the filter, merge rounds] to add to
    int row_bytes;       // bytes of a query row and of a corpus row (D x element size)
    int qstream;         // 1: query panels ride in the ring beside the corpus panels
    int n_pad;           // corpus rows of the map (int4: byte-rows)
    int n_valid;         // logical rows that may enter
    int b_pad, k, ranges, tiles, stages;
};

// Bytes of one ring stage: a corpus panel (and, streamed, a query panel).
__host__ __device__ inline int stage_bytes(int qb, int qstream) {
    return PANEL + (qstream ? qb * 128 : 0);
}

// Dynamic shared memory of scan_kernel at qb queries a block: the resident
// query panels, the ring, the lists, the survivor slots, counts and the
// queries' aux values, the barriers, and 1024 bytes to align.
inline size_t smem_bytes(int qb, int row_bytes, int k, int stages, int qstream) {
    return 1024 + (qstream ? 0 : (size_t)(row_bytes + 127) / 128 * qb * 128)
           + (size_t)stages * stage_bytes(qb, qstream) + (size_t)qb * k * 8
           + (size_t)qb * SLOTS * 8 + (size_t)qb * 8 + (size_t)(2 * stages + 1) * 8;
}

// ---- shared-memory loads at a shared-space address ----
// (not volatile, so ptxas may schedule them; the memory clobber keeps them
// after the ring's mbarrier wait)
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t v;
    asm("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
    float4 v;
    asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
    return v;
}

// Byte offset of 16-byte chunk c of row r in a 128-byte swizzled panel.
__device__ __forceinline__ uint32_t sw_chunk(int r, int c) {
    return r * 128 + (((c ^ r) & 7) << 4);
}

// ---- the wgmma accumulator layout (m64nN, f32 or s32) ----
// Lane (g = lane / 4, tq = lane % 4) of warp w4 holds rows w4*16 + g (rA)
// and rA + 8 of the warpgroup's 64, and accumulator a holds row
// (a & 2 ? rA + 8 : rA), query 8 (a / 4) + 2 tq + (a & 1): QB / 4 distinct
// queries a thread, slot j = query 8 (j / 2) + 2 tq + (j & 1).
__device__ __forceinline__ int wg_query(int j, int tq) { return 8 * (j >> 1) + 2 * tq + (j & 1); }
__device__ __forceinline__ int wg_slot(int a) { return ((a >> 2) << 1) | (a & 1); }

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS * 128) : "memory");
}

// A barrier of the consumer threads that also tells each whether any of
// them passed p = true.
__device__ __forceinline__ bool consumers_any(bool p) {
    int r;
    asm volatile(
        "{\n.reg .pred pi, po;\nsetp.ne.b32 pi, %1, 0;\n"
        "bar.red.or.pred po, 1, %2, pi;\nselp.b32 %0, 1, 0, po;\n}\n"
        : "=r"(r) : "r"((int)p), "n"(CONSUMERS * 128) : "memory");
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
    for (int q = warp; q < QB; q += CONSUMERS * 4) {
        const int nq = min(cnt[q], SLOTS);
        if (nq == 0) continue;
        merge_candidates(ls + q * k, li + q * k, k, cs + q * SLOTS, ci + q * SLOTS, nq);
        if (lane == 0) cnt[q] = 0;
    }
}

// The filter of one tile (after its sums are final), shared by scan_kernel
// and the IVF scans (ivf_scan.cuh): entry e of the stage may enter with the
// key (score, id(e)) when id(e) >= 0 (a row below n_valid; an IVF slot's doc
// id, -1 for an empty slot or a dead query column) and the key is ordered
// before its query's k-th (score desc, id asc) as of the last merge; the
// survivors, rare after the first tiles, wait in their query's slots
// (straight-line, predicated code: no per-element branch), and the slots are
// merged into the lists only when a survivor finds its query's slots full
// (it then tries again against the merged list); the caller merges what is
// left at the end of its range. stats: null, or [survivors, merge rounds] to
// add to. Every consumer thread calls it (it ends on a consumer barrier).
template <class S, class Id>
__device__ __forceinline__ void filter_tile(const S& st, float* ls, int* li, float* cs, int* ci,
                                            int* cnt, const float* aux, int k, int warp,
                                            int lane, int* stats, Id id) {
    uint64_t todo = ~0ull;
    for (bool first = true;; first = false) {
        float kth[S::NQ];
        int kid[S::NQ];
#pragma unroll
        for (int j = 0; j < S::NQ; ++j) {
            kth[j] = ls[st.query(j) * k + k - 1];
            kid[j] = li[st.query(j) * k + k - 1];
        }
        uint64_t pass = 0;
#pragma unroll
        for (int e = 0; e < S::NE; ++e) {
            const int r = id(e);
            pass |= (uint64_t)(r >= 0 && topk::better(st.score(e, aux), r, kth[st.qslot(e)],
                                                      kid[st.qslot(e)])) << e;
        }
        todo &= pass;
        if (stats && first) {
            const int c = __reduce_add_sync(topk::FULL, __popcll(todo));
            if (lane == 0) atomicAdd(stats, c);
        }
        if (__any_sync(topk::FULL, todo != 0)) {
#pragma unroll
            for (int e = 0; e < S::NE; ++e) {
                const int col = st.query(st.qslot(e));
                int pos = SLOTS;
                if ((todo >> e) & 1) pos = atomicAdd(&cnt[col], 1);
                if (pos < SLOTS) {
                    cs[col * SLOTS + pos] = st.score(e, aux);
                    ci[col * SLOTS + pos] = id(e);
                    todo &= ~(1ull << e);
                }                             // else slots full: after the merge
            }
        }
        if (!consumers_any(todo != 0)) break;
        if (stats && threadIdx.x == 0) atomicAdd(stats + 1, 1);
        merge_slots<S::QB>(ls, li, cs, ci, cnt, k, warp, lane);
        consumers_sync();
    }
}

// A Stage S (S::QB queries a block) gives each consumer thread S::NE <= 64
// entries of a tile over S::NQ distinct queries:
//   S(w4, lane)                      the thread's place in its warpgroup
//   begin(a, row0)                   a tile whose warpgroup rows start at row0
//   panel(c_addr, q_addr, first)     fold one whole K panel in (TMA fills the
//                                    bytes past a row's end with zeros, which
//                                    add nothing); first: the tile's first
//   settle()                         the tile's sums are final (S::ASYNC)
//   query(j), qslot(e), row(e)       query of slot j; slot and logical row of entry e
//   score(e, aux)                    entry e's f32 score (aux: the group's aux values)
// An S::ASYNC stage only issues its panel's wgmma group: the consumers wait
// for the group before last, release that panel's stage and go on to the
// next panel, so the tensor cores see the next products while a stage is
// handed back; its sums are read after the tile's last group (settle).
template <class S>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ Maps maps, const Args a) {
    constexpr int QB = S::QB;
    static_assert(S::NE <= 64, "a thread's entries are one 64-bit mask");
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    const int panels = (a.row_bytes + 127) / 128;
    const int sbytes = stage_bytes(QB, a.qstream);   // a multiple of 1024
    unsigned char* Qs = smem;
    unsigned char* ring = Qs + (a.qstream ? 0 : panels * QB * 128);
    float* ls = reinterpret_cast<float*>(ring + a.stages * sbytes);
    int* li = reinterpret_cast<int*>(ls + QB * a.k);
    float* cs = reinterpret_cast<float*>(li + QB * a.k);
    int* ci = reinterpret_cast<int*>(cs + QB * SLOTS);
    int* cnt = ci + QB * SLOTS;
    float* aux = reinterpret_cast<float*>(cnt + QB);
    uint64_t* full = reinterpret_cast<uint64_t*>(aux + QB);   // QB % 16 == 0: 8-byte aligned
    uint64_t* empty = full + a.stages;
    uint64_t* qbar = empty + a.stages;

    const int range = blockIdx.x, grp = blockIdx.y;
    const int t0 = (int)((long long)range * a.tiles / a.ranges);
    const int t1 = (int)((long long)(range + 1) * a.tiles / a.ranges);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < a.stages; ++s) {
            hop::mbar_init(&full[s], 1);
            hop::mbar_init(&empty[s], CONSUMERS * 4);
        }
        hop::mbar_init(qbar, 1);
        hop::fence_barrier_init();
    }
    for (int i = threadIdx.x; i < QB * a.k; i += blockDim.x) {
        ls[i] = -CUDART_INF_F;
        li[i] = INT_MAX;
    }
    for (int i = threadIdx.x; i < QB; i += blockDim.x) {
        cnt[i] = 0;
        aux[i] = a.aux && grp * QB + i < a.b_pad ? a.aux[grp * QB + i] : 0.f;
    }
    __syncthreads();

    if (warp == CONSUMERS * 4) {
        // ---------------- producer: the query tile once, then the corpus ring ----------------
        if (lane == 0) {
            if (a.qstream) {
                hop::mbar_arrive(qbar);
            } else {
                hop::mbar_expect_tx(qbar, panels * QB * 128);
                for (int p = 0; p < panels; ++p)
                    hop::tma_load_2d(Qs + p * QB * 128, &maps.q, qbar, p * 128, grp * QB);
            }
            int i = 0;
            for (int t = t0; t < t1; ++t)
                for (int p = 0; p < panels; ++p, ++i) {
                    const int s = i % a.stages;
                    unsigned char* stage = ring + s * sbytes;
                    hop::mbar_wait(&empty[s], ((i / a.stages) & 1) ^ 1);
                    hop::mbar_expect_tx(&full[s], sbytes);
                    hop::tma_load_2d(stage, &maps.c, &full[s], p * 128, t * ROWS);
                    if (a.qstream)
                        hop::tma_load_2d(stage + PANEL, &maps.q, &full[s], p * 128, grp * QB);
                }
        }
        return;
    }

    // ---------------- consumers: 64 corpus rows x QB queries each ----------------
    const int wg = warp >> 2;
    S st(warp & 3, lane);
    const uint32_t q_addr = hop::smem_u32(Qs);
    hop::mbar_wait(qbar, 0);

    auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[s]);
    };
    int i = 0;
    for (int t = t0; t < t1; ++t) {
        st.begin(a, t * ROWS + wg * 64);
        int held = -1;                        // ASYNC: the stage of the group in flight
        for (int p = 0; p < panels; ++p, ++i) {
            const int s = i % a.stages;
            hop::mbar_wait(&full[s], (i / a.stages) & 1);
            const uint32_t c_addr = hop::smem_u32(ring + s * sbytes);
            st.panel(c_addr + wg * 64 * 128, a.qstream ? c_addr + PANEL : q_addr + p * QB * 128,
                     p == 0);
            if constexpr (S::ASYNC) {
                hop::wg_wait<1>();            // every group but this panel's is done
                if (held >= 0) release(held);
                held = s;
            } else {
                release(s);
            }
        }
        if constexpr (S::ASYNC) {
            hop::wg_wait<0>();
            st.settle();
            release(held);
        }

        filter_tile(st, ls, li, cs, ci, cnt, aux, a.k, warp, lane, a.stats, [&](int e) {
            const int r = st.row(e);
            return r < a.n_valid ? r : -1;
        });
    }
    if (a.stats && threadIdx.x == 0) atomicAdd(a.stats + 1, 1);
    merge_slots<QB>(ls, li, cs, ci, cnt, a.k, warp, lane);   // after the last consumers_any
    consumers_sync();

    // every merge ended with a consumer barrier: the lists are final
    const int nq = min(QB, a.b_pad - grp * QB);
    for (int idx = threadIdx.x; idx < nq * a.k; idx += CONSUMERS * 128) {
        const int q = idx / a.k, j = idx % a.k;
        const size_t o = ((size_t)(grp * QB + q) * a.ranges + range) * a.k + j;
        a.part_s[o] = ls[idx];
        a.part_i[o] = li[idx];
    }
}

// Pass 1 and pass 2 of one scan at S::QB queries a block (a.b_pad / QB
// groups, rounded up): tensor maps over the queries and the corpus as bytes,
// then the launches. Returns a cudaError_t or a hop_host error code.
template <class S>
int run(const void* q, const void* c, const Args& a, float* out_s, int* out_i,
        cudaStream_t st) {
    Maps maps;
    int e;
    if ((e = hop_host::map_2d_bytes(&maps.q, q, a.b_pad, a.row_bytes, S::QB))) return e;
    if ((e = hop_host::map_2d_bytes(&maps.c, c, a.n_pad, a.row_bytes, ROWS))) return e;
    const size_t smem = smem_bytes(S::QB, a.row_bytes, a.k, a.stages, a.qstream);
    cudaError_t ce = cudaFuncSetAttribute(scan_kernel<S>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ce != cudaSuccess) return (int)ce;
    const int groups = (a.b_pad + S::QB - 1) / S::QB;
    scan_kernel<S><<<dim3(a.ranges, groups), THREADS, smem, st>>>(maps, a);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return (int)ce;
    topk::topk_merge_pass2<<<a.b_pad, 256, 0, st>>>(a.part_s, a.part_i, a.ranges, a.k, out_s,
                                                    out_i);
    return (int)cudaGetLastError();
}

// The checks every scan's entry point makes before run<S>.
inline bool args_ok(const Args& a, int qb) {
    return a.row_bytes % 16 == 0 && a.b_pad % 16 == 0 && a.k >= 1 && a.k <= KMAX &&
           a.stages >= 2 && a.ranges >= 1 && a.ranges <= a.tiles &&
           a.tiles == (a.n_pad + ROWS - 1) / ROWS &&
           smem_bytes(qb, a.row_bytes, a.k, a.stages, a.qstream) <= SMEM_MAX;
}

// The entry point's dispatch on qb: run<S<qb>> for qb in {16, 32, 64(, 128)}.
template <template <int> class S, bool QB128>
int dispatch(int qb, const void* q, const void* c, const Args& a, void* out_s, void* out_i,
             void* stream) {
    if (!args_ok(a, qb)) return (int)cudaErrorInvalidValue;
    float* os = (float*)out_s;
    int* oi = (int*)out_i;
    cudaStream_t st = (cudaStream_t)stream;
    switch (qb) {
        case 16: return run<S<16>>(q, c, a, os, oi, st);
        case 32: return run<S<32>>(q, c, a, os, oi, st);
        case 64: return run<S<64>>(q, c, a, os, oi, st);
        case 128:
            if constexpr (QB128) return run<S<128>>(q, c, a, os, oi, st);
            return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace scan
