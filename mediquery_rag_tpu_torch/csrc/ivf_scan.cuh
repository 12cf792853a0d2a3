// The Hopper IVF scan: pass 1 of every IVF kernel of ivf_topk.cu, B8a/B8b/B8c
// (query-major) and B9a/B9b/B9c (bucket-major), over bf16 or f32 buckets,
// int8 buckets and split-half packed int4 buckets, on the skeleton of the
// flat scan (scan.cuh) with its stages (float_stages.cuh, int_stages.cuh).
//
// What bounds it on an H100: reading the probed buckets' live rows. A row
// feeds one multiply-add per query that probes its bucket (int4: two): 1 to
// QB of them, far below the tensor cores' balance for bf16 and int8, and for
// f32 on the CUDA cores (20 operations a byte) below it too unless a bucket
// has more than ~40 probers. So the design reads only the live rows, and in
// the bucket-major layout each probed bucket's rows once for all its probers
// (B <= QB).
//
// Work items. The wrapper sorts the B * nprobe probers (query b, probe slot
// j; prober b * nprobe + j) by bucket ("positions" e, with pos_bucket[e] and
// pos_prober[e]). A chunk is a run of positions with one bucket u:
//   query-major: every position is its own chunk (one query);
//   bucket-major: a bucket's run cut into chunks of at most QB positions
//                 (chunk_plan below); the chunk's queries are rows e0 .. e0 +
//                 nq of the queries gathered in position order.
// A bucket's live extent (one past its last live slot; ops/ivf_kernel.py's
// ivf_extent) is cut into ntiles = ceil(rows / 128) tiles of its map rows
// (rows = extent; int4: min(extent, cap/2) packed rows, since packed row r
// holds slots r and r + cap/2), and the tiles
// into maxp pieces of equal size (p * ntiles / maxp ..): item (chunk h,
// piece p) = p * n_chunks + h. An item whose piece holds no tile still
// writes its (empty) lists, so every list that pass 2 reads was written. The
// grid is persistent (about one block per SM) and takes items in order from
// a counter (sched[0], an atomic add per item), so the items in flight are
// always neighbours: in the query-major layout the repeats of one bucket by
// other queries read its tiles at about the same time and meet in the L2,
// and a block that drew short items draws more. Each block counts itself
// out in sched[1]; the last one resets both, ready for the next launch.
//
// A block: the producer warp streams each item's tiles through a TMA ring
// of 128-byte K panels, each stage carrying the corpus panel of 128 slots
// and the chunk's query panel (QB rows from its first query row; the
// queries ride in the ring, as scan.cuh's qstream, because each item has its
// own), across item boundaries without a pause. Two consumer warpgroups
// score 64 rows each (the stage's wgmma or fmaf tile, only the live query
// groups for f32), load the doc id of each of their slots (int4: two a
// packed row; -1 at or past the extent or past the bucket's packed rows: a
// tile that reaches past them never scores the next bucket's rows) and run
// scan.cuh's filter on the key (score, doc id) with columns >= nq dead,
// survivors merged by rank. The integer stages take the item's bucket
// scales (scan::Args s0/s1 from the bucket's first slot, n_pad its rows);
// int4 takes each live column's corr from aux, filled at the item's start
// from corr at the chunk's query rows (bucket-major: the positions' rows, so
// the wrapper gathers corr as it gathers the queries).
// At the item's end the lists of its nq probers go to part[prober][p] and
// are emptied for the next item.
//
// Pass 2 (topk::topk_merge_heads, ivf_topk.cu) merges each query's nprobe *
// maxp lists under (score desc, doc id asc); short results end in (-inf, 0).

#pragma once

#include "scan.cuh"

namespace ivf {

constexpr int TILE = scan::ROWS;   // slots per tile, 64 per consumer warpgroup

struct Args {
    const int* bucket_ids;         // [nlist, cap] doc id of each slot, -1: empty or deleted
    const int* extent;             // [nlist] one past each bucket's last live slot
    const int* pos_bucket;         // [n_pos] bucket of each position
    const long long* pos_prober;   // [n_pos] prober of each position; null: the position
    const int* chunk_e0;           // bucket-major: [n_pos] first position of each chunk;
                                   // null: query-major, a chunk per position
    const int* n_chunks;           // bucket-major: the number of chunks
    int* sched;                    // [next item, blocks done], 0 at launch and at exit
    float* part_s;                 // [B * nprobe * maxp, k] pass 1's lists
    int* part_i;
    const float* scales;           // int8/int4: [nlist, cap] slot scales; null: float rows
    const float* corr;             // int4: [query rows] 8 * sum(q8) in query-map order; or null
    int row_bytes, cap, nprobe, n_pos, k, stages, maxp;
    int caph;                      // int4: cap / 2 (packed row r holds slots r and r + caph); 0
};

constexpr int IQ = 4;              // item numbers a producer may hand out ahead

// The slots a map row of stage S holds, S::SLOTS_PER_ROW where it declares
// it: the integer stages (int8 1, int4 2), which also take each item's
// bucket scales (int4: and its corr); 0 for the float stages, whose items
// need neither, so that their code is what it was before the integer stages.
template <class S, class = void>
struct SlotsPerRow {
    static constexpr int value = 0;
};
template <class S>
struct SlotsPerRow<S, decltype(void(S::SLOTS_PER_ROW))> {
    static constexpr int value = S::SLOTS_PER_ROW;
};

// Shared memory beside scan::smem_bytes(qb, .., qstream = 1) (which counts
// one spare barrier): the item queue's 2 IQ barriers and IQ item numbers.
constexpr int SCHED_SMEM = (2 * IQ - 1) * 8 + IQ * 4;

// One work item: bucket u, its chunk's first position e0 and nq probers,
// the row of its first query in the query map, its piece p, tiles [t0, t1)
// of its map rows, the bucket's slot extent r_end and its live map rows.
struct Item {
    int u, e0, nq, qrow, p, t0, t1, r_end, rows;
};

__device__ __forceinline__ int prober(const Args& a, int e) {
    return a.pos_prober ? (int)a.pos_prober[e] : e;
}

template <bool PACKED>
__device__ __forceinline__ Item item(const Args& a, int it, int n_chunks) {
    Item w;
    w.p = it / n_chunks;
    const int h = it - w.p * n_chunks;
    if (a.chunk_e0) {
        w.e0 = a.chunk_e0[h];
        w.nq = (h + 1 < n_chunks ? a.chunk_e0[h + 1] : a.n_pos) - w.e0;
        w.qrow = w.e0;
    } else {
        w.e0 = h;
        w.nq = 1;
        w.qrow = prober(a, h) / a.nprobe;
    }
    w.u = a.pos_bucket[w.e0];
    w.r_end = min(a.extent[w.u], a.cap);
    w.rows = PACKED ? min(w.r_end, a.caph) : w.r_end;
    const int nt = (w.rows + TILE - 1) / TILE;
    w.t0 = w.p * nt / a.maxp;
    w.t1 = (w.p + 1) * nt / a.maxp;
    return w;
}

// A consumer warp has read item queue slot `slot`.
__device__ __forceinline__ void release_item(uint64_t* qempty, int slot, int lane) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&qempty[slot]);
}

template <class S>
__global__ void __launch_bounds__(scan::THREADS, 1)
ivf_scan_kernel(const __grid_constant__ scan::Maps maps, const Args a) {
    constexpr int QB = S::QB, SPR = SlotsPerRow<S>::value;
    static_assert(S::NE <= 64, "a thread's entries are one 64-bit mask");
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    const int panels = (a.row_bytes + 127) / 128;
    const int sbytes = scan::stage_bytes(QB, 1);   // a multiple of 1024
    float* ls = reinterpret_cast<float*>(ring + a.stages * sbytes);
    int* li = reinterpret_cast<int*>(ls + QB * a.k);
    float* cs = reinterpret_cast<float*>(li + QB * a.k);
    int* ci = reinterpret_cast<int*>(cs + QB * scan::SLOTS);
    int* cnt = ci + QB * scan::SLOTS;
    float* aux = reinterpret_cast<float*>(cnt + QB);           // int4: the columns' corr
    uint64_t* full = reinterpret_cast<uint64_t*>(aux + QB);   // QB % 16 == 0: 8-byte aligned
    uint64_t* empty = full + a.stages;
    uint64_t* qfull = empty + a.stages;                          // the item queue
    uint64_t* qempty = qfull + IQ;
    int* itq = reinterpret_cast<int*>(qempty + IQ);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_chunks = a.chunk_e0 ? *a.n_chunks : a.n_pos;
    const int n_items = n_chunks * a.maxp;   // item it: piece it / n_chunks of chunk it % n_chunks

    if (threadIdx.x == 0) {
        for (int s = 0; s < a.stages; ++s) {
            hop::mbar_init(&full[s], 1);
            hop::mbar_init(&empty[s], scan::CONSUMERS * 4);
        }
        for (int s = 0; s < IQ; ++s) {
            hop::mbar_init(&qfull[s], 1);
            hop::mbar_init(&qempty[s], scan::CONSUMERS * 4);
        }
        hop::fence_barrier_init();
    }
    for (int i = threadIdx.x; i < QB * a.k; i += blockDim.x) {
        ls[i] = -CUDART_INF_F;
        li[i] = INT_MAX;
    }
    for (int i = threadIdx.x; i < QB; i += blockDim.x) {
        cnt[i] = 0;
        aux[i] = 0.f;
    }
    __syncthreads();

    if (warp == scan::CONSUMERS * 4) {
        // -------- producer: draws items, hands their numbers to the consumers, --------
        // -------- streams their tiles, each stage with the chunk's queries     --------
        if (lane == 0) {
            int i = 0;
            for (int n = 0;; ++n) {
                const int slot = n % IQ;
                hop::mbar_wait(&qempty[slot], ((n / IQ) & 1) ^ 1);
                const int it = atomicAdd(&a.sched[0], 1);
                itq[slot] = it;
                hop::mbar_arrive(&qfull[slot]);         // release: the consumers see itq
                if (it >= n_items) break;
                const Item w = item<SPR == 2>(a, it, n_chunks);
                const int row0 = w.u * (SPR == 2 ? a.caph : a.cap);
                for (int t = w.t0; t < w.t1; ++t)
                    for (int p = 0; p < panels; ++p, ++i) {
                        const int s = i % a.stages;
                        unsigned char* stage = ring + s * sbytes;
                        hop::mbar_wait(&empty[s], ((i / a.stages) & 1) ^ 1);
                        hop::mbar_expect_tx(&full[s], sbytes);
                        hop::tma_load_2d(stage, &maps.c, &full[s], p * 128, row0 + t * TILE);
                        hop::tma_load_2d(stage + scan::PANEL, &maps.q, &full[s], p * 128, w.qrow);
                    }
            }
            // every block draws once past the last item before it counts itself out,
            // so the last to count out may reset the counter for the next launch
            __threadfence();
            if (atomicAdd(&a.sched[1], 1) == (int)gridDim.x - 1) {
                atomicExch(&a.sched[0], 0);
                atomicExch(&a.sched[1], 0);
            }
        }
        return;
    }

    // ---------------- consumers: 64 rows x QB queries each ----------------
    const int wg = warp >> 2;
    S st(warp & 3, lane);
    auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[s]);
    };
    int i = 0;
    for (int n = 0;; ++n) {
        const int slot = n % IQ;
        hop::mbar_wait(&qfull[slot], (n / IQ) & 1);
        const int it = itq[slot];
        release_item(qempty, slot, lane);
        if (it >= n_items) break;
        const Item w = item<SPR == 2>(a, it, n_chunks);
        const int* slot_ids = a.bucket_ids + (size_t)w.u * a.cap;
        scan::Args ta{};                      // the item's bucket scales (integer stages)
        if constexpr (SPR > 0) {
            ta.s0 = a.scales + (size_t)w.u * a.cap;
            ta.s1 = ta.s0 + a.caph;
            ta.n_pad = w.rows;
        }
        if constexpr (SPR == 2) {             // the previous item's reads ended on a barrier
            for (int c = threadIdx.x; c < w.nq; c += scan::CONSUMERS * 128)
                aux[c] = a.corr[w.qrow + c];
            scan::consumers_sync();
        }
        for (int t = w.t0; t < w.t1; ++t) {
            st.begin(ta, t * TILE + wg * 64);
            int ids[S::NR];                   // loaded now, read after the sums
#pragma unroll
            for (int r = 0; r < S::NR; ++r) {
                const int lr = st.rowi(r);
                if constexpr (SPR == 2) {     // 2 * packed row + half: its slot
                    const int m = lr >> 1, s = m + (lr & 1) * a.caph;
                    ids[r] = m < w.rows && s < w.r_end ? slot_ids[s] : -1;
                } else {
                    ids[r] = lr < w.r_end ? slot_ids[lr] : -1;
                }
            }
            int held = -1;                    // ASYNC: the stage of the group in flight
            for (int p = 0; p < panels; ++p, ++i) {
                const int s = i % a.stages;
                hop::mbar_wait(&full[s], (i / a.stages) & 1);
                const uint32_t c_addr = hop::smem_u32(ring + s * sbytes);
                st.panel_live(c_addr + wg * 64 * 128, c_addr + scan::PANEL, p == 0, w.nq);
                if constexpr (S::ASYNC) {
                    hop::wg_wait<1>();        // every group but this panel's is done
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
            scan::filter_tile(st, ls, li, cs, ci, cnt, aux, a.k, warp, lane, nullptr,
                              [&](int e) {
                                  return st.query(st.qslot(e)) < w.nq ? ids[st.rsel(e)] : -1;
                              });
        }
        scan::merge_slots<QB>(ls, li, cs, ci, cnt, a.k, warp, lane);
        scan::consumers_sync();

        // the chunk's lists at piece p, then emptied for the next item (the
        // columns past nq were never touched)
        for (int idx = threadIdx.x; idx < w.nq * a.k; idx += scan::CONSUMERS * 128) {
            const int q = idx / a.k, j = idx - q * a.k;
            const size_t o = ((size_t)prober(a, w.e0 + q) * a.maxp + w.p) * a.k + j;
            a.part_s[o] = ls[idx];
            a.part_i[o] = li[idx];
            ls[idx] = -CUDART_INF_F;
            li[idx] = INT_MAX;
        }
        scan::consumers_sync();
    }
}

// Bucket-major chunks (one block of 1024 threads): from the positions'
// buckets sb[0, n_pos), sorted, the first position of every chunk, a new
// chunk at each bucket's first position and every qb positions after it;
// n_chunks[0] = their count. Positions go 1024 at a time: a max-scan of
// the bucket starts and a sum-scan of the chunk heads, carried over.
__global__ void __launch_bounds__(1024)
chunk_plan(const int* __restrict__ sb, int n_pos, int qb, int* __restrict__ chunk_e0,
           int* __restrict__ n_chunks) {
    __shared__ int wmax[32], wsum[32];
    __shared__ int carry[2];               // the last run's start, the chunks so far
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) carry[0] = carry[1] = 0;
    __syncthreads();
    for (int base = 0; base < n_pos; base += 1024) {
        const int e = base + tid;
        const bool in = e < n_pos;
        const bool first = in && (e == 0 || sb[e - 1] != sb[e]);
        int s = first ? e : 0;             // inclusive max-scan: the start of e's run
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(topk::FULL, s, o);
            if (lane >= o) s = max(s, v);
        }
        if (lane == 31) wmax[warp] = s;
        __syncthreads();
        if (warp == 0) {
            int x = wmax[lane];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(topk::FULL, x, o);
                if (lane >= o) x = max(x, v);
            }
            wmax[lane] = x;
        }
        __syncthreads();
        const int start = max(max(carry[0], s), warp > 0 ? wmax[warp - 1] : 0);
        const int head = in && (e - start) % qb == 0;
        int c = head;                      // inclusive sum-scan of the heads
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(topk::FULL, c, o);
            if (lane >= o) c += v;
        }
        if (lane == 31) wsum[warp] = c;
        __syncthreads();
        if (warp == 0) {
            int x = wsum[lane];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(topk::FULL, x, o);
                if (lane >= o) x += v;
            }
            wsum[lane] = x;
        }
        __syncthreads();
        const int before = carry[1] + (warp > 0 ? wsum[warp - 1] : 0) + c - head;
        if (head) chunk_e0[before] = e;
        __syncthreads();                   // every thread has read the carries
        if (tid == 0) {
            carry[0] = max(carry[0], wmax[31]);
            carry[1] += wsum[31];
        }
        __syncthreads();
    }
    if (tid == 0) *n_chunks = carry[1];
}

// Pass 1 at S::QB queries a chunk: tensor maps over the queries (q_rows
// rows, boxes of QB) and the buckets (rows, boxes of 128) as bytes, then the
// launch on grid blocks. Returns a cudaError_t or a hop_host error code.
template <class S>
int pass1(const void* q, int q_rows, const void* buckets, int rows, const Args& a, int grid,
          cudaStream_t st) {
    scan::Maps maps;
    int e;
    if ((e = hop_host::map_2d_bytes(&maps.q, q, q_rows, a.row_bytes, S::QB))) return e;
    if ((e = hop_host::map_2d_bytes(&maps.c, buckets, rows, a.row_bytes, TILE))) return e;
    const size_t smem = scan::smem_bytes(S::QB, a.row_bytes, a.k, a.stages, 1) + SCHED_SMEM;
    cudaError_t ce = cudaFuncSetAttribute(ivf_scan_kernel<S>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ce != cudaSuccess) return (int)ce;
    ivf_scan_kernel<S><<<grid, scan::THREADS, smem, st>>>(maps, a);
    return (int)cudaGetLastError();
}

// pass1<S<qb>> for qb in {16, 32, 64, 128} up to QBMAX, after the checks
// every entry point makes.
template <template <int> class S, int QBMAX = 128>
int dispatch(int qb, const void* q, int q_rows, const void* buckets, int rows, const Args& a,
             int grid, cudaStream_t st) {
    if (a.row_bytes % 16 || a.k < 1 || a.k > scan::KMAX || a.stages < 2 || a.maxp < 1 ||
        grid < 1 || a.n_pos < 1 || a.cap % 32 || !a.sched || qb > QBMAX ||
        (SlotsPerRow<S<16>>::value > 0 && !a.scales) ||
        (SlotsPerRow<S<16>>::value == 2 && (a.caph * 2 != a.cap || !a.corr)) ||
        scan::smem_bytes(qb, a.row_bytes, a.k, a.stages, 1) + SCHED_SMEM > scan::SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    switch (qb) {
        case 16: return pass1<S<16>>(q, q_rows, buckets, rows, a, grid, st);
        case 32:
            if constexpr (QBMAX >= 32) return pass1<S<32>>(q, q_rows, buckets, rows, a, grid, st);
            break;
        case 64:
            if constexpr (QBMAX >= 64) return pass1<S<64>>(q, q_rows, buckets, rows, a, grid, st);
            break;
        case 128:
            if constexpr (QBMAX >= 128)
                return pass1<S<128>>(q, q_rows, buckets, rows, a, grid, st);
            break;
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace ivf
