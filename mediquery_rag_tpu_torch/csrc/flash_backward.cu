// Causal flash attention backward (bf16 in, bf16 gradients, f32 softmax state and sums).
//
// Replaces the two Pallas passes of mediquery_rag_tpu/ops/attention.py run by
// _flash_bwd_call (:663-771), the VJP of flash_attention (_flash_mha, :792-819):
//   * B10a flash_bwd_dq  <- _flash_dq_kernel (:532, launched at :718): dQ and
//     the per-row logsumexp, KV-minor;
//   * B10b flash_bwd_dkv <- _flash_dkv_kernel (:602, launched at :744): dK and
//     dV, Q-minor, P rebuilt from B10a's logsumexp.
// D = rowsum(dO * O) is computed outside in f32 (attention.py:686).
//
// Semantics kept from the TPU kernels:
//   * GQA fold: the g = H / KH query heads of one KV head are stacked along
//     the row axis (folded row r -> head kh*g + r / S, position r % S), so a
//     block of B10b sums its KV head's gradient over the whole query group
//     with no atomics;
//   * visibility: key c is visible to the query at position p of batch b iff
//     key_mask[b, c] > 0 and c <= p; invisible logits get the forward's -1e9
//     bias, so a row with no visible key stays finite (its dO is 0 upstream,
//     so it gives dQ = 0 and adds nothing to dK/dV);
//   * dS = P (dP - D) scale, cast to bf16 before dQ and dK; P cast to bf16
//     before dV (attention.py:579, :635, :640). B10a keeps P un-normalized
//     with the forward's running-max rescale and divides dQ by l at the end;
//   * KV tiles wholly above the diagonal of a query tile are skipped.
// B10a's tiles are row-major (query rows); B10b computes S^T = K Q^T, as the
// TPU kernel does, because its keys are the rows of its wgmma products.
//
// B10a (flash_bwd_dq), designed for Hopper: one block of 3 warpgroups per
// (b, KV head, 128 folded query rows). What bounds it: ~6 * visible pairs *
// dh flops (S, dP and dQ products) against ~(2H + 2KH) * S * dh * 2 bytes,
// so the tensor cores at training lengths.
//   * the producer warpgroup gives its registers away (setmaxnreg); one
//     thread loads the block's Q and dO tiles and D rows once (TMA,
//     128-byte swizzle) and keeps a 3-stage ring of 64-key K and V tiles in
//     flight, each with its key-mask row;
//   * each consumer warpgroup owns 64 rows: S = Q K^T and dP = dO V^T by
//     wgmma into registers (both operands K-major), the online softmax on
//     the accumulator fragments (running max and denominator per row, P
//     un-normalized), dS = P (dP - D) scale packed to bf16 in registers as
//     the A operand of dQ += dS K (K MN-major through the descriptor's
//     transpose); the f32 dQ accumulator (64 x dh) stays in registers over
//     the whole loop and is rescaled there; the epilogue writes dQ / l and
//     lse = m + log l;
//   * key tiles wholly above the diagonal of the block's rows are never
//     loaded, and row tiles launch heaviest (latest positions) first;
//   * each block owns its rows' dQ (no atomics: the same bits every run).
//     B * KH * (g*S / 128) blocks: 896 at 7B widths (28q/4kv, S=4096) and
//     768 at the 1B-class training shape (B=8, S=768, 16 heads), so no
//     split of the key range is needed.
//
// B10b (flash_bwd_dkv), designed for Hopper: one block of 3 warpgroups per
// (b, KV head, 128 keys[, share of the query heads]). What bounds it: ~8 *
// visible pairs * dh flops against ~4 * S * dh * H bytes, so the tensor
// cores at training lengths.
//   * K and V of the block stay in shared memory (TMA, 128-byte swizzle);
//     the producer warpgroup gives its registers away (setmaxnreg) and one
//     thread keeps a 2-stage TMA ring of the group's Q and dO tiles (64
//     folded rows; one 3-D tensor map each, since the fold makes each KV
//     head's rows one [g*S, dh] matrix) with their lse and D rows;
//   * each consumer warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T by
//     wgmma into registers; P^T = exp(S^T scale + bias - lse) and dS^T =
//     P^T (dP^T - D) scale in registers; dV += bf16(P^T) dO and dK +=
//     bf16(dS^T) Q by wgmma with P^T and dS^T as register A operands (dO and
//     Q MN-major through the descriptor's transpose); dK and dV stay in
//     registers over the whole loop;
//   * only query tiles at or below the diagonal are walked, and key tile 0
//     (the heaviest) launches first;
//   * where B * KH * key tiles is under two waves (7B-class GQA, 28q/4kv),
//     each KV head's query heads are split over nsplit blocks that write f32
//     partial dK/dV; a second kernel sums the parts in order into bf16, so
//     the result does not change from run to run (no atomics).
#include "hopper.cuh"
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ---------------- B10a: dQ and the row logsumexp (wgmma from a TMA-fed ring) ----------------

namespace dq {

constexpr int BQ = 128;              // folded query rows per block (64 per consumer warpgroup)
constexpr int BK = 64;               // keys per ring tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int NST = 3;               // K/V ring stages
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr uint32_t align1024(uint32_t x) { return (x + 1023u) & ~1023u; }

template <int DH>
struct Cfg {
    static constexpr uint32_t QT_BYTES = BQ * DH * 2;       // the block's Q or dO
    static constexpr uint32_t KV_BYTES = BK * DH * 2;       // one K or V tile
    static constexpr uint32_t ROWS_OFF = 2 * QT_BYTES;      // D of the block's rows
    static constexpr uint32_t RING_OFF = align1024(ROWS_OFF + BQ * 4);
    static constexpr uint32_t MASK_OFF = 2 * KV_BYTES;      // in a stage: the tile's mask row
    static constexpr uint32_t STAGE = align1024(MASK_OFF + BK * 4);
    static constexpr uint32_t SMEM = RING_OFF + NST * STAGE + 128 + 1024;
};

struct Maps {
    CUtensorMap q, dout, k, v, mask, D;
};

struct Args {
    __nv_bfloat16* dq;
    float* lse;
    int H, KH, S, Sk;
    float scale;
};

// Highest and lowest position among folded rows [r0, rl] (S rows per head).
__device__ __forceinline__ int rows_pmax(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? rl % S : S - 1;
}
__device__ __forceinline__ int rows_pmin(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? r0 % S : 0;
}

// Row tile of launch slot y, heaviest (latest positions, most keys) first:
// with whole tiles per head, the last tile of every head of the group, then
// the one before, ...; otherwise simply the last tile first.
__device__ __forceinline__ int row_tile(int y, int ntiles, int S, int g) {
    if (S % BQ == 0) {
        const int per = S / BQ;
        return (y % g) * per + per - 1 - y / g;
    }
    return ntiles - 1 - y;
}

// Block (b, KV head, 128 folded query rows): walks the key tiles at or
// below the diagonal of its rows.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const Args a) {
    using C = Cfg<DH>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    unsigned char* Qs = smem;
    unsigned char* dOs = smem + C::QT_BYTES;
    float* Ds = reinterpret_cast<float*>(smem + C::ROWS_OFF);
    unsigned char* stages = smem + C::RING_OFF;
    uint64_t* full = reinterpret_cast<uint64_t*>(stages + NST * C::STAGE);
    uint64_t* empty = full + NST;
    uint64_t* qbar = empty + NST;

    const int S = a.S, Sk = a.Sk;
    const int g = a.H / a.KH;
    const int R = g * S;
    const int bkh = blockIdx.x;
    const int b = bkh / a.KH;
    const int r0 = row_tile(blockIdx.y, gridDim.y, S, g) * BQ;
    // keys past the block's highest position are invisible to all its rows
    const int kend = max(1, min(Sk, rows_pmax(r0, min(r0 + BQ, R) - 1, S) + 1));
    const int ntk = (kend + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NST; ++s) {
            hop::mbar_init(&full[s], 1);
            hop::mbar_init(&empty[s], CONSUMERS * 4);
        }
        hop::mbar_init(qbar, 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == CONSUMERS) {
        // ---------------- producer ----------------
        hop::reg_dealloc<40>();
        if (threadIdx.x == CONSUMERS * 128) {
            hop::mbar_expect_tx(qbar, 2 * C::QT_BYTES + BQ * 4);
#pragma unroll
            for (int p = 0; p < DH / 64; ++p) {
                hop::tma_load_3d(Qs + p * BQ * 128, &maps.q, qbar, p * 64, r0, bkh);
                hop::tma_load_3d(dOs + p * BQ * 128, &maps.dout, qbar, p * 64, r0, bkh);
            }
            hop::tma_load_row(Ds, &maps.D, qbar, r0, bkh);
            for (int t = 0; t < ntk; ++t) {
                const int s = t % NST;
                const int ph = (t / NST) & 1;
                unsigned char* st = stages + s * C::STAGE;
                hop::mbar_wait(&empty[s], ph ^ 1);
                hop::mbar_expect_tx(&full[s], 2 * C::KV_BYTES + BK * 4);
#pragma unroll
                for (int p = 0; p < DH / 64; ++p) {
                    hop::tma_load_3d(st + p * BK * 128, &maps.k, &full[s], p * 64, t * BK, bkh);
                    hop::tma_load_3d(st + C::KV_BYTES + p * BK * 128, &maps.v, &full[s], p * 64,
                                     t * BK, bkh);
                }
                hop::tma_load_row(st + C::MASK_OFF, &maps.mask, &full[s], t * BK, b);
            }
        }
    } else {
        // ---------------- consumers: 64 folded rows each ----------------
        hop::reg_alloc<232>();
        const int w4 = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int wr0 = r0 + 64 * wg;                    // first row of this warpgroup
        const int ra = wr0 + 16 * w4 + lane / 4;          // this thread's rows ra, ra + 8
        const int rb = ra + 8;
        const bool idle = wr0 >= R;
        const int wl = min(wr0 + 64, R) - 1;
        const int pmax_wg = idle ? -1 : rows_pmax(wr0, wl, S);
        const int pmin_wg = idle ? 0 : rows_pmin(wr0, wl, S);
        const int lim_a = ra % S, lim_b = rb % S;         // last visible key of each row
        const float scale = a.scale;

        float acc[DH / 2];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
        float ma = NEG_BIG, mb = NEG_BIG, la = 0.f, lb = 0.f;
        const uint32_t q_addr = hop::smem_u32(Qs) + wg * 64 * 128;
        const uint32_t do_addr = hop::smem_u32(dOs) + wg * 64 * 128;
        hop::mbar_wait(qbar, 0);
        const float Da = Ds[ra - r0], Db = Ds[rb - r0];   // rows past R read 0

        for (int t = 0; t < ntk; ++t) {
            const int s = t % NST;
            const int ph = (t / NST) & 1;
            unsigned char* st = stages + s * C::STAGE;
            const int k0 = t * BK;
            hop::mbar_wait(&full[s], ph);
            if (!idle && k0 <= pmax_wg) {
                const uint32_t k_addr = hop::smem_u32(st);
                const uint32_t v_addr = k_addr + C::KV_BYTES;
                float sc[BK / 2], dp[BK / 2];
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)      // S = Q K^T
                    hop::Wgmma<BK>::ss(
                        sc, hop::desc_sw128(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
                        hop::desc_sw128(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16), kk);
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)      // dP = dO V^T
                    hop::Wgmma<BK>::ss(
                        dp, hop::desc_sw128(do_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
                        hop::desc_sw128(v_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16), kk);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<BK / 2>(sc);
                hop::fence_regs<BK / 2>(dp);

                // online softmax: the forward's -1e9 bias on invisible keys, the
                // causal test only on tiles that cross a row's diagonal
                const bool diag = k0 + BK - 1 > pmin_wg;
                const float* mrow = reinterpret_cast<const float*>(st + C::MASK_OFF);
                float mxa = NEG_BIG, mxb = NEG_BIG;
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    const int col = 8 * j + 2 * (lane & 3);
                    const float2 mv = *reinterpret_cast<const float2*>(mrow + col);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int key = k0 + col + e;
                        const bool live = key < Sk && (e ? mv.y : mv.x) > 0.f;
                        const bool va = live && (!diag || key <= lim_a);
                        const bool vb = live && (!diag || key <= lim_b);
                        float& sa = sc[4 * j + e];
                        float& sb = sc[4 * j + 2 + e];
                        sa = sa * scale + (va ? 0.f : -1e9f);
                        sb = sb * scale + (vb ? 0.f : -1e9f);
                        mxa = fmaxf(mxa, sa);
                        mxb = fmaxf(mxb, sb);
                    }
                }
#pragma unroll
                for (int o_ = 1; o_ < 4; o_ <<= 1) {
                    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o_));
                    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o_));
                }
                const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
                const float ca = exp2f((ma - na) * LOG2E), cb = exp2f((mb - nb) * LOG2E);
                ma = na;
                mb = nb;
                // P un-normalized; dS = P (dP - D) scale, rounded to bf16 as the A
                // operand of dQ += dS K
                float sa = 0.f, sb = 0.f;
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float pa = exp2f((sc[4 * j + e] - na) * LOG2E);
                        const float pb = exp2f((sc[4 * j + 2 + e] - nb) * LOG2E);
                        sa += pa;
                        sb += pb;
                        sc[4 * j + e] = pa * (dp[4 * j + e] - Da) * scale;
                        sc[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - Db) * scale;
                    }
                }
                la = la * ca + sa;
                lb = lb * cb + sb;
                uint32_t df[BK / 16][4];
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                    for (int x = 0; x < 4; ++x)
                        df[kk][x] = hop::pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
                }
#pragma unroll
                for (int i = 0; i < DH / 2; ++i) acc[i] *= ((i >> 1) & 1) ? cb : ca;
                hop::fence_regs<DH / 2>(acc);
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)      // dQ += dS K (K MN-major)
                    hop::Wgmma<DH>::rs(acc, df[kk], hop::desc_sw128(k_addr + kk * 2048, BK * 128),
                                       1);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<DH / 2>(acc);
            }
            __syncwarp();
            if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&empty[s]);
        }

        // ---------------- epilogue: dQ / l in bf16, lse = m + log l ----------------
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
            la += __shfl_xor_sync(0xffffffffu, la, o_);
            lb += __shfl_xor_sync(0xffffffffu, lb, o_);
        }
        // dq and lse have q's layout, so the folded rows of (b, kh) are contiguous
        __nv_bfloat16* ob = a.dq + (size_t)bkh * R * DH;
        const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
            const int col = 8 * j + 2 * (lane & 3);
            if (ra < R)
                *reinterpret_cast<uint32_t*>(ob + (size_t)ra * DH + col) =
                    hop::pack_bf16(acc[4 * j] * ia, acc[4 * j + 1] * ia);
            if (rb < R)
                *reinterpret_cast<uint32_t*>(ob + (size_t)rb * DH + col) =
                    hop::pack_bf16(acc[4 * j + 2] * ib, acc[4 * j + 3] * ib);
        }
        if ((lane & 3) == 0) {
            if (ra < R) a.lse[(size_t)bkh * R + ra] = ma + logf(la);
            if (rb < R) a.lse[(size_t)bkh * R + rb] = mb + logf(lb);
        }
    }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
           const void* D, void* dq, void* lse, int B, int H, int KH, int S, int Sk, float scale,
           cudaStream_t st) {
    using C = Cfg<DH>;
    const int g = H / KH;
    Maps maps;
    int e;
    if ((e = hop_host::map_3d(&maps.q, q, false, B * KH, g * S, DH, BQ, 64))) return e;
    if ((e = hop_host::map_3d(&maps.dout, dout, false, B * KH, g * S, DH, BQ, 64))) return e;
    if ((e = hop_host::map_3d(&maps.k, k, false, B * KH, Sk, DH, BK, 64))) return e;
    if ((e = hop_host::map_3d(&maps.v, v, false, B * KH, Sk, DH, BK, 64))) return e;
    if ((e = hop_host::map_rows_f32(&maps.mask, mask, B, Sk, BK))) return e;
    if ((e = hop_host::map_rows_f32(&maps.D, D, B * KH, g * S, BQ))) return e;
    cudaError_t ce = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    Args args{(__nv_bfloat16*)dq, (float*)lse, H, KH, S, Sk, scale};
    flash_bwd_dq_kernel<DH><<<dim3(B * KH, (g * S + BQ - 1) / BQ), THREADS, C::SMEM, st>>>(
        maps, args);
    return (int)cudaGetLastError();
}

}  // namespace dq

// ---------------- B10b: dK, dV (wgmma from a TMA-fed ring) ----------------

namespace dkv {

constexpr int BKB = 128;             // keys per block (64 per consumer warpgroup)
constexpr int BQB = 64;              // folded query rows per ring tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int NST = 2;               // Q/dO ring stages
constexpr float LOG2E = 1.4426950408889634f;

constexpr uint32_t align1024(uint32_t x) { return (x + 1023u) & ~1023u; }

template <int DH>
struct Cfg {
    static constexpr uint32_t KV_BYTES = BKB * DH * 2;     // K or V of the block
    static constexpr uint32_t QT_BYTES = BQB * DH * 2;     // one Q or dO tile
    static constexpr uint32_t ROWS_OFF = 2 * QT_BYTES;     // lse, then D, of the tile
    static constexpr uint32_t STAGE = align1024(ROWS_OFF + 2 * BQB * 4);
    static constexpr uint32_t SMEM = 2 * KV_BYTES + NST * STAGE + BKB * 4 + 128 + 1024;
};

struct Maps {
    CUtensorMap q, dout, k, v, mask, lse, D;
};

struct Args {
    __nv_bfloat16* dk;
    __nv_bfloat16* dv;
    float* part_k;       // [nsplit, B*KH, Sk, DH] (nsplit > 1)
    float* part_v;
    int H, KH, S, Sk, nsplit;
    float scale;
};

__device__ __forceinline__ int rows_pmax(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? rl % S : S - 1;
}
__device__ __forceinline__ int rows_pmin(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? r0 % S : 0;
}

// Block (b, kh, query-head part hs of nsplit, key tile blockIdx.y): key tile
// 0, which every query row sees, launches first. The block's query rows are
// folded rows [Rb, Re) of its KV head: its nsplit-th share of the group's
// heads. Query tiles start at multiples of 64 rows (TMA reads the lse and D
// rows at 16-byte aligned offsets), so a part's first and last tiles may
// hold rows of the neighbouring parts, which add nothing here.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const Args a) {
    using C = Cfg<DH>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    unsigned char* Ks = smem;
    unsigned char* Vs = smem + C::KV_BYTES;
    unsigned char* stages = smem + 2 * C::KV_BYTES;
    float* mask_s = reinterpret_cast<float*>(stages + NST * C::STAGE);
    uint64_t* full = reinterpret_cast<uint64_t*>(mask_s + BKB);
    uint64_t* empty = full + NST;
    uint64_t* kvbar = empty + NST;

    const int S = a.S, Sk = a.Sk;
    const int g = a.H / a.KH;
    const int bkh = blockIdx.x / a.nsplit;
    const int hs = blockIdx.x % a.nsplit;
    const int b = bkh / a.KH;
    const int k0 = blockIdx.y * BKB;
    const int gs = g / a.nsplit;
    const int Rb = hs * gs * S, Re = Rb + gs * S;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NST; ++s) {
            hop::mbar_init(&full[s], 1);
            hop::mbar_init(&empty[s], CONSUMERS * 4);
        }
        hop::mbar_init(kvbar, 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == CONSUMERS) {
        // ---------------- producer ----------------
        hop::reg_dealloc<40>();
        if (threadIdx.x == CONSUMERS * 128) {
            hop::mbar_expect_tx(kvbar, 2 * C::KV_BYTES + BKB * 4);
#pragma unroll
            for (int p = 0; p < DH / 64; ++p) {
                hop::tma_load_3d(Ks + p * BKB * 128, &maps.k, kvbar, p * 64, k0, bkh);
                hop::tma_load_3d(Vs + p * BKB * 128, &maps.v, kvbar, p * 64, k0, bkh);
            }
            hop::tma_load_row(mask_s, &maps.mask, kvbar, k0, b);
            int i = 0;
            for (int r0 = Rb / BQB * BQB; r0 < Re; r0 += BQB) {
                if (rows_pmax(max(r0, Rb), min(r0 + BQB, Re) - 1, S) < k0) continue;   // above the diagonal
                const int s = i % NST;
                const int ph = (i / NST) & 1;
                unsigned char* st = stages + s * C::STAGE;
                hop::mbar_wait(&empty[s], ph ^ 1);
                hop::mbar_expect_tx(&full[s], 2 * C::QT_BYTES + 2 * BQB * 4);
#pragma unroll
                for (int p = 0; p < DH / 64; ++p) {
                    hop::tma_load_3d(st + p * BQB * 128, &maps.q, &full[s], p * 64, r0, bkh);
                    hop::tma_load_3d(st + C::QT_BYTES + p * BQB * 128, &maps.dout, &full[s],
                                     p * 64, r0, bkh);
                }
                hop::tma_load_row(st + C::ROWS_OFF, &maps.lse, &full[s], r0, bkh);
                hop::tma_load_row(st + C::ROWS_OFF + BQB * 4, &maps.D, &full[s], r0, bkh);
                ++i;
            }
        }
    } else {
        // ---------------- consumers: 64 keys each ----------------
        hop::reg_alloc<232>();
        const int w4 = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int kw0 = k0 + 64 * wg;                    // first key of this warpgroup
        const int ka = kw0 + 16 * w4 + lane / 4;          // this thread's keys ka, ka + 8
        const int kb = ka + 8;
        const float scale = a.scale;

        float dk[DH / 2], dv[DH / 2];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) {
            dk[i] = 0.f;
            dv[i] = 0.f;
        }
        hop::mbar_wait(kvbar, 0);
        const bool live_a = ka < Sk && mask_s[ka - k0] > 0.f;
        const bool live_b = kb < Sk && mask_s[kb - k0] > 0.f;
        const uint32_t k_addr = hop::smem_u32(Ks) + wg * 64 * 128;
        const uint32_t v_addr = hop::smem_u32(Vs) + wg * 64 * 128;

        int i = 0;
        for (int r0 = Rb / BQB * BQB; r0 < Re; r0 += BQB) {
            const int rf = max(r0, Rb), rl = min(r0 + BQB, Re) - 1;   // the block's rows of the tile
            const int pmax = rows_pmax(rf, rl, S);
            if (pmax < k0) continue;
            const int s = i % NST;
            const int ph = (i / NST) & 1;
            ++i;
            unsigned char* st = stages + s * C::STAGE;
            hop::mbar_wait(&full[s], ph);
            if (pmax >= kw0) {
                const uint32_t q_addr = hop::smem_u32(st);
                const uint32_t do_addr = q_addr + C::QT_BYTES;
                float sc[32], dp[32];
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)      // S^T = K Q^T
                    hop::Wgmma<64>::ss(
                        sc, hop::desc_sw128(k_addr + (kk / 4) * BKB * 128 + (kk % 4) * 32, 16),
                        hop::desc_sw128(q_addr + (kk / 4) * BQB * 128 + (kk % 4) * 32, 16), kk);
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)      // dP^T = V dO^T
                    hop::Wgmma<64>::ss(
                        dp, hop::desc_sw128(v_addr + (kk / 4) * BKB * 128 + (kk % 4) * 32, 16),
                        hop::desc_sw128(do_addr + (kk / 4) * BQB * 128 + (kk % 4) * 32, 16), kk);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<32>(sc);
                hop::fence_regs<32>(dp);

                // P^T = exp(S^T scale + bias - lse), dS^T = P^T (dP^T - D) scale;
                // rows past the block's range add nothing
                const bool diag = kw0 + 63 > rows_pmin(rf, rl, S);
                const bool ragged = rf > r0 || r0 + BQB - 1 > rl;
                const float* lse_r = reinterpret_cast<const float*>(st + C::ROWS_OFF);
                const float* d_r = lse_r + BQB;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int col = 8 * j + 2 * (lane & 3);
                    const float2 l2 = *reinterpret_cast<const float2*>(lse_r + col);
                    const float2 d2 = *reinterpret_cast<const float2*>(d_r + col);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int r = r0 + col + e;
                        const bool real = !ragged || (r >= rf && r <= rl);
                        const int pos = diag ? r % S : 0;
                        const float lse = e ? l2.y : l2.x;
                        const float dd = e ? d2.y : d2.x;
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int idx = 4 * j + 2 * h + e;
                            const bool vis = (h ? live_b : live_a) && (!diag || (h ? kb : ka) <= pos);
                            const float p = real
                                ? exp2f((sc[idx] * scale + (vis ? 0.f : -1e9f) - lse) * LOG2E)
                                : 0.f;
                            sc[idx] = p;
                            dp[idx] = p * (dp[idx] - dd) * scale;
                        }
                    }
                }
                uint32_t pf[4][4], df[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        pf[kk][x] = hop::pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
                        df[kk][x] = hop::pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
                    }
                }
                hop::fence_regs<DH / 2>(dv);
                hop::fence_regs<DH / 2>(dk);
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)            // dV += P^T dO
                    hop::Wgmma<DH>::rs(dv, pf[kk], hop::desc_sw128(do_addr + kk * 2048, BQB * 128), 1);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)            // dK += dS^T Q
                    hop::Wgmma<DH>::rs(dk, df[kk], hop::desc_sw128(q_addr + kk * 2048, BQB * 128), 1);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<DH / 2>(dv);
                hop::fence_regs<DH / 2>(dk);
            }
            __syncwarp();
            if (lane == 0) hop::mbar_arrive(&empty[s]);
        }

        // ---------------- epilogue: bf16 gradients, or this part's f32 sums ----------------
        if (a.nsplit == 1) {
            __nv_bfloat16* dkb = a.dk + (size_t)bkh * Sk * DH;
            __nv_bfloat16* dvb = a.dv + (size_t)bkh * Sk * DH;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
                const int col = 8 * j + 2 * (lane & 3);
                if (ka < Sk) {
                    *reinterpret_cast<uint32_t*>(dkb + (size_t)ka * DH + col) =
                        hop::pack_bf16(dk[4 * j], dk[4 * j + 1]);
                    *reinterpret_cast<uint32_t*>(dvb + (size_t)ka * DH + col) =
                        hop::pack_bf16(dv[4 * j], dv[4 * j + 1]);
                }
                if (kb < Sk) {
                    *reinterpret_cast<uint32_t*>(dkb + (size_t)kb * DH + col) =
                        hop::pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
                    *reinterpret_cast<uint32_t*>(dvb + (size_t)kb * DH + col) =
                        hop::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
                }
            }
        } else {
            const size_t base = ((size_t)hs * (gridDim.x / a.nsplit) + bkh) * Sk * DH;
            float* pk = a.part_k + base;
            float* pv = a.part_v + base;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
                const int col = 8 * j + 2 * (lane & 3);
                if (ka < Sk) {
                    *reinterpret_cast<float2*>(pk + (size_t)ka * DH + col) = make_float2(dk[4 * j], dk[4 * j + 1]);
                    *reinterpret_cast<float2*>(pv + (size_t)ka * DH + col) = make_float2(dv[4 * j], dv[4 * j + 1]);
                }
                if (kb < Sk) {
                    *reinterpret_cast<float2*>(pk + (size_t)kb * DH + col) = make_float2(dk[4 * j + 2], dk[4 * j + 3]);
                    *reinterpret_cast<float2*>(pv + (size_t)kb * DH + col) = make_float2(dv[4 * j + 2], dv[4 * j + 3]);
                }
            }
        }
    }
}

// Deterministic sum of the nsplit f32 parts into bf16 (n elements of dK and
// of dV, four per thread, parts added in order).
__global__ void sum_parts_kernel(const float* __restrict__ pk, const float* __restrict__ pv,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                 size_t n, int nsplit) {
    const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i >= n) return;
    float4 sk = *reinterpret_cast<const float4*>(pk + i);
    float4 sv = *reinterpret_cast<const float4*>(pv + i);
    for (int s = 1; s < nsplit; ++s) {
        const float4 xk = *reinterpret_cast<const float4*>(pk + s * n + i);
        const float4 xv = *reinterpret_cast<const float4*>(pv + s * n + i);
        sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
        sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    *reinterpret_cast<uint2*>(dk + i) = make_uint2(hop::pack_bf16(sk.x, sk.y), hop::pack_bf16(sk.z, sk.w));
    *reinterpret_cast<uint2*>(dv + i) = make_uint2(hop::pack_bf16(sv.x, sv.y), hop::pack_bf16(sv.z, sv.w));
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
           const void* lse, const void* D, void* dk, void* dv, void* part_k, void* part_v, int B,
           int H, int KH, int S, int Sk, int nsplit, float scale, cudaStream_t st) {
    using C = Cfg<DH>;
    const int g = H / KH;
    if (nsplit < 1 || g % nsplit) return (int)cudaErrorInvalidValue;
    Maps maps;
    int e;
    if ((e = hop_host::map_3d(&maps.q, q, false, B * KH, g * S, DH, BQB, 64))) return e;
    if ((e = hop_host::map_3d(&maps.dout, dout, false, B * KH, g * S, DH, BQB, 64))) return e;
    if ((e = hop_host::map_3d(&maps.k, k, false, B * KH, Sk, DH, BKB, 64))) return e;
    if ((e = hop_host::map_3d(&maps.v, v, false, B * KH, Sk, DH, BKB, 64))) return e;
    if ((e = hop_host::map_rows_f32(&maps.mask, mask, B, Sk, BKB))) return e;
    if ((e = hop_host::map_rows_f32(&maps.lse, lse, B * KH, g * S, BQB))) return e;
    if ((e = hop_host::map_rows_f32(&maps.D, D, B * KH, g * S, BQB))) return e;
    cudaError_t ce = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    Args args{(__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)part_k, (float*)part_v,
              H, KH, S, Sk, nsplit, scale};
    flash_bwd_dkv_kernel<DH><<<dim3(B * KH * nsplit, (Sk + BKB - 1) / BKB), THREADS, C::SMEM,
                               st>>>(maps, args);
    ce = cudaGetLastError();
    if (ce != cudaSuccess || nsplit == 1) return (int)ce;
    const size_t n = (size_t)B * KH * Sk * DH;
    sum_parts_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
        (const float*)part_k, (const float*)part_v, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n,
        nsplit);
    return (int)cudaGetLastError();
}

}  // namespace dkv

// q, dout: [B, H, S, dh] bf16; k, v: [B, KH, Sk, dh] bf16; mask: [B, Sk4] f32;
// D: [B * KH, (g*S)4] f32 (each KV head's folded rows; "4": each row padded
// to a multiple of 4 values, as TMA reads them) -> dq: [B, H, S, dh] bf16,
// lse: [B, H, S] f32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* mask, const void* D, void* dq, void* lse, int B, int H,
                            int KH, int S, int Sk, int dh, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128) return dq::launch<128>(q, k, v, dout, mask, D, dq, lse, B, H, KH, S, Sk, scale, st);
    if (dh == 64) return dq::launch<64>(q, k, v, dout, mask, D, dq, lse, B, H, KH, S, Sk, scale, st);
    return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, plus lse from it (as [B * KH, (g*S)4], like D) -> dk, dv:
// [B, KH, Sk, dh] bf16. With
// nsplit > 1 (a divisor of H / KH) each KV head's query heads are split
// over nsplit blocks per key tile, which write f32 parts to part_k/part_v
// [nsplit, B, KH, Sk, dh]; a second kernel sums them in order into dk/dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* lse, const void* D, void* dk, void* dv,
                             void* part_k, void* part_v, int B, int H, int KH, int S, int Sk,
                             int dh, int nsplit, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128)
        return dkv::launch<128>(q, k, v, dout, mask, lse, D, dk, dv, part_k, part_v, B, H, KH, S,
                                Sk, nsplit, scale, st);
    if (dh == 64)
        return dkv::launch<64>(q, k, v, dout, mask, lse, D, dk, dv, part_k, part_v, B, H, KH, S,
                               Sk, nsplit, scale, st);
    return (int)cudaErrorInvalidValue;
}
