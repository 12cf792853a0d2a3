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
// B10a (flash_bwd_dq), not yet redesigned: 4 warps per block, one block per
// (b, KV head, 64 folded query rows), looping over KV tiles with Q, dO and
// the f32 dQ accumulator in shared memory (~136 KB at dh 128); every
// product a bf16 WMMA (mma.sync) tile from shared memory. What bounds it:
// ~6 * visible pairs * dh flops, so the tensor cores, which this design
// keeps ~1.3% busy at S=4096; it is the next kernel to redesign.
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
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;      // folded query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

template <int DH>
constexpr size_t dq_smem_bytes() {
    // Q, dO, K, V tiles (bf16), S and dP (f32), dS (bf16), dQ acc (f32), rows
    return 4 * (size_t)BQ * DH * 2 + 2 * (size_t)BQ * BK * 4 + (size_t)BQ * BK * 2
           + (size_t)BQ * DH * 4 + 3 * (size_t)BQ * 4 + (size_t)BK * 4;
}

// Rows [r0, r0 + 64) of the folded [g*S, DH] view of x ([B, H, S, DH]) for
// KV head kh; rows past R are zero.
template <int DH>
__device__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x, int b,
                          int kh, int g, int H, int S, int r0, int R) {
    constexpr int CPR = DH / 8;
    for (int idx = threadIdx.x; idx < BQ * CPR; idx += blockDim.x) {
        const int row = idx / CPR, cc = idx % CPR;
        const int r = r0 + row;
        int4 val = make_int4(0, 0, 0, 0);
        if (r < R) {
            const int h = kh * g + r / S, p = r % S;
            val = *reinterpret_cast<const int4*>(x + (((size_t)b * H + h) * S + p) * DH + cc * 8);
        }
        *reinterpret_cast<int4*>(dst + row * DH + cc * 8) = val;
    }
}

// Keys [k0, k0 + 64) of [B, KH, Sk, DH]; keys past Sk are zero.
template <int DH>
__device__ void load_keys(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x,
                          size_t base, int k0, int Sk) {
    constexpr int CPR = DH / 8;
    for (int idx = threadIdx.x; idx < BK * CPR; idx += blockDim.x) {
        const int row = idx / CPR, cc = idx % CPR;
        int4 val = make_int4(0, 0, 0, 0);
        if (k0 + row < Sk)
            val = *reinterpret_cast<const int4*>(x + base + (size_t)(k0 + row) * DH + cc * 8);
        *reinterpret_cast<int4*>(dst + row * DH + cc * 8) = val;
    }
}

// out[16 rows of this warp, 64] = A[16, DH] . B[64, DH]^T (A, B row-major).
template <int DH>
__device__ void rows_by_keys(float* out, const __nv_bfloat16* A, const __nv_bfloat16* Bm) {
    for (int j = 0; j < BK / 16; ++j) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
        for (int d = 0; d < DH; d += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
            wmma::load_matrix_sync(a, A + d, DH);
            wmma::load_matrix_sync(bm, Bm + j * 16 * DH + d, DH);
            wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(out + j * 16, acc, BK, wmma::mem_row_major);
    }
}

// The highest position among folded rows [r0, min(r0 + 64, R)).
__device__ __forceinline__ int tile_pmax(int r0, int R, int S) {
    const int rlast = min(r0 + BQ, R) - 1;
    return (r0 / S == rlast / S) ? rlast % S : S - 1;
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ mask, const float* __restrict__ Dvec,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ lse, int H, int KH,
                    int S, int Sk, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* dOs = Qs + BQ * DH;
    __nv_bfloat16* Ks = dOs + BQ * DH;
    __nv_bfloat16* Vs = Ks + BK * DH;
    float* Ss = reinterpret_cast<float*>(Vs + BK * DH);
    float* dPs = Ss + BQ * BK;
    __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(dPs + BQ * BK);
    float* Acs = reinterpret_cast<float*>(dSs + BQ * BK);
    float* ms = Acs + BQ * DH;
    float* ls = ms + BQ;
    float* Ds = ls + BQ;
    float* vis_s = Ds + BQ;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int g = H / KH;
    const int R = g * S;
    const int r0 = blockIdx.x * BQ;

    load_rows<DH>(Qs, q, b, kh, g, H, S, r0, R);
    load_rows<DH>(dOs, dout, b, kh, g, H, S, r0, R);
    for (int idx = threadIdx.x; idx < BQ * DH; idx += blockDim.x) Acs[idx] = 0.f;
    for (int idx = threadIdx.x; idx < BQ; idx += blockDim.x) {
        const int r = r0 + idx;
        ms[idx] = NEG_BIG;
        ls[idx] = 0.f;
        Ds[idx] = r < R ? Dvec[((size_t)b * H + kh * g + r / S) * S + r % S] : 0.f;
    }
    const int kend = max(1, min(Sk, tile_pmax(r0, R, S) + 1));   // later keys are invisible
    const size_t kvbase = ((size_t)b * KH + kh) * Sk * DH;
    const float* mrow = mask + (size_t)b * Sk;
    __syncthreads();

    for (int k0 = 0; k0 < kend; k0 += BK) {
        load_keys<DH>(Ks, k, kvbase, k0, Sk);
        load_keys<DH>(Vs, v, kvbase, k0, Sk);
        for (int idx = threadIdx.x; idx < BK; idx += blockDim.x)
            vis_s[idx] = (k0 + idx < Sk && mrow[min(k0 + idx, Sk - 1)] > 0.f) ? 1.f : 0.f;
        __syncthreads();

        rows_by_keys<DH>(Ss + warp * 16 * BK, Qs + warp * 16 * DH, Ks);     // Q K^T
        rows_by_keys<DH>(dPs + warp * 16 * BK, dOs + warp * 16 * DH, Vs);   // dO V^T
        __syncwarp();

        // online softmax and dS for this warp's 16 rows, two keys per lane
        for (int rr = 0; rr < 16; ++rr) {
            const int row = warp * 16 + rr;
            const int r = r0 + row;
            const int pos = (r < R) ? r % S : 0;
            float sv[BK / 32];
            float mx = NEG_BIG;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                const int col = lane + 32 * t;
                const bool vis = vis_s[col] > 0.f && k0 + col <= pos;
                const float s = Ss[row * BK + col] * scale + (vis ? 0.f : -1e9f);
                sv[t] = s;
                mx = fmaxf(mx, s);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
            const float m_old = ms[row];
            const float m_new = fmaxf(m_old, mx);
            const float corr = expf(m_old - m_new);
            const float Dr = Ds[row];
            float psum = 0.f;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                const int col = lane + 32 * t;
                const float p = expf(sv[t] - m_new);
                psum += p;
                dSs[row * BK + col] = __float2bfloat16(p * (dPs[row * BK + col] - Dr) * scale);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o);
            for (int d = lane; d < DH; d += 32) Acs[row * DH + d] *= corr;
            __syncwarp();
            if (lane == 0) { ls[row] = ls[row] * corr + psum; ms[row] = m_new; }
        }
        __syncwarp();

        // dQ += dS K
        for (int j = 0; j < DH / 16; ++j) {
            Acc acc;
            wmma::load_matrix_sync(acc, Acs + warp * 16 * DH + j * 16, DH, wmma::mem_row_major);
            for (int kk = 0; kk < BK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
                wmma::load_matrix_sync(a, dSs + warp * 16 * BK + kk, BK);
                wmma::load_matrix_sync(bm, Ks + kk * DH + j * 16, DH);
                wmma::mma_sync(acc, a, bm, acc);
            }
            wmma::store_matrix_sync(Acs + warp * 16 * DH + j * 16, acc, DH, wmma::mem_row_major);
        }
        __syncthreads();
    }

    for (int idx = threadIdx.x; idx < BQ * DH; idx += blockDim.x) {
        const int row = idx / DH, d = idx % DH;
        const int r = r0 + row;
        if (r < R) {
            const size_t o = ((size_t)b * H + kh * g + r / S) * S + r % S;
            dq[o * DH + d] = __float2bfloat16(Acs[idx] / ls[row]);
            if (d == 0) lse[o] = ms[row] + logf(ls[row]);
        }
    }
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* mask,
              const void* D, void* dq, void* lse, int B, int H, int KH, int S, int Sk,
              float scale, cudaStream_t st) {
    const size_t smem = dq_smem_bytes<DH>();
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(((H / KH) * S + BQ - 1) / BQ, KH, B);
    flash_bwd_dq_kernel<DH><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)mask, (const float*)D, (__nv_bfloat16*)dq,
        (float*)lse, H, KH, S, Sk, scale);
    return (int)cudaGetLastError();
}

}  // namespace

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

// q, dout: [B, H, S, dh] bf16; k, v: [B, KH, Sk, dh] bf16; mask: [B, Sk] f32;
// D: [B, H, S] f32 -> dq: [B, H, S, dh] bf16, lse: [B, H, S] f32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* mask, const void* D, void* dq, void* lse, int B, int H,
                            int KH, int S, int Sk, int dh, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128) return launch_dq<128>(q, k, v, dout, mask, D, dq, lse, B, H, KH, S, Sk, scale, st);
    if (dh == 64) return launch_dq<64>(q, k, v, dout, mask, D, dq, lse, B, H, KH, S, Sk, scale, st);
    return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, plus lse from it -> dk, dv: [B, KH, Sk, dh] bf16. Here the
// mask comes as [B, Sk4] and lse and D as [B * KH, (g*S)4] (each KV head's
// folded rows, "4": padded to a multiple of 4 values). With
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
