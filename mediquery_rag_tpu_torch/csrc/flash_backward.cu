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
// The TPU kernels' transposed orientation (s_t = K Q^T, query rows on lanes)
// is a TPU layout choice and is not copied: tiles here are row-major.
//
// Design for Hopper: 4 warps per block, 64-row tiles, every product a bf16
// WMMA (mma.sync) tile from shared memory with f32 accumulation.
//   B10a: one block per (b, KV head, 64 folded query rows); it loops over KV
//         tiles, holding Q, dO and the f32 dQ accumulator (~136 KB at dh 128).
//   B10b: one block per (b, KV head, 64 keys); it loops over the group's
//         folded query tiles, holding K, V and the f32 dK and dV accumulators
//         (~176 KB at dh 128).
// What bounds it on this card: ~6 (B10a) and ~8 (B10b) * visible pairs * dh
// flops against ~4 * S * dh * H bytes, so both are compute bound at training
// lengths; WMMA from shared memory is the simple first step, wgmma/TMA
// pipelining is later work.

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

template <int DH>
constexpr size_t dkv_smem_bytes() {
    // K, V, Q, dO tiles (bf16), S and dP (f32), P and dS (bf16), dK and dV
    // acc (f32), rows
    return 4 * (size_t)BQ * DH * 2 + 2 * (size_t)BQ * BK * 4 + 2 * (size_t)BQ * BK * 2
           + 2 * (size_t)BK * DH * 4 + 3 * (size_t)BQ * 4 + (size_t)BK * 4;
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
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ Dvec, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int KH, int S, int Sk, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Vs = Ks + BK * DH;
    __nv_bfloat16* Qs = Vs + BK * DH;
    __nv_bfloat16* dOs = Qs + BQ * DH;
    float* Ss = reinterpret_cast<float*>(dOs + BQ * DH);
    float* dPs = Ss + BQ * BK;
    __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(dPs + BQ * BK);
    __nv_bfloat16* dSs = Ps + BQ * BK;
    float* dKs = reinterpret_cast<float*>(dSs + BQ * BK);
    float* dVs = dKs + BK * DH;
    float* lses = dVs + BK * DH;
    float* Ds = lses + BQ;
    float* poss = Ds + BQ;        // position of each tile row, -1 past R
    float* vis_s = poss + BQ;

    const int warp = threadIdx.x >> 5;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int g = H / KH;
    const int R = g * S;
    const int k0 = blockIdx.x * BK;
    const size_t kvbase = ((size_t)b * KH + kh) * Sk * DH;
    const float* mrow = mask + (size_t)b * Sk;

    load_keys<DH>(Ks, k, kvbase, k0, Sk);
    load_keys<DH>(Vs, v, kvbase, k0, Sk);
    for (int idx = threadIdx.x; idx < BK * DH; idx += blockDim.x) { dKs[idx] = 0.f; dVs[idx] = 0.f; }
    for (int idx = threadIdx.x; idx < BK; idx += blockDim.x)
        vis_s[idx] = (k0 + idx < Sk && mrow[min(k0 + idx, Sk - 1)] > 0.f) ? 1.f : 0.f;

    for (int r0 = 0; r0 < R; r0 += BQ) {
        if (k0 > tile_pmax(r0, R, S)) continue;         // every row sits left of this tile
        __syncthreads();                                  // previous tile's products are done
        load_rows<DH>(Qs, q, b, kh, g, H, S, r0, R);
        load_rows<DH>(dOs, dout, b, kh, g, H, S, r0, R);
        for (int idx = threadIdx.x; idx < BQ; idx += blockDim.x) {
            const int r = r0 + idx;
            const size_t o = ((size_t)b * H + kh * g + r / S) * S + r % S;
            lses[idx] = r < R ? lse[o] : 0.f;
            Ds[idx] = r < R ? Dvec[o] : 0.f;
            poss[idx] = r < R ? (float)(r % S) : -1.f;
        }
        __syncthreads();

        rows_by_keys<DH>(Ss + warp * 16 * BK, Qs + warp * 16 * DH, Ks);     // Q K^T
        rows_by_keys<DH>(dPs + warp * 16 * BK, dOs + warp * 16 * DH, Vs);   // dO V^T
        __syncwarp();
        for (int idx = threadIdx.x & 31; idx < 16 * BK; idx += 32) {
            const int row = warp * 16 + idx / BK, col = idx % BK;
            const float pos = poss[row];
            float p = 0.f, ds = 0.f;
            if (pos >= 0.f) {                             // rows past R add nothing
                const bool vis = vis_s[col] > 0.f && (float)(k0 + col) <= pos;
                const float s = Ss[row * BK + col] * scale + (vis ? 0.f : -1e9f);
                p = expf(s - lses[row]);
                ds = p * (dPs[row * BK + col] - Ds[row]) * scale;
            }
            Ps[row * BK + col] = __float2bfloat16(p);
            dSs[row * BK + col] = __float2bfloat16(ds);
        }
        __syncthreads();

        // dV += P^T dO and dK += dS^T Q for this warp's 16 keys
        for (int j = 0; j < DH / 16; ++j) {
            Acc av, ak;
            wmma::load_matrix_sync(av, dVs + warp * 16 * DH + j * 16, DH, wmma::mem_row_major);
            wmma::load_matrix_sync(ak, dKs + warp * 16 * DH + j * 16, DH, wmma::mem_row_major);
            for (int qq = 0; qq < BQ; qq += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> pt, dst;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> dob, qb;
                wmma::load_matrix_sync(pt, Ps + qq * BK + warp * 16, BK);
                wmma::load_matrix_sync(dst, dSs + qq * BK + warp * 16, BK);
                wmma::load_matrix_sync(dob, dOs + qq * DH + j * 16, DH);
                wmma::load_matrix_sync(qb, Qs + qq * DH + j * 16, DH);
                wmma::mma_sync(av, pt, dob, av);
                wmma::mma_sync(ak, dst, qb, ak);
            }
            wmma::store_matrix_sync(dVs + warp * 16 * DH + j * 16, av, DH, wmma::mem_row_major);
            wmma::store_matrix_sync(dKs + warp * 16 * DH + j * 16, ak, DH, wmma::mem_row_major);
        }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < BK * DH; idx += blockDim.x) {
        const int row = idx / DH, d = idx % DH;
        if (k0 + row < Sk) {
            const size_t o = kvbase + (size_t)(k0 + row) * DH + d;
            dk[o] = __float2bfloat16(dKs[idx]);
            dv[o] = __float2bfloat16(dVs[idx]);
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

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* mask,
               const void* lse, const void* D, void* dk, void* dv, int B, int H, int KH, int S,
               int Sk, float scale, cudaStream_t st) {
    const size_t smem = dkv_smem_bytes<DH>();
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sk + BK - 1) / BK, KH, B);
    flash_bwd_dkv_kernel<DH><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)mask, (const float*)lse, (const float*)D,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, KH, S, Sk, scale);
    return (int)cudaGetLastError();
}

}  // namespace

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

// As flash_bwd_dq, plus lse from it -> dk, dv: [B, KH, Sk, dh] bf16.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* lse, const void* D, void* dk, void* dv,
                             int B, int H, int KH, int S, int Sk, int dh, float scale,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128)
        return launch_dkv<128>(q, k, v, dout, mask, lse, D, dk, dv, B, H, KH, S, Sk, scale, st);
    if (dh == 64)
        return launch_dkv<64>(q, k, v, dout, mask, lse, D, dk, dv, B, H, KH, S, Sk, scale, st);
    return (int)cudaErrorInvalidValue;
}
