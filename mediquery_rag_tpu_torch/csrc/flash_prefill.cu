// Causal flash attention forward for prefill (bf16 in, bf16 out, f32 softmax state).
//
// Replaces the forward of the Pallas kernel mediquery_rag_tpu/ops/attention.py:
// _flash_kernel (:72, launched at :498 via _flash_call :278; entry points
// flash_attention :822 and flash_attention_at :863) without stacked layer or
// (m, l) outputs: a bf16 KV cache (flash_prefill) or an int8 cache of codes
// with per-column f32 scales (flash_prefill_int8, the kernel's quant mode:
// codes widened to bf16 on the way into shared memory, which is exact; the
// logit of key c is (q . code_c) * scale * ks[c]; P.V takes bf16(p * vs[c])
// while the denominator sums p).
//
// Semantics kept from the TPU kernel:
//   * GQA fold: the g = H / KH query heads of one KV head are stacked along
//     the row axis (folded row r -> head kh*g + r / S, position r % S), so a
//     block reads each K/V tile once for the whole group;
//   * visibility: key c is visible to the query at position p of batch b iff
//     key_mask[b, c] > 0 and c <= q_offset[b] + p; invisible logits get a
//     -1e9 bias (not -inf), so a row with no visible key gives finite output;
//   * online softmax in f32; P is cast to bf16 before P.V (attention.py:142);
//   * KV tiles wholly above the (offset) diagonal of the row tile are skipped.
// Design for Hopper: one block (4 warps) per (b, KV head, 64 folded rows).
// Q, the current 64-key K and V tiles, the scores, P and the f32 output
// accumulator live in shared memory (~104 KB at dh = 128); each warp owns 16
// rows and runs Q.K^T and P.V on bf16 WMMA tensor-core tiles. What bounds it
// on this card: at S ~ 4K the work is ~4*S^2*dh*H/2 flops against ~S*dh*KH
// bytes, so it is compute bound; WMMA (mma.sync) from shared memory is the
// simple first step, wgmma/TMA pipelining is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;      // folded query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
    return (size_t)BQ * DH * 2 + 2 * (size_t)BK * DH * 2 + (size_t)BQ * BK * 4
           + (size_t)BQ * BK * 2 + (size_t)BQ * DH * 4 + 2 * (size_t)BQ * 4 + 2 * (size_t)BK * 4;
}

__device__ __forceinline__ int4 widen8(int word0, int word1) {
    // eight int8 codes (two 32-bit words) -> eight bf16 values (exact)
    __nv_bfloat162 p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int w = j < 2 ? word0 : word1;
        const int sh = 16 * (j & 1);
        p[j] = __floats2bfloat162_rn((float)(int8_t)((w >> sh) & 0xff),
                                     (float)(int8_t)((w >> (sh + 8)) & 0xff));
    }
    return *reinterpret_cast<int4*>(p);
}

// QUANT: k/v hold int8 codes, ks/vs the per-column scales [B, KH, Sk] f32.
template <int DH, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const float* __restrict__ mask,
                     const int* __restrict__ q_off, __nv_bfloat16* __restrict__ out,
                     int H, int KH, int S, int Sk, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Ks = Qs + BQ * DH;
    __nv_bfloat16* Vs = Ks + BK * DH;
    float* Ss = reinterpret_cast<float*>(Vs + BK * DH);
    __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * BK);
    float* Os = reinterpret_cast<float*>(Ps + BQ * BK);
    float* ms = Os + BQ * DH;
    float* ls = ms + BQ;
    float* kss = ls + BQ;
    float* vss = kss + BK;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int g = H / KH;
    const int R = g * S;
    const int r0 = blockIdx.x * BQ;
    const int off = q_off[b];
    constexpr int CPR = DH / 8;          // 16-byte chunks per head row

    for (int idx = threadIdx.x; idx < BQ * CPR; idx += blockDim.x) {
        const int row = idx / CPR, cc = idx % CPR;
        const int r = r0 + row;
        int4 val = make_int4(0, 0, 0, 0);
        if (r < R) {
            const int h = kh * g + r / S, p = r % S;
            val = *reinterpret_cast<const int4*>(q + (((size_t)b * H + h) * S + p) * DH + cc * 8);
        }
        *reinterpret_cast<int4*>(Qs + row * DH + cc * 8) = val;
    }
    for (int idx = threadIdx.x; idx < BQ * DH; idx += blockDim.x) Os[idx] = 0.f;
    for (int idx = threadIdx.x; idx < BQ; idx += blockDim.x) { ms[idx] = NEG_BIG; ls[idx] = 0.f; }

    const int rlast = min(r0 + BQ, R) - 1;
    const int pmax = (r0 / S == rlast / S) ? rlast % S : S - 1;
    const int kend = max(1, min(Sk, off + pmax + 1));     // later keys are invisible to the tile
    const size_t kvbase = ((size_t)b * KH + kh) * Sk * DH;
    const float* mrow = mask + (size_t)b * Sk;
    __syncthreads();

    for (int k0 = 0; k0 < kend; k0 += BK) {
        for (int idx = threadIdx.x; idx < BK * CPR; idx += blockDim.x) {
            const int row = idx / CPR, cc = idx % CPR;
            int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
            if (k0 + row < Sk) {
                const size_t o = kvbase + (size_t)(k0 + row) * DH + cc * 8;
                if constexpr (QUANT) {       // 8 codes = 8 bytes per chunk
                    const int2 kc = *reinterpret_cast<const int2*>((const int8_t*)k + o);
                    const int2 vc = *reinterpret_cast<const int2*>((const int8_t*)v + o);
                    kv = widen8(kc.x, kc.y);
                    vv = widen8(vc.x, vc.y);
                } else {
                    kv = *reinterpret_cast<const int4*>((const __nv_bfloat16*)k + o);
                    vv = *reinterpret_cast<const int4*>((const __nv_bfloat16*)v + o);
                }
            }
            *reinterpret_cast<int4*>(Ks + row * DH + cc * 8) = kv;
            *reinterpret_cast<int4*>(Vs + row * DH + cc * 8) = vv;
        }
        if constexpr (QUANT) {
            for (int idx = threadIdx.x; idx < BK; idx += blockDim.x) {
                const int key = k0 + idx;
                const size_t si = ((size_t)b * KH + kh) * Sk + min(key, Sk - 1);
                kss[idx] = key < Sk ? ks[si] : 0.f;
                vss[idx] = key < Sk ? vs[si] : 0.f;
            }
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows
        for (int j = 0; j < BK / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.f);
            for (int d = 0; d < DH; d += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
                wmma::load_matrix_sync(a, Qs + warp * 16 * DH + d, DH);
                wmma::load_matrix_sync(bm, Ks + j * 16 * DH + d, DH);
                wmma::mma_sync(acc, a, bm, acc);
            }
            wmma::store_matrix_sync(Ss + warp * 16 * BK + j * 16, acc, BK, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax update, one row at a time, two keys per lane
        for (int rr = 0; rr < 16; ++rr) {
            const int row = warp * 16 + rr;
            const int r = r0 + row;
            const int pos = (r < R) ? r % S : 0;
            float sv[BK / 32];
            float mx = NEG_BIG;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                const int col = lane + 32 * t;
                const int key = k0 + col;
                const bool vis = key < Sk && mrow[min(key, Sk - 1)] > 0.f && key <= off + pos;
                float s = Ss[row * BK + col] * scale;
                if constexpr (QUANT) s *= kss[col];
                s += vis ? 0.f : -1e9f;
                sv[t] = s;
                mx = fmaxf(mx, s);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
            const float m_old = ms[row];
            const float m_new = fmaxf(m_old, mx);
            const float corr = expf(m_old - m_new);
            float psum = 0.f;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                const float p = expf(sv[t] - m_new);
                psum += p;
                Ps[row * BK + lane + 32 * t] = __float2bfloat16(QUANT ? p * vss[lane + 32 * t] : p);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o);
            for (int d = lane; d < DH; d += 32) Os[row * DH + d] *= corr;
            __syncwarp();
            if (lane == 0) { ls[row] = ls[row] * corr + psum; ms[row] = m_new; }
        }
        __syncwarp();

        // O += P V
        for (int j = 0; j < DH / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::load_matrix_sync(acc, Os + warp * 16 * DH + j * 16, DH, wmma::mem_row_major);
            for (int kk = 0; kk < BK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
                wmma::load_matrix_sync(a, Ps + warp * 16 * BK + kk, BK);
                wmma::load_matrix_sync(bm, Vs + kk * DH + j * 16, DH);
                wmma::mma_sync(acc, a, bm, acc);
            }
            wmma::store_matrix_sync(Os + warp * 16 * DH + j * 16, acc, DH, wmma::mem_row_major);
        }
        __syncthreads();
    }

    for (int idx = threadIdx.x; idx < BQ * DH; idx += blockDim.x) {
        const int row = idx / DH, d = idx % DH;
        const int r = r0 + row;
        if (r < R) {
            const int h = kh * g + r / S, p = r % S;
            out[(((size_t)b * H + h) * S + p) * DH + d] = __float2bfloat16(Os[idx] / ls[row]);
        }
    }
}

template <int DH, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* mask, const void* q_off, void* out, int B, int H, int KH, int S, int Sk,
           float scale, cudaStream_t st) {
    const size_t smem = smem_bytes<DH>();
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<DH, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int R = (H / KH) * S;
    dim3 grid((R + BQ - 1) / BQ, KH, B);
    flash_prefill_kernel<DH, QUANT><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
        (const float*)mask, (const int*)q_off, (__nv_bfloat16*)out, H, KH, S, Sk, scale);
    return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, const void* q_off, void* out, int B, int H, int KH, int S,
             int Sk, int dh, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128)
        return launch<128, QUANT>(q, k, v, ks, vs, mask, q_off, out, B, H, KH, S, Sk, scale, st);
    if (dh == 64)
        return launch<64, QUANT>(q, k, v, ks, vs, mask, q_off, out, B, H, KH, S, Sk, scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v, const void* mask,
                             const void* q_off, void* out, int B, int H, int KH, int S,
                             int Sk, int dh, float scale, void* stream) {
    return dispatch<false>(q, k, v, nullptr, nullptr, mask, q_off, out, B, H, KH, S, Sk, dh,
                           scale, stream);
}

// k8/v8: int8 codes [B, KH, Sk, dh]; ks/vs: [B, KH, Sk] f32 scales.
extern "C" int flash_prefill_int8(const void* q, const void* k8, const void* v8, const void* ks,
                                  const void* vs, const void* mask, const void* q_off, void* out,
                                  int B, int H, int KH, int S, int Sk, int dh, float scale,
                                  void* stream) {
    return dispatch<true>(q, k8, v8, ks, vs, mask, q_off, out, B, H, KH, S, Sk, dh, scale,
                          stream);
}
