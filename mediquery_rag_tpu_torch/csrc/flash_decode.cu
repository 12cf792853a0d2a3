// Mask-only attention of a few query rows over the KV cache (decode), split over
// the cache length and combined in a second pass.
//
// Replaces the forward of the Pallas kernel mediquery_rag_tpu/ops/attention.py:
// _flash_cached_kernel (:171, launched at :498 via _flash_call; entry point
// flash_attention_cached :905): a bf16 cache (flash_decode) or an int8 cache
// of codes with per-column f32 scales (flash_decode_int8, the kernel's quant
// mode), each with the fresh-column fold (attention.py:249-266) or with the
// (m, l) outputs (attention.py:200-201, :270-272; the speculative
// extend_slots' verify/propose pass), or neither.
//
// Semantics kept: compact GQA fold (the g*S query rows of one KV head share
// every K/V tile), visibility from the key mask alone with a -1e9 bias on
// masked keys, f32 online softmax, P cast to bf16 before P.V. int8: codes are
// exact in bf16; the logit of key c is (q . code_c) * scale * ks[c], and the
// weight fed to P.V is bf16(p * vs[c]) while the denominator sums p.
// Fresh fold: the decode step's own K/V column (bf16, not yet in the cache)
// is one more virtual key after the merge, its term gated per lane:
// s2 = q . kn * scale, m = max(M, s2), a1 = e^(M-m) L, a2 = e^(s2-m) gate,
// o = (acc e^(M-m) + a2 vn) / max(a1 + a2, 1e-30), so an inactive lane over
// an empty cache gives finite output, never NaN.
// Design for Hopper: at decode B*KH is tiny (16 (lane, KV head) pairs at
// B=4 on a 7B GQA model), so one block per pair would leave most SMs idle.
// Pass 1 splits the cache length over blocks (grid.y); each block streams
// 64-key K/V tiles through shared memory (bf16, int8 codes widened to bf16
// on the way in; K rows padded to an odd word stride, so 32 consecutive keys
// hit 32 banks), keeps its own (m, l, acc) for up to 16 folded rows in f32
// and writes them out. Pass 2 combines the splits: M = max m_s,
// L = sum l_s e^(m_s - M), acc = sum acc_s e^(m_s - M), then o = acc / L or
// the fold above. With (m, l) outputs each folded row (h, p) also writes its
// M and L to m_out/l_out [B, H, S] f32, un-folded: the caller folds the
// speculative round's G x G fresh block in outside the kernel. A G-row verify
// pass at 7B GQA folds 7 * G rows per KV head, more than 16 at G > 2: the
// rows go to row chunks (grid.z), each streaming the cache once.
// What bounds it on an H100: every cache byte is read once per step for
// 2*g flops per element, far below the compute/bandwidth balance, so it is
// bound by reading the cache (2*C*KH*dh bytes per lane and layer at int8,
// twice that at bf16, plus 8 bytes of scales per column and KV head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;         // keys per tile
constexpr int RMAX = 16;       // folded query rows per block
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ uint32_t codes2(uint32_t word, int half) {
    // two int8 codes of a 32-bit word -> a bf16 pair (exact)
    const int lo = (int)(int8_t)((word >> (16 * half)) & 0xff);
    const int hi = (int)(int8_t)((word >> (16 * half + 8)) & 0xff);
    __nv_bfloat162 p = __floats2bfloat162_rn((float)lo, (float)hi);
    return *reinterpret_cast<uint32_t*>(&p);
}

// QUANT: k/v hold int8 codes, ks/vs the per-column scales [B, KH, C] f32.
template <int DH, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, const float* __restrict__ mask,
                   int H, int KH, int S, int C, int chunk, float scale,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc) {
    constexpr int W = DH / 2;                 // bf16 pairs per head row
    constexpr int KW = W + 1;                 // padded K row stride (words)
    constexpr int SG = THREADS / BK;          // score phase: row groups
    constexpr int SR = RMAX / SG;             //   rows per thread
    constexpr int VG = THREADS / W;           // P.V phase: row groups
    constexpr int VR = RMAX / VG;             //   rows per thread
    __shared__ float Qs[RMAX][DH];
    __shared__ uint32_t Ks[BK * KW];
    __shared__ __align__(16) __nv_bfloat162 Vs[BK * W];
    __shared__ float Ps[RMAX][BK];
    __shared__ float ms[RMAX], ls[RMAX], cs[RMAX];
    __shared__ float kss[BK], vss[BK];

    const int bkh = blockIdx.x;               // b * KH + kh
    const int split = blockIdx.y;
    const int rc = blockIdx.z;                // row chunk
    const int nsplit = gridDim.y;
    const int b = bkh / KH, kh = bkh % KH;
    const int g = H / KH;
    const int R = g * S;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;

    for (int idx = tid; idx < RMAX * DH; idx += THREADS) {
        const int row = idx / DH, d = idx % DH;
        const int r = rc * RMAX + row;
        float val = 0.f;
        if (r < R) {
            const int h = kh * g + r / S, p = r % S;
            val = __bfloat162float(q[(((size_t)b * H + h) * S + p) * DH + d]);
        }
        Qs[row][d] = val;
    }
    if (tid < RMAX) { ms[tid] = NEG_BIG; ls[tid] = 0.f; }

    const int key = tid % BK, sg = tid / BK;  // score phase mapping
    const int wp = tid % W, vg = tid / W;     // P.V phase mapping
    float2 o[VR];
#pragma unroll
    for (int i = 0; i < VR; ++i) o[i] = make_float2(0.f, 0.f);

    const int kbeg = split * chunk;
    const int kend = min(C, kbeg + chunk);
    const size_t kvbase = (size_t)bkh * C * DH;
    const float* mrow = mask + (size_t)b * C;
    __syncthreads();

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        if constexpr (QUANT) {
            // 16 codes per 16-byte load -> 8 bf16 pairs of K and of V
            for (int idx = tid; idx < BK * (DH / 16); idx += THREADS) {
                const int row = idx / (DH / 16), cc = idx % (DH / 16);
                int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
                if (k0 + row < kend) {
                    const size_t off = kvbase + (size_t)(k0 + row) * DH + cc * 16;
                    kv = *reinterpret_cast<const int4*>((const int8_t*)k + off);
                    vv = *reinterpret_cast<const int4*>((const int8_t*)v + off);
                }
                const uint32_t kw4[4] = {(uint32_t)kv.x, (uint32_t)kv.y, (uint32_t)kv.z,
                                         (uint32_t)kv.w};
                const uint32_t vw4[4] = {(uint32_t)vv.x, (uint32_t)vv.y, (uint32_t)vv.z,
                                         (uint32_t)vv.w};
                uint32_t* kd = Ks + row * KW + cc * 8;
                uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + row * W + cc * 8);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    kd[2 * j] = codes2(kw4[j], 0);
                    kd[2 * j + 1] = codes2(kw4[j], 1);
                    vd[2 * j] = codes2(vw4[j], 0);
                    vd[2 * j + 1] = codes2(vw4[j], 1);
                }
            }
            if (tid < BK) {
                const int kk = k0 + tid;
                const size_t sidx = (size_t)bkh * C + min(kk, C - 1);
                kss[tid] = kk < kend ? ks[sidx] : 0.f;
                vss[tid] = kk < kend ? vs[sidx] : 0.f;
            }
        } else {
            for (int idx = tid; idx < BK * (DH / 8); idx += THREADS) {
                const int row = idx / (DH / 8), cc = idx % (DH / 8);
                int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
                if (k0 + row < kend) {
                    const size_t off = kvbase + (size_t)(k0 + row) * DH + cc * 8;
                    kv = *reinterpret_cast<const int4*>((const __nv_bfloat16*)k + off);
                    vv = *reinterpret_cast<const int4*>((const __nv_bfloat16*)v + off);
                }
                uint32_t* kd = Ks + row * KW + cc * 4;
                kd[0] = (uint32_t)kv.x; kd[1] = (uint32_t)kv.y;
                kd[2] = (uint32_t)kv.z; kd[3] = (uint32_t)kv.w;
                *reinterpret_cast<int4*>(Vs + row * W + cc * 4) = vv;
            }
        }
        __syncthreads();

        // scores: thread -> one key, rows sg, sg+SG, ...
        {
            float acc[SR];
#pragma unroll
            for (int i = 0; i < SR; ++i) acc[i] = 0.f;
            for (int w = 0; w < W; ++w) {
                const uint32_t raw = Ks[key * KW + w];
                const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
#pragma unroll
                for (int i = 0; i < SR; ++i) {
                    const int row = sg + i * SG;
                    acc[i] += Qs[row][2 * w] * kf.x + Qs[row][2 * w + 1] * kf.y;
                }
            }
            const int kk = k0 + key;
            const bool live = kk < kend;
            const float bias = (live && mrow[min(kk, C - 1)] > 0.f) ? 0.f : -1e9f;
#pragma unroll
            for (int i = 0; i < SR; ++i) {
                float sc = acc[i] * scale;
                if constexpr (QUANT) sc *= kss[key];
                Ps[sg + i * SG][key] = live ? sc + bias : -INFINITY;
            }
        }
        __syncthreads();

        // online softmax: each warp owns rows warp, warp + 4, ...
        for (int row = warp; row < RMAX; row += THREADS / 32) {
            float sv[BK / 32];
            float mx = NEG_BIG;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                sv[t] = Ps[row][lane + 32 * t];
                mx = fmaxf(mx, sv[t]);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_old = ms[row];
            const float m_new = fmaxf(m_old, mx);
            const float corr = expf(m_old - m_new);
            float psum = 0.f;
#pragma unroll
            for (int t = 0; t < BK / 32; ++t) {
                const float p = expf(sv[t] - m_new);
                psum += p;
                const float pw = QUANT ? p * vss[lane + 32 * t] : p;
                Ps[row][lane + 32 * t] = __bfloat162float(__float2bfloat16(pw));
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(FULL, psum, off);
            if (lane == 0) {
                ls[row] = ls[row] * corr + psum;
                ms[row] = m_new;
                cs[row] = corr;
            }
        }
        __syncthreads();

        // acc = acc * corr + P V: thread -> one bf16 pair of dh, rows vg, vg+VG, ...
#pragma unroll
        for (int i = 0; i < VR; ++i) {
            const int row = vg + i * VG;
            const float c = cs[row];
            float2 a = make_float2(o[i].x * c, o[i].y * c);
            for (int j = 0; j < BK; ++j) {
                const float p = Ps[row][j];
                const float2 vf = __bfloat1622float2(Vs[j * W + wp]);
                a.x += p * vf.x;
                a.y += p * vf.y;
            }
            o[i] = a;
        }
        __syncthreads();
    }

    const size_t pbase = ((size_t)bkh * nsplit + split) * gridDim.z * RMAX + rc * RMAX;
    if (tid < RMAX) {
        part_m[pbase + tid] = ms[tid];
        part_l[pbase + tid] = ls[tid];
    }
#pragma unroll
    for (int i = 0; i < VR; ++i) {
        const int row = vg + i * VG;
        float* dst = part_acc + (pbase + row) * DH + 2 * wp;
        dst[0] = o[i].x;
        dst[1] = o[i].y;
    }
}

// one block per (folded row, b*KH); thread d combines column d over the splits.
// With fresh_k (bf16 [B, KH, dh]) the fresh column is folded in, gated by gate[b];
// with m_out/l_out the row's M and L are written beside o = acc / L.
__global__ void flash_decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ fresh_k,
                                     const __nv_bfloat16* __restrict__ fresh_v,
                                     const float* __restrict__ gate, float scale,
                                     __nv_bfloat16* __restrict__ out,
                                     float* __restrict__ m_out, float* __restrict__ l_out,
                                     int H, int KH, int S, int nsplit, int rpad, int DH) {
    __shared__ float red[32];
    const int r = blockIdx.x;
    const int bkh = blockIdx.y;
    const int b = bkh / KH, kh = bkh % KH;
    const int g = H / KH;
    const int d = threadIdx.x;
    float M = NEG_BIG;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[((size_t)bkh * nsplit + s) * rpad + r]);
    float L = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
        const size_t pr = ((size_t)bkh * nsplit + s) * rpad + r;
        const float w = expf(part_m[pr] - M);
        L += part_l[pr] * w;
        acc += part_acc[pr * DH + d] * w;
    }
    const int h = kh * g + r / S, p = r % S;
    const size_t oi = (((size_t)b * H + h) * S + p) * DH + d;
    if (fresh_k == nullptr) {
        out[oi] = __float2bfloat16(acc / L);
        if (m_out != nullptr && d == 0) {
            const size_t ri = ((size_t)b * H + h) * S + p;
            m_out[ri] = M;
            l_out[ri] = L;
        }
        return;
    }
    // s2 = q . kn * scale: a block reduction over the DH threads
    float part = __bfloat162float(q[oi]) * __bfloat162float(fresh_k[(size_t)bkh * DH + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    if ((d & 31) == 0) red[d >> 5] = part;
    __syncthreads();
    float s2 = 0.f;
    for (int w = 0; w < DH / 32; ++w) s2 += red[w];
    s2 *= scale;
    const float m = fmaxf(M, s2);
    const float c1 = expf(M - m);
    const float a1 = c1 * L;
    const float a2 = expf(s2 - m) * gate[b];
    const float ctx = acc * c1 + a2 * __bfloat162float(fresh_v[(size_t)bkh * DH + d]);
    out[oi] = __float2bfloat16(ctx / fmaxf(a1 + a2, 1e-30f));
}

template <int DH, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* mask, const void* fk, const void* fv, const void* gate, void* part_m,
           void* part_l, void* part_acc, void* out, void* m_out, void* l_out, int B, int H,
           int KH, int S, int C, int nsplit, int chunk, float scale, cudaStream_t st) {
    const int R = (H / KH) * S;
    const int nrc = (R + RMAX - 1) / RMAX;
    dim3 g1(B * KH, nsplit, nrc);
    flash_decode_split<DH, QUANT><<<g1, THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
        (const float*)mask, H, KH, S, C, chunk, scale, (float*)part_m, (float*)part_l,
        (float*)part_acc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 g2(R, B * KH);
    flash_decode_combine<<<g2, DH, 0, st>>>((const float*)part_m, (const float*)part_l,
                                            (const float*)part_acc, (const __nv_bfloat16*)q,
                                            (const __nv_bfloat16*)fk, (const __nv_bfloat16*)fv,
                                            (const float*)gate, scale, (__nv_bfloat16*)out,
                                            (float*)m_out, (float*)l_out, H, KH, S, nsplit,
                                            nrc * RMAX, DH);
    return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, const void* fk, const void* fv, const void* gate, void* part_m,
             void* part_l, void* part_acc, void* out, void* m_out, void* l_out, int B, int H,
             int KH, int S, int C, int dh, int nsplit, int chunk, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128)
        return launch<128, QUANT>(q, k, v, ks, vs, mask, fk, fv, gate, part_m, part_l,
                                  part_acc, out, m_out, l_out, B, H, KH, S, C, nsplit, chunk,
                                  scale, st);
    if (dh == 64)
        return launch<64, QUANT>(q, k, v, ks, vs, mask, fk, fv, gate, part_m, part_l,
                                 part_acc, out, m_out, l_out, B, H, KH, S, C, nsplit, chunk,
                                 scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// part_m/part_l: [B*KH, nsplit, ceil(g*S/16)*16] f32; part_acc: the same x dh.
// fk/fv ([B, KH, 1, dh] bf16) and gate ([B] f32): the fresh fold, or all null.
// m_out/l_out ([B, H, S] f32): the (m, l) outputs, or both null; never with the fold.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* mask,
                            const void* fk, const void* fv, const void* gate,
                            void* part_m, void* part_l, void* part_acc, void* out,
                            void* m_out, void* l_out, int B, int H, int KH, int S, int C,
                            int dh, int nsplit, int chunk, float scale, void* stream) {
    return dispatch<false>(q, k, v, nullptr, nullptr, mask, fk, fv, gate, part_m, part_l,
                           part_acc, out, m_out, l_out, B, H, KH, S, C, dh, nsplit, chunk,
                           scale, stream);
}

// k8/v8: int8 codes [B, KH, C, dh]; ks/vs: [B, KH, C] f32 scales.
extern "C" int flash_decode_int8(const void* q, const void* k8, const void* v8, const void* ks,
                                 const void* vs, const void* mask, const void* fk,
                                 const void* fv, const void* gate, void* part_m, void* part_l,
                                 void* part_acc, void* out, void* m_out, void* l_out, int B,
                                 int H, int KH, int S, int C, int dh, int nsplit, int chunk,
                                 float scale, void* stream) {
    return dispatch<true>(q, k8, v8, ks, vs, mask, fk, fv, gate, part_m, part_l, part_acc,
                          out, m_out, l_out, B, H, KH, S, C, dh, nsplit, chunk, scale, stream);
}
