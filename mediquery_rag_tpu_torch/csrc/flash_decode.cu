// Mask-only attention of a few query rows over a bf16 KV cache (decode), split over
// the cache length and combined in a second pass.
//
// Replaces the forward of the Pallas kernel mediquery_rag_tpu/ops/attention.py:
// _flash_cached_kernel (:171, launched at :498 via _flash_call; entry point
// flash_attention_cached :905) for a bf16 cache, without int8 KV, the
// fresh-column fold or (m, l) outputs.
//
// Semantics kept: compact GQA fold (the g*S query rows of one KV head share
// every K/V tile), visibility from the key mask alone with a -1e9 bias on
// masked keys, f32 online softmax, P cast to bf16 before P.V.
// Design for Hopper: at decode B*KH is tiny (4 (lane, KV head) pairs at B=1
// on a 7B GQA model), so one block per pair would leave 128 of 132 SMs idle.
// Pass 1 splits the cache length over blocks (grid.y); each block streams
// 64-key K/V tiles through shared memory (K rows padded to an odd word
// stride, so 32 consecutive keys hit 32 banks), keeps its own (m, l, acc)
// for up to 16 folded rows in f32 and writes them out. Pass 2 combines the
// splits: M = max m_s, L = sum l_s e^(m_s - M), O = sum acc_s e^(m_s - M) / L.
// What bounds it on an H100: every cache byte is read once per step for
// 2*g flops per element, far below the compute/bandwidth balance, so it is
// bound by reading the cache (2*C*KH*dh*2 bytes per lane and layer).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;         // keys per tile
constexpr int RMAX = 16;       // folded query rows per block
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
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
        for (int idx = tid; idx < BK * (DH / 8); idx += THREADS) {
            const int row = idx / (DH / 8), cc = idx % (DH / 8);
            int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
            if (k0 + row < kend) {
                const size_t off = kvbase + (size_t)(k0 + row) * DH + cc * 8;
                kv = *reinterpret_cast<const int4*>(k + off);
                vv = *reinterpret_cast<const int4*>(v + off);
            }
            uint32_t* kd = Ks + row * KW + cc * 4;
            kd[0] = (uint32_t)kv.x; kd[1] = (uint32_t)kv.y;
            kd[2] = (uint32_t)kv.z; kd[3] = (uint32_t)kv.w;
            *reinterpret_cast<int4*>(Vs + row * W + cc * 4) = vv;
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
            for (int i = 0; i < SR; ++i)
                Ps[sg + i * SG][key] = live ? acc[i] * scale + bias : -INFINITY;
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
                Ps[row][lane + 32 * t] = __bfloat162float(__float2bfloat16(p));
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

// one block per (folded row, b*KH); thread d combines column d over the splits
__global__ void flash_decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out,
                                     int H, int KH, int S, int nsplit, int rpad, int DH) {
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
    out[(((size_t)b * H + h) * S + p) * DH + d] = __float2bfloat16(acc / L);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* part_m,
           void* part_l, void* part_acc, void* out, int B, int H, int KH, int S, int C,
           int nsplit, int chunk, float scale, cudaStream_t st) {
    const int R = (H / KH) * S;
    const int nrc = (R + RMAX - 1) / RMAX;
    dim3 g1(B * KH, nsplit, nrc);
    flash_decode_split<DH><<<g1, THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const float*)mask, H, KH, S, C, chunk, scale, (float*)part_m, (float*)part_l,
        (float*)part_acc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 g2(R, B * KH);
    flash_decode_combine<<<g2, DH, 0, st>>>((const float*)part_m, (const float*)part_l,
                                            (const float*)part_acc, (__nv_bfloat16*)out,
                                            H, KH, S, nsplit, nrc * RMAX, DH);
    return (int)cudaGetLastError();
}

}  // namespace

// part_m/part_l: [B*KH, nsplit, ceil(g*S/16)*16] f32; part_acc: the same x dh.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* mask,
                            void* part_m, void* part_l, void* part_acc, void* out,
                            int B, int H, int KH, int S, int C, int dh, int nsplit,
                            int chunk, float scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128)
        return launch<128>(q, k, v, mask, part_m, part_l, part_acc, out, B, H, KH, S, C,
                           nsplit, chunk, scale, st);
    if (dh == 64)
        return launch<64>(q, k, v, mask, part_m, part_l, part_acc, out, B, H, KH, S, C,
                          nsplit, chunk, scale, st);
    return (int)cudaErrorInvalidValue;
}
