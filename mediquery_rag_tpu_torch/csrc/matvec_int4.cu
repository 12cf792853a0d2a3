// Int4 weight-streaming matvec for LM decode, two halves from one packed byte row:
//   dotU[b, r] = sum_d x8[b, d] * (q4[r, d] & 15)      (low nibble, code + 8)
//   dotP[b, r] = sum_d x8[b, d] * q4[r, d]             (the signed byte 16 hi + lo + 8)
//   out[b, r]        = (float(dotU) - corr[b]) * s[0, r]              channel r
//   out[b, F/2 + r]  = float(dotP - dotU) * 0.0625 * s[1, r]          channel r + F/2
// with corr[b] = 8 * sum_d x8[b, d] computed by the wrapper.
//
// Replaces the Pallas kernels mediquery_rag_tpu/ops/matvec.py:_matvec4_kernel
// (:228) and _matvec4_stacked_kernel (:282). The stacked [L, F/2, D] form with
// a layer index is this same kernel at a pointer offset (the wrapper passes
// q4[layer] and s[layer], contiguous views).
//
// What bounds it on an H100: at decode (B = 1..8 rows) every packed weight byte
// is read once per step for 2*B multiply-adds, far below the ~295 ops per byte
// the card needs before compute matters, so it is bound by device-memory
// bandwidth on the packed weights (half the bytes of int8). The design is
// matvec_int8.cu's: each warp owns ROWS packed rows and streams them with one
// 16-byte load per lane per row and iteration; the activations (a few KB) come
// from L1/L2 and are reused for every row of the warp; __dp4a does four
// products per instruction, once on the signed bytes and once on the bytes
// masked to their low nibbles (0..15, the same value signed or unsigned); a
// warp shuffle finishes each dot; lane 0 applies the f32 epilogue in the JAX
// kernel's order with _rn intrinsics (no FMA contraction), so the result is
// bit-equal to the plain version. Requires D % 16 == 0 and 16-byte aligned
// pointers (checked by the wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // warps per block
constexpr int ROWS = 2;    // packed rows (output pairs) per warp
constexpr int BT = 8;      // batch rows per block
constexpr int LO_MASK = 0x0F0F0F0F;

__global__ void __launch_bounds__(WARPS * 32)
matvec_int4_kernel(const int8_t* __restrict__ x, const float* __restrict__ corr,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   float* __restrict__ out, int B, int F2, int D) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = (blockIdx.x * WARPS + warp) * ROWS;
    if (r0 >= F2) return;                      // warp-uniform
    const int b0 = blockIdx.y * BT;
    const int nb = min(BT, B - b0);
    const int nv = D >> 4;                     // 16-byte chunks per row
    const int4* xv = reinterpret_cast<const int4*>(x) + (size_t)b0 * nv;

    int accU[ROWS][BT], accP[ROWS][BT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < BT; ++i) { accU[r][i] = 0; accP[r][i] = 0; }

    const int4* wv[ROWS];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        live[r] = r0 + r < F2;
        wv[r] = reinterpret_cast<const int4*>(w + (size_t)(live[r] ? r0 + r : r0) * D);
    }

    for (int c = lane; c < nv; c += 32) {
        int4 wq[ROWS], wl[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            wq[r] = __ldg(wv[r] + c);
            wl[r] = make_int4(wq[r].x & LO_MASK, wq[r].y & LO_MASK,
                              wq[r].z & LO_MASK, wq[r].w & LO_MASK);
        }
#pragma unroll
        for (int i = 0; i < BT; ++i) {
            if (i < nb) {
                const int4 xq = __ldg(xv + (size_t)i * nv + c);
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    int u = accU[r][i], p = accP[r][i];
                    u = __dp4a(wl[r].x, xq.x, u);
                    u = __dp4a(wl[r].y, xq.y, u);
                    u = __dp4a(wl[r].z, xq.z, u);
                    u = __dp4a(wl[r].w, xq.w, u);
                    p = __dp4a(wq[r].x, xq.x, p);
                    p = __dp4a(wq[r].y, xq.y, p);
                    p = __dp4a(wq[r].z, xq.z, p);
                    p = __dp4a(wq[r].w, xq.w, p);
                    accU[r][i] = u;
                    accP[r][i] = p;
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int i = 0; i < BT; ++i) {
            int u = accU[r][i], p = accP[r][i];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                u += __shfl_xor_sync(0xffffffffu, u, o);
                p += __shfl_xor_sync(0xffffffffu, p, o);
            }
            if (lane == 0 && live[r] && i < nb) {
                const int row = r0 + r;
                float* o = out + (size_t)(b0 + i) * 2 * F2;
                o[row] = __fmul_rn(__fsub_rn(__int2float_rn(u), corr[b0 + i]), s[row]);
                o[F2 + row] = __fmul_rn(__fmul_rn(__int2float_rn(p - u), 0.0625f), s[F2 + row]);
            }
        }
    }
}

}  // namespace

// x [B, D] i8, corr [B] f32, w [F2, D] i8 packed, s [2, F2] f32 -> out [B, 2*F2] f32.
extern "C" int matvec_int4(const void* x, const void* corr, const void* w, const void* s,
                           void* out, int B, int F2, int D, void* stream) {
    const int rows_per_block = WARPS * ROWS;
    dim3 grid((F2 + rows_per_block - 1) / rows_per_block, (B + BT - 1) / BT);
    matvec_int4_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const float*)corr, (const int8_t*)w, (const float*)s,
        (float*)out, B, F2, D);
    return (int)cudaGetLastError();
}
