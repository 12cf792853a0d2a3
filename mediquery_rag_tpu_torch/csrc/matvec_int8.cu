// Int8 weight-streaming matvec for LM decode: out[b, f] = float(sum_d x8[b, d] * w8[f, d]) * s[f].
//
// Replaces the Pallas kernels mediquery_rag_tpu/ops/matvec.py:_matvec_kernel
// (:30) and _matvec_stacked_kernel (:69). The stacked [L, F, D] form with a
// layer index is this same kernel at a pointer offset (the wrapper passes
// w8 + layer*F*D and s + layer*F).
//
// What bounds it on an H100: at decode (B = 1..8 rows) every weight byte is
// read once per step and used for B multiply-adds, far below the ~295 ops
// per byte the card needs before compute matters, so the kernel is bound by
// device-memory bandwidth on the int8 weights (3.35 TB/s peak). The design
// therefore only tries to keep many 16-byte weight loads in flight:
//   * each warp owns ROWS output channels and streams those rows with one
//     16-byte load per lane per row and iteration (coalesced 512 B / warp);
//   * the activations (B x D int8, a few KB) come from L1/L2 and are reused
//     for all ROWS channels of the warp;
//   * __dp4a does four int8 products into an int32 per instruction;
//   * a warp shuffle reduction finishes each dot; lane 0 applies the scale.
// Batches above BT rows run as extra grid rows (blockIdx.y); the weight
// re-read then mostly hits L2. Requires D % 16 == 0 and 16-byte aligned
// pointers (checked by the wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // warps per block
constexpr int ROWS = 2;    // output channels per warp
constexpr int BT = 8;      // batch rows per block

__global__ void __launch_bounds__(WARPS * 32)
matvec_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ out,
                   int B, int F, int D) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int f0 = (blockIdx.x * WARPS + warp) * ROWS;
    if (f0 >= F) return;                       // warp-uniform
    const int b0 = blockIdx.y * BT;
    const int nb = min(BT, B - b0);
    const int nv = D >> 4;                     // 16-byte chunks per row
    const int4* xv = reinterpret_cast<const int4*>(x) + (size_t)b0 * nv;

    int acc[ROWS][BT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < BT; ++i) acc[r][i] = 0;

    const int4* wv[ROWS];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        live[r] = f0 + r < F;
        wv[r] = reinterpret_cast<const int4*>(w + (size_t)(live[r] ? f0 + r : f0) * D);
    }

    for (int c = lane; c < nv; c += 32) {
        int4 wq[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) wq[r] = __ldg(wv[r] + c);
#pragma unroll
        for (int i = 0; i < BT; ++i) {
            if (i < nb) {
                const int4 xq = __ldg(xv + (size_t)i * nv + c);
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    int a = acc[r][i];
                    a = __dp4a(wq[r].x, xq.x, a);
                    a = __dp4a(wq[r].y, xq.y, a);
                    a = __dp4a(wq[r].z, xq.z, a);
                    a = __dp4a(wq[r].w, xq.w, a);
                    acc[r][i] = a;
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int i = 0; i < BT; ++i) {
            int a = acc[r][i];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
            if (lane == 0 && live[r] && i < nb) {
                out[(size_t)(b0 + i) * F + f0 + r] = (float)a * s[f0 + r];
            }
        }
    }
}

}  // namespace

extern "C" int matvec_int8(const void* x, const void* w, const void* s, void* out,
                           int B, int F, int D, void* stream) {
    const int rows_per_block = WARPS * ROWS;
    dim3 grid((F + rows_per_block - 1) / rows_per_block, (B + BT - 1) / BT);
    matvec_int8_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)s, (float*)out, B, F, D);
    return (int)cudaGetLastError();
}
