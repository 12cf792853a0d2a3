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
// is read once per step for 2*B multiply-adds, far below the ~590 int8 ops per
// byte the card needs before compute matters, so it is bound by device-memory
// bandwidth on the packed weights. At 128 rows (a short prefill) the two dots
// come to 512 ops per weight byte, and mma.sync's rate binds.
//
// Design for Hopper (one launch):
//   * a block owns 16 packed weight rows (one mma M tile) and up to 32 rows of
//     x (x's rows past 32 go to more blocks, grid.y, which meet the same
//     weight tile in the L2, so device memory still serves each weight byte
//     once), and walks the whole of D in 1 KB slices;
//   * its 4 warps split each slice along D, 256 bytes a warp, so a 16-row
//     tile is enough work for 4 warps and the grid has F/32 blocks without
//     splitting D over blocks (no partial sums leave the block, no second
//     pass, no arrival counters: the warps' int32 partial dots meet once in
//     shared memory at the end, exact in any order);
//   * the slices stream through a ring of `stages` shared-memory stages with
//     cp.async (16 bytes a thread, zero-filled past F/2 rows, past x's rows or
//     past D), the weight slice [16 x 1 KB] and x's slice [8*NT x 1 KB] side by
//     side, stored with a 16-byte-chunk swizzle so that ldmatrix reads them
//     without bank conflicts; the plan deepens the ring where the grid is
//     small, so about 8 MB or more are in flight on the card;
//   * the integer product is mma.sync.m16n8k32.s32.s8.s8 with the packed
//     weight rows on the M side (the A fragment masked with & 0x0F0F0F0F in
//     registers for dotU) and x's rows on the N side in NT tiles of 8;
//   * the f32 epilogue runs in the JAX kernel's order with _rn intrinsics (no
//     FMA contraction), so the result is bit-equal to the plain version.
// Requires D % 16 == 0 and 16-byte aligned pointers (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 16;                    // packed weight rows per block
constexpr int QUARTER = 256;              // bytes of D per warp and stage
constexpr int SLICE = WARPS * QUARTER;    // bytes of D per stage
constexpr int W_STAGE = MT * SLICE;       // the weight part of a stage
constexpr int GROUP = 32;                 // x rows per block (NT <= 4)
constexpr unsigned LO_MASK = 0x0F0F0F0Fu;

struct Args {
    const int8_t* x;
    const float* corr;
    const int8_t* w;
    const float* s;
    float* out;
    int B, F2, D, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most stages - 2 groups are pending (the ring's depth, 2..8)
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
    switch (stages) {
        case 2: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 3: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 4: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        case 5: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
        case 6: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
        case 7: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk ch (0..15) of row `row` in a [rows x 256-byte]
// quarter stored as two [rows x 128-byte] panels, chunk j of a row at j ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int rows, int row, int ch) {
    return (ch >> 3) * rows * 128 + row * 128 + ((((ch & 7) ^ row) & 7) << 4);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
matvec_int4_kernel(const Args a) {
    constexpr int XR = NT * 8;                        // x rows per block, padded to 8
    constexpr int STAGE = W_STAGE + XR * SLICE;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red[WARPS][2][XR][MT];              // each warp's partial dots

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = blockIdx.x * MT;
    const int b0 = blockIdx.y * GROUP;
    const int nb = min(GROUP, a.B - b0);
    const int n = (a.D + SLICE - 1) / SLICE;
    const int8_t* x = a.x + (size_t)b0 * a.D;
    const uint32_t base = smem_u32(smem);

    // stage i <- slice i: weights as 4 quarters [16 rows][256 B], then x as 4 [XR][256 B]
    auto load = [&](int i) {
        const int k0 = i * SLICE;
        const uint32_t st = base + (i % a.stages) * STAGE;
#pragma unroll
        for (int j = 0; j < MT * SLICE / 16 / THREADS; ++j) {
            const int c = tid + j * THREADS, row = c >> 6, q = (c >> 4) & 3, ch = c & 15;
            const int k = k0 + (c & 63) * 16;
            const bool ok = r0 + row < a.F2 && k < a.D;
            cp_async16(st + q * MT * QUARTER + swz(MT, row, ch),
                       a.w + (ok ? (size_t)(r0 + row) * a.D + k : 0), ok ? 16 : 0);
        }
#pragma unroll
        for (int j = 0; j < XR * SLICE / 16 / THREADS; ++j) {
            const int c = tid + j * THREADS, row = c >> 6, q = (c >> 4) & 3, ch = c & 15;
            const int k = k0 + (c & 63) * 16;
            const bool ok = row < nb && k < a.D;
            cp_async16(st + W_STAGE + q * XR * QUARTER + swz(XR, row, ch),
                       x + (ok ? (size_t)row * a.D + k : 0), ok ? 16 : 0);
        }
    };

    int accP[NT][4], accU[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) accP[j][e] = accU[j][e] = 0;

    for (int i = 0; i < a.stages - 1; ++i) {
        if (i < n) load(i);
        cp_async_commit();
    }
    const int ar = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix row of A
    for (int i = 0; i < n; ++i) {
        cp_async_wait_ring(a.stages);
        __syncthreads();                  // stage i landed; stage i - 1 is free
        if (i + a.stages - 1 < n) load(i + a.stages - 1);
        cp_async_commit();

        const uint32_t wq = base + (i % a.stages) * STAGE + warp * MT * QUARTER;
        const uint32_t xq = base + (i % a.stages) * STAGE + W_STAGE + warp * XR * QUARTER;
#pragma unroll
        for (int ks = 0; ks < QUARTER / 32; ++ks) {
            const int ch = 2 * ks;                        // first chunk of this k32 step
            uint32_t af[4], au[4];
            ldsm_x4(af, wq + swz(MT, ar, ch + (lane >> 4)));
#pragma unroll
            for (int q = 0; q < 4; ++q) au[q] = af[q] & LO_MASK;
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t b[4];
                const int jt = j + 1 < NT ? j + (lane >> 4) : j;
                const uint32_t addr = xq + swz(XR, 8 * jt + (lane & 7), ch + ((lane >> 3) & 1));
                if (j + 1 < NT) {
                    ldsm_x4(b, addr);
                    mma_s8(accP[j + 1], af, b[2], b[3]);
                    mma_s8(accU[j + 1], au, b[2], b[3]);
                } else {
                    ldsm_x2(b, addr);
                }
                mma_s8(accP[j], af, b[0], b[1]);
                mma_s8(accU[j], au, b[0], b[1]);
            }
        }
    }

    // the 4 warps' partial dots (each over its quarters of D) meet in shared memory
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = g + (e >> 1) * 8, col = 8 * j + 2 * t + (e & 1);
            red[warp][0][col][row] = accP[j][e];
            red[warp][1][col][row] = accU[j][e];
        }
    __syncthreads();
    for (int c = tid; c < nb * MT; c += THREADS) {
        const int col = c / MT, row = c % MT, r = r0 + row;
        if (r >= a.F2) continue;
        int p = 0, u = 0;                 // int32 sums: exact in any order
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            p += red[w][0][col][row];
            u += red[w][1][col][row];
        }
        float* o = a.out + (size_t)(b0 + col) * 2 * a.F2;
        o[r] = __fmul_rn(__fsub_rn(__int2float_rn(u), a.corr[b0 + col]), a.s[r]);
        o[a.F2 + r] = __fmul_rn(__fmul_rn(__int2float_rn(p - u), 0.0625f), a.s[a.F2 + r]);
    }
}

template <int NT>
int launch(const Args& a, dim3 grid, cudaStream_t st) {
    const int smem = a.stages * (W_STAGE + NT * 8 * SLICE);
    static int allowed[64] = {};          // dynamic shared memory opted in, per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || smem > allowed[dev]) {
        e = cudaFuncSetAttribute(matvec_int4_kernel<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        if (dev < 64) allowed[dev] = smem;
    }
    matvec_int4_kernel<NT><<<grid, THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// x [B, D] i8, corr [B] f32, w [F2, D] i8 packed, s [2, F2] f32 -> out [B, 2*F2] f32.
// ntiles: n8 tiles of x rows per block (1..4; 8*ntiles >= min(B, 32)); stages:
// the ring's depth (2..8). Grid: ceil(F2/16) x ceil(B/32) blocks.
extern "C" int matvec_int4(const void* x, const void* corr, const void* w, const void* s,
                           void* out, int B, int F2, int D, int ntiles, int stages,
                           void* stream) {
    if (B < 1 || F2 < 1 || D % 16 || stages < 2 || stages > 8 || ntiles < 1 || ntiles > 4 ||
        8 * ntiles < min(B, GROUP))
        return (int)cudaErrorInvalidValue;
    Args a{(const int8_t*)x, (const float*)corr, (const int8_t*)w, (const float*)s,
           (float*)out, B, F2, D, stages};
    const dim3 grid((F2 + MT - 1) / MT, (B + GROUP - 1) / GROUP);
    cudaStream_t st = (cudaStream_t)stream;
    switch (ntiles) {
        case 1: return launch<1>(a, grid, st);
        case 2: return launch<2>(a, grid, st);
        case 3: return launch<3>(a, grid, st);
        default: return launch<4>(a, grid, st);
    }
}
