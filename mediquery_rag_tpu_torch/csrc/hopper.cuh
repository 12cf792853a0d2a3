// Hopper building blocks shared by the attention kernels (flash_prefill.cu,
// flash_backward.cu): mbarriers, TMA loads (cp.async.bulk.tensor), wgmma
// (warpgroup matrix products from shared memory, or with A from registers)
// and their shared-memory descriptors, setmaxnreg, and the host-side tensor
// map encoder, looked up at run time with cudaGetDriverEntryPoint so the
// libraries need no -lcuda.
//
// Layout convention: every bf16 operand tile lives in shared memory as
// "panels" of 64 columns (128 bytes per row) with TMA's 128-byte swizzle
// (16-byte chunk j of row i stored at chunk j ^ (i % 8)), each panel
// 1024-byte aligned; a [rows, 128] tile is two panels, [rows, 64] one.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. The spin loop is
// PTX of its own, so the warp leaves it converged (the wgmma that follow
// are .sync.aligned).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n"
        :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Generic-proxy writes to shared memory (e.g. a widened tile) made visible
// to the async proxy (wgmma, TMA) before a barrier hands them over.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA loads, completion counted in bytes on an mbarrier ----
// Values [c0, c0 + box) of row `row` of a map_rows_f32 map (c0 a multiple
// of 4).
__device__ __forceinline__ void tma_load_row(void* dst, const CUtensorMap* tm, uint64_t* bar,
                                             int c0, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)), "r"(c0),
           "r"(row)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* tm, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)),
           "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// ---- register hand-over between warpgroups ----
template <int N>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma ----
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers in place around the asynchronous products, so
// the compiler neither reads them before wgmma.wait nor moves writes past
// wgmma.fence.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle: 14 bits of the
// address, the leading and stride byte offsets (16-byte units), layout 1.
// K-major panel (rows along M/N, 64 K-columns per row): SBO = 1024 (the next
// 8 rows), LBO unused; a 16-wide K step adds 32 bytes to the address.
// MN-major panel (rows along K, 64 M/N-columns per row): SBO = 1024 (the
// next 8 K-rows), LBO = the byte distance to the next 64-column panel; a
// 16-deep K step adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (row, col) of a [rows, 64-column-panel] bf16 tile
// stored as TMA's 128-byte swizzle writes it (col < 64).
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
    // D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B from shared memory, both K-major
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(acc));
    }
    // D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A from registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
};

template <>
struct Wgmma<128> {
    // D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B from shared memory, both K-major
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(da), "l"(db), "r"(acc));
    }
    // D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A from registers, B MN-major in shared memory
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
};

}  // namespace hop

// ---- host: tensor maps ----
namespace hop_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// Error codes the C entry points return when a tensor map cannot be made
// (beside cudaError_t values, which stay below 1000): ERR_NO_ENCODER, or
// ERR_ENCODE + the CUresult of the encoder.
constexpr int ERR_NO_ENCODER = 1000;
constexpr int ERR_ENCODE = 2000;

// A map over `rows` rows of n f32 values, each row starting (n + 3) / 4 * 4
// values after the one before (TMA wants 16-byte row strides and 16-byte
// aligned reads, so callers pad rows to a multiple of 4); box [1, box];
// values past n of a row read as 0.
inline int map_rows_f32(CUtensorMap* m, const void* ptr, uint64_t rows, uint64_t n,
                        uint32_t box) {
    EncodeTiled enc = encoder();
    if (!enc) return ERR_NO_ENCODER;
    cuuint64_t dims[2] = {n, rows};
    cuuint64_t strides[1] = {(n + 3) / 4 * 16};
    cuuint32_t boxd[2] = {box, 1}, es[2] = {1, 1};
    CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                     boxd, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A 3-D map over [groups, rows, cols] (cols contiguous) of bf16 (swizzled
// 64-column boxes) or int8 (whole rows, no swizzle); box [1, box_rows,
// box_cols]; rows past `rows` of a group read as 0.
inline int map_3d(CUtensorMap* m, const void* ptr, bool int8, uint64_t groups, uint64_t rows,
                  uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
    EncodeTiled enc = encoder();
    if (!enc) return ERR_NO_ENCODER;
    const uint64_t esz = int8 ? 1 : 2;
    cuuint64_t dims[3] = {cols, rows, groups};
    cuuint64_t strides[2] = {cols * esz, rows * cols * esz};
    cuuint32_t boxd[3] = {box_cols, box_rows, 1}, es[3] = {1, 1, 1};
    CUresult r = enc(m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<void*>(ptr), dims, strides, boxd, es,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

}  // namespace hop_host
