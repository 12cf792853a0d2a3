// Causal flash attention forward for prefill (bf16 in, bf16 out, f32 softmax state).
//
// Replaces the forward of the Pallas kernel mediquery_rag_tpu/ops/attention.py:
// _flash_kernel (:72, launched at :498 via _flash_call :278; entry points
// flash_attention :822 and flash_attention_at :863) without stacked layer or
// (m, l) outputs: a bf16 KV cache (flash_prefill) or an int8 cache of codes
// with per-column f32 scales (flash_prefill_int8, the kernel's quant mode:
// codes widened to bf16 in shared memory, which is exact; the logit of key c
// is (q . code_c) * scale * ks[c]; P.V takes bf16(p * vs[c]) while the
// denominator sums p).
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
//
// What bounds it on an H100: at S ~ 4K the work is ~4 * S^2/2 * dh * H
// flops against ~S * dh * (2H + 2KH) bytes, so it is bound by the tensor
// cores (989 TFLOP/s bf16 dense), reachable only through wgmma fed from
// shared memory with the softmax kept out of shared memory.
//
// Design for Hopper (warp-specialized, one block of 3 warpgroups per
// (b, KV head, 128 folded rows[, key split])):
//   * the producer warpgroup gives its registers away (setmaxnreg) and one
//     thread keeps a 2-stage ring of K/V tiles in flight with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, completion on an mbarrier);
//     Q of one (b, KV head) is one contiguous [g*S, dh] matrix (the fold
//     stacks adjacent heads), K/V one [Sk, dh] matrix, so 3-D tensor maps
//     cover them and zero-fill the ragged edges; the key mask (and the int8
//     scales) come with each tile as TMA rows;
//   * int8: TMA brings the code tiles into a staging area and the whole
//     producer warpgroup widens them into the swizzled bf16 operand tiles;
//   * each consumer warpgroup owns 64 rows: S = Q K^T by wgmma (both
//     operands K-major in shared memory) into registers; the online softmax
//     runs on the accumulator fragments (row max by quad shuffles, the mask
//     from the tile's mask row, the causal test only on diagonal tiles); P
//     goes to bf16 in registers and is wgmma's A operand for O += P V (V
//     MN-major through the descriptor's transpose); O, m and l stay in
//     registers over the whole key loop;
//   * row tiles launch heaviest (latest positions) first; where the grid is
//     under two waves (the 256-query serving piece), the key range is split
//     over up to 4 blocks that write (m, l, o) partials, combined by a
//     second kernel as B5's split kernel does.

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;              // folded query rows per block (64 per consumer)
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int NST = 2;               // K/V ring stages
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr uint32_t align1024(uint32_t x) { return (x + 1023u) & ~1023u; }

template <int DH, bool QUANT>
struct Cfg {
    static constexpr int BK = QUANT ? 64 : 128;             // keys per tile
    static constexpr uint32_t Q_BYTES = BQ * DH * 2;
    static constexpr uint32_t KV_BYTES = BK * DH * 2;       // one bf16 K or V tile
    static constexpr uint32_t CODE_BYTES = QUANT ? BK * DH : 0;
    static constexpr uint32_t ROW_BYTES = BK * 4;           // mask, ks or vs of a tile
    static constexpr uint32_t CODES_OFF = 2 * KV_BYTES;
    static constexpr uint32_t ROWS_OFF = CODES_OFF + 2 * CODE_BYTES;
    static constexpr uint32_t STAGE = align1024(ROWS_OFF + (QUANT ? 3 : 1) * ROW_BYTES);
    static constexpr uint32_t SMEM = Q_BYTES + NST * STAGE + 128 + 1024;   // + barriers, alignment
};

struct FwdMaps {
    CUtensorMap q, k, v, mask, ks, vs;
};

struct FwdArgs {
    const int* q_off;
    __nv_bfloat16* out;
    float* part_m;       // [B*KH, nsplit, Rpad] (nsplit > 1)
    float* part_l;
    float* part_o;       // [B*KH, nsplit, Rpad, DH]
    int H, KH, S, Sk, nsplit;
    float scale;
};

__device__ __forceinline__ int4 widen8(int word0, int word1) {
    // eight int8 codes (two 32-bit words) -> eight bf16 values (exact)
    uint32_t p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int w = j < 2 ? word0 : word1;
        const int sh = 16 * (j & 1);
        p[j] = hop::pack_bf16((float)(int8_t)((w >> sh) & 0xff),
                              (float)(int8_t)((w >> (sh + 8)) & 0xff));
    }
    return make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
}

// Row tile of launch slot y, heaviest (latest positions) first: with whole
// tiles per head, the last tile of every head of the group, then the one
// before, ...; otherwise simply the last tile first.
__device__ __forceinline__ int row_tile(int y, int ntiles, int S, int g) {
    if (S % BQ == 0) {
        const int per = S / BQ;
        return (y % g) * per + per - 1 - y / g;
    }
    return ntiles - 1 - y;
}

// Highest and lowest position among folded rows [r0, rl] (S rows per head).
__device__ __forceinline__ int rows_pmax(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? rl % S : S - 1;
}
__device__ __forceinline__ int rows_pmin(int r0, int rl, int S) {
    return (r0 / S == rl / S) ? r0 % S : 0;
}

template <int DH, bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
    using C = Cfg<DH, QUANT>;
    constexpr int BK = C::BK;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
    unsigned char* Qs = smem;
    unsigned char* stages = smem + C::Q_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(stages + NST * C::STAGE);
    uint64_t* empty = full + NST;
    uint64_t* staged = empty + NST;      // int8 codes landed (QUANT)
    uint64_t* qbar = staged + NST;

    const int g = a.H / a.KH;
    const int R = g * a.S;
    const int S = a.S, Sk = a.Sk;
    const int bkh = blockIdx.x / a.nsplit;
    const int split = blockIdx.x % a.nsplit;
    const int b = bkh / a.KH;
    const int tile = row_tile(blockIdx.y, gridDim.y, S, g);
    const int r0 = tile * BQ;
    const int off = a.q_off[b];

    // this block's key tiles: the visible range of its rows, cut into nsplit parts
    const int kend = max(1, min(Sk, off + rows_pmax(r0, min(r0 + BQ, R) - 1, S) + 1));
    const int ntk = (kend + BK - 1) / BK;
    const int per = (ntk + a.nsplit - 1) / a.nsplit;
    const int t_begin = min(ntk, split * per);
    const int t_end = min(ntk, t_begin + per);

    if (threadIdx.x == 0) {
        for (int s = 0; s < NST; ++s) {
            hop::mbar_init(&full[s], QUANT ? 128 : 1);
            hop::mbar_init(&empty[s], CONSUMERS * 4);
            hop::mbar_init(&staged[s], 1);
        }
        hop::mbar_init(qbar, 1);
        hop::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == CONSUMERS) {
        // ---------------- producer ----------------
        hop::reg_dealloc<40>();
        const int pt = threadIdx.x - CONSUMERS * 128;
        if (pt == 0) {
            hop::mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
            for (int p = 0; p < DH / 64; ++p)
                hop::tma_load_3d(Qs + p * BQ * 128, &maps.q, qbar, p * 64, r0, bkh);
        }
        for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
            const int s = i % NST;
            const int ph = (i / NST) & 1;
            unsigned char* st = stages + s * C::STAGE;
            if constexpr (!QUANT) {
                if (pt == 0) {
                    hop::mbar_wait(&empty[s], ph ^ 1);
                    hop::mbar_expect_tx(&full[s], 2 * C::KV_BYTES + C::ROW_BYTES);
#pragma unroll
                    for (int p = 0; p < DH / 64; ++p) {
                        hop::tma_load_3d(st + p * BK * 128, &maps.k, &full[s], p * 64, t * BK, bkh);
                        hop::tma_load_3d(st + C::KV_BYTES + p * BK * 128, &maps.v, &full[s],
                                         p * 64, t * BK, bkh);
                    }
                    hop::tma_load_row(st + C::ROWS_OFF, &maps.mask, &full[s], t * BK, b);
                }
            } else {
                hop::mbar_wait(&empty[s], ph ^ 1);
                if (pt == 0) {
                    hop::mbar_expect_tx(&staged[s], 2 * C::CODE_BYTES + 3 * C::ROW_BYTES);
                    hop::tma_load_3d(st + C::CODES_OFF, &maps.k, &staged[s], 0, t * BK, bkh);
                    hop::tma_load_3d(st + C::CODES_OFF + C::CODE_BYTES, &maps.v, &staged[s], 0,
                                     t * BK, bkh);
                    hop::tma_load_row(st + C::ROWS_OFF, &maps.mask, &staged[s], t * BK, b);
                    hop::tma_load_row(st + C::ROWS_OFF + C::ROW_BYTES, &maps.ks, &staged[s],
                                      t * BK, bkh);
                    hop::tma_load_row(st + C::ROWS_OFF + 2 * C::ROW_BYTES, &maps.vs, &staged[s],
                                      t * BK, bkh);
                }
                hop::mbar_wait(&staged[s], ph);
                // widen the codes into the swizzled bf16 K and V operand tiles
                constexpr int CPR = DH / 8;                  // 8-code chunks per row
                for (int idx = pt; idx < 2 * BK * CPR; idx += 128) {
                    const int which = idx / (BK * CPR);
                    const int rem = idx % (BK * CPR);
                    const int row = rem / CPR, ch = rem % CPR;
                    const int2 c = *reinterpret_cast<const int2*>(
                        st + C::CODES_OFF + which * C::CODE_BYTES + row * DH + ch * 8);
                    *reinterpret_cast<int4*>(st + which * C::KV_BYTES + (ch / 8) * BK * 128
                                             + hop::sw128_offset(row, (ch % 8) * 8)) =
                        widen8(c.x, c.y);
                }
                hop::fence_proxy_async();
                hop::mbar_arrive(&full[s]);
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
        const int lim_a = off + ra % S, lim_b = off + rb % S;   // last visible key of each row
        const float scale = a.scale;

        float o[DH / 2];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
        float ma = NEG_BIG, mb = NEG_BIG, la = 0.f, lb = 0.f;
        const uint32_t q_addr = hop::smem_u32(Qs) + wg * 64 * 128;
        hop::mbar_wait(qbar, 0);

        for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
            const int s = i % NST;
            const int ph = (i / NST) & 1;
            unsigned char* st = stages + s * C::STAGE;
            const int k0 = t * BK;
            hop::mbar_wait(&full[s], ph);
            if (!idle && k0 <= off + pmax_wg) {
                const uint32_t k_addr = hop::smem_u32(st);
                const uint32_t v_addr = k_addr + C::KV_BYTES;
                float sc[BK / 2];
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk)
                    hop::Wgmma<BK>::ss(
                        sc, hop::desc_sw128(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
                        hop::desc_sw128(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16), kk);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<BK / 2>(sc);

                const bool diag = k0 + BK - 1 > off + pmin_wg;
                const float* mrow = reinterpret_cast<const float*>(st + C::ROWS_OFF);
                const float* ksr = mrow + BK;
                const float* vsr = ksr + BK;
                float mxa = NEG_BIG, mxb = NEG_BIG;
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    const int col = 8 * j + 2 * (lane & 3);
                    const float2 mv = *reinterpret_cast<const float2*>(mrow + col);
                    float2 kv = make_float2(1.f, 1.f);
                    if constexpr (QUANT) kv = *reinterpret_cast<const float2*>(ksr + col);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int key = k0 + col + e;
                        const bool live = key < Sk && (e ? mv.y : mv.x) > 0.f;
                        const float ksc = scale * (e ? kv.y : kv.x);
                        const bool va = live && (!diag || key <= lim_a);
                        const bool vb = live && (!diag || key <= lim_b);
                        float& sa = sc[4 * j + e];
                        float& sb = sc[4 * j + 2 + e];
                        sa = sa * ksc + (va ? 0.f : -1e9f);
                        sb = sb * ksc + (vb ? 0.f : -1e9f);
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
                float sa = 0.f, sb = 0.f;
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    float2 vv = make_float2(1.f, 1.f);
                    if constexpr (QUANT)
                        vv = *reinterpret_cast<const float2*>(vsr + 8 * j + 2 * (lane & 3));
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float pa = exp2f((sc[4 * j + e] - na) * LOG2E);
                        const float pb = exp2f((sc[4 * j + 2 + e] - nb) * LOG2E);
                        sa += pa;
                        sb += pb;
                        const float w = QUANT ? (e ? vv.y : vv.x) : 1.f;
                        sc[4 * j + e] = pa * w;
                        sc[4 * j + 2 + e] = pb * w;
                    }
                }
                la = la * ca + sa;
                lb = lb * cb + sb;
                uint32_t pf[BK / 16][4];
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
                    pf[kk][0] = hop::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
                    pf[kk][1] = hop::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
                    pf[kk][2] = hop::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
                    pf[kk][3] = hop::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
                }
#pragma unroll
                for (int i2 = 0; i2 < DH / 2; ++i2) o[i2] *= ((i2 >> 1) & 1) ? cb : ca;
                hop::fence_regs<DH / 2>(o);
                hop::wg_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    hop::Wgmma<DH>::rs(o, pf[kk], hop::desc_sw128(v_addr + kk * 2048, BK * 128), 1);
                hop::wg_commit();
                hop::wg_wait<0>();
                hop::fence_regs<DH / 2>(o);
            }
            __syncwarp();
            if (lane == 0) hop::mbar_arrive(&empty[s]);
        }

        // ---------------- epilogue ----------------
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
            la += __shfl_xor_sync(0xffffffffu, la, o_);
            lb += __shfl_xor_sync(0xffffffffu, lb, o_);
        }
        if (a.nsplit == 1) {
            // out has q's layout, so the folded rows of (b, kh) are contiguous
            __nv_bfloat16* ob = a.out + (size_t)bkh * R * DH;
            const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
                const int col = 8 * j + 2 * (lane & 3);
                if (ra < R)
                    *reinterpret_cast<uint32_t*>(ob + (size_t)ra * DH + col) =
                        hop::pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
                if (rb < R)
                    *reinterpret_cast<uint32_t*>(ob + (size_t)rb * DH + col) =
                        hop::pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
            }
        } else {
            const int rpad = gridDim.y * BQ;
            const size_t base = ((size_t)bkh * a.nsplit + split) * rpad;
#pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
                const int col = 8 * j + 2 * (lane & 3);
                *reinterpret_cast<float2*>(a.part_o + (base + ra) * DH + col) =
                    make_float2(o[4 * j], o[4 * j + 1]);
                *reinterpret_cast<float2*>(a.part_o + (base + rb) * DH + col) =
                    make_float2(o[4 * j + 2], o[4 * j + 3]);
            }
            if ((lane & 3) == 0) {
                a.part_m[base + ra] = ma;
                a.part_l[base + ra] = la;
                a.part_m[base + rb] = mb;
                a.part_l[base + rb] = lb;
            }
        }
    }
}

// Second pass of a split key range: M = max m_s, o = sum o_s e^(m_s - M) /
// sum l_s e^(m_s - M), four columns per thread.
template <int DH>
__global__ void combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                               const float* __restrict__ po, __nv_bfloat16* __restrict__ out,
                               int R, int rpad, int nsplit) {
    const int bkh = blockIdx.y;
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= R * (DH / 4)) return;
    const int r = idx / (DH / 4), c4 = idx % (DH / 4);
    float M = NEG_BIG;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[((size_t)bkh * nsplit + s) * rpad + r]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
        const size_t row = ((size_t)bkh * nsplit + s) * rpad + r;
        const float w = exp2f((pm[row] - M) * LOG2E);
        L += pl[row] * w;
        const float4 x = *reinterpret_cast<const float4*>(po + row * DH + 4 * c4);
        acc.x += x.x * w;
        acc.y += x.y * w;
        acc.z += x.z * w;
        acc.w += x.w * w;
    }
    const float inv = 1.f / L;
    uint2 packed = make_uint2(hop::pack_bf16(acc.x * inv, acc.y * inv),
                              hop::pack_bf16(acc.z * inv, acc.w * inv));
    *reinterpret_cast<uint2*>(out + ((size_t)bkh * R + r) * DH + 4 * c4) = packed;
}

template <int DH, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* mask, const void* q_off, void* out, void* part_m, void* part_l,
           void* part_o, int B, int H, int KH, int S, int Sk, int nsplit, float scale,
           cudaStream_t st) {
    using C = Cfg<DH, QUANT>;
    const int g = H / KH, R = g * S;
    FwdMaps maps;
    int e;
    if ((e = hop_host::map_3d(&maps.q, q, false, B * KH, R, DH, BQ, 64))) return e;
    if ((e = hop_host::map_3d(&maps.k, k, QUANT, B * KH, Sk, DH, C::BK, QUANT ? DH : 64))) return e;
    if ((e = hop_host::map_3d(&maps.v, v, QUANT, B * KH, Sk, DH, C::BK, QUANT ? DH : 64))) return e;
    if ((e = hop_host::map_rows_f32(&maps.mask, mask, B, Sk, C::BK))) return e;
    maps.ks = maps.mask;
    maps.vs = maps.mask;
    if (QUANT) {
        if ((e = hop_host::map_rows_f32(&maps.ks, ks, B * KH, Sk, C::BK))) return e;
        if ((e = hop_host::map_rows_f32(&maps.vs, vs, B * KH, Sk, C::BK))) return e;
    }
    cudaError_t ce = cudaFuncSetAttribute(flash_prefill_kernel<DH, QUANT>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    const int tiles = (R + BQ - 1) / BQ;
    FwdArgs args{(const int*)q_off, (__nv_bfloat16*)out, (float*)part_m, (float*)part_l,
                 (float*)part_o, H, KH, S, Sk, nsplit, scale};
    flash_prefill_kernel<DH, QUANT><<<dim3(B * KH * nsplit, tiles), THREADS, C::SMEM, st>>>(
        maps, args);
    ce = cudaGetLastError();
    if (ce != cudaSuccess || nsplit == 1) return (int)ce;
    dim3 cgrid((R * (DH / 4) + 255) / 256, B * KH);
    combine_kernel<DH><<<cgrid, 256, 0, st>>>((const float*)part_m, (const float*)part_l,
                                              (const float*)part_o, (__nv_bfloat16*)out, R,
                                              tiles * BQ, nsplit);
    return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, const void* q_off, void* out, void* part_m, void* part_l,
             void* part_o, int B, int H, int KH, int S, int Sk, int dh, int nsplit, float scale,
             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (nsplit < 1) return (int)cudaErrorInvalidValue;
    if (dh == 128)
        return launch<128, QUANT>(q, k, v, ks, vs, mask, q_off, out, part_m, part_l, part_o, B,
                                  H, KH, S, Sk, nsplit, scale, st);
    if (dh == 64)
        return launch<64, QUANT>(q, k, v, ks, vs, mask, q_off, out, part_m, part_l, part_o, B,
                                 H, KH, S, Sk, nsplit, scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: [B, H, S, dh] bf16; k, v: [B, KH, Sk, dh] bf16; mask: [B, Sk] f32,
// each row padded to a multiple of 4 values (Sk4); q_off: [B] int32 -> out: [B, H, S, dh] bf16. With nsplit > 1 the key range
// of each row tile is split over nsplit blocks; part_m/part_l [B*KH, nsplit,
// Rpad] and part_o [B*KH, nsplit, Rpad, dh] f32 (Rpad = g*S rounded up to
// 128) hold their partial states.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, const void* mask,
                             const void* q_off, void* out, void* part_m, void* part_l,
                             void* part_o, int B, int H, int KH, int S, int Sk, int dh,
                             int nsplit, float scale, void* stream) {
    return dispatch<false>(q, k, v, nullptr, nullptr, mask, q_off, out, part_m, part_l, part_o,
                           B, H, KH, S, Sk, dh, nsplit, scale, stream);
}

// k8/v8: int8 codes [B, KH, Sk, dh]; ks/vs: [B, KH, Sk4] f32 scales (rows
// padded as the mask's).
extern "C" int flash_prefill_int8(const void* q, const void* k8, const void* v8, const void* ks,
                                  const void* vs, const void* mask, const void* q_off, void* out,
                                  void* part_m, void* part_l, void* part_o, int B, int H, int KH,
                                  int S, int Sk, int dh, int nsplit, float scale, void* stream) {
    return dispatch<true>(q, k8, v8, ks, vs, mask, q_off, out, part_m, part_l, part_o, B, H, KH,
                          S, Sk, dh, nsplit, scale, stream);
}
