// Mask-only attention of a few query rows over the KV cache (decode): each
// block walks its share of the cache's live tiles on the tensor cores, and
// the last block to finish a (lane, KV head) combines the shares.
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
//
// What bounds it on an H100: every live cache byte is read once per step for
// 2*g flops per element, far below the compute/bandwidth balance, so it is
// bound by reading the live columns (2*live*KH*dh bytes per lane and layer at
// int8, twice that at bf16, plus 8 bytes of scales per column and KV head).
// The design reads each live byte once and nothing else of the cache:
//   * one block holds all folded rows of a (lane, KV head) (up to 64: G <= 9
//     verify rows at g = 7), so each cache tile is read once whatever the
//     mode; more rows go to row chunks of 64 (blockIdx.y), each reading the
//     cache once;
//   * the cache's 64-column tiles are dealt to nsplit blocks in turn (split
//     s takes tiles s, s + nsplit, ...), so a live prefix, however short,
//     spreads over every block (ops/attention.py:decode_plan picks nsplit for
//     one block per SM at B=1 and B=4); each block first reads its tiles' key
//     mask (256 bytes a tile) and lists the tiles with a live key: dead
//     tiles are never read. A masked key in a live tile gets weight exactly
//     0 once a live key sets the row's max, so skipping changes only the
//     rounding order; a row with no live column gives o = 0, m = -1e30,
//     l = 0 (and with the fold, the fresh term alone);
//   * 128 threads keep a 3-stage (bf16) or 4-stage (int8) ring of raw K/V
//     tiles in flight with cp.async 16-byte copies (int8 at 1 byte a code,
//     XOR-swizzled so the fragment reads below hit distinct banks);
//   * Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16 bf16, f32
//     sums): each warp owns one 16-row M tile and a quarter, half or all of
//     each tile's keys (by the number of M tiles), with its own running max,
//     denominator and accumulator in registers; Q fragments are loaded once
//     per block; P goes from the score accumulators straight into the A
//     fragments of P.V; int8 codes are widened to bf16 in registers (exact).
//     The dh order inside each product is permuted so every thread's K and V
//     fragment reads are whole 16-byte words; the output column map undoes
//     the permutation;
//   * the warps' states are merged in shared memory, then each block writes
//     its (m, l, acc) for its rows; the last block of a (lane, KV head, row
//     chunk) to arrive (a counter it resets itself) sums all splits in split
//     order, so the bits are the same on every run, and writes o, the fold
//     or (m, l). One launch per call; with nsplit = 1 no partial is written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // cache columns per tile
constexpr int ROWS = 64;        // folded query rows per block (4 M tiles of 16)
constexpr int THREADS = 128;    // 4 warps
constexpr int MAXT = 1024;      // tiles one block may walk (decode_plan keeps to it)
constexpr int MAXW = 2048;      // nsplit * rows of a chunk the merge holds (decode_plan keeps to it)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, bool QUANT>
struct Cfg {
    static constexpr int ESZ = QUANT ? 1 : 2;
    static constexpr int RB = DH * ESZ;                 // bytes of one K/V row
    static constexpr int NC = RB / 16;                  // 16-byte chunks per row
    static constexpr int CH = 16 / ESZ;                 // elements per chunk
    static constexpr int NST = QUANT ? 4 : 3;           // ring stages
    static constexpr uint32_t KV = BK * RB;             // one K or V tile
    static constexpr uint32_t ROWS_OFF = 2 * KV;        // mask[, ks, vs] rows of the tile
    static constexpr uint32_t STAGE = 2 * KV + (QUANT ? 3 : 1) * BK * 4;
    static constexpr uint32_t RING = NST * STAGE;
    // epilogue, over the ring: 4 warps' accumulators [16][DH], their m, l,
    // the warp-merge weights [4][ROWS], then the splits' m and l [nsplit][rows]
    static constexpr uint32_t EPI = 4 * 16 * DH * 4 + 2 * 4 * 16 * 4 + 4 * ROWS * 4;
    static constexpr uint32_t BODY = RING > EPI + 2 * MAXW * 4 ? RING : EPI + 2 * MAXW * 4;
    // + the live-tile list, the tile flags, M, L and s2 per row, two ints
    static constexpr uint32_t SMEM = BODY + MAXT * 2 + MAXT + 3 * ROWS * 4 + 16;
};

struct Args {
    const __nv_bfloat16* q;
    const void* k;
    const void* v;
    const float* ks;          // [B*KH, C4] (int8)
    const float* vs;
    const float* mask;        // [B, C4]
    const __nv_bfloat16* fk;  // [B*KH, DH] or null
    const __nv_bfloat16* fv;
    const float* gate;        // [B]
    float* part_m;            // [pairs, nsplit, ROWS] (nsplit > 1)
    float* part_l;
    float* part_acc;          // [pairs, nsplit, ROWS, DH]
    int* counters;            // [pairs], zero between calls
    __nv_bfloat16* out;
    float* m_out;             // [B, H, S] or null
    float* l_out;
    int H, KH, S, C, C4, nsplit;
    float scale;
};

// Chunk swizzles of the K and V tiles (a bijection within each row): the
// fragment reads below then hit distinct banks. Rows of 4 chunks (int8,
// dh 64) are left as they are.
template <int NC>
__device__ __forceinline__ int swz_k(int row) { return NC >= 8 ? (row & 1) << 2 : 0; }
template <int NC>
__device__ __forceinline__ int swz_v(int row) { return NC >= 8 ? ((row >> 1) & 3) << 1 : 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes (and no read) where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
}

// int8 code (byte e of w ^ 0x80808080, i.e. code + 128) -> its exact float:
// 2^23 + (code + 128) has the offset code as its low mantissa bits
__device__ __forceinline__ float code_f32(uint32_t wx, int e) {
    return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650u | (unsigned)e))
           - 8388736.f;
}

// Column of the P.V output that accumulator column n (0..7) of n8 tile nd
// holds: each thread's V fragment reads are whole 16-byte words of a row
// (two for bf16 dh 128: columns 64h + 8n .. +7), so the n8 tiles walk a
// permuted dh.
template <int DH, int ESZ>
__device__ __forceinline__ int vcol(int nd, int n) {
    if constexpr (DH * ESZ / 8 > 16) return 64 * (nd >> 3) + 8 * n + (nd & 7);
    else return (DH / 8) * n + nd;
}

template <int DH, bool QUANT, int WPM>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const Args a) {
    using Cf = Cfg<DH, QUANT>;
    constexpr int NC = Cf::NC, CH = Cf::CH, RB = Cf::RB;
    constexpr int KPW = BK / WPM;          // keys of each tile per warp
    constexpr int NT = KPW / 8;            // their n8 tiles
    constexpr int ND = DH / 8;             // n8 tiles of the output
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem;
    uint16_t* live = reinterpret_cast<uint16_t*>(smem + Cf::BODY);
    uint8_t* flags = reinterpret_cast<uint8_t*>(live + MAXT);
    float* rowM = reinterpret_cast<float*>(flags + MAXT);
    float* rowL = rowM + ROWS;
    float* rowS2 = rowL + ROWS;
    int* shi = reinterpret_cast<int*>(rowS2 + ROWS);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, c = lane & 3;
    const int g = a.H / a.KH, R = g * a.S;
    const int nrc = (R + ROWS - 1) / ROWS;
    const int split = blockIdx.x, nsplit = a.nsplit;
    const int pair = blockIdx.y;                 // (b * KH + kh) * nrc + row chunk
    const int bkh = pair / nrc, rc = pair % nrc;
    const int b = bkh / a.KH;
    const int rbase = rc * ROWS;
    const int Rc = min(ROWS, R - rbase);
    const int C = a.C, C4 = a.C4;
    const int ntiles = (C + BK - 1) / BK;
    const int nts = (ntiles - split + nsplit - 1) / nsplit;   // tiles split + j * nsplit

    // ---- 1. Q fragments, once (their loads overlap the mask scan): this
    // warp's 16-row M tile ----
    const int mw = warp / WPM, kq = warp % WPM;
    const bool busy = 16 * mw < Rc;
    const int ra = 16 * mw + gq, rb = ra + 8;        // rows of the chunk
    uint32_t qf[DH / 16][4];
    {
        const __nv_bfloat16* qa = a.q + ((size_t)bkh * R + rbase + ra) * DH;
        const __nv_bfloat16* qb = qa + 8 * DH;
        const bool oka = busy && ra < Rc, okb = busy && rb < Rc;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            // k slots (2c, 2c+1) and (2c+8, 2c+9) of step kk <-> dims d0..d0+3
            const int d0 = (4 * (kk / (CH / 4)) + c) * CH + 4 * (kk % (CH / 4));
            qf[kk][0] = oka ? *reinterpret_cast<const uint32_t*>(qa + d0) : 0u;
            qf[kk][1] = okb ? *reinterpret_cast<const uint32_t*>(qb + d0) : 0u;
            qf[kk][2] = oka ? *reinterpret_cast<const uint32_t*>(qa + d0 + 2) : 0u;
            qf[kk][3] = okb ? *reinterpret_cast<const uint32_t*>(qb + d0 + 2) : 0u;
        }
    }

    // ---- 2. this split's tiles that hold a live key: each half-warp reads
    // one tile's 64 mask values, so 8 tiles per pass ----
    const float* mrow_g = a.mask + (size_t)b * C4;
    {
        const int half = lane >> 4, hl = lane & 15;
        for (int j0 = 2 * warp; j0 < nts; j0 += 8) {
            const int j = j0 + half;
            const int key = (split + j * nsplit) * BK + 4 * hl;
            float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j < nts && key < C) mv = *reinterpret_cast<const float4*>(mrow_g + key);
            const bool f = (mv.x > 0.f) || (key + 1 < C && mv.y > 0.f)
                           || (key + 2 < C && mv.z > 0.f) || (key + 3 < C && mv.w > 0.f);
            const unsigned bal = __ballot_sync(FULL, f);
            if (hl == 0 && j < nts) flags[j] = ((bal >> (16 * half)) & 0xFFFFu) != 0u;
        }
    }
    __syncthreads();
    if (warp == 0) {
        int n = 0;
        for (int j0 = 0; j0 < nts; j0 += 32) {
            const int j = j0 + lane;
            const bool f = j < nts && flags[j];
            const unsigned bal = __ballot_sync(FULL, f);
            if (f) live[n + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)(split + j * nsplit);
            n += __popc(bal);
        }
        if (lane == 0) shi[0] = n;
    }
    __syncthreads();
    const int nlive = shi[0];

    // ---- 3. the ring: raw K/V tiles and their mask (and scale) rows ----
    const size_t kvrow0 = (size_t)bkh * C;
    auto load_tile = [&](int i) {
        const int t = live[i];
        unsigned char* st = ring + (i % Cf::NST) * Cf::STAGE;
        for (int idx = tid; idx < 2 * BK * NC; idx += THREADS) {
            const int which = idx / (BK * NC), rem = idx % (BK * NC);
            const int row = rem / NC, q = rem % NC;
            const int key = t * BK + row;
            const bool ok = key < C;
            const unsigned char* src = static_cast<const unsigned char*>(which ? a.v : a.k)
                                       + (kvrow0 + (ok ? key : 0)) * RB + q * 16;
            const int qs = which ? q ^ swz_v<NC>(row) : q ^ swz_k<NC>(row);
            cp_async16(st + which * Cf::KV + row * RB + qs * 16, src, ok);
        }
        for (int idx = tid; idx < (QUANT ? 3 : 1) * 16; idx += THREADS) {
            const int which = idx / 16, q = idx % 16;
            const int key = t * BK + 4 * q;
            const bool ok = key < C4;
            const float* base = which == 0 ? mrow_g
                                           : (which == 1 ? a.ks : a.vs) + (size_t)bkh * C4;
            cp_async16(st + Cf::ROWS_OFF + which * BK * 4 + q * 16, base + (ok ? key : 0), ok);
        }
    };
#pragma unroll
    for (int i = 0; i < Cf::NST - 1; ++i) {
        if (i < nlive) load_tile(i);
        cp_async_commit();
    }

    float acc[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float ma = NEG_BIG, mb = NEG_BIG, la = 0.f, lb = 0.f;
    const float scale = a.scale;

    for (int i = 0; i < nlive; ++i) {
        cp_async_wait<Cf::NST - 2>();
        __syncthreads();                    // tile i landed; tile i-1's stage is free
        if (i + Cf::NST - 1 < nlive) load_tile(i + Cf::NST - 1);
        cp_async_commit();
        if (!busy) continue;
        const unsigned char* st = ring + (i % Cf::NST) * Cf::STAGE;
        const unsigned char* Kt = st;
        const unsigned char* Vt = st + Cf::KV;
        const float* mrow = reinterpret_cast<const float*>(st + Cf::ROWS_OFF);
        const int k0 = live[i] * BK;
        const int kbase = kq * KPW;

        // S = Q K^T over this warp's keys
        float sc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
            const int key = kbase + 8 * n + gq;
            const unsigned char* krow = Kt + key * RB;
#pragma unroll
            for (int j = 0; j < NC / 4; ++j) {
                const uint4 w = *reinterpret_cast<const uint4*>(
                    krow + (((4 * j + c) ^ swz_k<NC>(key)) * 16));
                const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
                if constexpr (QUANT) {
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const uint32_t x = wv[u] ^ 0x80808080u;
                        mma16816(sc[n], qf[4 * j + u], pack_bf16(code_f32(x, 0), code_f32(x, 1)),
                                 pack_bf16(code_f32(x, 2), code_f32(x, 3)));
                    }
                } else {
#pragma unroll
                    for (int u = 0; u < 2; ++u) mma16816(sc[n], qf[2 * j + u], wv[2 * u], wv[2 * u + 1]);
                }
            }
        }

        // online softmax over the tile (rows ra, rb; keys 8n + 2c + e)
        float mxa = NEG_BIG, mxb = NEG_BIG;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kl = kbase + 8 * n + 2 * c + e;
                const bool lk = k0 + kl < C && mrow[kl] > 0.f;
                float sa = sc[n][e] * scale, sb = sc[n][2 + e] * scale;
                if constexpr (QUANT) {
                    const float kscl = mrow[BK + kl];
                    sa *= kscl;
                    sb *= kscl;
                }
                sc[n][e] = sa + (lk ? 0.f : -1e9f);
                sc[n][2 + e] = sb + (lk ? 0.f : -1e9f);
                mxa = fmaxf(mxa, sc[n][e]);
                mxb = fmaxf(mxb, sc[n][2 + e]);
            }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            mxa = fmaxf(mxa, __shfl_xor_sync(FULL, mxa, o));
            mxb = fmaxf(mxb, __shfl_xor_sync(FULL, mxb, o));
        }
        const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
        const float ca = exp2f((ma - na) * LOG2E), cb = exp2f((mb - nb) * LOG2E);
        ma = na;
        mb = nb;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float pa = exp2f((sc[n][e] - na) * LOG2E);
                const float pb = exp2f((sc[n][2 + e] - nb) * LOG2E);
                sa += pa;
                sb += pb;
                const float w = QUANT ? mrow[2 * BK + kbase + 8 * n + 2 * c + e] : 1.f;
                sc[n][e] = pa * w;
                sc[n][2 + e] = pb * w;
            }
        }
        la = la * ca + sa;
        lb = lb * cb + sb;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
            acc[nd][0] *= ca;
            acc[nd][1] *= ca;
            acc[nd][2] *= cb;
            acc[nd][3] *= cb;
        }

        // acc += P V: k16 chunk jj = the warp's keys 16 jj .. +15
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
            const uint32_t pa4[4] = {pack_bf16(sc[2 * jj][0], sc[2 * jj][1]),
                                     pack_bf16(sc[2 * jj][2], sc[2 * jj][3]),
                                     pack_bf16(sc[2 * jj + 1][0], sc[2 * jj + 1][1]),
                                     pack_bf16(sc[2 * jj + 1][2], sc[2 * jj + 1][3])};
            const int kv0 = kbase + 16 * jj + 2 * c;        // keys kv0, +1, +8, +9
            const int keys[4] = {kv0, kv0 + 1, kv0 + 8, kv0 + 9};
            if constexpr (DH * Cf::ESZ / 8 >= 16) {
                // each key: (DH / 8) elements of this thread's column group, in
                // 16-byte words
#pragma unroll
                for (int h = 0; h < DH * Cf::ESZ / 128; ++h) {
                    uint4 w[4];
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        const int qc = (DH * Cf::ESZ / 8 > 16 ? 8 * h + gq : gq) ^ swz_v<NC>(keys[x]);
                        w[x] = *reinterpret_cast<const uint4*>(Vt + keys[x] * RB + qc * 16);
                    }
                    if constexpr (QUANT) {
                        // 16 codes a word: nd = element
#pragma unroll
                        for (int wi = 0; wi < 4; ++wi) {
                            const uint32_t x0 = (&w[0].x)[wi] ^ 0x80808080u;
                            const uint32_t x1 = (&w[1].x)[wi] ^ 0x80808080u;
                            const uint32_t x2 = (&w[2].x)[wi] ^ 0x80808080u;
                            const uint32_t x3 = (&w[3].x)[wi] ^ 0x80808080u;
#pragma unroll
                            for (int e = 0; e < 4; ++e)
                                mma16816(acc[4 * wi + e], pa4,
                                         pack_bf16(code_f32(x0, e), code_f32(x1, e)),
                                         pack_bf16(code_f32(x2, e), code_f32(x3, e)));
                        }
                    } else {
                        // 8 bf16 a word: nd = 8h + element
#pragma unroll
                        for (int wi = 0; wi < 4; ++wi) {
                            const uint32_t y0 = (&w[0].x)[wi], y1 = (&w[1].x)[wi];
                            const uint32_t y2 = (&w[2].x)[wi], y3 = (&w[3].x)[wi];
                            mma16816(acc[8 * h + 2 * wi], pa4, __byte_perm(y0, y1, 0x5410),
                                     __byte_perm(y2, y3, 0x5410));
                            mma16816(acc[8 * h + 2 * wi + 1], pa4, __byte_perm(y0, y1, 0x7632),
                                     __byte_perm(y2, y3, 0x7632));
                        }
                    }
                }
            } else {
                // int8, dh 64: 8 codes (8 bytes) of each key
                uint2 w[4];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    w[x] = *reinterpret_cast<const uint2*>(Vt + keys[x] * RB + 8 * gq);
#pragma unroll
                for (int wi = 0; wi < 2; ++wi) {
                    const uint32_t x0 = (&w[0].x)[wi] ^ 0x80808080u;
                    const uint32_t x1 = (&w[1].x)[wi] ^ 0x80808080u;
                    const uint32_t x2 = (&w[2].x)[wi] ^ 0x80808080u;
                    const uint32_t x3 = (&w[3].x)[wi] ^ 0x80808080u;
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        mma16816(acc[4 * wi + e], pa4, pack_bf16(code_f32(x0, e), code_f32(x1, e)),
                                 pack_bf16(code_f32(x2, e), code_f32(x3, e)));
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();                        // the ring is free for the epilogue

    // ---- 4. merge the warps sharing an M tile (in warp order) ----
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        la += __shfl_xor_sync(FULL, la, o);
        lb += __shfl_xor_sync(FULL, lb, o);
    }
    float* wacc = reinterpret_cast<float*>(ring);     // [4 warps][16 rows][DH]
    float* wm = wacc + 4 * 16 * DH;
    float* wl = wm + 4 * 16;
    float* wgt = wl + 4 * 16;                          // [WPM][ROWS]
    if (busy) {
        float* ra_p = wacc + (warp * 16 + gq) * DH;
        float* rb_p = ra_p + 8 * DH;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int d = vcol<DH, Cf::ESZ>(nd, 2 * c + e);
                ra_p[d] = acc[nd][e];
                rb_p[d] = acc[nd][2 + e];
            }
        }
        if (c == 0) {
            wm[warp * 16 + gq] = ma;
            wl[warp * 16 + gq] = la;
            wm[warp * 16 + gq + 8] = mb;
            wl[warp * 16 + gq + 8] = lb;
        }
    }
    __syncthreads();
    // the block's state of row r: M, L in rowM/rowL, acc in place of the
    // first warp of its M tile (wacc row (r / 16) * WPM * 16 + r % 16)
    if (tid < Rc) {
        const int r = tid, w0 = (r >> 4) * WPM, rr = r & 15;
        float M = NEG_BIG;
#pragma unroll
        for (int x = 0; x < WPM; ++x) M = fmaxf(M, wm[(w0 + x) * 16 + rr]);
        float L = 0.f;
#pragma unroll
        for (int x = 0; x < WPM; ++x) {
            const float w = exp2f((wm[(w0 + x) * 16 + rr] - M) * LOG2E);
            wgt[x * ROWS + r] = w;
            L += wl[(w0 + x) * 16 + rr] * w;
        }
        rowM[r] = M;
        rowL[r] = L;
    }
    __syncthreads();
    auto bacc = [&](int r) { return wacc + (((r >> 4) * WPM) * 16 + (r & 15)) * DH; };
    if constexpr (WPM > 1) {
        for (int idx = tid; idx < Rc * DH; idx += THREADS) {
            const int r = idx / DH, d = idx % DH;
            float s = 0.f;
#pragma unroll
            for (int x = 0; x < WPM; ++x) s += wgt[x * ROWS + r] * bacc(r)[x * 16 * DH + d];
            bacc(r)[d] = s;
        }
        __syncthreads();
    }

    // ---- 5. with splits: write this block's part; the last block merges all ----
    if (nsplit > 1) {
        const size_t p0 = (size_t)pair * nsplit;
        const size_t pb = (p0 + split) * ROWS;
        for (int r = tid; r < Rc; r += THREADS) {
            a.part_m[pb + r] = rowM[r];
            a.part_l[pb + r] = rowL[r];
        }
        for (int idx = tid; idx < Rc * (DH / 4); idx += THREADS) {
            const int r = idx / (DH / 4), d = 4 * (idx % (DH / 4));
            *reinterpret_cast<float4*>(a.part_acc + (pb + r) * DH + d) =
                *reinterpret_cast<const float4*>(bacc(r) + d);
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) shi[1] = atomicAdd(a.counters + pair, 1) == nsplit - 1;
        __syncthreads();
        if (!shi[1]) return;
        __threadfence();
        // every split's m and l of the chunk's rows at once, then each row's
        // M, L and split weights e^(m_s - M) (split order)
        float* sm = wacc + 4 * 16 * DH + 2 * 4 * 16 + 4 * ROWS;   // [nsplit][Rc]
        float* sl = sm + MAXW;
        for (int i = tid; i < nsplit * Rc; i += THREADS) {
            const size_t pr = (p0 + i / Rc) * ROWS + i % Rc;
            sm[i] = __ldcg(a.part_m + pr);
            sl[i] = __ldcg(a.part_l + pr);
        }
        __syncthreads();
        if (tid < Rc) {
            const int r = tid;
            float M = NEG_BIG;
            for (int s = 0; s < nsplit; ++s) M = fmaxf(M, sm[s * Rc + r]);
            float L = 0.f;
            for (int s = 0; s < nsplit; ++s) {
                const float w = exp2f((sm[s * Rc + r] - M) * LOG2E);
                sm[s * Rc + r] = w;
                L += sl[s * Rc + r] * w;
            }
            rowM[r] = M;
            rowL[r] = L;
        }
        __syncthreads();
        // acc = sum_s w_s acc_s, 8 splits' loads in flight at a time
        for (int idx = tid; idx < Rc * (DH / 4); idx += THREADS) {
            const int r = idx / (DH / 4), d = 4 * (idx % (DH / 4));
            float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int s0 = 0; s0 < nsplit; s0 += 8) {
                float4 x[8];
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    x[u] = s0 + u < nsplit
                        ? __ldcg(reinterpret_cast<const float4*>(
                              a.part_acc + ((p0 + s0 + u) * ROWS + r) * DH + d))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const float w = s0 + u < nsplit ? sm[(s0 + u) * Rc + r] : 0.f;
                    s4.x += w * x[u].x;
                    s4.y += w * x[u].y;
                    s4.z += w * x[u].z;
                    s4.w += w * x[u].w;
                }
            }
            *reinterpret_cast<float4*>(bacc(r) + d) = s4;
        }
        if (tid == 0) a.counters[pair] = 0;    // ready for the next call
        __syncthreads();
    }

    // ---- 6. o = acc / L (0 where no live column), the fold, or (m, l) ----
    const size_t orow = (size_t)bkh * R + rbase;
    if (a.fk != nullptr) {
        // s2 = q . kn * scale, one warp per row
        const __nv_bfloat16* kn = a.fk + (size_t)bkh * DH;
        for (int r = warp; r < Rc; r += 4) {
            const __nv_bfloat16* qr = a.q + (orow + r) * DH;
            float s = 0.f;
            for (int d = lane; d < DH; d += 32)
                s += __bfloat162float(qr[d]) * __bfloat162float(kn[d]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
            if (lane == 0) rowS2[r] = s * a.scale;
        }
        __syncthreads();
    }
    for (int idx = tid; idx < Rc * (DH / 2); idx += THREADS) {
        const int r = idx / (DH / 2), d = 2 * (idx % (DH / 2));
        const float M = rowM[r], L = rowL[r];
        const float2 x = *reinterpret_cast<const float2*>(bacc(r) + d);
        float o0, o1;
        if (a.fk == nullptr) {
            const float inv = L > 0.f ? 1.f / L : 0.f;
            o0 = x.x * inv;
            o1 = x.y * inv;
        } else {
            const float s2 = rowS2[r];
            const float m = fmaxf(M, s2);
            const float c1 = expf(M - m);
            const float a2 = expf(s2 - m) * a.gate[b];
            const float den = fmaxf(c1 * L + a2, 1e-30f);
            const __nv_bfloat16* vn = a.fv + (size_t)bkh * DH + d;
            o0 = (x.x * c1 + a2 * __bfloat162float(vn[0])) / den;
            o1 = (x.y * c1 + a2 * __bfloat162float(vn[1])) / den;
        }
        *reinterpret_cast<uint32_t*>(a.out + (orow + r) * DH + d) = pack_bf16(o0, o1);
    }
    if (a.m_out != nullptr) {
        for (int r = tid; r < Rc; r += THREADS) {
            a.m_out[orow + r] = rowM[r];
            a.l_out[orow + r] = rowL[r];
        }
    }
}

template <int DH, bool QUANT, int WPM>
int launch(const Args& a, int pairs, cudaStream_t st) {
    constexpr int smem = (int)Cfg<DH, QUANT>::SMEM;
    static unsigned sized = 0;       // devices whose attribute is set: once each
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(sized >> dev & 1u)) {
        cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<DH, QUANT, WPM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        if (dev < 32) sized |= 1u << dev;
    }
    flash_decode_kernel<DH, QUANT, WPM><<<dim3(a.nsplit, pairs), THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

// warps per M tile: 4 while one M tile holds every row of a chunk, else 2 or 1
template <int DH, bool QUANT>
int by_rows(const Args& a, int pairs, int rows, cudaStream_t st) {
    if (rows <= 16) return launch<DH, QUANT, 4>(a, pairs, st);
    if (rows <= 32) return launch<DH, QUANT, 2>(a, pairs, st);
    return launch<DH, QUANT, 1>(a, pairs, st);
}

template <bool QUANT>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, const void* fk, const void* fv, const void* gate, void* part_m,
             void* part_l, void* part_acc, void* counters, void* out, void* m_out, void* l_out,
             int B, int H, int KH, int S, int C, int dh, int nsplit, float scale, void* stream) {
    const int R = (H / KH) * S;
    const int ntiles = (C + BK - 1) / BK;
    if (nsplit < 1 || nsplit > ntiles || (ntiles + nsplit - 1) / nsplit > MAXT || ntiles > 65535
        || nsplit * (R < ROWS ? R : ROWS) > MAXW
        || (nsplit > 1 && (part_m == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    Args a{(const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
           (const float*)mask, (const __nv_bfloat16*)fk, (const __nv_bfloat16*)fv,
           (const float*)gate, (float*)part_m, (float*)part_l, (float*)part_acc,
           (int*)counters, (__nv_bfloat16*)out, (float*)m_out, (float*)l_out,
           H, KH, S, C, (C + 3) / 4 * 4, nsplit, scale};
    const int nrc = (R + ROWS - 1) / ROWS;
    const int pairs = B * KH * nrc;
    const int rows = R < ROWS ? R : ROWS;
    cudaStream_t st = (cudaStream_t)stream;
    if (dh == 128) return by_rows<128, QUANT>(a, pairs, rows, st);
    if (dh == 64) return by_rows<64, QUANT>(a, pairs, rows, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: [B, H, S, dh] bf16; k, v: [B, KH, C, dh] bf16; mask: [B, C4] f32 (each
// row padded to a multiple of 4 values). nsplit blocks per (lane, KV head, 64
// folded rows) share the cache's 64-column tiles in turn; with nsplit > 1,
// part_m/part_l [B*KH*nrc, nsplit, 64] and part_acc [.., 64, dh] f32 hold
// their states and counters [B*KH*nrc] int32 (zero, and left zero) count
// arrivals (nrc = ceil(H/KH*S / 64)). fk/fv ([B, KH, 1, dh] bf16) and gate
// ([B] f32): the fresh fold, or all null. m_out/l_out ([B, H, S] f32): the
// (m, l) outputs, or both null; never with the fold.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* mask,
                            const void* fk, const void* fv, const void* gate, void* part_m,
                            void* part_l, void* part_acc, void* counters, void* out,
                            void* m_out, void* l_out, int B, int H, int KH, int S, int C,
                            int dh, int nsplit, float scale, void* stream) {
    return dispatch<false>(q, k, v, nullptr, nullptr, mask, fk, fv, gate, part_m, part_l,
                           part_acc, counters, out, m_out, l_out, B, H, KH, S, C, dh, nsplit,
                           scale, stream);
}

// k8/v8: int8 codes [B, KH, C, dh]; ks/vs: [B, KH, C4] f32 scales (rows
// padded as the mask's).
extern "C" int flash_decode_int8(const void* q, const void* k8, const void* v8, const void* ks,
                                 const void* vs, const void* mask, const void* fk,
                                 const void* fv, const void* gate, void* part_m, void* part_l,
                                 void* part_acc, void* counters, void* out, void* m_out,
                                 void* l_out, int B, int H, int KH, int S, int C, int dh,
                                 int nsplit, float scale, void* stream) {
    return dispatch<true>(q, k8, v8, ks, vs, mask, fk, fv, gate, part_m, part_l, part_acc,
                          counters, out, m_out, l_out, B, H, KH, S, C, dh, nsplit, scale,
                          stream);
}
