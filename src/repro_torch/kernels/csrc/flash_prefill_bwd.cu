// Backward of flash_prefill.cu for Hopper (sm_90a): dQ, dK and dV of the
// causal GQA attention with prefix resume, for exactly the forward's
// contract. Sq queries at positions q_offset.. attend to keys < kv_len; the
// key at kpos is live for the query at qpos when
//   kpos <= qpos  &&  kpos < kv_len  &&  (window <= 0 || kpos > qpos - window),
// (dh, dv) is one of the forward's WIDTHS, MLA's (192, 128) included, and H
// query heads share KV kv heads. whisper's bidirectional attention is the
// forward's q_offset = kv_len = Sk and needs nothing of its own here.
//
// Replaces no TPU kernel: no Pallas kernel of the reference has a backward
// (it trains on plain JAX, src/repro/models/attention.py:99 attend). It is
// here because the port's layers call the forward kernel, and training on
// the card needs its gradient; a plain PyTorch backward would put the plain
// attention back on the card's main path.
//
// The math (FlashAttention-2's): with the forward's per-row log-sum-exp L
// (flash_prefill.cu writes it when asked) and D = rowsum(dO * O),
//   P = exp(scale * Q K^T - L),  dP = dO V^T,  dS = P * (dP - D),
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K,
// with P and dS recomputed tile by tile: no [Sq, Sk] matrix is stored. A
// fully masked row has L = +inf, so P = 0 and it adds nothing.
//
// Three launches (a fourth with GQA, one more where bf16 splits dK and dV),
// no atomics, so the result is the same on every run:
//  1. delta: D a row, one warp a (b, query, head), in fp32.
//  2. dK/dV: one CTA a (key tile, query head, batch). It walks the query
//     tiles that can see its keys (from the first query at or after the
//     tile's first key, to the window's end) and keeps dK and dV of its
//     keys in registers. With GQA (rep = H / KV > 1) each of a kv head's
//     rep query heads adds its own part: the CTA writes it in fp32 to a
//     scratch [rep, B, Sk, KV, d], and a fourth launch sums the rep parts
//     in a fixed order into dK and dV. No atomic add: one CTA a (tile,
//     kv head) looping over the rep heads would leave a GQA model's
//     backward with B x KV x Sk / 64 CTAs (qwen2-vl-2b at B=1: 16).
//  3. dQ: one CTA a (query tile, head, batch) over the key tiles its queries
//     can see, as the forward walks them.
//
// What bounds it on this card. The backward does 2.5x the forward's products
// (QK^T and dO V^T again, then dV, dK and dQ) over the same bytes plus dO
// and the three gradients; at the training shapes (gemma3-270m (4/1, 256)
// B=4 S=1024: 4 x 4 x 1024 x 1024 / 2 causal pairs, 2.7 GFLOP bf16 products
// over 25 MB) it is bound by operations on paper (0.003 ms at 989 TFLOP/s vs
// 0.008 ms for the bytes; the byte side wins at that size, the operation
// side at deepseek's (128/128, (192, 128))). What the design does:
//  - bf16: every product on the tensor cores, mma.sync m16n8k16 bf16 -> fp32
//    (mma_bf16.cuh), fragments by ldmatrix from padded shared rows. P and dS
//    go from the fp32 accumulators straight into the next product's A operand,
//    rounded to bf16 in registers (as FlashAttention-2 does). The dK/dV CTA
//    computes S^T = K Q^T (keys as rows), so P^T and dS^T are already in A's
//    layout for dV += P^T dO and dK += dS^T Q. A warp owns 16 keys (dK/dV) or
//    16 queries (dQ); tiles go by 16-byte cp.async (async_copy.cuh).
//  - Registers: a warp's dK and dV accumulators take (dh + dv) / 2 floats a
//    thread. Up to dh + dv = 256 they stay in registers in one pass; above
//    (gemma3's (256, 256), MLA's (192, 128)) the dK/dV kernel runs twice, dV
//    in one launch and dK in the next, each recomputing P: 1.3x the products,
//    no spills and no shared-memory accumulators. The dQ kernel takes 32-key
//    tiles at dh = 256, 64 below, as the forward's chunks.
//  - fp32: scalar FMAs (the tensor cores take no fp32 input at the 1e-5
//    tolerance). Each kernel mirrors the forward's fp32 kernel: a warp owns 4
//    rows (queries for dQ, keys for dK/dV), a lane one column (key or query)
//    of a 32-wide tile for the scores and dims lane + 32 i of the sums.
// This is the simple first form: single-buffered tiles, no GQA packing in the
// dQ kernel, mma.sync rather than wgmma. PERF.md keeps its times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 128;                // 4 warps
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const void* q; const void* k; const void* v; const void* o; const void* dout;
    const float* lse; float* delta;
    void* dq; void* dk; void* dv;
    float* part;                       // GQA: fp32 [rep, B, Sk, KV, DH + DV]
                                       // parts of dK, dV; null when rep = 1
    int B, Sq, Sk, H, KV, rep;
    int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
    int q_offset, k_lim, window;       // k_lim = min(kv_len, Sk)
    float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool live(int kp, int qp, int k_lim, int window) {
    return kp < k_lim && kp <= qp && (window <= 0 || kp > qp - window);
}

// o and dout are contiguous [B, Sq, H, DV]; delta [B, H, Sq]
template <typename T, int DV>
__global__ void __launch_bounds__(NT) delta_kernel(const Args a) {
    const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= a.B * a.Sq * a.H) return;
    const T* o = static_cast<const T*>(a.o) + (int64_t)row * DV;
    const T* d = static_cast<const T*>(a.dout) + (int64_t)row * DV;
    float s = 0.f;
#pragma unroll
    for (int i = lane; i < DV; i += 32) s += to_f(o[i]) * to_f(d[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) {
        const int h = row % a.H, bq = row / a.H, qi = bq % a.Sq, b = bq / a.Sq;
        a.delta[((int64_t)b * a.H + h) * a.Sq + qi] = s;
    }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FR = 4;                  // rows a warp
constexpr int FROWS = 4 * FR;          // rows a CTA
constexpr int FC = 32;                 // columns a tile: one a lane

// dQ: CTA (16 queries, head, batch); lane j takes key k0 + j of a 32-key tile
template <int DH, int DV>
__global__ void __launch_bounds__(NT) dq_fp32_kernel(const Args a) {
    constexpr int KST = DH + 4, VST = DV + 4, NI = DH / 32;
    extern __shared__ float4 smem_f[];
    float* sQ = reinterpret_cast<float*>(smem_f);  // [16][DH]
    float* sD = sQ + FROWS * DH;                   // [16][DV] dO
    float* sK = sD + FROWS * DV;                   // [32][KST]
    float* sV = sK + FC * KST;                     // [32][VST]
    const int q0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / a.rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rows = min(FROWS, a.Sq - q0);
    const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* K = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const float* V = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const float* dO = static_cast<const float*>(a.dout);
    load_rows<float, NT, FROWS, DH, DH>(sQ, Q + q0 * a.q_ss, a.q_ss, rows, tid);
    load_rows<float, NT, FROWS, DV, DV>(
        sD, dO + (((int64_t)b * a.Sq + q0) * a.H + h) * DV, (int64_t)a.H * DV, rows, tid);
    cp_async_commit();

    float L[FR], Dl[FR], acc[FR][NI];
#pragma unroll
    for (int r = 0; r < FR; ++r) {
        const int qi = q0 + warp * FR + r;
        const int64_t li = ((int64_t)b * a.H + h) * a.Sq + qi;
        L[r] = qi < a.Sq ? a.lse[li] : INFINITY;
        Dl[r] = qi < a.Sq ? a.delta[li] : 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    }
    const int qpos_lo = a.q_offset + q0, qpos_hi = a.q_offset + q0 + rows - 1;
    const int k_end = min(a.k_lim, qpos_hi + 1);
    int k_begin = a.window > 0 ? max(0, qpos_lo - a.window + 1) : 0;
    k_begin = (k_begin / FC) * FC;
    for (int k0 = k_begin; k0 < k_end; k0 += FC) {
        __syncthreads();                           // the previous tile is read
        load_rows<float, NT, FC, DH, KST>(sK, K + k0 * a.k_ss, a.k_ss, k_end - k0, tid);
        load_rows<float, NT, FC, DV, VST>(sV, V + k0 * a.v_ss, a.v_ss, k_end - k0, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float s[FR], dp[FR];
#pragma unroll
        for (int r = 0; r < FR; ++r) s[r] = dp[r] = 0.f;
        const float4* kr = reinterpret_cast<const float4*>(sK + lane * KST);
        const float4* vr = reinterpret_cast<const float4*>(sV + lane * VST);
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 kk = kr[d4];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const float4 qq = reinterpret_cast<const float4*>(sQ + (warp * FR + r) * DH)[d4];
                s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
            }
        }
#pragma unroll 4
        for (int d4 = 0; d4 < DV / 4; ++d4) {
            const float4 vv = vr[d4];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const float4 oo = reinterpret_cast<const float4*>(sD + (warp * FR + r) * DV)[d4];
                dp[r] += oo.x * vv.x + oo.y * vv.y + oo.z * vv.z + oo.w * vv.w;
            }
        }
        const int kp = k0 + lane;
#pragma unroll
        for (int r = 0; r < FR; ++r) {
            const int qp = a.q_offset + q0 + warp * FR + r;
            const float p = live(kp, qp, k_end, a.window) ? expf(s[r] * a.scale - L[r]) : 0.f;
            s[r] = p * (dp[r] - Dl[r]);            // dS
        }
#pragma unroll 2
        for (int j = 0; j < FC; ++j) {
            float kv[NI];
#pragma unroll
            for (int i = 0; i < NI; ++i) kv[i] = sK[j * KST + lane + 32 * i];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const float ds = __shfl_sync(FULL, s[r], j);
#pragma unroll
                for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(ds, kv[i], acc[r][i]);
            }
        }
    }
    cp_async_wait<0>();
    float* dq = static_cast<float*>(a.dq);
#pragma unroll
    for (int r = 0; r < FR; ++r) {
        const int qi = q0 + warp * FR + r;
        if (qi >= a.Sq) continue;
        float* row = dq + (((int64_t)b * a.Sq + qi) * a.H + h) * DH;
#pragma unroll
        for (int i = 0; i < NI; ++i) row[lane + 32 * i] = acc[r][i] * a.scale;
    }
}

// dK/dV: CTA (16 keys, kv head, batch); lane j takes query q0 + j of a
// 32-query tile; the rep heads of the group in turn
template <int DH, int DV>
__global__ void __launch_bounds__(NT) dkv_fp32_kernel(const Args a) {
    constexpr int QST = DH + 4, OST = DV + 4, NK = DH / 32, NV = DV / 32;
    extern __shared__ float4 smem_f[];
    float* sK = reinterpret_cast<float*>(smem_f);  // [16][DH]
    float* sV = sK + FROWS * DH;                   // [16][DV]
    float* sQ = sV + FROWS * DV;                   // [32][QST]
    float* sO = sQ + FC * QST;                     // [32][OST] dO
    float* sL = sO + FC * OST;                     // [32] lse
    float* sDl = sL + FC;                          // [32] delta
    const int k0 = blockIdx.x * FROWS, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / a.rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int krows = min(FROWS, a.Sk - k0);
    const float* K = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const float* V = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const float* dO = static_cast<const float*>(a.dout);
    load_rows<float, NT, FROWS, DH, DH>(sK, K + k0 * a.k_ss, a.k_ss, krows, tid);
    load_rows<float, NT, FROWS, DV, DV>(sV, V + k0 * a.v_ss, a.v_ss, krows, tid);
    cp_async_commit();

    float dk[FR][NK], dv[FR][NV];
#pragma unroll
    for (int r = 0; r < FR; ++r) {
#pragma unroll
        for (int i = 0; i < NK; ++i) dk[r][i] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) dv[r][i] = 0.f;
    }
    // queries that can see a key of [k0, k_last]
    const int k_last = min(k0 + FROWS, a.k_lim) - 1;
    int qi_lo = max(0, k0 - a.q_offset);
    int qi_hi = a.Sq - 1;
    if (a.window > 0) qi_hi = min(qi_hi, k_last + a.window - 1 - a.q_offset);
    if (k_last < k0) qi_hi = -1;                   // no live key here
    {
        const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
        for (int q0 = qi_lo; q0 <= qi_hi; q0 += FC) {
            const int qrows = min(FC, a.Sq - q0);
            __syncthreads();                       // the previous tile is read
            load_rows<float, NT, FC, DH, QST>(sQ, Q + q0 * a.q_ss, a.q_ss, qrows, tid);
            load_rows<float, NT, FC, DV, OST>(
                sO, dO + (((int64_t)b * a.Sq + q0) * a.H + h) * DV, (int64_t)a.H * DV,
                qrows, tid);
            cp_async_commit();
            if (tid < FC) {
                const int64_t li = ((int64_t)b * a.H + h) * a.Sq + q0 + tid;
                sL[tid] = tid < qrows ? a.lse[li] : INFINITY;
                sDl[tid] = tid < qrows ? a.delta[li] : 0.f;
            }
            cp_async_wait<0>();
            __syncthreads();
            float s[FR], dp[FR];
#pragma unroll
            for (int r = 0; r < FR; ++r) s[r] = dp[r] = 0.f;
            const float4* qr = reinterpret_cast<const float4*>(sQ + lane * QST);
            const float4* orr = reinterpret_cast<const float4*>(sO + lane * OST);
#pragma unroll 4
            for (int d4 = 0; d4 < DH / 4; ++d4) {
                const float4 qq = qr[d4];
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    const float4 kk = reinterpret_cast<const float4*>(sK + (warp * FR + r) * DH)[d4];
                    s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
                }
            }
#pragma unroll 4
            for (int d4 = 0; d4 < DV / 4; ++d4) {
                const float4 oo = orr[d4];
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    const float4 vv = reinterpret_cast<const float4*>(sV + (warp * FR + r) * DV)[d4];
                    dp[r] += oo.x * vv.x + oo.y * vv.y + oo.z * vv.z + oo.w * vv.w;
                }
            }
            const int qp = a.q_offset + q0 + lane;
            const float Lq = sL[lane], Dq = sDl[lane];
            float p[FR];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const int kp = k0 + warp * FR + r;
                p[r] = lane < qrows && live(kp, qp, a.k_lim, a.window)
                           ? expf(s[r] * a.scale - Lq) : 0.f;
                s[r] = p[r] * (dp[r] - Dq);        // dS
            }
#pragma unroll 2
            for (int j = 0; j < FC; ++j) {
                float qv[NK], ov[NV];
#pragma unroll
                for (int i = 0; i < NK; ++i) qv[i] = sQ[j * QST + lane + 32 * i];
#pragma unroll
                for (int i = 0; i < NV; ++i) ov[i] = sO[j * OST + lane + 32 * i];
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    const float pj = __shfl_sync(FULL, p[r], j);
                    const float dsj = __shfl_sync(FULL, s[r], j);
#pragma unroll
                    for (int i = 0; i < NV; ++i) dv[r][i] = fmaf(pj, ov[i], dv[r][i]);
#pragma unroll
                    for (int i = 0; i < NK; ++i) dk[r][i] = fmaf(dsj, qv[i], dk[r][i]);
                }
            }
        }
    }
    cp_async_wait<0>();
    // this head's part: into dK / dV, or into its slot of the GQA scratch
    const int64_t pk = (int64_t)(h % a.rep) * a.B * a.Sk * a.KV;
    float* gk = a.part ? a.part + pk * DH : static_cast<float*>(a.dk);
    float* gv = a.part ? a.part + (int64_t)a.rep * a.B * a.Sk * a.KV * DH + pk * DV
                       : static_cast<float*>(a.dv);
#pragma unroll
    for (int r = 0; r < FR; ++r) {
        const int kp = k0 + warp * FR + r;
        if (kp >= a.Sk) continue;
        const int64_t row = ((int64_t)b * a.Sk + kp) * a.KV + kvh;
#pragma unroll
        for (int i = 0; i < NK; ++i) gk[row * DH + lane + 32 * i] = dk[r][i] * a.scale;
#pragma unroll
        for (int i = 0; i < NV; ++i) gv[row * DV + lane + 32 * i] = dv[r][i];
    }
}

// dK, dV = the sum of the rep query heads' parts, in head order
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(NT) dkv_reduce_kernel(const Args a) {
    const int64_t nk = (int64_t)a.B * a.Sk * a.KV * DH;
    const int64_t n = nk + (int64_t)a.B * a.Sk * a.KV * DV;
    for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * NT) {
        const bool is_k = i < nk;
        const int64_t j = is_k ? i : i - nk;
        const float* p = a.part + (is_k ? 0 : (int64_t)a.rep * nk) + j;
        const int64_t stride = is_k ? nk : n - nk;
        float s = 0.f;
        for (int r = 0; r < a.rep; ++r) s += p[r * stride];
        put(static_cast<T*>(is_k ? a.dk : a.dv) + j, s);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// Fragment layouts of m16n8k16 and ldmatrix addresses: mma_bf16.cuh.

constexpr int TROWS = 64;              // rows a CTA: 4 warps x 16
constexpr int BMQ = 32;                // queries a dK/dV tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

template <int DH, int DV>
struct Bw {
    static constexpr int KST = DH + 8, VST = DV + 8;       // padded rows
    static constexpr bool SPLIT = DH + DV > 256;           // dK, dV apart
    static constexpr int BN = DH >= 256 ? 32 : 64;         // dQ key tile
    static constexpr size_t SMEM_DKV = sizeof(bf16) *
        (size_t)(TROWS * KST + TROWS * VST + BMQ * KST + BMQ * VST) +
        2 * BMQ * sizeof(float);
    static constexpr size_t SMEM_DQ = sizeof(bf16) *
        (size_t)(TROWS * KST + TROWS * VST + BN * KST + BN * VST);
};

// dK/dV on the tensor cores. Warp w owns keys k0 + 16 w .. + 15; per query
// tile it computes S^T [16 x 32] = K_w Q^T and, for dK, dP^T = V_w dO^T.
template <int DH, int DV, bool DO_K, bool DO_V>
__global__ void __launch_bounds__(NT, 1) dkv_tc_kernel(const Args a) {
    using Tr = Bw<DH, DV>;
    constexpr int KST = Tr::KST, VST = Tr::VST;
    constexpr int NSN = BMQ / 8;       // n-tiles of S^T (queries)
    constexpr int NKC = BMQ / 16;      // k-steps over queries
    constexpr int NKN = DO_K ? DH / 8 : 1, NVN = DO_V ? DV / 8 : 1;
    extern __shared__ uint4 smem_t[];
    bf16* sK = reinterpret_cast<bf16*>(smem_t);   // [64][KST]
    bf16* sV = sK + TROWS * KST;                   // [64][VST]
    bf16* sQ = sV + TROWS * VST;                   // [32][KST]
    bf16* sO = sQ + BMQ * KST;                     // [32][VST] dO
    float* sL = reinterpret_cast<float*>(sO + BMQ * VST);  // [32] lse, log2
    float* sDl = sL + BMQ;                         // [32] delta
    const int k0 = blockIdx.x * TROWS, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / a.rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int krows = min(TROWS, a.Sk - k0);
    const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const bf16* dO = static_cast<const bf16*>(a.dout);
    load_rows<bf16, NT, TROWS, DH, KST>(sK, K + k0 * a.k_ss, a.k_ss, krows, tid);
    load_rows<bf16, NT, TROWS, DV, VST>(sV, V + k0 * a.v_ss, a.v_ss, krows, tid);
    cp_async_commit();

    float dk[NKN][4], dv[NVN][4];
#pragma unroll
    for (int n = 0; n < NKN; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NVN; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

    const int k_last = min(k0 + TROWS, a.k_lim) - 1;
    const int qi_lo = max(0, k0 - a.q_offset);
    int qi_hi = a.Sq - 1;
    if (a.window > 0) qi_hi = min(qi_hi, k_last + a.window - 1 - a.q_offset);
    if (k_last < k0) qi_hi = -1;
    // this warp's keys
    const int wk0 = k0 + 16 * warp;
    const bool w_live = wk0 <= k_last;
    const int a_row = 16 * warp + (lane & 15), a_col = (lane >> 4) * 8;
    const int bn_row = (lane & 7) + ((lane >> 4) << 3), bn_col = ((lane >> 3) & 1) * 8;
    const int bt_row = lane & 15, bt_col = (lane >> 4) * 8;
    const float scale_log2 = a.scale * LOG2E;

    {
        const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
        for (int q0 = qi_lo; q0 <= qi_hi; q0 += BMQ) {
            const int qrows = min(BMQ, a.Sq - q0);
            __syncthreads();                       // the previous tile is read
            load_rows<bf16, NT, BMQ, DH, KST>(sQ, Q + q0 * a.q_ss, a.q_ss, qrows, tid);
            load_rows<bf16, NT, BMQ, DV, VST>(
                sO, dO + (((int64_t)b * a.Sq + q0) * a.H + h) * DV, (int64_t)a.H * DV,
                qrows, tid);
            cp_async_commit();
            if (tid < BMQ) {
                const int64_t li = ((int64_t)b * a.H + h) * a.Sq + q0 + tid;
                sL[tid] = tid < qrows ? a.lse[li] * LOG2E : INFINITY;
                sDl[tid] = tid < qrows ? a.delta[li] : 0.f;
            }
            cp_async_wait<0>();
            __syncthreads();
            // a warp whose keys all lie past every query of the tile, or
            // past the keys' end, has nothing to add
            const int qpos_hi = a.q_offset + q0 + qrows - 1;
            if (!w_live || wk0 > qpos_hi) continue;

            float s[NSN][4];
#pragma unroll
            for (int n = 0; n < NSN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, sK + a_row * KST + kk * 16 + a_col);
#pragma unroll
                for (int jp = 0; jp < NSN / 2; ++jp) {
                    uint32_t bq[4];
                    ldsm_x4(bq, sQ + (16 * jp + bn_row) * KST + kk * 16 + bn_col);
                    mma_bf16(s[2 * jp], af, bq[0], bq[1]);
                    mma_bf16(s[2 * jp + 1], af, bq[2], bq[3]);
                }
            }
            float dp[DO_K ? NSN : 1][4];
            if (DO_K) {
#pragma unroll
                for (int n = 0; n < (DO_K ? NSN : 1); ++n)
                    dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
                for (int kk = 0; kk < DV / 16; ++kk) {
                    uint32_t af[4];
                    ldsm_x4(af, sV + a_row * VST + kk * 16 + a_col);
#pragma unroll
                    for (int jp = 0; jp < NSN / 2; ++jp) {
                        uint32_t bo[4];
                        ldsm_x4(bo, sO + (16 * jp + bn_row) * VST + kk * 16 + bn_col);
                        mma_bf16(dp[DO_K ? 2 * jp : 0], af, bo[0], bo[1]);
                        mma_bf16(dp[DO_K ? 2 * jp + 1 : 0], af, bo[2], bo[3]);
                    }
                }
            }
            // P^T (and dS^T): rows keys, columns queries
#pragma unroll
            for (int n = 0; n < NSN; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = 8 * n + c2 + (e & 1);
                    const int kp = wk0 + g + (e >> 1) * 8;
                    const int qp = a.q_offset + q0 + col;
                    const bool ok = col < qrows && live(kp, qp, a.k_lim, a.window);
                    const float p = ok ? exp2f(fmaf(s[n][e], scale_log2, -sL[col])) : 0.f;
                    s[n][e] = p;
                    if (DO_K) dp[DO_K ? n : 0][e] = p * (dp[DO_K ? n : 0][e] - sDl[col]);
                }
            }
#pragma unroll
            for (int kc = 0; kc < NKC; ++kc) {
                if (DO_V) {
                    const uint32_t pa[4] = {
                        pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                        pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                        pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                        pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
                    for (int dpi = 0; dpi < (DO_V ? DV / 16 : 0); ++dpi) {
                        uint32_t bo[4];
                        ldsm_x4_trans(bo, sO + (kc * 16 + bt_row) * VST + dpi * 16 + bt_col);
                        mma_bf16(dv[2 * dpi], pa, bo[0], bo[1]);
                        mma_bf16(dv[2 * dpi + 1], pa, bo[2], bo[3]);
                    }
                }
                if (DO_K) {
                    const int n0 = DO_K ? 2 * kc : 0, n1 = DO_K ? 2 * kc + 1 : 0;
                    const uint32_t da[4] = {
                        pack_bf16(dp[n0][0], dp[n0][1]), pack_bf16(dp[n0][2], dp[n0][3]),
                        pack_bf16(dp[n1][0], dp[n1][1]), pack_bf16(dp[n1][2], dp[n1][3])};
#pragma unroll
                    for (int dpi = 0; dpi < (DO_K ? DH / 16 : 0); ++dpi) {
                        uint32_t bq[4];
                        ldsm_x4_trans(bq, sQ + (kc * 16 + bt_row) * KST + dpi * 16 + bt_col);
                        mma_bf16(dk[2 * dpi], da, bq[0], bq[1]);
                        mma_bf16(dk[2 * dpi + 1], da, bq[2], bq[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    // rows g and g + 8 of the warp's keys; columns c2, c2 + 1 of each
    // n-tile: into dK / dV in bf16, or this head's fp32 part (GQA)
    const int64_t pk = (int64_t)(h % a.rep) * a.B * a.Sk * a.KV;
    float* pkp = a.part ? a.part + pk * DH : nullptr;
    float* pvp = a.part ? a.part + (int64_t)a.rep * a.B * a.Sk * a.KV * DH + pk * DV
                        : nullptr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kp = wk0 + g + 8 * i;
        if (kp >= a.Sk) continue;
        const int64_t row = ((int64_t)b * a.Sk + kp) * a.KV + kvh;
        if (DO_K) {
#pragma unroll
            for (int n = 0; n < NKN; ++n) {
                const float x = dk[n][2 * i] * a.scale, y = dk[n][2 * i + 1] * a.scale;
                if (pkp)
                    *reinterpret_cast<float2*>(pkp + row * DH + c2 + 8 * n) = make_float2(x, y);
                else
                    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + row * DH
                                                       + c2 + 8 * n) = __floats2bfloat162_rn(x, y);
            }
        }
        if (DO_V) {
#pragma unroll
            for (int n = 0; n < NVN; ++n) {
                const float x = dv[n][2 * i], y = dv[n][2 * i + 1];
                if (pvp)
                    *reinterpret_cast<float2*>(pvp + row * DV + c2 + 8 * n) = make_float2(x, y);
                else
                    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + row * DV
                                                       + c2 + 8 * n) = __floats2bfloat162_rn(x, y);
            }
        }
    }
}

// dQ on the tensor cores: CTA (64 queries, head, batch), warp w owns queries
// q0 + 16 w .. + 15 and walks BN-key tiles: S = Q K^T, dP = dO V^T,
// dS = P (dP - D), dQ += dS K.
template <int DH, int DV>
__global__ void __launch_bounds__(NT, 1) dq_tc_kernel(const Args a) {
    using Tr = Bw<DH, DV>;
    constexpr int KST = Tr::KST, VST = Tr::VST, BN = Tr::BN;
    constexpr int NSN = BN / 8, NKC = BN / 16, NQN = DH / 8;
    extern __shared__ uint4 smem_t[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_t);   // [64][KST]
    bf16* sO = sQ + TROWS * KST;                   // [64][VST] dO
    bf16* sK = sO + TROWS * VST;                   // [BN][KST]
    bf16* sV = sK + BN * KST;                      // [BN][VST]
    const int q0 = (gridDim.x - 1 - blockIdx.x) * TROWS;  // longest first
    const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int rows = min(TROWS, a.Sq - q0);
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const bf16* dO = static_cast<const bf16*>(a.dout);
    load_rows<bf16, NT, TROWS, DH, KST>(sQ, Q + q0 * a.q_ss, a.q_ss, rows, tid);
    load_rows<bf16, NT, TROWS, DV, VST>(
        sO, dO + (((int64_t)b * a.Sq + q0) * a.H + h) * DV, (int64_t)a.H * DV, rows, tid);
    cp_async_commit();

    const int wq0 = q0 + 16 * warp;
    const bool w_live = wq0 < a.Sq;
    float L[2], Dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = wq0 + g + 8 * i;
        const int64_t li = ((int64_t)b * a.H + h) * a.Sq + qi;
        L[i] = qi < a.Sq ? a.lse[li] * LOG2E : INFINITY;
        Dl[i] = qi < a.Sq ? a.delta[li] : 0.f;
    }
    float acc[NQN][4];
#pragma unroll
    for (int n = 0; n < NQN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    const int qpos_lo = a.q_offset + q0, qpos_hi = a.q_offset + q0 + rows - 1;
    const int k_end = min(a.k_lim, qpos_hi + 1);
    int k_begin = a.window > 0 ? max(0, qpos_lo - a.window + 1) : 0;
    k_begin = (k_begin / BN) * BN;
    const int wpos_lo = a.q_offset + wq0;
    const int wpos_hi = a.q_offset + min(wq0 + 15, a.Sq - 1);
    const int a_row = 16 * warp + (lane & 15), a_col = (lane >> 4) * 8;
    const int bn_row = (lane & 7) + ((lane >> 4) << 3), bn_col = ((lane >> 3) & 1) * 8;
    const int bt_row = lane & 15, bt_col = (lane >> 4) * 8;
    const float scale_log2 = a.scale * LOG2E;

    for (int k0 = k_begin; k0 < k_end; k0 += BN) {
        __syncthreads();                           // the previous tile is read
        load_rows<bf16, NT, BN, DH, KST>(sK, K + k0 * a.k_ss, a.k_ss, k_end - k0, tid);
        load_rows<bf16, NT, BN, DV, VST>(sV, V + k0 * a.v_ss, a.v_ss, k_end - k0, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const bool dead = !w_live || k0 > wpos_hi ||
                          (a.window > 0 && k0 + BN - 1 <= wpos_lo - a.window);
        if (dead) continue;
        float s[NSN][4], dp[NSN][4];
#pragma unroll
        for (int n = 0; n < NSN; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            uint32_t af[4];
            ldsm_x4(af, sQ + a_row * KST + kk * 16 + a_col);
#pragma unroll
            for (int jp = 0; jp < NSN / 2; ++jp) {
                uint32_t bk[4];
                ldsm_x4(bk, sK + (16 * jp + bn_row) * KST + kk * 16 + bn_col);
                mma_bf16(s[2 * jp], af, bk[0], bk[1]);
                mma_bf16(s[2 * jp + 1], af, bk[2], bk[3]);
            }
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
            uint32_t af[4];
            ldsm_x4(af, sO + a_row * VST + kk * 16 + a_col);
#pragma unroll
            for (int jp = 0; jp < NSN / 2; ++jp) {
                uint32_t bv[4];
                ldsm_x4(bv, sV + (16 * jp + bn_row) * VST + kk * 16 + bn_col);
                mma_bf16(dp[2 * jp], af, bv[0], bv[1]);
                mma_bf16(dp[2 * jp + 1], af, bv[2], bv[3]);
            }
        }
#pragma unroll
        for (int n = 0; n < NSN; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kp = k0 + 8 * n + c2 + (e & 1);
                const int qi = wq0 + g + (e >> 1) * 8;
                const bool ok = qi < a.Sq && live(kp, a.q_offset + qi, k_end, a.window);
                const float p = ok ? exp2f(fmaf(s[n][e], scale_log2, -L[e >> 1])) : 0.f;
                dp[n][e] = p * (dp[n][e] - Dl[e >> 1]);   // dS
            }
        }
#pragma unroll
        for (int kc = 0; kc < NKC; ++kc) {
            const uint32_t da[4] = {
                pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
            for (int dpi = 0; dpi < DH / 16; ++dpi) {
                uint32_t bk[4];
                ldsm_x4_trans(bk, sK + (kc * 16 + bt_row) * KST + dpi * 16 + bt_col);
                mma_bf16(acc[2 * dpi], da, bk[0], bk[1]);
                mma_bf16(acc[2 * dpi + 1], da, bk[2], bk[3]);
            }
        }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = wq0 + g + 8 * i;
        if (qi >= a.Sq) continue;
        bf16* row = static_cast<bf16*>(a.dq) + (((int64_t)b * a.Sq + qi) * a.H + h) * DH + c2;
#pragma unroll
        for (int n = 0; n < NQN; ++n)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
                acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
    }
}

template <typename K>
cudaError_t go(K kern, dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, NT, smem, s>>>(a);
    return cudaGetLastError();
}

template <typename T, int DH, int DV>
cudaError_t reduce(const Args& a, cudaStream_t s) {
    const int64_t n = (int64_t)a.B * a.Sk * a.KV * (DH + DV);
    const int blocks = (int)((n + NT - 1) / NT < 132 * 16 ? (n + NT - 1) / NT : 132 * 16);
    dkv_reduce_kernel<T, DH, DV><<<blocks, NT, 0, s>>>(a);
    return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t run(int dtype, const Args& a, cudaStream_t s) {
    const dim3 dgrid((a.B * a.Sq * a.H + 3) / 4);
    cudaError_t err;
    if (dtype == 0) {
        delta_kernel<float, DV><<<dgrid, NT, 0, s>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        constexpr size_t sm_kv = sizeof(float) *
            ((size_t)FROWS * (DH + DV) + FC * (DH + 4) + FC * (DV + 4) + 2 * FC);
        err = go(dkv_fp32_kernel<DH, DV>, dim3((a.Sk + FROWS - 1) / FROWS, a.H, a.B),
                 sm_kv, s, a);
        if (err == cudaSuccess && a.part) err = reduce<float, DH, DV>(a, s);
        if (err != cudaSuccess) return err;
        constexpr size_t sm_q = sizeof(float) *
            ((size_t)FROWS * (DH + DV) + FC * (DH + 4) + FC * (DV + 4));
        return go(dq_fp32_kernel<DH, DV>, dim3((a.Sq + FROWS - 1) / FROWS, a.H, a.B),
                  sm_q, s, a);
    }
    using Tr = Bw<DH, DV>;
    delta_kernel<bf16, DV><<<dgrid, NT, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 kgrid((a.Sk + TROWS - 1) / TROWS, a.H, a.B);
    if constexpr (Tr::SPLIT) {
        err = go(dkv_tc_kernel<DH, DV, false, true>, kgrid, Tr::SMEM_DKV, s, a);
        if (err != cudaSuccess) return err;
        err = go(dkv_tc_kernel<DH, DV, true, false>, kgrid, Tr::SMEM_DKV, s, a);
    } else {
        err = go(dkv_tc_kernel<DH, DV, true, true>, kgrid, Tr::SMEM_DKV, s, a);
    }
    if (err == cudaSuccess && a.part) err = reduce<bf16, DH, DV>(a, s);
    if (err != cudaSuccess) return err;
    return go(dq_tc_kernel<DH, DV>, dim3((a.Sq + TROWS - 1) / TROWS, a.H, a.B),
              Tr::SMEM_DQ, s, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B, Sq, H, dh], k [B, Sk, KV, dh] and
// v [B, Sk, KV, dv] through their strides (last axis contiguous, rows on 16
// bytes), as the forward read them; o and dout contiguous [B, Sq, H, dv];
// lse the forward's fp32 [B, H, Sq]; delta fp32 scratch [B, H, Sq]; part,
// where H > KV, fp32 scratch of H * B * Sk * (dh + dv) (null where H = KV);
// dq [B, Sq, H, dh], dk [B, Sk, KV, dh] and dv [B, Sk, KV, dv] contiguous,
// of dtype, every element written (a key no query sees gets 0). Launches
// the delta pass, the dK/dV kernel (twice where dh + dv > 256 in bf16),
// with GQA the sum of its parts, and the dQ kernel on `stream`; returns
// the first cudaError_t (0 on success).
extern "C" int flash_prefill_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* part, void* dq, void* dk, void* dv,
    int dtype, int B, int Sq, int Sk, int H, int KV, int dh, int dv_,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int q_offset, int kv_len, int window, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
        (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    if ((H != KV) != (part != nullptr)) return cudaErrorInvalidValue;
    Args a{q, k, v, o, dout, static_cast<const float*>(lse),
           static_cast<float*>(delta), dq, dk, dv, static_cast<float*>(part),
           B, Sq, Sk, H, KV, H / KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           q_offset, kv_len < Sk ? kv_len : Sk, window, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh == dv_) {
        switch (dh) {
            case 32: return run<32, 32>(dtype, a, s);
            case 64: return run<64, 64>(dtype, a, s);
            case 128: return run<128, 128>(dtype, a, s);
            case 256: return run<256, 256>(dtype, a, s);
        }
    }
    if (dh == 192 && dv_ == 128) return run<192, 128>(dtype, a, s);
    return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
