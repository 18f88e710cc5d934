// Backward of flash_prefill.cu for Hopper (sm_90a): dQ, dK and dV of the
// causal GQA attention with prefix resume, for exactly the forward's
// contract. Sq queries at positions q_offset.. attend to keys < kv_len; the
// key at kpos is live for the query at qpos when
//   kpos <= qpos  &&  kpos < kv_len  &&  (window <= 0 || kpos > qpos - window),
// (dh, dv) is one of the forward's WIDTHS, MLA's (192, 128) included, and H
// query heads share KV kv heads. whisper's bidirectional attention is the
// forward's q_offset = kv_len = Sk and needs nothing of its own here. The
// forward's key limit (lim[Sq], non-decreasing, at most kv_len; q_offset 0,
// no window) replaces the causal rule as there: kpos < lim[qi] && kpos <
// kv_len. Each kernel takes it as a template flag (LIM), so the null
// instantiation is the code without it. Under it, a dQ tile's keys end at
// min(kv_len, lim[last row]); a dK/dV CTA's first query tile is the first
// whose last row's limit passes its first key (first_query: a warp's ballot
// over the tiles' last rows, 32 tiles a round; the fp32 kernel starts at that
// row itself, first_row, as its causal form starts at the key's own query),
// and every tile after it sees the keys too; a tile pair needs no per-element
// mask when its last key is below its first query's limit. With lim[i] = i + 1
// every loop bound equals the causal form's, so the results are its bits.
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
// bf16 runs two kernels on wgmma (a third and a fourth sum fixed-order fp32
// shares where the plan splits work), fp32 three on scalar FMAs. No atomics:
// two calls on the same inputs give the same bits.
//  1. dQ (bf16 first): CTA (64 queries, head, batch, key split) over the key
//     tiles its queries see. It also computes D = rowsum(dO * O) and
//     lse * log2(e) of its rows for the dK/dV kernel (no separate pass).
//  2. dK/dV: CTA (64 keys, kv head, part) over the (query head, query tile)
//     pairs that see its keys, the group's heads summed in registers.
//  (fp32: a delta pass, dK/dV with one fp32 part a query head and their sum,
//  then dQ, as the first form.)
//
// What bounds it on this card. The backward does 3.5x the forward's products
// (7: S and dP twice, dV, dK, dQ) over the forward's bytes plus dO and the
// three gradients. On paper the bytes bound it at deepseek-v3's (128/128,
// (192, 128)) B=1 S=512 (0.050 ms; the 28 GFLOP of FlashAttention's 5
// products take 0.029 ms at 989 TFLOP/s) and the operations at gemma3-270m's
// (4/1, 256) B=4 S=1024 (0.022 ms). In practice the 64 x 64 tiles'
// products, the exponentials (at dh 64 they take
// half the tensor cores' time on the SM's 16 exp units a clock) and each
// CTA's latency chain bound it; PERF.md has the times. The design, point by
// point against the first form (single-buffered mma.sync tiles):
//  - Tiles come by TMA (wgmma.cuh: 64 x 64 boxes, 128-byte swizzle, rows
//    past a tensor's end zero-filled; k and v mapped only up to kv_len) into
//    rings of 2 or 3 stages (Wg::S, as shared memory allows), issued S - 1
//    tiles ahead by one thread of warpgroup 1 and waited on by mbarrier.
//  - Products on wgmma m64n64k16 over 64-row warpgroup tiles, two warpgroups
//    a CTA. The first product's fixed operand (K or V in dK/dV, Q or dO in
//    dQ) is held in registers by ldmatrix where it fits (Wg::KV_AREG), P^T
//    and dS^T (P and dS) are register A operands, and the second operand of
//    dV += P^T dO, dK += dS^T Q and dQ += dS K is read MN-major.
//  - Enough CTAs: flash_prefill.bwd_plan splits dQ's key range (dq_splits)
//    and dK/dV's (head, query tile) pairs (kv_parts) where the card would
//    sit idle, each split an fp32 share summed in a fixed order.
//  - One dK/dV pass at every width: warpgroup 0 owns dV, warpgroup 1 dK of
//    the same keys, so a thread holds dv / 2 or dh / 2 accumulators (128 at
//    gemma3's 256) and P^T is computed once; 7 products, not 8. dQ keeps its
//    own S and dP: without atomics the other ways store dS ([B, H, Sq, Sk])
//    or a dQ share for every key tile, more bytes than the products save.
//  - GQA: a dK/dV CTA walks every query head of its kv head, so no per-head
//    fp32 parts; parts come back only where the plan wants more CTAs (at
//    gemma3 two of its four heads each, 128 CTAs).
//  - The warpgroups meet only through mbarriers (a full and an empty one a
//    stage, and a double-buffered P^T hand-off in dK/dV), so warpgroup 0 can
//    run tiles ahead of warpgroup 1.
// fp32 keeps the first form's scalar FMAs (the tensor cores take no fp32
// input at the 1e-5 tolerance).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 128;                // 4 warps
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const void* q; const void* k; const void* v; const void* o; const void* dout;
    const float* lse;                  // the forward's [B, H, Sq]
    const int* lim;                    // the key limit [Sq], or null
    float* delta;                      // D [B, H, sq_pad] (rows padded to 16 bytes)
    float* l2;                         // lse * log2(e) [B, H, sq_pad], after delta
    void* dq; void* dk; void* dv;
    float* part;                       // GQA: fp32 [kv_parts, B, Sk, KV, DH],
                                       // then [kv_parts, B, Sk, KV, DV]: parts
                                       // of dK, dV; null when kv_parts = 1
    float* dq_part;                    // fp32 [dq_splits, B, Sq, H, DH]; null
                                       // when dq_splits = 1
    int B, Sq, Sk, H, KV, rep, kv_parts, dq_splits, sq_pad;
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

// the first query of the first STEP-query tile whose last row's limit passes
// k0 (under a non-decreasing limit, that tile and every later one see the key
// at k0), or the tiles' end where none does; a warp's ballot over 32 tiles a
// round, every lane converged
template <int STEP>
__device__ __forceinline__ int first_query(const int* lim, int Sq, int k0) {
    const int lane = threadIdx.x & 31, nt = (Sq + STEP - 1) / STEP;
    for (int t0 = 0; t0 < nt; t0 += 32) {
        const int t = t0 + lane;
        const unsigned hit = __ballot_sync(
            FULL, t < nt && lim[min(t * STEP + STEP - 1, Sq - 1)] > k0);
        if (hit) return (t0 + __ffs(hit) - 1) * STEP;
    }
    return nt * STEP;
}

// the first query whose limit passes k0 (Sq where none does): the tile of
// first_query<32>, then a ballot over its rows
__device__ __forceinline__ int first_row(const int* lim, int Sq, int k0) {
    const int q0 = first_query<32>(lim, Sq, k0);
    if (q0 >= Sq) return Sq;
    const int qi = q0 + (threadIdx.x & 31);
    return q0 + __ffs(__ballot_sync(FULL, qi < Sq && lim[qi] > k0)) - 1;
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
        const int64_t bh = (int64_t)b * a.H + h, li = bh * a.sq_pad + qi;
        a.delta[li] = s;
        a.l2[li] = a.lse[bh * a.Sq + qi] * LOG2E;
    }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int FR = 4;                  // rows a warp
constexpr int FROWS = 4 * FR;          // rows a CTA
constexpr int FC = 32;                 // columns a tile: one a lane

// dQ: CTA (16 queries, head, batch); lane j takes key k0 + j of a 32-key tile
template <int DH, int DV, bool LIM>
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
    int lim_r[FR];                                 // the rows' limits (LIM)
#pragma unroll
    for (int r = 0; r < FR; ++r) {
        const int qi = q0 + warp * FR + r;
        const int64_t li = ((int64_t)b * a.H + h) * a.Sq + qi;
        lim_r[r] = LIM && qi < a.Sq ? a.lim[qi] : 0;
        L[r] = qi < a.Sq ? a.lse[li] : INFINITY;
        Dl[r] = qi < a.Sq ? a.delta[li - (int64_t)(b * a.H + h) * (a.Sq - a.sq_pad)] : 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    }
    const int qpos_lo = a.q_offset + q0, qpos_hi = a.q_offset + q0 + rows - 1;
    const int k_end = min(a.k_lim, LIM ? a.lim[q0 + rows - 1] : qpos_hi + 1);
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
            const bool ok = LIM ? kp < k_end && kp < lim_r[r] : live(kp, qp, k_end, a.window);
            const float p = ok ? expf(s[r] * a.scale - L[r]) : 0.f;
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
template <int DH, int DV, bool LIM>
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
    int qi_lo = LIM ? first_row(a.lim, a.Sq, k0) : max(0, k0 - a.q_offset);
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
                sDl[tid] = tid < qrows
                    ? a.delta[li - (int64_t)(b * a.H + h) * (a.Sq - a.sq_pad)] : 0.f;
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
            const int lq = LIM && lane < qrows ? a.lim[q0 + lane] : 0;
            float p[FR];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const int kp = k0 + warp * FR + r;
                p[r] = lane < qrows && (LIM ? kp < a.k_lim && kp < lq
                                            : live(kp, qp, a.k_lim, a.window))
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
    float* gv = a.part ? a.part + (int64_t)a.kv_parts * a.B * a.Sk * a.KV * DH + pk * DV
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

// dK, dV = the sum of the kv_parts parts, in part order
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(NT) dkv_reduce_kernel(const Args a) {
    const int64_t nk = (int64_t)a.B * a.Sk * a.KV * DH;
    const int64_t n = nk + (int64_t)a.B * a.Sk * a.KV * DV;
    for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * NT) {
        const bool is_k = i < nk;
        const int64_t j = is_k ? i : i - nk;
        const float* p = a.part + (is_k ? 0 : (int64_t)a.kv_parts * nk) + j;
        const int64_t stride = is_k ? nk : n - nk;
        float s = 0.f;
        for (int r = 0; r < a.kv_parts; ++r) s += p[r * stride];
        put(static_cast<T*>(is_k ? a.dk : a.dv) + j, s);
    }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma
// ---------------------------------------------------------------------------
// Tiles of 64 rows (keys or queries) in the swizzled layout of wgmma.cuh,
// widths below 64 padded with zero columns. Barrier 0 is __syncthreads;
// barrier 1 hands P^T from the dV warpgroup to the dK warpgroup.

constexpr int WR = 64;                 // rows of a tile

__host__ __device__ constexpr int padw(int d) { return d < 64 ? 64 : d; }

// the bf16 kernels' TMA maps: q, k, v, dout as [d, heads, rows, B] in
// 64 x 64 boxes (k and v end at kv_len), and the delta pass's D and l2 as
// fp32 [Sq, B * H, 2] in boxes of 64
struct Maps {
    CUtensorMap q, k, v, o, ld;
};

template <int DH, int DV>
struct Wg {
    static constexpr int PH = padw(DH), PV = padw(DV);
    static constexpr int KB = WR * PH * 2, VB = WR * PV * 2;   // tile bytes
    static constexpr int PB = 16 * 128 * 4;                    // P^T hand-off
    // dK/dV's K / V operand in registers: 4 x max(DH, DV) / 16 more a
    // thread; at (128, 128) they would cost the second CTA an SM, and at
    // (256, 256) they do not fit
    static constexpr bool KV_AREG = DH <= 64 || DH == 192;
    // dK/dV: K, V, then two stages of (Q, dO), P^T, two stages of (L, D)
    // ring stages: three (loads two tiles ahead) where they fit beside the
    // occupancy the registers allow, else two
    static constexpr int S = (DH + DV <= 128 || DH == 192) ? 3 : 2;
    static constexpr size_t SMEM_KV =
        (size_t)(S + 1) * (KB + VB) + 2 * PB + S * 2 * WR * 4 + 8 * (2 * S + 4) + 1024;
    // dQ: Q, dO, then two stages of (K, V), P and dS hand-offs
    static constexpr size_t SMEM_Q =
        (size_t)(S + 1) * (KB + VB) + 2 * PB + 8 * S + 2 * WR * 4 + 1024;
};

__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// every (key, query) pair of a 64-key tile from kf and a 64-query tile at
// absolute position qf is live (no mask needed)
__device__ __forceinline__ bool all_live(int kf, int qf, int qrows, int k_lim, int window) {
    return qrows == WR && kf + WR - 1 < k_lim && kf + WR - 1 <= qf &&
           (window <= 0 || kf > qf + WR - 1 - window);
}


// byte offset of k-step kk (16 columns) in a K-major tile of 64 rows
__device__ __forceinline__ uint32_t kstep(int kk) {
    return (uint32_t)((kk >> 2) * (WR * 128) + (kk & 3) * 32);
}

// dK/dV: CTA (64 keys, kv head, batch, part of the (query head, query tile)
// pairs that see them), two warpgroups on the same keys. Warpgroup 0 computes S^T = K Q^T, P^T and
// dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - D) with the
// P^T that warpgroup 0 hands it through shared memory, and dK += dS^T Q. The
// query tiles (of each head in turn) come through an S-stage
// ring filled by TMA, S - 1 tiles ahead. The warpgroups meet only through
// mbarriers, so warpgroup 0 runs up to S - 1 tiles ahead of warpgroup 1 and
// its exponentials overlap warpgroup 1's products:
//   full[s]   the stage's copies landed (TMA bytes)
//   empty[s]  warpgroup 0's warps are done with the stage (warpgroup 1,
//             which issues the copies, is past it by program order)
//   pready[j] P^T of the tile in hand-off buffer j is written (128 arrivals)
//   pfree[j]  warpgroup 1 has read it (128 arrivals)
template <int DH, int DV, bool LIM>
__global__ void __launch_bounds__(256, (DH + DV <= 256 ? 2 : 1))
dkv_wg_kernel(const Args a, const __grid_constant__ Maps m) {
    using W = Wg<DH, DV>;
    constexpr int S = W::S;
    constexpr int NCM = (W::PH > W::PV ? W::PH : W::PV) / 64;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint8_t* sK = sm;
    uint8_t* sV = sK + W::KB;
    uint8_t* sS0 = sV + W::VB;                      // stage s: Q, then dO
    uint32_t* sP = reinterpret_cast<uint32_t*>(sm + (S + 1) * (W::KB + W::VB));   // [2]
    float* sLD = reinterpret_cast<float*>(sP + 2 * 16 * 128);   // stage s: D, then L
    uint64_t* full = reinterpret_cast<uint64_t*>(sLD + S * 2 * WR);
    uint64_t* empty = full + S;
    uint64_t* pready = empty + S;                   // [2]
    uint64_t* pfree = pready + 2;                   // [2]
    const int tid = threadIdx.x, t128 = tid & 127;
    const bool vside = tid < 128;                   // warpgroup 0
    const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, c2 = 2 * (lane & 3);
    // grid (parts of every kv head and batch, key tiles): the CTAs of key
    // tile 0, the longest under a causal mask, start first
    const int k0 = blockIdx.y * WR, part = blockIdx.x % a.kv_parts;
    const int kvh = (blockIdx.x / a.kv_parts) % a.KV, b = blockIdx.x / a.kv_parts / a.KV;
    const int h0 = kvh * a.rep;                     // the group's first query head

    // the queries that can see a key of the tile, in 64-query tiles from a
    // multiple of 64 (TMA reads L and D from a 16-byte boundary)
    const int k_last = min(k0 + WR, a.k_lim) - 1;
    const int qi_lo = LIM ? first_query<WR>(a.lim, a.Sq, k0)
                          : max(0, k0 - a.q_offset) / WR * WR;
    int qi_hi = a.Sq - 1;
    if (a.window > 0) qi_hi = min(qi_hi, k_last + a.window - 1 - a.q_offset);
    if (k_last < k0) qi_hi = -1;
    const int nqt = qi_hi >= qi_lo ? (qi_hi - qi_lo) / WR + 1 : 0;
    // this part's share of the (query head, query tile) pairs, head-major
    const int per = (nqt * a.rep + a.kv_parts - 1) / a.kv_parts;
    const int t_lo = min(nqt * a.rep, part * per);
    const int T = min(nqt * a.rep, t_lo + per) - t_lo;
    // pair t_lo + t into stage st: Q, dO, then D and L of its queries; rows
    // past Sq arrive as zeros
    auto load = [&](int st, int t, uint32_t extra) {
        const int h = h0 + (t_lo + t) / nqt, q0 = qi_lo + ((t_lo + t) % nqt) * WR;
        uint8_t* s = sS0 + st * (W::KB + W::VB);
        mb_expect(&full[st], W::KB + W::VB + 2 * WR * 4 + extra);
        for (int c = 0; c < W::PH / 64; ++c)
            tma_load4(s + c * WR * 128, &m.q, 64 * c, h, q0, b, &full[st]);
        for (int c = 0; c < W::PV / 64; ++c)
            tma_load4(s + W::KB + c * WR * 128, &m.o, 64 * c, h, q0, b, &full[st]);
        tma_load3(sLD + st * 2 * WR, &m.ld, q0, b * a.H + h, 0, &full[st]);
    };
    // one thread of warpgroup 1 issues the copies
    const bool issuer = tid == 128;
    if (tid == 0 && T > 0) {
        for (int i = 0; i < S; ++i) {
            mb_init(&full[i], 1);
            mb_init(&empty[i], 4);
        }
        for (int j = 0; j < 2; ++j) {
            mb_init(&pready[j], 128);
            mb_init(&pfree[j], 128);
        }
        mb_init_fence();
    }
    __syncthreads();
    if (issuer && T > 0) {                          // K and V (keys past kv_len
        prefetch_map(&m.q);                         // are zeros) with tile 0
        prefetch_map(&m.o);
        prefetch_map(&m.ld);
        for (int c = 0; c < W::PH / 64; ++c)
            tma_load4(sK + c * WR * 128, &m.k, 64 * c, kvh, k0, b, &full[0]);
        for (int c = 0; c < W::PV / 64; ++c)
            tma_load4(sV + c * WR * 128, &m.v, 64 * c, kvh, k0, b, &full[0]);
        load(0, 0, W::KB + W::VB);
        for (int i = 1; i < S - 1 && i < T; ++i) load(i, i, 0);
    }

    float acc[NCM][32];
#pragma unroll
    for (int n = 0; n < NCM; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
    const int nc = vside ? W::PV / 64 : W::PH / 64;   // 64-column parts of dV / dK
    const int ksteps = vside ? DH / 16 : DV / 16;
    const uint32_t uK = smem_u32(sK), uV = smem_u32(sV), uS0 = smem_u32(sS0);
    const float scale_log2 = a.scale * LOG2E;
    // the first product's A (this warpgroup's K or V rows) in registers
    // where they fit (Wg::KV_AREG), else read from shared memory
    constexpr bool AREG = W::KV_AREG;
    constexpr int KSM = (DH > DV ? DH : DV) / 16;
    uint32_t af[AREG ? KSM : 1][4];

    for (int t = 0; t < T; ++t) {
        const int st = t % S, j = t & 1;
        mb_wait(&full[st], (t / S) & 1);            // tile t landed
        if (issuer && t + S - 1 < T) {              // tile t + S - 1 into the
            if (t > 0) mb_wait(&empty[(t - 1) % S], ((t - 1) / S) & 1);   // slot of t - 1
            load((t + S - 1) % S, t + S - 1, 0);
        }
        const int q0 = qi_lo + ((t_lo + t) % nqt) * WR;
        const int qrows = min(WR, a.Sq - q0);
        const uint32_t uQ = uS0 + st * (W::KB + W::VB), uO = uQ + W::KB;
        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
        float s[32];
        {
            const uint32_t ua = vside ? uK : uV, ub = vside ? uQ : uO;
            if (AREG && t == 0) {
#pragma unroll
                for (int kk = 0; kk < (AREG ? KSM : 0); ++kk)
                    if (kk < ksteps) ldsm_a(af[AREG ? kk : 0], ua, WR, warp, kk, lane);
            }
            wg_fence();
            if (AREG) {
#pragma unroll
                for (int kk = 0; kk < (AREG ? KSM : 0); ++kk)
                    if (kk < ksteps)
                        wgmma_rs<0>(s, af[AREG ? kk : 0], desc_k(ub + kstep(kk)), kk > 0);
            } else {
                for (int kk = 0; kk < ksteps; ++kk)
                    wgmma_ss_k(s, desc_k(ua + kstep(kk)), desc_k(ub + kstep(kk)), kk > 0);
            }
            wg_commit();
            wg_wait<0>();
            reg_fence(s);
        }
        const float* sD = sLD + st * 2 * WR;
        const float* sL = sD + WR;
        uint32_t* pbuf = sP + j * 16 * 128;
        uint32_t pa[4][4];
        if (vside) {
            if (LIM ? qrows == WR && k0 + WR - 1 < a.k_lim && k0 + WR - 1 < a.lim[q0]
                    : all_live(k0, a.q_offset + q0, qrows, a.k_lim, a.window)) {
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    s[i] = ex2(fmaf(s[i], scale_log2, -sL[8 * (i >> 2) + c2 + (i & 1)]));
            } else {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int row = 16 * warp + g + 8 * ((i & 3) >> 1);
                    const int col = 8 * (i >> 2) + c2 + (i & 1);
                    const bool ok = col < qrows &&
                        (LIM ? k0 + row < a.k_lim && k0 + row < a.lim[q0 + col]
                             : live(k0 + row, a.q_offset + q0 + col, a.k_lim, a.window));
                    s[i] = ok ? ex2(fmaf(s[i], scale_log2, -sL[col])) : 0.f;
                }
            }
            if (t >= 2) mb_wait(&pfree[j], ((t - 2) >> 1) & 1);   // buffer j read
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
                a_frag(pa[kc], s, kc);
#pragma unroll
                for (int r = 0; r < 4; ++r) pbuf[(kc * 4 + r) * 128 + t128] = pa[kc][r];
            }
            mb_arrive(&pready[j]);
        } else {
            mb_wait(&pready[j], (t >> 1) & 1);     // P^T of tile t is in buffer j
            uint32_t pr[4][4];
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
#pragma unroll
                for (int r = 0; r < 4; ++r) pr[kc][r] = pbuf[(kc * 4 + r) * 128 + t128];
            mb_arrive(&pfree[j]);
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float2 p = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&pr[kc][r]));
                    const int i = 8 * kc + 2 * r;
                    const int col = 8 * (i >> 2) + c2;
                    pa[kc][r] = pack_bf16x2(p.x * (s[i] - sD[col]),
                                            p.y * (s[i + 1] - sD[col + 1]));
                }
            }
        }
        // dV += P^T dO or dK += dS^T Q: B is the stage's dO / Q tile, MN-major
        {
            const uint32_t ub = vside ? uO : uQ;
            wg_fence();
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
#pragma unroll
                for (int n = 0; n < NCM; ++n)
                    if (n < nc)
                        wgmma_rs<1>(acc[n], pa[kc],
                                    desc_mn(ub + n * (WR * 128) + kc * 2048, WR * 128));
            wg_commit();
            wg_wait<0>();
#pragma unroll
            for (int n = 0; n < NCM; ++n) reg_fence(acc[n]);
        }
        if (vside && lane == 0) mb_arrive(&empty[st]);   // a warp of warpgroup 0 is done
    }
    // rows g and g + 8 of the warp's keys: into dV / dK in bf16, or this
    // part's fp32 slot of the GQA scratch
    const int DW = vside ? DV : DH;
    const float mul = vside ? 1.f : a.scale;
    const int64_t nkv = (int64_t)a.B * a.Sk * a.KV;
    float* pp = nullptr;
    if (a.part)
        pp = vside ? a.part + a.kv_parts * nkv * DH + part * nkv * DV
                   : a.part + part * nkv * DH;
    bf16* out = static_cast<bf16*>(vside ? a.dv : a.dk);
#pragma unroll
    for (int n = 0; n < NCM; ++n) {
        if (n >= nc) break;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            const int kp = k0 + 16 * warp + g + 8 * ((i & 3) >> 1);
            const int col = 64 * n + 8 * (i >> 2) + c2;
            if (kp >= a.Sk || col >= DW) continue;
            const int64_t at = (((int64_t)b * a.Sk + kp) * a.KV + kvh) * DW + col;
            const float x = acc[n][i] * mul, y = acc[n][i + 1] * mul;
            if (pp)
                *reinterpret_cast<float2*>(pp + at) = make_float2(x, y);
            else
                *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(x, y);
        }
    }
}

// dQ: CTA (64 queries, head, batch, key split), two warpgroups on the same
// queries, as dK/dV's. Per 64-key tile of the split's range (a 2-stage
// cp.async ring): warpgroup 0 computes S = Q K^T and P, warpgroup 1 dP = dO
// V^T and, with the P handed over, dS = P (dP - D), which it hands back;
// then dQ += dS K with dS as the register A operand and K read MN-major,
// warpgroup 0 over dQ's first NC0 64-column parts, warpgroup 1 over the
// rest (at (192, 128): one and two, so each does 256 columns' products).
template <int DH, int DV, bool LIM>
__global__ void __launch_bounds__(256, (DH <= 128 ? 2 : 1))
dq_wg_kernel(const Args a, const __grid_constant__ Maps m) {
    using W = Wg<DH, DV>;
    constexpr int NC = W::PH / 64, NC0 = NC / 2, NCM = NC - NC0;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint8_t* sQ = sm;
    uint8_t* sO = sQ + W::KB;
    uint8_t* sS0 = sO + W::VB;                      // stage s: K, then V
    constexpr int S = W::S;
    uint32_t* sP = reinterpret_cast<uint32_t*>(sm + (S + 1) * (W::KB + W::VB));
    uint32_t* sDS = sP + 16 * 128;
    uint64_t* full = reinterpret_cast<uint64_t*>(sDS + 16 * 128);   // a stage each
    // grid (splits of every head and batch, query tiles from the last): the
    // CTAs of the last query tile, the longest under a causal mask, first
    const int q0 = (gridDim.y - 1 - blockIdx.y) * WR, sp = blockIdx.x % a.dq_splits;
    const int h = (blockIdx.x / a.dq_splits) % a.H, b = blockIdx.x / a.dq_splits / a.H;
    const int kvh = h / a.rep;
    const int tid = threadIdx.x, t128 = tid & 127;
    const bool pside = tid < 128;                   // warpgroup 0
    const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, c2 = 2 * (lane & 3);
    const int rows = min(WR, a.Sq - q0);
    // D = rowsum(O * dO) and lse * log2(e) of the CTA's rows, 4 threads a
    // row from global memory; split 0 writes them for the dK/dV kernel,
    // which runs after this one
    float* sRow = reinterpret_cast<float*>(full + S);   // L [64], then D [64]
    {
        const int r = tid >> 2, sub = tid & 3, qi = q0 + r;
        float d = 0.f, l = INFINITY;
        if (qi < a.Sq) {
            const int64_t at = (((int64_t)b * a.Sq + qi) * a.H + h) * DV;
            const bf16* o = static_cast<const bf16*>(a.o) + at;
            const bf16* dd = static_cast<const bf16*>(a.dout) + at;
#pragma unroll
            for (int c = 8 * sub; c < DV; c += 32) {
                const uint4 x = *reinterpret_cast<const uint4*>(o + c);
                const uint4 y = *reinterpret_cast<const uint4*>(dd + c);
                const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
                const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 fx = __bfloat1622float2(xh[e]), fy = __bfloat1622float2(yh[e]);
                    d = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, d));
                }
            }
            l = a.lse[((int64_t)b * a.H + h) * a.Sq + qi] * LOG2E;
        }
        d += __shfl_xor_sync(FULL, d, 1);
        d += __shfl_xor_sync(FULL, d, 2);
        if (sub == 0) {
            sRow[r] = l;
            sRow[WR + r] = d;
            if (sp == 0 && qi < a.Sq) {
                const int64_t li = ((int64_t)b * a.H + h) * a.sq_pad + qi;
                a.delta[li] = d;
                a.l2[li] = l;
            }
        }
    }
    // this split's key tiles
    const int qpos_lo = a.q_offset + q0, qpos_hi = a.q_offset + q0 + rows - 1;
    const int k_end = min(a.k_lim, LIM ? a.lim[q0 + rows - 1] : qpos_hi + 1);
    int k_begin = a.window > 0 ? max(0, qpos_lo - a.window + 1) : 0;
    k_begin = (k_begin / WR) * WR;
    // LIM: keys below lim_lo are live for every row of the tile; lim_q[i]
    // is row g + 8 i of this warp's (0 past Sq)
    const int lim_lo = LIM ? a.lim[q0] : 0;
    int lim_q[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + 16 * warp + g + 8 * i;
        lim_q[i] = LIM && qi < a.Sq ? a.lim[qi] : 0;
    }
    const int nkt = k_end > k_begin ? (k_end - k_begin + WR - 1) / WR : 0;
    const int per = (nkt + a.dq_splits - 1) / a.dq_splits;
    const int t_lo = min(nkt, sp * per), t_hi = min(nkt, t_lo + per);
    // key tile t into stage st (one thread); keys past kv_len are zeros
    auto load = [&](int st, int t, uint32_t extra) {
        const int kt0 = k_begin + t * WR;
        uint8_t* s = sS0 + st * (W::KB + W::VB);
        mb_expect(&full[st], W::KB + W::VB + extra);
        for (int c = 0; c < W::PH / 64; ++c)
            tma_load4(s + c * WR * 128, &m.k, 64 * c, kvh, kt0, b, &full[st]);
        for (int c = 0; c < W::PV / 64; ++c)
            tma_load4(s + W::KB + c * WR * 128, &m.v, 64 * c, kvh, kt0, b, &full[st]);
    };
    // one thread of warpgroup 1 (off the P path) issues the copies
    const bool issuer = tid == 128;
    if (tid == 0 && t_lo < t_hi) {
        for (int i = 0; i < S; ++i) mb_init(&full[i], 1);
        mb_init_fence();
    }
    __syncthreads();                                // the rows' L and D too
    float L[2], Dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        L[i] = sRow[16 * warp + g + 8 * i];
        Dl[i] = sRow[WR + 16 * warp + g + 8 * i];
    }
    if (issuer && t_lo < t_hi) {                    // Q and dO with key tile t_lo
        prefetch_map(&m.q);
        prefetch_map(&m.o);
        prefetch_map(&m.k);
        prefetch_map(&m.v);
        for (int c = 0; c < W::PH / 64; ++c)
            tma_load4(sQ + c * WR * 128, &m.q, 64 * c, h, q0, b, &full[0]);
        for (int c = 0; c < W::PV / 64; ++c)
            tma_load4(sO + c * WR * 128, &m.o, 64 * c, h, q0, b, &full[0]);
        load(0, t_lo, W::KB + W::VB);
        for (int i = 1; i < S - 1 && t_lo + i < t_hi; ++i) load(i, t_lo + i, 0);
    }

    float acc[NCM][32];
#pragma unroll
    for (int n = 0; n < NCM; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
    const int n_lo = pside ? 0 : NC0, nc = pside ? NC0 : NCM;   // dQ parts
    const int ksteps = pside ? DH / 16 : DV / 16;
    const uint32_t uQ = smem_u32(sQ), uO = smem_u32(sO), uS0 = smem_u32(sS0);
    const float scale_log2 = a.scale * LOG2E;
    // the first product's A (the CTA's Q or dO rows) in registers
    constexpr int KSM = (DH > DV ? DH : DV) / 16;
    uint32_t af[KSM][4];
    for (int t = t_lo; t < t_hi; ++t) {
        const int u = t - t_lo;
        mb_wait(&full[u % S], (u / S) & 1);        // tile t landed
        __syncthreads();                           // tile t - 1 is done
        if (issuer && t + S - 1 < t_hi) load((u + S - 1) % S, t + S - 1, 0);
        const int kt0 = k_begin + t * WR;
        const uint32_t uK = uS0 + (u % S) * (W::KB + W::VB), uV = uK + W::KB;
        // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
        float s[32];
        {
            const uint32_t ua = pside ? uQ : uO, ub = pside ? uK : uV;
            if (t == t_lo) {
#pragma unroll
                for (int kk = 0; kk < KSM; ++kk)
                    if (kk < ksteps) ldsm_a(af[kk], ua, WR, warp, kk, lane);
            }
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < KSM; ++kk)
                if (kk < ksteps) wgmma_rs<0>(s, af[kk], desc_k(ub + kstep(kk)), kk > 0);
            wg_commit();
            wg_wait<0>();
            reg_fence(s);
        }
        uint32_t da[4][4];
        if (pside) {
            if (LIM ? rows == WR && kt0 + WR - 1 < k_end && kt0 + WR - 1 < lim_lo
                    : all_live(kt0, qpos_lo, rows, k_end, a.window)) {
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    s[i] = ex2(fmaf(s[i], scale_log2, -L[(i & 3) >> 1]));
            } else {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int r = (i & 3) >> 1;
                    const int qi = q0 + 16 * warp + g + 8 * r;
                    const int kp = kt0 + 8 * (i >> 2) + c2 + (i & 1);
                    const bool ok = qi < a.Sq &&
                        (LIM ? kp < k_end && kp < lim_q[r] : live(kp, a.q_offset + qi, k_end, a.window));
                    s[i] = ok ? ex2(fmaf(s[i], scale_log2, -L[r])) : 0.f;
                }
            }
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
                a_frag(da[kc], s, kc);
#pragma unroll
                for (int r = 0; r < 4; ++r) sP[(kc * 4 + r) * 128 + t128] = da[kc][r];
            }
            bar_arrive(1, 256);
            if (NC0 > 0) {
                bar_sync(2, 256);                  // dS is in sDS
#pragma unroll
                for (int kc = 0; kc < 4; ++kc)
#pragma unroll
                    for (int r = 0; r < 4; ++r) da[kc][r] = sDS[(kc * 4 + r) * 128 + t128];
            }
        } else {
            bar_sync(1, 256);                      // P is in sP
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        &sP[(kc * 4 + r) * 128 + t128]));
                    const int i = 8 * kc + 2 * r, rr = (i & 3) >> 1;
                    da[kc][r] = pack_bf16x2(p.x * (s[i] - Dl[rr]), p.y * (s[i + 1] - Dl[rr]));
                    if (NC0 > 0) sDS[(kc * 4 + r) * 128 + t128] = da[kc][r];
                }
            }
            if (NC0 > 0) bar_arrive(2, 256);
        }
        // dQ += dS K over this warpgroup's parts
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
#pragma unroll
            for (int n = 0; n < NCM; ++n)
                if (n < nc)
                    wgmma_rs<1>(acc[n], da[kc],
                                desc_mn(uK + (n_lo + n) * (WR * 128) + kc * 2048, WR * 128));
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int n = 0; n < NCM; ++n) reg_fence(acc[n]);
    }
    float* pp = a.dq_splits > 1
        ? a.dq_part + (int64_t)sp * a.B * a.Sq * a.H * DH : nullptr;
#pragma unroll
    for (int n = 0; n < NCM; ++n) {
        if (n >= nc) break;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            const int qi = q0 + 16 * warp + g + 8 * ((i & 3) >> 1);
            const int col = 64 * (n_lo + n) + 8 * (i >> 2) + c2;
            if (qi >= a.Sq || col >= DH) continue;
            const int64_t at = (((int64_t)b * a.Sq + qi) * a.H + h) * DH + col;
            const float x = acc[n][i] * a.scale, y = acc[n][i + 1] * a.scale;
            if (pp)
                *reinterpret_cast<float2*>(pp + at) = make_float2(x, y);
            else
                *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dq) + at) =
                    __floats2bfloat162_rn(x, y);
        }
    }
}

// dQ = the sum of the key splits' parts, in split order
__global__ void __launch_bounds__(NT) dq_reduce_kernel(const Args a, int DH) {
    const int64_t n = (int64_t)a.B * a.Sq * a.H * DH;
    for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * NT) {
        float s = 0.f;
        for (int p = 0; p < a.dq_splits; ++p) s += a.dq_part[p * n + i];
        static_cast<bf16*>(a.dq)[i] = __float2bfloat16(s);
    }
}

template <typename K, typename... P>
cudaError_t go(K kern, dim3 grid, int threads, size_t smem, cudaStream_t s, P... p) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, threads, smem, s>>>(p...);
    return cudaGetLastError();
}

// D and l2 as fp32 [Sq, B * H, 2] (rows sq_pad apart) in boxes of 64 x 1 x 2
bool ld_map(CUtensorMap* m, const Args& a) {
    auto enc = tensor_map_encoder();
    if (!enc) return false;
    cuuint64_t dims[3] = {(cuuint64_t)a.Sq, (cuuint64_t)a.B * a.H, 2};
    cuuint64_t strides[2] = {(cuuint64_t)a.sq_pad * 4, (cuuint64_t)a.B * a.H * a.sq_pad * 4};
    cuuint32_t box[3] = {64, 1, 2}, estr[3] = {1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.delta, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

int grid_stride_blocks(int64_t n) {
    const int64_t b = (n + NT - 1) / NT;
    return (int)(b < 132 * 16 ? b : 132 * 16);
}

template <typename T, int DH, int DV>
cudaError_t reduce(const Args& a, cudaStream_t s) {
    const int64_t n = (int64_t)a.B * a.Sk * a.KV * (DH + DV);
    dkv_reduce_kernel<T, DH, DV><<<grid_stride_blocks(n), NT, 0, s>>>(a);
    return cudaGetLastError();
}

template <int DH, int DV, bool LIM>
cudaError_t run(int dtype, const Args& a, cudaStream_t s) {
    const dim3 dgrid((a.B * a.Sq * a.H + 3) / 4);
    cudaError_t err;
    if (dtype == 0) {
        delta_kernel<float, DV><<<dgrid, NT, 0, s>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        constexpr size_t sm_kv = sizeof(float) *
            ((size_t)FROWS * (DH + DV) + FC * (DH + 4) + FC * (DV + 4) + 2 * FC);
        err = go(dkv_fp32_kernel<DH, DV, LIM>, dim3((a.Sk + FROWS - 1) / FROWS, a.H, a.B),
                 NT, sm_kv, s, a);
        if (err == cudaSuccess && a.part) err = reduce<float, DH, DV>(a, s);
        if (err != cudaSuccess) return err;
        constexpr size_t sm_q = sizeof(float) *
            ((size_t)FROWS * (DH + DV) + FC * (DH + 4) + FC * (DV + 4));
        return go(dq_fp32_kernel<DH, DV, LIM>, dim3((a.Sq + FROWS - 1) / FROWS, a.H, a.B),
                  NT, sm_q, s, a);
    }
    using W = Wg<DH, DV>;
    // bf16: the dQ kernel computes D and l2 (no delta pass) and runs first
    Maps m;
    const int kl = a.k_lim > 0 ? a.k_lim : 1;
    auto encode = [&]() {
        return tile_map(&m.q, a.q, DH, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb) &&
               tile_map(&m.k, a.k, DH, a.KV, kl, a.B, a.k_sh, a.k_ss, a.k_sb) &&
               tile_map(&m.v, a.v, DV, a.KV, kl, a.B, a.v_sh, a.v_ss, a.v_sb) &&
               tile_map(&m.o, a.dout, DV, a.H, a.Sq, a.B, DV, (int64_t)a.H * DV,
                        (int64_t)a.Sq * a.H * DV) &&
               ld_map(&m.ld, a);
    };
    // the driver's encoder needs the context current on this thread, which
    // a thread of autograd's may not have yet: cudaFree(0) binds it
    if (!encode() && (cudaFree(nullptr) != cudaSuccess || !encode()))
        return cudaErrorInvalidValue;
    err = go(dq_wg_kernel<DH, DV, LIM>, dim3(a.B * a.H * a.dq_splits, (a.Sq + WR - 1) / WR),
             256, W::SMEM_Q, s, a, m);
    if (err == cudaSuccess && a.dq_splits > 1) {
        dq_reduce_kernel<<<grid_stride_blocks((int64_t)a.B * a.Sq * a.H * DH), NT, 0, s>>>(
            a, DH);
        err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
    err = go(dkv_wg_kernel<DH, DV, LIM>, dim3(a.B * a.KV * a.kv_parts, (a.Sk + WR - 1) / WR),
             256, W::SMEM_KV, s, a, m);
    if (err == cudaSuccess && a.part) err = reduce<bf16, DH, DV>(a, s);
    return err;
}

// the LIM instantiation where the call has a key limit
template <int DH, int DV>
cudaError_t by_limit(int dtype, const Args& a, cudaStream_t s) {
    return a.lim ? run<DH, DV, true>(dtype, a, s) : run<DH, DV, false>(dtype, a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B, Sq, H, dh], k [B, Sk, KV, dh] and
// v [B, Sk, KV, dv] through their strides (last axis contiguous, rows on 16
// bytes), as the forward read them; o and dout contiguous [B, Sq, H, dv];
// lse the forward's fp32 [B, H, Sq]; key_limit the forward's int32 [Sq] or
// null (q_offset 0 and window <= 0 with one); delta fp32 scratch [2, B, H, sq_pad]
// with sq_pad = Sq rounded up to a multiple of 4; dq,
// dk [B, Sk, KV, dh] and dv [B, Sk, KV, dv] contiguous, of dtype, every
// element written (a key no query sees gets 0). kv_parts (dividing H / KV)
// and dq_splits are the wrapper's plan (flash_prefill.bwd_plan): where
// kv_parts > 1, part is fp32 scratch of kv_parts * B * Sk * KV * (dh + dv)
// (else null); where dq_splits > 1, dq_part is fp32 scratch of dq_splits *
// B * Sq * H * dh (else null). fp32 takes kv_parts = H / KV and dq_splits =
// 1. Launches the delta pass, the dK/dV kernel, the sum of dK/dV's parts
// where kv_parts > 1, the dQ kernel and the sum of dQ's splits where
// dq_splits > 1 on `stream`; returns the first cudaError_t (0 on success).
extern "C" int flash_prefill_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* key_limit, void* delta, void* part, void* dq_part, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int dh, int dv_,
    int kv_parts, int dq_splits,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int q_offset, int kv_len, int window, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
        (dtype != 0 && dtype != 1) || kv_parts <= 0 || dq_splits <= 0)
        return cudaErrorInvalidValue;
    if ((kv_parts > 1) != (part != nullptr) || (dq_splits > 1) != (dq_part != nullptr))
        return cudaErrorInvalidValue;
    if (dtype == 0 && (kv_parts != H / KV || dq_splits != 1))
        return cudaErrorInvalidValue;
    if (key_limit && (q_offset != 0 || window > 0)) return cudaErrorInvalidValue;
    float* dl = static_cast<float*>(delta);
    const int sq_pad = (Sq + 3) / 4 * 4;
    Args a{q, k, v, o, dout, static_cast<const float*>(lse),
           static_cast<const int*>(key_limit), dl,
           dl + (int64_t)B * H * sq_pad, dq, dk, dv, static_cast<float*>(part),
           static_cast<float*>(dq_part), B, Sq, Sk, H, KV, H / KV, kv_parts, dq_splits, sq_pad,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           q_offset, kv_len < Sk ? kv_len : Sk, window, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh == dv_) {
        switch (dh) {
            case 32: return by_limit<32, 32>(dtype, a, s);
            case 64: return by_limit<64, 64>(dtype, a, s);
            case 128: return by_limit<128, 128>(dtype, a, s);
            case 256: return by_limit<256, 256>(dtype, a, s);
        }
    }
    if (dh == 192 && dv_ == 128) return by_limit<192, 128>(dtype, a, s);
    return cudaErrorInvalidValue;
}


extern "C" const char* flash_prefill_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
