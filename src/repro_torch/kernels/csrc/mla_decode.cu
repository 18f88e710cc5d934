// MLA absorbed decode for Hopper (sm_90a): every query head's latent query
// against one latent cache that all heads share, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/mla_decode.py::mla_decode_kernel
// (:25), which runs flash_decode's pallas_call (:89) on q = [q_lat; q_rope],
// k = [ckv; krope] with one kv head and v = ckv. For each (b, h):
//   o[b,h,:] = softmax_s((q_lat[b,h]·ckv[b,s] + q_rope[b,h]·krope[b,s]) * scale)
//              · ckv[b,s,:]
// over keys kv_start <= s < kv_end (the wrapper turns kv_len and the window
// into that range), with an online fp32 softmax; the output is in q's dtype
// and a row with no live key gives 0.
//
// What bounds it on this card: bytes on paper, latency in practice.
// deepseek-v3 decodes 128 heads against a cache row of 576 values (R = 512
// latent + Dr = 64 rotary), ~0.5 flop per byte over the call. The floor is
// the cache, the queries and the output over 3.35 TB/s (~0.2 us at 300 keys
// in bf16); the kernel takes 0.0116 ms there on an H100 80GB HBM3 at 700 W
// (PERF.md), made of a few serial steps: the cluster's set-up, the first
// tile's copies, each tile's products and softmax, the partials' stores and
// arrival, and the last CTA's merge (rounds of L2 reads). The design:
//  - One launch. The keys are cut into splits (mla_decode.py::split_plan);
//    each split is one thread-block cluster of up to 8 CTAs, one CTA per 16
//    heads (one m16 tile), so a cluster covers 128 heads.
//  - The latent cache is read once: each tile of [ckv; krope] goes through a
//    two-stage ring in shared memory, filled by bulk copies (cp.async.bulk,
//    one per row part) that every CTA of the cluster issues for its share of
//    the rows and multicasts to all of them, completing on each CTA's
//    mbarrier; the CTA's queries come by bulk copy on the first tile's
//    barrier. A cluster barrier frees a stage before the tile two ahead
//    goes into it.
//  - bf16: 64-key tiles, the products on the tensor cores, mma.sync m16n8k16
//    bf16 -> fp32, 8 warps. Scores: warp w takes keys 8w..8w+7 of the tile
//    against the CTA's 16 heads over the 576 dims (four accumulator chains).
//    The online softmax (log2 domain, scale folded into one multiply)
//    reduces over the warps through shared memory; P goes to shared memory
//    in bf16 and P·ckv runs with warp w owning latent dims [w R/8, (w+1)
//    R/8): 32 fp32 accumulators a thread at R = 512, no spills.
//  - fp32 keeps scalar FMAs (the tensor cores take no fp32 input at the
//    1e-5 tolerance) on 32-key tiles: for the scores warp w takes 4 heads
//    against 16 keys, a lane pair one key; for P·ckv warp w owns R/8 latent
//    dims of all 16 heads, with P read as broadcasts. Its tiles are bound by
//    the shared-memory pipe, several times a bf16 tile, so it takes more
//    splits.
//  - Each CTA of a split writes its partial (m, l, acc) and counts its
//    arrival on a per-(b, head group) counter with one acq_rel atomic; the
//    last CTA of the group merges the splits (the first batch of
//    accumulators in flight while every split's weight forms) and resets
//    the counter to 0. With one split the CTA writes the output directly.
// ckv and krope are read in place through their own pointers and strides
// (views of the [L, B, S, .] cache), with no concatenation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HG = 16;                 // heads per CTA: one m16 tile
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;        // threads
constexpr int STAGES = 2;
constexpr int MAX_SPLITS = 64;         // splits the merge's scratch holds
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// every thread of every CTA of the cluster; orders shared memory cluster-wide
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(shared_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(shared_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile("{\n.reg .pred P1;\nLAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
                 "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
                 :: "r"(shared_u32(bar)), "r"(parity) : "memory");
}

// `bytes` of global memory into this CTA's shared memory or, multicast, to
// the same offset in every CTA of `mask`, each completing on its own mbarrier
// at bar's offset
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask, bool multicast) {
    if (multicast)
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                     ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
                     :: "r"(shared_u32(dst)), "l"(src), "r"(bytes),
                        "r"(shared_u32(bar)), "h"(mask) : "memory");
    else
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                     " [%0], [%1], %2, [%3];\n"
                     :: "r"(shared_u32(dst)), "l"(src), "r"(bytes),
                        "r"(shared_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(shared_u32(p)));
}

template <typename T, int R, int DR>
struct Layout {
    static constexpr int W = R + DR;                 // a key row: latent then rotary
    static constexpr bool TC = std::is_same<T, bf16>::value;
    // keys per tile: bf16, one 8-key n-tile of the scores per warp; fp32,
    // one key per lane
    static constexpr int BK = TC ? 8 * NWARPS : 32;
    static constexpr int PST = BK + 8;               // padded row of bf16 P
    // padded rows: an odd number of 16-byte units, so the 8 row addresses
    // of an ldmatrix (bf16) or the float4 reads of 8 lanes (fp32) meet 8
    // distinct bank groups
    static constexpr int KST = TC ? W + 8 : W + 4;
    static constexpr int QST = TC ? KST : W;
    static constexpr size_t STAGE = sizeof(T) * (size_t)BK * KST;
    static constexpr size_t SMEM = STAGES * STAGE + sizeof(T) * (size_t)HG * QST
                                 + (TC ? sizeof(bf16) * (size_t)HG * PST : 0);
    static_assert(STAGES * STAGE >= 2 * sizeof(float) * HG * MAX_SPLITS, "merge scratch");
    static_assert(R % 32 == 0 && W % 16 == 0 && (DR * sizeof(T)) % 16 == 0, "widths");
};

struct Args {
    const void *q_lat, *q_rope, *ckv, *krope;
    void* out;
    float *pm, *pl, *pacc;
    int* counters;
    int H, nsplit, chunk, kv_start, kv_end, csize;
    int64_t ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_ss, r_sb, r_ss;
    float scale_log2;
};

// Tile rows [k0, k0 + rows) of [ckv; krope] into `stage` of every CTA of the
// cluster: this CTA issues the row parts q = 2 row + part with q = rank mod
// csize, and arms its own barrier for the whole tile (and extra_bytes more
// that this CTA copies on the same barrier).
template <typename T, int R, int DR>
__device__ __forceinline__ void issue_tile(const Args& a, T* stage, uint64_t* bar,
                                           const T* cb, const T* rb, int k0, int rows,
                                           int rank, uint32_t extra_bytes = 0) {
    constexpr int KST = Layout<T, R, DR>::KST;
    if (threadIdx.x == 0)
        mbar_expect(bar, (uint32_t)(rows * (R + DR) * sizeof(T)) + extra_bytes);
    if (threadIdx.x < 32) {
        const uint16_t mask = (uint16_t)((1u << a.csize) - 1u);
        for (int q = rank + a.csize * (int)threadIdx.x; q < 2 * rows; q += 32 * a.csize) {
            const int r = q >> 1;
            if (q & 1)
                bulk_copy(stage + r * KST + R, rb + (int64_t)(k0 + r) * a.r_ss,
                          DR * sizeof(T), bar, mask, a.csize > 1);
            else
                bulk_copy(stage + r * KST, cb + (int64_t)(k0 + r) * a.c_ss,
                          R * sizeof(T), bar, mask, a.csize > 1);
        }
    }
}

// splits s0 .. s0 + U - 1 of the accumulators (the last split repeated past
// nsplit) at this thread's G outputs
template <int R, int G, int U>
__device__ __forceinline__ void load_partials(const Args& a, int64_t row0, int s0,
                                              const int (&rr)[G], const int (&dd)[G],
                                              float4 (&v)[G][U]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int s = min(s0 + u, a.nsplit - 1);
            v[g][u] = __ldcg(reinterpret_cast<const float4*>(
                a.pacc + ((row0 + rr[g]) * a.nsplit + s) * R + dd[g]));
        }
}

// The last CTA of a head group: out[row0 + r] = sum_s w_s acc_s / sum_s w_s l_s,
// w_s = 2^(m_s - M), for its `rows` heads. A thread streams G float4
// outputs, four splits a batch; the first batch is in flight while every
// split's m and l (one round of loads) form the weights.
// scratch is free shared memory of 2 HG nsplit floats.
template <typename T, int R>
__device__ void merge_splits(const Args& a, int64_t row0, int rows, float* scratch) {
    __shared__ float s_inv[HG];
    const int ns = a.nsplit, tid = threadIdx.x;
    constexpr int NO = R / 4, G = (HG * NO + NT - 1) / NT, U = 4;
    const int n_out = rows * NO;
    int rr[G], dd[G];
    float4 acc[G], xs[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const int idx = min(tid + g * NT, n_out - 1);
        rr[g] = idx / NO;
        dd[g] = (idx % NO) * 4;
        acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    load_partials<R, G, U>(a, row0, 0, rr, dd, xs);   // in flight while the weights form
    float* sm = scratch;                   // [rows][ns] m, then the weights
    float* sl = scratch + HG * ns;         // [rows][ns] l
    for (int i = tid; i < rows * ns; i += NT) {
        sm[i] = __ldcg(a.pm + row0 * ns + i);
        sl[i] = __ldcg(a.pl + row0 * ns + i);
    }
    __syncthreads();
    if (tid < rows) {
        float M = -INFINITY;
        for (int s = 0; s < ns; ++s) M = fmaxf(M, sm[tid * ns + s]);
        const float mu = M == -INFINITY ? 0.f : M;
        float Ls = 0.f;
        for (int s = 0; s < ns; ++s) {
            const float w = exp2f(sm[tid * ns + s] - mu);   // 0 for an empty split
            sm[tid * ns + s] = w;
            Ls += w * sl[tid * ns + s];
        }
        s_inv[tid] = Ls > 0.f ? 1.f / Ls : 0.f;
    }
    __syncthreads();
    for (int s0 = 0; s0 < ns; s0 += U) {
        if (s0 > 0) load_partials<R, G, U>(a, row0, s0, rr, dd, xs);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const float w = s0 + u < ns ? sm[rr[g] * ns + s0 + u] : 0.f;
                acc[g].x += w * xs[g][u].x;
                acc[g].y += w * xs[g][u].y;
                acc[g].z += w * xs[g][u].z;
                acc[g].w += w * xs[g][u].w;
            }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (tid + g * NT >= n_out) break;
        const float inv = s_inv[rr[g]];
        T* o = (T*)a.out + (row0 + rr[g]) * R + dd[g];
        store(o, acc[g].x * inv);
        store(o + 1, acc[g].y * inv);
        store(o + 2, acc[g].z * inv);
        store(o + 3, acc[g].w * inv);
    }
}

// Tile t of the split, once its copies have landed; on the split's last
// tile the rows past its end (nk of BK live) are zeroed, so that P = 0
// never meets stale values.
template <typename T, int R, int DR>
__device__ __forceinline__ T* wait_tile(T* sK, uint64_t* full, int t, int nk) {
    constexpr int KST = Layout<T, R, DR>::KST, BK = Layout<T, R, DR>::BK;
    T* tK = sK + (t & 1) * BK * KST;
    mbar_wait(&full[t & 1], (t >> 1) & 1);
    if (nk < BK) {
        uint4* z = reinterpret_cast<uint4*>(tK + nk * KST);
        const int n16 = (int)((BK - nk) * KST * sizeof(T) / 16);
        for (int e = threadIdx.x; e < n16; e += NT) z[e] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();
    }
    return tK;
}

// After tile t, if a tile two ahead remains: the cluster barrier frees the
// stage in every CTA, and that tile goes into it.
template <typename T, int R, int DR>
__device__ __forceinline__ void next_tile(const Args& a, T* sK, uint64_t* full, int t,
                                          int ntiles, int j0, int j1, const T* cb,
                                          const T* rb, int rank) {
    constexpr int KST = Layout<T, R, DR>::KST, BK = Layout<T, R, DR>::BK;
    const int tn = t + STAGES;
    if (tn >= ntiles) return;
    cluster_sync();
    issue_tile<T, R, DR>(a, sK + (t & 1) * BK * KST, &full[t & 1], cb, rb,
                         j0 + tn * BK, min(BK, j1 - j0 - tn * BK), rank);
}

// grid (head groups, rounded up to the cluster size; key splits; batch),
// cluster (csize, 1, 1). partials: pm, pl [B, H, nsplit] (log2 domain);
// pacc [B, H, nsplit, R]; counters [B, gridDim.x] (0 between launches)
template <typename T, int R, int DR>
__global__ void __launch_bounds__(NT) mla_decode_kernel(const Args a) {
    using L = Layout<T, R, DR>;
    constexpr int W = R + DR, KST = L::KST, QST = L::QST, BK = L::BK, PST = L::PST;
    extern __shared__ uint4 smem4[];
    T* sK = reinterpret_cast<T*>(smem4);                 // [STAGES][BK][KST]
    T* sQ = sK + STAGES * BK * KST;                      // [HG][QST]
    bf16* sP = reinterpret_cast<bf16*>(sQ + HG * QST);   // [HG][PST] (bf16 only)
    __shared__ __align__(8) uint64_t full[STAGES];
    __shared__ float s_red[NWARPS][HG];
    __shared__ float s_alpha[HG];                        // fp32: each head's rescale
    __shared__ __align__(16) float s_pf[L::TC ? 1 : L::BK * HG];     // fp32: P [BK][HG]
    __shared__ int s_last;

    const int h0 = blockIdx.x * HG, split = blockIdx.y, b = blockIdx.z;
    const int rows = max(0, min(HG, a.H - h0));          // live heads of this CTA
    const int rank = (int)cluster_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j0 = a.kv_start + split * a.chunk;
    const int j1 = min(j0 + a.chunk, a.kv_end);
    const int ntiles = j1 > j0 ? (j1 - j0 + BK - 1) / BK : 0;
    const T* cb = (const T*)a.ckv + b * a.c_sb;
    const T* rb = (const T*)a.krope + b * a.r_sb;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();        // every CTA's barriers exist before any copy lands
    // tiles 0 and 1; this CTA's queries [q_lat; q_rope] (its live heads) by
    // bulk copies on tile 0's barrier; the rows past H are zeroed here
    const uint32_t q_bytes = ntiles > 0 ? (uint32_t)(rows * W * sizeof(T)) : 0u;
    for (int t = 0; t < min(ntiles, STAGES); ++t)
        issue_tile<T, R, DR>(a, sK + t * BK * KST, &full[t], cb, rb, j0 + t * BK,
                             min(BK, j1 - j0 - t * BK), rank, t == 0 ? q_bytes : 0u);
    if (q_bytes && warp == 1) {
        for (int q = lane; q < 2 * rows; q += 32) {
            const int r = q >> 1, h = h0 + r;
            if (q & 1)
                bulk_copy(sQ + r * QST + R,
                          (const T*)a.q_rope + b * a.qr_sb + (int64_t)h * a.qr_sh,
                          DR * sizeof(T), &full[0], 0, false);
            else
                bulk_copy(sQ + r * QST,
                          (const T*)a.q_lat + b * a.ql_sb + (int64_t)h * a.ql_sh,
                          R * sizeof(T), &full[0], 0, false);
        }
    }
    {
        uint4* z = reinterpret_cast<uint4*>(sQ + rows * QST);
        const int n16 = (int)((HG - rows) * QST * sizeof(T) / 16);
        for (int e = tid; e < n16; e += NT) z[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    const int64_t row0 = (int64_t)b * a.H + h0;    // this CTA's first (b, h)
    T* out = (T*)a.out;
    if constexpr (L::TC) {
        // P ckv: PVW warps, each R / PVW latent dims (NR n-tiles of 8)
        constexpr int PVW = R / 8 < NWARPS ? R / 8 : NWARPS;
        constexpr int NR = R / PVW / 8;
        constexpr int NKD = W / 16;                 // k-steps of the scores
        const int g = lane >> 2, c2 = 2 * (lane & 3);
        const bool pv = warp < PVW;
        const int rd0 = warp * (R / PVW);           // this warp's latent dims
        float m[2] = {-INFINITY, -INFINITY}, lw[2] = {0.f, 0.f};
        float acc[NR][4];
#pragma unroll
        for (int n = 0; n < NR; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

        for (int t = 0; t < ntiles; ++t) {
            const int nk = min(BK, j1 - j0 - t * BK);
            const T* tK = wait_tile<T, R, DR>(sK, full, t, nk);
            if (rows == 0) {
                next_tile<T, R, DR>(a, sK, full, t, ntiles, j0, j1, cb, rb, rank);
                continue;
            }
            // scores of keys 8 warp .. 8 warp + 7 against the 16 heads
            // four accumulator chains, one per k-step mod 4
            float sa[4][4];
#pragma unroll
            for (int c = 0; c < 4; ++c) sa[c][0] = sa[c][1] = sa[c][2] = sa[c][3] = 0.f;
            const T* qa = sQ + (lane & 15) * QST + (lane >> 4) * 8;
            const T* kb = tK + (warp * 8 + (lane & 7)) * KST + (lane >> 3) * 8;
#pragma unroll
            for (int kk = 0; kk + 1 < NKD; kk += 2) {
                uint32_t q0[4], q1[4], kf[4];
                ldsm_x4(q0, qa + kk * 16);
                ldsm_x4(q1, qa + kk * 16 + 16);
                ldsm_x4(kf, kb + kk * 16);          // k-steps kk and kk + 1
                mma_bf16(sa[kk & 3], q0, kf[0], kf[1]);
                mma_bf16(sa[(kk + 1) & 3], q1, kf[2], kf[3]);
            }
            if (NKD & 1) {
                uint32_t q0[4], k0r, k1r;
                ldsm_x4(q0, qa + (NKD - 1) * 16);
                ldsm_x2(k0r, k1r, tK + (warp * 8 + (lane & 7)) * KST + (NKD - 1) * 16
                                  + ((lane >> 3) & 1) * 8);
                mma_bf16(sa[(NKD - 1) & 3], q0, k0r, k1r);
            }
            // online softmax: x = score * scale * log2 e; dead keys -inf
            const int key = warp * 8 + c2;
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                x[e] = key + (e & 1) < nk
                    ? ((sa[0][e] + sa[1][e]) + (sa[2][e] + sa[3][e])) * a.scale_log2 : -INFINITY;
            float mx0 = fmaxf(x[0], x[1]), mx1 = fmaxf(x[2], x[3]);
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
                mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
            }
            if ((lane & 3) == 0) {
                s_red[warp][g] = mx0;
                s_red[warp][g + 8] = mx1;
            }
            __syncthreads();
            float t0 = s_red[0][g], t1 = s_red[0][g + 8];
#pragma unroll
            for (int w = 1; w < NWARPS; ++w) {
                t0 = fmaxf(t0, s_red[w][g]);
                t1 = fmaxf(t1, s_red[w][g + 8]);
            }
            const float mn0 = fmaxf(m[0], t0), mn1 = fmaxf(m[1], t1);
            const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
            const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
            const float al0 = exp2f(m[0] - mu0), al1 = exp2f(m[1] - mu1);
            m[0] = mn0;
            m[1] = mn1;
            const float p0 = exp2f(x[0] - mu0), p1 = exp2f(x[1] - mu0);
            const float p2 = exp2f(x[2] - mu1), p3 = exp2f(x[3] - mu1);
            lw[0] = lw[0] * al0 + (p0 + p1);
            lw[1] = lw[1] * al1 + (p2 + p3);
            *reinterpret_cast<uint32_t*>(sP + g * PST + key) =
                bf16x2_bits(__floats2bfloat162_rn(p0, p1));
            *reinterpret_cast<uint32_t*>(sP + (g + 8) * PST + key) =
                bf16x2_bits(__floats2bfloat162_rn(p2, p3));
            __syncthreads();
            // acc = acc * alpha + P ckv over this warp's latent dims
            if (pv) {
#pragma unroll
                for (int n = 0; n < NR; ++n) {
                    acc[n][0] *= al0; acc[n][1] *= al0;
                    acc[n][2] *= al1; acc[n][3] *= al1;
                }
#pragma unroll
                for (int ks = 0; ks < BK / 16; ++ks) {
                    uint32_t pa[4];
                    ldsm_x4(pa, sP + (lane & 15) * PST + ks * 16 + (lane >> 4) * 8);
#pragma unroll
                    for (int np = 0; np < (NR + 1) / 2; ++np) {
                        uint32_t v[4];
                        ldsm_x4_trans(v, tK + (ks * 16 + (lane & 15)) * KST + rd0 + np * 16
                                         + (lane >> 4) * 8);
                        mma_bf16(acc[2 * np], pa, v[0], v[1]);
                        if (2 * np + 1 < NR) mma_bf16(acc[2 * np + 1], pa, v[2], v[3]);
                    }
                }
            }
            next_tile<T, R, DR>(a, sK, full, t, ntiles, j0, j1, cb, rb, rank);
        }

        // l of each head: the lanes of a row, then the warps
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            lw[0] += __shfl_xor_sync(FULL, lw[0], o);
            lw[1] += __shfl_xor_sync(FULL, lw[1], o);
        }
        if ((lane & 3) == 0) {
            s_red[warp][g] = lw[0];
            s_red[warp][g + 8] = lw[1];
        }
        __syncthreads();
        if (rows == 0) return;
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
            l0 += s_red[w][g];
            l1 += s_red[w][g + 8];
        }
        if (!pv && a.nsplit == 1) return;
        if (a.nsplit == 1) {
            const float i0 = l0 > 0.f ? 1.f / l0 : 0.f, i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
            for (int n = 0; n < NR; ++n) {
                const int d = rd0 + n * 8 + c2;
                if (g < rows)
                    *reinterpret_cast<uint32_t*>(out + (row0 + g) * R + d) =
                        bf16x2_bits(__floats2bfloat162_rn(acc[n][0] * i0, acc[n][1] * i0));
                if (g + 8 < rows)
                    *reinterpret_cast<uint32_t*>(out + (row0 + g + 8) * R + d) =
                        bf16x2_bits(__floats2bfloat162_rn(acc[n][2] * i1, acc[n][3] * i1));
            }
            return;
        }
#pragma unroll
        for (int n = 0; n < NR; ++n) {
            if (!pv) break;
            const int d = rd0 + n * 8 + c2;
            if (g < rows)
                *reinterpret_cast<float2*>(a.pacc + ((row0 + g) * a.nsplit + split) * R + d) =
                    make_float2(acc[n][0], acc[n][1]);
            if (g + 8 < rows)
                *reinterpret_cast<float2*>(a.pacc + ((row0 + g + 8) * a.nsplit + split) * R + d) =
                    make_float2(acc[n][2], acc[n][3]);
        }
        if (warp == 0 && (lane & 3) == 0) {
            if (g < rows) {
                a.pm[(row0 + g) * a.nsplit + split] = m[0];
                a.pl[(row0 + g) * a.nsplit + split] = l0;
            }
            if (g + 8 < rows) {
                a.pm[(row0 + g + 8) * a.nsplit + split] = m[1];
                a.pl[(row0 + g + 8) * a.nsplit + split] = l1;
            }
        }
    } else {
        // scores: warp w takes heads 4 (w % 4) .. + 3 against keys 16 (w / 4)
        // .. + 15; lane l takes key l % 16 over the 16-byte chunks of parity
        // l / 16, and the two halves add up
        const int hb = 4 * (warp & 3), kh = warp >> 2;
        const int key = 16 * kh + (lane & 15), half = lane >> 4;
        // P ckv: warp w owns PVD latent dims, DPL a lane (lanes >= PVD idle)
        constexpr int PVD = R / NWARPS, DPL = PVD >= 32 ? PVD / 32 : 1;
        const int dl = warp * PVD + lane * DPL;
        const bool pv = lane * DPL < PVD;
        float m[4], l[4], acc[HG][DPL];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            m[r] = -INFINITY;
            l[r] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < HG; ++h)
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[h][i] = 0.f;
        float* sPf = reinterpret_cast<float*>(s_pf);   // [BK][HG] probabilities

        for (int t = 0; t < ntiles; ++t) {
            const int nk = min(BK, j1 - j0 - t * BK);
            const T* tK = wait_tile<T, R, DR>(sK, full, t, nk);
            if (rows == 0) {
                next_tile<T, R, DR>(a, sK, full, t, ntiles, j0, j1, cb, rb, rank);
                continue;
            }
            float s[4] = {0.f, 0.f, 0.f, 0.f};
            const float4* krow = reinterpret_cast<const float4*>(tK + key * KST) + half;
            const float4* qrow = reinterpret_cast<const float4*>(sQ + hb * QST) + half;
#pragma unroll 4
            for (int i = 0; i < W / 8; ++i) {
                const float4 kk = krow[2 * i];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float4 qq = qrow[r * (QST / 4) + 2 * i];
                    s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
                }
            }
            // online softmax in the log2 domain over both key halves
            const bool live = key < nk;
            float x[4], mx[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                s[r] += __shfl_xor_sync(FULL, s[r], 16);
                x[r] = live ? s[r] * a.scale_log2 : -INFINITY;
                mx[r] = x[r];
#pragma unroll
                for (int o = 8; o > 0; o >>= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], o));
            }
            if (lane == 0)
#pragma unroll
                for (int r = 0; r < 4; ++r) s_red[kh][hb + r] = mx[r];
            __syncthreads();
            float ps[4], al[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float m_new = fmaxf(m[r], fmaxf(s_red[0][hb + r], s_red[1][hb + r]));
                const float mu = m_new == -INFINITY ? 0.f : m_new;
                const float p = live ? exp2f(x[r] - mu) : 0.f;
                al[r] = exp2f(m[r] - mu);
                m[r] = m_new;
                if (half == 0) sPf[key * HG + hb + r] = p;
                ps[r] = half == 0 ? p : 0.f;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) ps[r] += __shfl_xor_sync(FULL, ps[r], o);
            }
            if (lane == 0)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    s_red[2 + kh][hb + r] = ps[r];
                    if (kh == 0) s_alpha[hb + r] = al[r];
                }
            __syncthreads();
#pragma unroll
            for (int r = 0; r < 4; ++r)
                l[r] = l[r] * al[r] + (s_red[2][hb + r] + s_red[3][hb + r]);
            // acc = acc * alpha + P ckv over this lane's latent dims
            if (pv) {
#pragma unroll
                for (int h = 0; h < HG; ++h) {
                    const float ah = s_alpha[h];
#pragma unroll
                    for (int i = 0; i < DPL; ++i) acc[h][i] *= ah;
                }
#pragma unroll 2
                for (int j = 0; j < BK; ++j) {
                    float vv[DPL];
#pragma unroll
                    for (int i = 0; i < DPL; ++i) vv[i] = tK[j * KST + dl + i];
                    const float4* pj = reinterpret_cast<const float4*>(sPf + j * HG);
#pragma unroll
                    for (int h4 = 0; h4 < HG / 4; ++h4) {
                        const float4 p4 = pj[h4];
#pragma unroll
                        for (int i = 0; i < DPL; ++i) {
                            acc[4 * h4][i] += p4.x * vv[i];
                            acc[4 * h4 + 1][i] += p4.y * vv[i];
                            acc[4 * h4 + 2][i] += p4.z * vv[i];
                            acc[4 * h4 + 3][i] += p4.w * vv[i];
                        }
                    }
                }
            }
            next_tile<T, R, DR>(a, sK, full, t, ntiles, j0, j1, cb, rb, rank);
        }

        if (rows == 0) return;
        // each head's (m, l), from the warps of key half 0, to every thread
        if (kh == 0 && lane == 0)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                s_red[0][hb + r] = m[r];
                s_red[1][hb + r] = l[r];
            }
        __syncthreads();
        if (pv) {
#pragma unroll
            for (int h = 0; h < HG; ++h) {
                if (h >= rows) break;
                if (a.nsplit == 1) {
                    const float lh = s_red[1][h], inv = lh > 0.f ? 1.f / lh : 0.f;
#pragma unroll
                    for (int i = 0; i < DPL; ++i) store(out + (row0 + h) * R + dl + i, acc[h][i] * inv);
                } else {
                    float* pa = a.pacc + ((row0 + h) * a.nsplit + split) * R + dl;
#pragma unroll
                    for (int i = 0; i < DPL; ++i) pa[i] = acc[h][i];
                }
            }
        }
        if (a.nsplit == 1) return;
        if (tid < rows) {
            a.pm[(row0 + tid) * a.nsplit + split] = s_red[0][tid];
            a.pl[(row0 + tid) * a.nsplit + split] = s_red[1][tid];
        }
    }

    // arrival: the last CTA of this (b, head group) merges the splits. The
    // barrier orders the CTA's partial stores before thread 0's release; its
    // acquire makes the other CTAs' partials visible to the merge.
    __syncthreads();
    int* counter = a.counters + (int64_t)b * gridDim.x + blockIdx.x;
    if (tid == 0) {
        int prev;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(prev) : "l"(counter) : "memory");
        s_last = prev == a.nsplit - 1;
    }
    __syncthreads();
    if (!s_last) return;
    merge_splits<T, R>(a, row0, rows, reinterpret_cast<float*>(sK));
    if (tid == 0) *counter = 0;        // ready for the next launch
}

template <typename T, int R, int DR>
cudaError_t launch(const Args& a, int B, int groups, cudaStream_t stream) {
    auto kern = mla_decode_kernel<T, R, DR>;
    constexpr size_t smem = Layout<T, R, DR>::SMEM;
    static bool ready = false;         // the shared-memory opt-in, once
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(groups, a.nsplit, B);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int R, int Dr, const Args& a, int B, int groups, cudaStream_t s) {
    if (R == 512 && Dr == 64) return launch<T, 512, 64>(a, B, groups, s);   // deepseek-v3
    if (R == 64 && Dr == 16) return launch<T, 64, 16>(a, B, groups, s);     // the reference
    if (R == 128 && Dr == 32) return launch<T, 128, 32>(a, B, groups, s);   // kernel tests'
    if (R == 32 && Dr == 16) return launch<T, 32, 16>(a, B, groups, s);     // widths
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q_lat is [B, H, R], q_rope [B, H, Dr],
// ckv [B, S, R], krope [B, S, Dr], each with a contiguous last axis and
// 16-byte aligned rows (strides in elements: q_lat (sb, sh), q_rope (sb, sh),
// ckv (sb, ss), krope (sb, ss)). out is a contiguous [B, H, R]. pm, pl
// ([B, H, nsplit]) and pacc ([B, H, nsplit, R]) are fp32 scratch; counters
// ([B, groups] ints) must be 0 and are left 0. groups (a multiple of csize,
// at least ceil(H / 16)) CTAs of 16 heads form clusters of csize <= 8. Split
// s (of nsplit <= 64) covers keys [kv_start + s * chunk, min(kv_start + (s +
// 1) * chunk, kv_end)), chunk a multiple of the tile (64 keys bf16, 32
// fp32). One launch; returns its cudaError_t (0 on success).
extern "C" int mla_decode_launch(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
    void* out, void* pm, void* pl, void* pacc, void* counters,
    int dtype, int B, int H, int R, int Dr, int groups, int csize, int nsplit,
    int chunk, int kv_start, int kv_end,
    int64_t ql_sb, int64_t ql_sh, int64_t qr_sb, int64_t qr_sh,
    int64_t c_sb, int64_t c_ss, int64_t r_sb, int64_t r_ss,
    float scale, void* stream) {
    if (B <= 0 || H <= 0 || nsplit <= 0 || chunk <= 0 || kv_start < 0 ||
        kv_end < kv_start || csize <= 0 || csize > 8 || groups % csize ||
        nsplit > MAX_SPLITS ||
        groups * HG < H)
        return cudaErrorInvalidValue;
    Args a{q_lat, q_rope, ckv, krope, out, (float*)pm, (float*)pl, (float*)pacc,
           (int*)counters, H, nsplit, chunk, kv_start, kv_end, csize,
           ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_ss, r_sb, r_ss, scale * LOG2E};
    if (dtype == 0) return by_width<float>(R, Dr, a, B, groups, (cudaStream_t)stream);
    if (dtype == 1) return by_width<bf16>(R, Dr, a, B, groups, (cudaStream_t)stream);
    return cudaErrorInvalidValue;
}

extern "C" const char* mla_decode_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
