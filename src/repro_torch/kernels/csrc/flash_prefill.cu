// Causal GQA flash-attention prefill with prefix resume, for Hopper (sm_90a).
// The value width DV may differ from the key width DH: MLA's prefill attends
// with (DH, DV) = (192, 128), keys [k_nope; k_rope] against v_dim values.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (body _kernel :32, pallas_call :115). Sq suffix queries sit at absolute
// positions q_offset.. and attend to a KV cache that already holds the
// downloaded prefix. A key at kpos is live for the query at qpos when
//   kpos <= qpos  &&  kpos < kv_len  &&  (window <= 0 || kpos > qpos - window).
// The softmax runs online in fp32 (m, l, acc); a row with no live key gives 0.
// The cache is read in place through the strides it is given.
//
// A key limit (int32 lim[Sq], non-decreasing, at most kv_len; q_offset 0 and
// no window, as the wrapper checks) replaces the causal rule: the key at kpos
// is live for query row i when kpos < lim[i] && kpos < kv_len. It is the
// reference's training mask for a VLM batch whose temporal positions repeat
// (image patches at one index see each other). Each kernel takes it as a
// template flag (LIM), so the null instantiation is the code without it.
// Since lim is non-decreasing, a query tile's keys end at min(kv_len,
// lim[last row]); a chunk of keys from k0 is dead for rows i..j when k0 >=
// lim[j] and live for all of them when k0 + n - 1 < lim[i]; only chunks
// between pay for the per-element test kpos < lim[row].
//
// bf16: flash_prefill_tc_kernel, FlashAttention-2 form on the tensor cores.
// What bounds it: at the card's peak rates the path's shapes are bound by
// bytes. deepseek-v3's (192, 128) with H = KV = 128 and Sq = 512 moves ~84
// MB of q/k/v/out (0.025 ms at 3.35 TB/s) for 10.8 GFLOP (0.011 ms at 989
// TFLOP/s); gemma3-270m's (256, 256), H = 4, KV = 1 moves 2.6 MB for 0.54
// GFLOP. In practice (192, 128) is held by the K/V tiles each query tile
// re-reads from L2 (~190 MB in all) and by the shared-memory reads of
// ldmatrix, 16 rows a warp; gemma3-270m runs only 32 CTAs of 64 rows, one
// warp per scheduler, and is bound by the latency of each tile's chain of
// loads, products and softmax. What the design does:
//  - Products on tensor cores: mma.sync m16n8k16 bf16 -> fp32 for S = QK^T
//    and O += PV. A CTA is 4 warps, each owning 16 rows (64 rows a CTA).
//    P goes from the S accumulators straight into PV's A operand, rounded to
//    bf16 in registers; the online softmax (m, l) stays fp32 per row, reduced
//    over the 4 lanes that share a row, on exp2 with the scale folded into
//    one FFMA. l is summed per lane and reduced once at the end.
//  - K and V tiles of 64 keys go through two-stage rings in shared memory,
//    in bf16, by 16-byte cp.async.cg, a thread walking one 16-byte column
//    down the rows (async_copy.cuh). As in FlashAttention-2, K(t+1) is
//    issued before QK(t) and V(t+1) before PV(t), each behind the wait for
//    its own tile, so no load burst waits on the other. Fragments are read
//    with ldmatrix (ldmatrix.trans for V); rows are padded by 16 bytes, so
//    the 8 row addresses of each 8x8 matrix fall in 8 distinct bank groups.
//    Q is staged once; for DH <= 192 its fragments stay in registers, for
//    DH = 256 they are re-read from shared memory and a warp computes each
//    64-key tile as two 32-key chunks, which keeps S within the registers
//    that O (128 a thread) leaves: no spills.
//  - GQA packing: where rep = H / KV > 1 a CTA takes hp heads (4, 2 or 1,
//    dividing rep) that share a kv head as extra rows, 64 / hp queries each,
//    so each K/V tile is loaded once for all of them (gemma3-270m: 16
//    queries x 4 heads). A warp's 16 rows are 16 consecutive queries of one
//    head. The grid is (ceil(Sq / (64 / hp)), H / hp, B), as the
//    wrapper's grid_plan gives it; query tiles run longest first.
//  - Masking: tiles wholly above the diagonal or before the window are never
//    loaded; a warp skips the products of a chunk that is dead for all its
//    rows; only a chunk that crosses a mask edge for the warp pays for
//    per-element masking.
// mma.sync rather than wgmma + TMA is this design's choice: it is the
// simpler form, and it is not enough. The kernel stays above 2x its bound
// at both path shapes (measured in chip_smoke.py, see PERF.md): 16-row warps
// read every K/V fragment from shared memory once per 16 rows, and each
// query tile fetches its K/V tiles again. The warp-specialised form is the
// next step: wgmma on 64-row warpgroup tiles with B read from shared memory
// once per warpgroup, and TMA loads multicast to the CTAs of a cluster that
// share a head's K/V.
//
// fp32: flash_prefill_kernel, scalar fp32 FMAs (the tensor cores take no
// fp32 input at the 1e-5 tolerance: TF32 keeps ~3 digits). One CTA of 4
// warps per (16-query tile, head, batch); each warp owns 4 query rows, a
// lane owns dims lane + 32 i of each row's accumulator. The CTA walks 32-key
// tiles of K and V staged in shared memory (widened to fp32; each thread
// keeps up to 16 independent 16-byte loads in flight) from the window's
// start to min(kv_len, last query position + 1). For QK^T a lane takes one
// key of the tile (K rows padded by 4 floats, so float4 reads are free of
// bank conflicts) against the warp's 4 query rows (broadcast reads); for PV
// the probabilities are shuffled across the warp and V is read along dv by
// consecutive lanes. GQA: kv head = h / (H / KV).
//
// Both kernels can also write each row's log-sum-exp, lse = m + log(l) of the
// scaled scores (natural log; +inf for a row with no live key), to an fp32
// [B, H, Sq] buffer: the backward (flash_prefill_bwd.cu) recomputes P from
// it. Serving passes a null pointer and writes nothing more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BQ = 16;                 // query rows per CTA
constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;      // query rows per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 16 bytes (4 floats) into dst (16-byte aligned)
__device__ __forceinline__ void widen(const uint4& raw, float* dst, float) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}

__device__ __forceinline__ uint4 load16(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

template <int DH, int DV>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(BQ * DH + BK * (DH + 4) + BK * DV);
}

// the largest divisor of n that is at most 16: loads kept in flight at once
__host__ __device__ constexpr int group_of(int n) {
    for (int g = 16; g > 1; --g)
        if (n % g == 0) return g;
    return 1;
}

template <typename T, int DH, int DV, bool LIM>
__global__ void __launch_bounds__(NWARPS * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ lim,
                     int Sq, int Sk, int H, int rep,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int q_offset, int kv_len, int window, float scale) {
    constexpr int NI = DV / 32;        // accumulator dims per lane
    constexpr int KSTR = DH + 4;       // padded K row, in floats
    constexpr int NT = NWARPS * 32;    // threads
    constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte load
    constexpr int NKV = BK * DH / VEC;              // K vectors per tile
    constexpr int NVT = (NKV + BK * DV / VEC) / NT; // K+V loads per thread
    constexpr int GRP = group_of(NVT);              // loads in flight at once
    static_assert(NKV % NT == 0 && (BK * DV / VEC) % NT == 0, "tile split");
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][DH]
    float* sK = sQ + BQ * DH;                      // [BK][KSTR]
    float* sV = sK + BK * KSTR;                    // [BK][DV]

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = qt * BQ;
    const int q_rows = min(BQ, Sq - q0);

    // 16-byte loads: the wrapper checks that rows and strides are aligned
    const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
#pragma unroll
    for (int i = tid * VEC; i < BQ * DH; i += NT * VEC) {
        const int r = i / DH, d = i % DH;
        const uint4 raw = r < q_rows ? load16(qb + (int64_t)(q0 + r) * q_ss + d)
                                     : make_uint4(0u, 0u, 0u, 0u);
        widen(raw, sQ + i, T());
    }

    float m[ROWS], l[ROWS], acc[ROWS][NI];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    }

    // live key range of this CTA's queries
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + q0 + q_rows - 1;
    const int k_end = min(min(kv_len, LIM ? lim[q0 + q_rows - 1] : qpos_hi + 1), Sk);
    int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
    k_begin = (k_begin / BK) * BK;
    int lim_r[ROWS];                   // the warp's rows' limits (LIM)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int qi = q0 + warp * ROWS + r;
        lim_r[r] = LIM && qi < Sq ? lim[qi] : 0;
    }

    const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
    const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
        __syncthreads();               // the previous tile is consumed
        // GRP independent 16-byte loads in flight per thread (the K tile's
        // vectors first, then V's; whether a slot is K or V is known at
        // compile time), then widen to fp32 into shared memory
#pragma unroll
        for (int g = 0; g < NVT; g += GRP) {
            uint4 raw[GRP];
#pragma unroll
            for (int u = 0; u < GRP; ++u) {
                const int e = tid + (g + u) * NT;
                const bool is_k = (g + u) * NT < NKV;
                const int x = (is_k ? e : e - NKV) * VEC;
                const int w = is_k ? DH : DV;
                const int kp = k0 + x / w, d = x % w;
                raw[u] = kp >= k_end ? make_uint4(0u, 0u, 0u, 0u)
                         : is_k ? load16(kb + (int64_t)kp * k_ss + d)
                                : load16(vb + (int64_t)kp * v_ss + d);
            }
#pragma unroll
            for (int u = 0; u < GRP; ++u) {
                const int e = tid + (g + u) * NT;
                if ((g + u) * NT < NKV) {
                    const int x = e * VEC;
                    widen(raw[u], sK + (x / DH) * KSTR + x % DH, T());
                } else {
                    const int x = (e - NKV) * VEC;
                    widen(raw[u], sV + x, T());
                }
            }
        }
        __syncthreads();

        // scores: this lane's key against the warp's rows
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
        const float4* krow = reinterpret_cast<const float4*>(sK + lane * KSTR);
        const float4* qrow = reinterpret_cast<const float4*>(sQ + warp * ROWS * DH);
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
            const float4 kk = krow[d4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float4 qq = qrow[r * (DH / 4) + d4];
                s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
            }
        }

        // online softmax; s[r] becomes this lane's probability
        const int kp = k0 + lane;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int qpos = q_offset + q0 + warp * ROWS + r;
            const bool live = kp < k_end && (LIM ? kp < lim_r[r] : kp <= qpos) &&
                              (window <= 0 || kp > qpos - window);
            const float sc = live ? s[r] * scale : -INFINITY;
            const float m_new = fmaxf(m[r], warp_max(sc));
            const float p = live ? expf(sc - m_new) : 0.f;
            const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
            l[r] = l[r] * alpha + warp_sum(p);
            m[r] = m_new;
#pragma unroll
            for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
            s[r] = p;
        }

        // acc += P V
#pragma unroll 2
        for (int j = 0; j < BK; ++j) {
            float vv[NI];
#pragma unroll
            for (int i = 0; i < NI; ++i) vv[i] = sV[j * DV + lane + 32 * i];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
                for (int i = 0; i < NI; ++i) acc[r][i] += pj * vv[i];
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int qi = q0 + warp * ROWS + r;
        if (qi >= Sq) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
        T* o = out + (((int64_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
        for (int i = 0; i < NI; ++i) store(o + lane + 32 * i, acc[r][i] * inv);
        if (lse != nullptr && lane == 0)
            lse[((int64_t)b * H + h) * Sq + qi] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = TC_WARPS * 16;  // rows per CTA: 16 per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH, int DV>
struct Tc {
    static constexpr int BN = 64;                    // keys a tile
    // keys a warp takes at once: 32 for DH = 256, where O already takes 128
    // registers a thread and 64 keys of S would spill
    static constexpr int BC = DH >= 256 ? 32 : 64;
    static constexpr bool Q_IN_REGS = DH <= 192;     // else re-read from smem
    static constexpr int QST = DH + 8;               // padded rows, in bf16
    static constexpr int KST = DH + 8;
    static constexpr int VST = DV + 8;
    static constexpr size_t SMEM = sizeof(__nv_bfloat16) *
        (size_t)(TC_ROWS * QST + 2 * BN * (KST + VST));
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layouts of m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A regs 0..3: (row g, cols c..c+1), (g+8, c), (g, c+8), (g+8, c+8)
//   B regs 0..1: (k c..c+1, col g), (k c+8.., col g)
//   C/D 0..3:    (row g, cols c, c+1), (row g+8, cols c, c+1)
// CTA row r is query q0 + r % qb of head h_first + r / qb (qb = 64 / hp);
// warp w owns rows 16 w .. 16 w + 15.
template <int DH, int DV, bool LIM>
__global__ void __launch_bounds__(TC_WARPS * 32, 1)
flash_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, const int* __restrict__ lim,
                        int Sq, int Sk, int H, int rep, int hp,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int q_offset, int kv_len, int window, float scale_log2) {
    using Tr = Tc<DH, DV>;
    constexpr int BN = Tr::BN, QST = Tr::QST, KST = Tr::KST, VST = Tr::VST;
    constexpr int NT = TC_WARPS * 32;
    constexpr int NKD = DH / 16;       // k-steps of QK^T
    constexpr int BC = Tr::BC;
    constexpr int NSN = BC / 8;        // n-tiles of S
    constexpr int NKC = BC / 16;       // k-steps of PV
    constexpr int NON = DV / 8;        // n-tiles of O
    static_assert(DH % 16 == 0 && DV % 16 == 0 && BN % BC == 0 && BC % 16 == 0,
                  "tile shapes");
    extern __shared__ uint4 smem_tc[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [64][QST]
    __nv_bfloat16* sK = sQ + TC_ROWS * QST;                 // [2][BN][KST]
    __nv_bfloat16* sV = sK + 2 * BN * KST;                  // [2][BN][VST]

    const int qb = TC_ROWS / hp;                  // queries per CTA
    const int qt = gridDim.x - 1 - blockIdx.x;    // longest query tiles first
    const int h_first = blockIdx.y * hp, b = blockIdx.z;
    const int kvh = h_first / rep;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int q0 = qt * qb;

    // the CTA's live key range
    const int qpos_lo = q_offset + q0;
    const int qpos_hi = q_offset + min(q0 + qb, Sq) - 1;
    const int k_end = min(min(kv_len, LIM ? lim[min(q0 + qb, Sq) - 1] : qpos_hi + 1), Sk);
    int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
    k_begin = (k_begin / BN) * BN;
    const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

    // this warp's 16 rows: queries wq0 .. wq0 + 15 of head wh
    const int wq0 = q0 + (warp * 16) % qb;
    const int wh = h_first + (warp * 16) / qb;
    const bool w_live = wq0 < Sq;
    const int wpos_lo = q_offset + wq0;
    const int wpos_hi = q_offset + min(wq0 + 15, Sq - 1);
    // LIM: keys below lim_lo are live for all the warp's rows, keys from
    // lim_hi on for none; lim_g[i] is row g + 8 i's own (0 past Sq)
    const int lim_lo = LIM && w_live ? lim[wq0] : 0;
    const int lim_hi = LIM && w_live ? lim[min(wq0 + 15, Sq - 1)] : 0;
    int lim_g[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
        lim_g[i] = LIM && wq0 + g + 8 * i < Sq ? lim[wq0 + g + 8 * i] : 0;

    const __nv_bfloat16* qbase = q + (int64_t)b * q_sb;
    const __nv_bfloat16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
    const __nv_bfloat16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

    // Q tile, rows past Sq zero-filled (group 0)
    for (int c = tid; c < TC_ROWS * (DH / 8); c += NT) {
        const int r = c / (DH / 8), d = (c % (DH / 8)) * 8;
        const int qi = q0 + r % qb, hh = h_first + r / qb;
        const bool ok = qi < Sq;
        cp_async16(sQ + r * QST + d,
                   ok ? qbase + (int64_t)qi * q_ss + (int64_t)hh * q_sh + d : qbase, ok);
    }
    cp_async_commit();

    // K or V of tile t into stage t & 1; keys past k_end zero-filled, so
    // that p = 0 never meets an uninitialised value
    auto load_k = [&](int t) {
        const int k0 = k_begin + t * BN;
        load_rows<__nv_bfloat16, NT, BN, DH, KST>(
            sK + (t & 1) * BN * KST, kb + (int64_t)k0 * k_ss, k_ss, k_end - k0, tid);
    };
    auto load_v = [&](int t) {
        const int k0 = k_begin + t * BN;
        load_rows<__nv_bfloat16, NT, BN, DV, VST>(
            sV + (t & 1) * BN * VST, vb + (int64_t)k0 * v_ss, v_ss, k_end - k0, tid);
    };
    // commit groups, in order: Q, K0, V0, then K(t+1) (issued before
    // QK(t)) and V(t+1) (issued before PV(t)) in tile t
    if (ntiles > 0) load_k(0);
    cp_async_commit();
    if (ntiles > 0) load_v(0);
    cp_async_commit();

    float o[NON][4];
#pragma unroll
    for (int n = 0; n < NON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t qf[Tr::Q_IN_REGS ? NKD : 1][4];

    // ldmatrix row addresses of this lane (see the fragment layouts above)
    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int kb_row = (lane & 7) + ((lane >> 4) << 3), kb_col = ((lane >> 3) & 1) * 8;
    const int vb_row = lane & 15, vb_col = (lane >> 4) * 8;

    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<1>();            // Q and K(t) have landed (V(t) may not)
        __syncthreads();               // ... for all threads; every warp is
                                       // done with tile t - 1's K and V
        if (t + 1 < ntiles) load_k(t + 1);
        cp_async_commit();
        if (Tr::Q_IN_REGS && t == 0) {
#pragma unroll
            for (int kk = 0; kk < (Tr::Q_IN_REGS ? NKD : 0); ++kk)
                ldsm_x4(qf[kk], sQ + a_row * QST + kk * 16 + a_col);
        }
#pragma unroll
        for (int c = 0; c < BN / BC; ++c) {       // compute chunks of the tile
            const int k0 = k_begin + t * BN + c * BC;
            const bool dead = !w_live || (LIM ? k0 >= lim_hi : k0 > wpos_hi) || k0 >= k_end ||
                              (window > 0 && k0 + BC - 1 <= wpos_lo - window);
            float s[NSN][4];
            float alpha[2];
            if (!dead) {
                const __nv_bfloat16* tK = sK + ((t & 1) * BN + c * BC) * KST;
#pragma unroll
                for (int n = 0; n < NSN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
                for (int kk = 0; kk < NKD; ++kk) {
                    uint32_t a[4];
                    if (Tr::Q_IN_REGS) {
#pragma unroll
                        for (int i = 0; i < 4; ++i) a[i] = qf[Tr::Q_IN_REGS ? kk : 0][i];
                    } else {
                        ldsm_x4(a, sQ + a_row * QST + kk * 16 + a_col);
                    }
#pragma unroll
                    for (int jp = 0; jp < NSN / 2; ++jp) {
                        uint32_t bk[4];
                        ldsm_x4(bk, tK + (16 * jp + kb_row) * KST + kk * 16 + kb_col);
                        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
                        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
                    }
                }

                // mask only a tile that crosses an edge for this warp
                const bool full = (LIM ? k0 + BC <= lim_lo : k0 + BC - 1 <= wpos_lo) &&
                                  k0 + BC <= k_end &&
                                  (window <= 0 || k0 > wpos_hi - window);
                if (!full) {
#pragma unroll
                    for (int n = 0; n < NSN; ++n) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int kp = k0 + 8 * n + c2 + (e & 1);
                            const int qp = wpos_lo + g + (e >> 1) * 8;
                            const bool live = kp < k_end &&
                                              (LIM ? kp < lim_g[e >> 1] : kp <= qp) &&
                                              (window <= 0 || kp > qp - window);
                            if (!live) s[n][e] = -INFINITY;
                        }
                    }
                }
                // online softmax in the log2 domain: the scale > 0 keeps the
                // order of the raw scores, so it is folded into one FFMA
                float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
                for (int n = 0; n < NSN; ++n) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
                    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
                    const float m_use = m_new == -INFINITY ? 0.f : m_new;
                    alpha[i] = exp2f(m[i] - m_use);
                    m[i] = m_new;
                    mx[i] = m_use;
                }
                float rs[2] = {0.f, 0.f};
#pragma unroll
                for (int n = 0; n < NSN; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = exp2f(fmaf(s[n][e], scale_log2, -mx[e >> 1]));
                        s[n][e] = p;
                        rs[e >> 1] += p;
                    }
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
            }

            if (c == 0) {
                cp_async_wait<1>();        // V(t) has landed
                __syncthreads();           // ... for all threads
                if (t + 1 < ntiles) load_v(t + 1);
                cp_async_commit();
            }
            if (!dead) {
                const __nv_bfloat16* tV = sV + ((t & 1) * BN + c * BC) * VST;
#pragma unroll
                for (int n = 0; n < NON; ++n) {
                    o[n][0] *= alpha[0];
                    o[n][1] *= alpha[0];
                    o[n][2] *= alpha[1];
                    o[n][3] *= alpha[1];
                }

                // O += P V, P straight from the S accumulators
#pragma unroll
                for (int kc = 0; kc < NKC; ++kc) {
                    const uint32_t pa[4] = {
                        pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                        pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                        pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                        pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
                    for (int dp = 0; dp < NON / 2; ++dp) {
                        uint32_t bv[4];
                        ldsm_x4_trans(bv, tV + (kc * 16 + vb_row) * VST + dp * 16 + vb_col);
                        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
                        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = wq0 + g + 8 * i;
        if (!w_live || qi >= Sq) continue;
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        if (lse != nullptr && (lane & 3) == 0)   // m is in the log2 domain
            lse[((int64_t)b * H + wh) * Sq + qi] =
                l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : INFINITY;
        __nv_bfloat16* orow = out + (((int64_t)b * Sq + qi) * H + wh) * DV + c2;
#pragma unroll
        for (int n = 0; n < NON; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
                __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
}

template <typename T, int DH, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* lim, int B, int Sq, int Sk, int H, int KV,
                   const int64_t* st, int q_offset, int kv_len, int window,
                   float scale, cudaStream_t stream) {
    auto kern = lim ? flash_prefill_kernel<T, DH, DV, true>
                    : flash_prefill_kernel<T, DH, DV, false>;
    constexpr size_t smem = smem_bytes<DH, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, NWARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, lim, Sq, Sk, H, H / KV,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        q_offset, kv_len, window, scale);
    return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* lim, int B, int Sq, int Sk, int H, int KV,
                      int hp, const int64_t* st, int q_offset, int kv_len, int window,
                      float scale, cudaStream_t stream) {
    auto kern = lim ? flash_prefill_tc_kernel<DH, DV, true>
                    : flash_prefill_tc_kernel<DH, DV, false>;
    constexpr size_t smem = Tc<DH, DV>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int qb = TC_ROWS / hp;
    dim3 grid((Sq + qb - 1) / qb, H / hp, B);
    kern<<<grid, TC_WARPS * 32, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, lim, Sq, Sk, H, H / KV, hp,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        q_offset, kv_len, window, scale * LOG2E);
    return cudaGetLastError();
}

// one instantiation per (DH, DV) of WIDTHS: bf16 on the tensor cores, fp32
// on the scalar kernel
template <int DH, int DV>
cudaError_t by_dtype(int dtype, const void* q, const void* k, const void* v,
                     void* out, float* lse, const int* lim, int B, int Sq, int Sk, int H,
                     int KV, int hp, const int64_t* st, int q_offset, int kv_len,
                     int window, float scale, cudaStream_t s) {
    if (dtype == 0 && hp == 1)
        return launch<float, DH, DV>(q, k, v, out, lse, lim, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
    if (dtype == 1)
        return launch_tc<DH, DV>(q, k, v, out, lse, lim, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last axis
// of q, k and v must be contiguous and rows must start on 16 bytes. q and k
// are dh wide, v dv wide; out is a contiguous [B, Sq, H, dv]; lse, when not
// null, a contiguous fp32 [B, H, Sq] that takes each row's log-sum-exp (the
// backward's input; serving passes null); key_limit, when not null, a
// contiguous int32 [Sq] (see the top; q_offset 0, window <= 0). hp is the
// number of query heads a CTA packs (the wrapper's grid_plan): 1 for
// float32; for bfloat16 4, 2 or 1, dividing H / KV. Returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const int* key_limit, int dtype, int B, int Sq, int Sk, int H, int KV, int dh, int dv, int hp,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int q_offset, int kv_len, int window, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV || hp <= 0 ||
        hp > 4 || (H / KV) % hp || (key_limit && (q_offset != 0 || window > 0)))
        return cudaErrorInvalidValue;
    const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    if (dh == dv) {
        switch (dh) {
            case 32: return by_dtype<32, 32>(dtype, q, k, v, out, lse, key_limit, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
            case 64: return by_dtype<64, 64>(dtype, q, k, v, out, lse, key_limit, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
            case 128: return by_dtype<128, 128>(dtype, q, k, v, out, lse, key_limit, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
            case 256: return by_dtype<256, 256>(dtype, q, k, v, out, lse, key_limit, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
        }
    }
    if (dh == 192 && dv == 128)        // MLA: [k_nope; k_rope] against v
        return by_dtype<192, 128>(dtype, q, k, v, out, lse, key_limit, B, Sq, Sk, H, KV, hp, st, q_offset, kv_len, window, scale, s);
    return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
