// Split-KV flash decode for Hopper (sm_90a): one new query token per head
// against a long KV cache, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (body _kernel :22, pallas_call :89). For each (b, h) the query attends to
// keys kpos < kv_len (and kpos > kv_len - 1 - window when a window is set)
// with an online fp32 softmax; a row with no live key gives 0. kv_len is one
// value for every row or, read from device memory, one per row (a batch of
// slots at their own positions: each CTA reads its row's kv_len and window
// start; a split past its row's live keys leaves an empty partial). The value
// width dv may differ from the key width dh and the scale may be overridden,
// as MLA's absorbed decode needs.
//
// What bounds it on this card: at the main path's shape (gemma3-270m: H = 4
// over one kv head of 256, bf16, up to 1024 keys) the bytes are ~1 MB, 0.3
// us at 3.35 TB/s, so the kernel lives on latency: the serial steps of each
// CTA, the number of launches and the merge of the key splits.
// What the design does about it:
//  - One CTA per (key split, head group, batch): HG query heads that share a
//    kv head (up to 4) read each K/V tile once.
//  - Keys come in 32-key tiles through a two-stage ring in shared memory,
//    by 16-byte cp.async loads (one stage where two would not fit: fp32 at
//    576 / 512 wide). The CTA's queries sit in shared memory in fp32.
//  - A tile is cut into 2 parts of 16 keys, each taken by 128 threads (256
//    threads a CTA). Scores: warp r of a part takes head r, and a pair
//    of lanes takes one key, each lane the alternate 16-byte chunks of the
//    row (K rows padded by 32 bytes, so the quarter-warp's reads are free of
//    bank conflicts; the query is a broadcast read). Per part, tile and
//    head that is one warp max and one warp sum, not a shuffle reduction per
//    key. Each part keeps its own (m, l, acc); the parts merge once at the
//    end, through shared memory.
//  - PV along dv: a thread owns 16 bytes of dv of one head and reads V
//    rows as 16-byte vectors, consecutive threads on consecutive chunks.
//  - One launch: each CTA writes its partial (m, l, acc) and counts its
//    arrival on a per-(b, head group) counter with one acq_rel atomic; the
//    last CTA to arrive merges the splits in one pass (m, l and acc of
//    several splits in flight at once, combined online) and resets the
//    counter to 0. With one split the CTA writes the output directly. An
//    empty split (m = -inf, l = 0, acc = 0) weighs 0 in the merge, and a
//    row whose splits are all empty gives 0.
//  - The grid is planned on the host from an upper bound of the rows'
//    kv_len (kv_cap), so the same launch serves every row of a batch.
// The cache is read in place through its strides. m is kept in the log2
// domain (scale folded into log2 e), so the softmax runs on exp2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int HT = 128;                // threads of one key part
constexpr int PARTS = 2;               // key parts of a tile
constexpr int SUB = 16;                // keys a part takes of a tile: two lanes a key
constexpr int TK = PARTS * SUB;        // keys of a tile
constexpr int NT = PARTS * HT;         // threads of a CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_BUDGET = 200 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// 16 bytes of T as fp32: 4 floats or 8 bf16
__device__ __forceinline__ void widen(const uint4& raw, float* f, float) {
    const float4 x = *reinterpret_cast<const float4*>(&raw);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void widen(const uint4& raw, float* f, __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(h[i]);
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
    }
}

// Shared memory: the queries and probabilities (fixed) and a ring of one
// or two stages of K and V rows (two where they fit: all but fp32 at
// 576 / 512 wide). K rows are padded by 32 bytes, so the two lanes of a
// key, reading alternate 16-byte chunks of the row, and the keys of a
// quarter-warp meet 8 distinct bank groups.
template <typename T, int DH, int DV, int HG>
struct Layout {
    static constexpr int VEC = 16 / sizeof(T);       // elements per 16 bytes
    static constexpr int KST = DH + 2 * VEC;         // padded K row
    static constexpr size_t STAGE = sizeof(T) * (size_t)TK * (KST + DV);
    static constexpr size_t FIXED = sizeof(float) * (size_t)HG * (DH + TK);
    static constexpr int STAGES = FIXED + 2 * STAGE <= SMEM_BUDGET ? 2 : 1;
    static constexpr size_t SMEM = FIXED + STAGES * STAGE;
};

// partials: pm, pl [B, H, nsplit]; pacc [B, H, nsplit, DV] (fp32, m in the
// log2 domain); counters [B, H / HG] (int, 0 between launches)
template <typename T, int DH, int DV, int HG>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ pm, float* __restrict__ pl,
                    float* __restrict__ pacc, int* __restrict__ counters,
                    const int* __restrict__ kv_lens,
                    int H, int rep, int nsplit, int chunk,
                    int kv_cap, int window,
                    int64_t q_sb, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    float scale_log2) {
    using L = Layout<T, DH, DV, HG>;
    constexpr int VEC = L::VEC, KST = L::KST, STAGES = L::STAGES;
    constexpr int NCK = DH / VEC / 2;                 // K chunks a lane takes
    constexpr int NCH = DV / VEC;                     // 16-byte chunks of a V row
    constexpr int NIT = (HG * NCH + HT - 1) / HT;     // PV items per thread
    static_assert(DH % (2 * VEC) == 0 && DV % VEC == 0, "16-byte rows");
    static_assert(sizeof(float) * (PARTS - 1) * NIT * HT * VEC <= STAGES * L::STAGE,
                  "the parts' accumulators fit in the ring");
    extern __shared__ uint4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);      // [HG][DH]
    float* sP = sQ + HG * DH;                         // [PARTS][HG][SUB]
    T* sK = reinterpret_cast<T*>(sP + PARTS * HG * SUB);   // [STAGES][TK][KST]
    T* sV = sK + STAGES * TK * KST;                   // [STAGES][TK][DV]
    __shared__ float s_alpha[PARTS][HG], s_m[PARTS][HG], s_l[PARTS][HG];
    __shared__ int s_last;

    const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
    const int kvh = h0 / rep;
    const int tid = threadIdx.x, lane = tid & 31;
    const int part = tid / HT, htid = tid % HT, hwarp = htid >> 5;

    // this row's live keys [kv_start, kv_end): kv_len from device memory
    // (never past kv_cap, which the grid covers) or kv_cap for every row
    const int kv_end = kv_lens ? min(max(__ldg(kv_lens + b), 0), kv_cap) : kv_cap;
    const int kv_start = window > 0 ? max(0, kv_end - window) : 0;
    const int j0 = kv_start + split * chunk;
    const int j1 = min(j0 + chunk, kv_end);
    const int ntiles = j1 > j0 ? (j1 - j0 + TK - 1) / TK : 0;
    const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
    const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

    // K and V rows of tile t into stage st; keys past j1 zero-filled
    auto load_tile = [&](int t, int st) {
        const int k0 = j0 + t * TK;
        load_rows<T, NT, TK, DH, KST>(sK + st * TK * KST, kb + (int64_t)k0 * k_ss,
                                      k_ss, j1 - k0, tid);
        load_rows<T, NT, TK, DV, DV>(sV + st * TK * DV, vb + (int64_t)k0 * v_ss,
                                     v_ss, j1 - k0, tid);
    };
    if (ntiles > 0) load_tile(0, 0);
    cp_async_commit();
    for (int i = tid; i < HG * DH; i += NT)     // while the tile is in flight
        sQ[i] = to_f(q[(int64_t)b * q_sb + (int64_t)(h0 + i / DH) * q_sh + i % DH]);

    // warp hwarp < HG of each part: head hwarp's running (m, l) over the
    // part's keys; every thread: acc of its NIT runs of 16 bytes of dv
    float m = -INFINITY, l = 0.f;
    float acc[NIT][VEC];
#pragma unroll
    for (int i = 0; i < NIT; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        const int st = STAGES == 2 ? (t & 1) : 0;
        if (STAGES == 2) {
            if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = j0 + t * TK + part * SUB;      // this part's keys
        const int nk = max(0, min(SUB, j1 - k0));
        const T* tK = sK + (st * TK + part * SUB) * KST;
        const T* tV = sV + (st * TK + part * SUB) * DV;
        float* hP = sP + part * HG * SUB;

        // scores: warp r = head r; lanes 2j and 2j+1 take key j, each the
        // alternate 16-byte chunks of its row, and add their halves
        if (hwarp < HG) {
            const int key = lane >> 1, odd = lane & 1;
            float s = -INFINITY;
            if (key < nk) {
                const uint4* kr = reinterpret_cast<const uint4*>(tK + key * KST);
                const float4* qr = reinterpret_cast<const float4*>(sQ + hwarp * DH);
                float d4[4] = {0.f, 0.f, 0.f, 0.f};   // independent chains
#pragma unroll 4
                for (int c = 0; c < NCK; ++c) {
                    const int cc = 2 * c + odd;
                    float kf[VEC];
                    widen(kr[cc], kf, T());
#pragma unroll
                    for (int e = 0; e < VEC; e += 4) {
                        const float4 qq = qr[(cc * VEC + e) / 4];
                        d4[0] += qq.x * kf[e];
                        d4[1] += qq.y * kf[e + 1];
                        d4[2] += qq.z * kf[e + 2];
                        d4[3] += qq.w * kf[e + 3];
                    }
                }
                s = (d4[0] + d4[1]) + (d4[2] + d4[3]);
            }
            s = (s + __shfl_xor_sync(FULL, s, 1)) * scale_log2;
            const float m_new = fmaxf(m, warp_max(s));
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = exp2f(m - m_use);
            const float p = exp2f(s - m_use);
            l = l * alpha + warp_sum(odd ? 0.f : p);
            m = m_new;
            if (!odd) hP[hwarp * SUB + key] = p;
            if (lane == 0) s_alpha[part][hwarp] = alpha;
        }
        __syncthreads();

        // acc = acc * alpha + P V: a thread owns 16 bytes of dv of one head
#pragma unroll
        for (int i = 0; i < NIT; ++i) {
            const int it = htid + i * HT;
            if (it >= HG * NCH) break;
            const int r = it / NCH, c = it % NCH;
            const float alpha = s_alpha[part][r];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
#pragma unroll 4
            for (int j = 0; j < nk; ++j) {
                const float p = hP[r * SUB + j];
                float vf[VEC];
                widen(reinterpret_cast<const uint4*>(tV + j * DV)[c], vf, T());
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[i][e] += p * vf[e];
            }
        }
        __syncthreads();               // the stage and sP are free again
        if (STAGES == 1 && t + 1 < ntiles) {
            load_tile(t + 1, 0);
            cp_async_commit();
        }
    }
    cp_async_wait<0>();

    if (hwarp < HG && lane == 0) {
        s_m[part][hwarp] = m;
        s_l[part][hwarp] = l;
    }
    __syncthreads();

    // head r's (m, l) over the whole split, and each part's weight in it
    auto head_ml = [&](int r, float& M, float& Lr, float (&w)[PARTS]) {
        M = s_m[0][r];
#pragma unroll
        for (int p = 1; p < PARTS; ++p) M = fmaxf(M, s_m[p][r]);
        const float m_use = M == -INFINITY ? 0.f : M;
        Lr = 0.f;
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
            w[p] = exp2f(s_m[p][r] - m_use);
            Lr += s_l[p][r] * w[p];
        }
    };
    // parts 1.. hand their accumulators to part 0 through the (free) ring
    {
        float* sAcc = reinterpret_cast<float*>(sK);  // [PARTS-1][NIT][HT][VEC]
        if (part > 0) {
#pragma unroll
            for (int i = 0; i < NIT; ++i)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    sAcc[(((part - 1) * NIT + i) * HT + htid) * VEC + e] = acc[i][e];
        }
        __syncthreads();
        if (part == 0) {
#pragma unroll
            for (int i = 0; i < NIT; ++i) {
                const int it = htid + i * HT;
                if (it >= HG * NCH) break;
                float M, Lr, w[PARTS];
                head_ml(it / NCH, M, Lr, w);
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    float x = acc[i][e] * w[0];
#pragma unroll
                    for (int p = 1; p < PARTS; ++p)
                        x += sAcc[(((p - 1) * NIT + i) * HT + htid) * VEC + e] * w[p];
                    acc[i][e] = x;
                }
            }
        }
    }

    const int64_t row0 = (int64_t)b * H + h0;      // this CTA's first (b, h)
    if (nsplit == 1) {                             // no merge: write the output
        if (part != 0) return;
#pragma unroll
        for (int i = 0; i < NIT; ++i) {
            const int it = htid + i * HT;
            if (it >= HG * NCH) break;
            const int r = it / NCH, c = it % NCH;
            float M, Lr, w[PARTS];
            head_ml(r, M, Lr, w);
            const float inv = Lr > 0.f ? 1.f / Lr : 0.f;
            T* o = out + (row0 + r) * DV + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) store(o + e, acc[i][e] * inv);
        }
        return;
    }

    if (part == 0) {
#pragma unroll
        for (int i = 0; i < NIT; ++i) {
            const int it = htid + i * HT;
            if (it >= HG * NCH) break;
            const int r = it / NCH, c = it % NCH;
            float4* pa = reinterpret_cast<float4*>(pacc + ((row0 + r) * nsplit + split) * DV + c * VEC);
#pragma unroll
            for (int e = 0; e < VEC; e += 4)
                pa[e / 4] = make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
        }
        if (htid < HG) {
            float M, Lr, w[PARTS];
            head_ml(htid, M, Lr, w);
            pm[(row0 + htid) * nsplit + split] = M;
            pl[(row0 + htid) * nsplit + split] = Lr;
        }
    }

    // arrival: the last CTA of this (b, head group) merges the splits. The
    // barrier orders the CTA's partial stores before thread 0's release;
    // its acquire makes the other CTAs' partials visible to the merge.
    __syncthreads();
    int* counter = counters + (int64_t)b * gridDim.y + blockIdx.y;
    if (tid == 0) {
        int prev;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(prev) : "l"(counter) : "memory");
        s_last = prev == nsplit - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, merged online:
    // a thread owns NM runs of 4 outputs, and the loads of all of them for
    // UNROLL splits (m, l and a float4 of acc each) are in flight together
    constexpr int N4 = HG * DV / 4;
    constexpr int NM = (N4 + NT - 1) / NT;
    constexpr int UNROLL = NM >= 4 ? 2 : 32 / NM;   // 32 splits a batch
    int rr[NM], dd[NM];
    float4 A[NM];
    float M[NM], Lsum[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
        const int idx = min(tid + i * NT, N4 - 1);
        rr[i] = idx / (DV / 4);
        dd[i] = (idx % (DV / 4)) * 4;
        A[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        M[i] = -INFINITY;
        Lsum[i] = 0.f;
    }
    for (int s0 = 0; s0 < nsplit; s0 += UNROLL) {
        float ms[NM][UNROLL], ls[NM][UNROLL];
        float4 xs[NM][UNROLL];
#pragma unroll
        for (int i = 0; i < NM; ++i) {
            const int64_t row = (row0 + rr[i]) * nsplit;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int s = min(s0 + u, nsplit - 1);
                ms[i][u] = s0 + u < nsplit ? __ldcg(pm + row + s) : -INFINITY;
                ls[i][u] = __ldcg(pl + row + s);
                xs[i][u] = __ldcg(reinterpret_cast<const float4*>(pacc + (row + s) * DV + dd[i]));
            }
        }
#pragma unroll
        for (int i = 0; i < NM; ++i) {
            float mx = M[i];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, ms[i][u]);
            const float m_use = mx == -INFINITY ? 0.f : mx;
            const float a = exp2f(M[i] - m_use);
            A[i].x *= a; A[i].y *= a; A[i].z *= a; A[i].w *= a;
            Lsum[i] *= a;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const float w = exp2f(ms[i][u] - m_use);  // 0 for an empty split
                Lsum[i] += w * ls[i][u];
                A[i].x += w * xs[i][u].x;
                A[i].y += w * xs[i][u].y;
                A[i].z += w * xs[i][u].z;
                A[i].w += w * xs[i][u].w;
            }
            M[i] = mx;
        }
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
        if (N4 % NT != 0 && tid + i * NT >= N4) break;
        const float inv = Lsum[i] > 0.f ? 1.f / Lsum[i] : 0.f;
        T* o = out + (row0 + rr[i]) * DV + dd[i];
        store(o, A[i].x * inv);
        store(o + 1, A[i].y * inv);
        store(o + 2, A[i].z * inv);
        store(o + 3, A[i].w * inv);
    }
    if (tid == 0) *counter = 0;        // ready for the next launch
}

struct Args {
    const void *q, *k, *v;
    void* out;
    float *pm, *pl, *pacc;
    int* counters;
    const int* kv_lens;
    int B, H, KV, hg, nsplit, chunk, kv_cap, window;
    int64_t st[8];
    float scale;
    cudaStream_t stream;
};

template <typename T, int DH, int DV, int HG>
cudaError_t launch(const Args& a) {
    using L = Layout<T, DH, DV, HG>;
    auto kern = flash_decode_kernel<T, DH, DV, HG>;
    constexpr size_t smem = L::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.nsplit, a.H / HG, a.B);
    kern<<<grid, NT, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out,
        a.pm, a.pl, a.pacc, a.counters, a.kv_lens,
        a.H, a.H / a.KV, a.nsplit, a.chunk, a.kv_cap, a.window,
        a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7],
        a.scale * LOG2E);
    return cudaGetLastError();
}

template <typename T, int DH, int DV>
cudaError_t by_group(const Args& a) {
    switch (a.hg) {
        case 1: return launch<T, DH, DV, 1>(a);
        case 2: return launch<T, DH, DV, 2>(a);
        case 4: return launch<T, DH, DV, 4>(a);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t by_width(int dh, int dv, const Args& a) {
    if (dh == dv) {
        switch (dh) {
            case 32: return by_group<T, 32, 32>(a);
            case 64: return by_group<T, 64, 64>(a);
            case 128: return by_group<T, 128, 128>(a);
            case 256: return by_group<T, 256, 256>(a);
        }
    }
    if (dh == 576 && dv == 512) return by_group<T, 576, 512>(a);  // MLA latent
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is [B, H, dh], k [B, Sk, KV, dh],
// v [B, Sk, KV, dv], each with a contiguous last axis (strides in elements;
// k and v rows on 16 bytes). out is a contiguous [B, H, dv]. pm, pl
// ([B, H, nsplit]) and pacc ([B, H, nsplit, dv]) are fp32 scratch;
// counters ([B, H / hg] ints) must be 0 and are left 0. Row b's live keys
// end at kv_end = min(kv_lens[b], kv_cap) when kv_lens (int32 [B] in device
// memory) is given, else at kv_cap, and start at max(0, kv_end - window)
// when window > 0, else at 0. Split s covers keys [kv_start + s * chunk,
// min(kv_start + (s + 1) * chunk, kv_end)), so nsplit * chunk must cover
// min(kv_cap, window). hg query heads (dividing H / KV, at most 4) share a
// CTA.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* out,
    void* pm, void* pl, void* pacc, void* counters, const void* kv_lens,
    int dtype, int B, int H, int KV, int dh, int dv, int hg, int nsplit,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int chunk, int kv_cap, int window, float scale, void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV || hg <= 0 || (H / KV) % hg ||
        nsplit <= 0 || chunk <= 0 || kv_cap < 0)
        return cudaErrorInvalidValue;
    Args a{q, k, v, out, (float*)pm, (float*)pl, (float*)pacc, (int*)counters,
           (const int*)kv_lens, B, H, KV, hg, nsplit, chunk, kv_cap, window,
           {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh},
           scale, (cudaStream_t)stream};
    if (dtype == 0) return by_width<float>(dh, dv, a);
    if (dtype == 1) return by_width<__nv_bfloat16>(dh, dv, a);
    return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
