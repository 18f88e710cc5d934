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
//
// What bounds it on this card: at the main path's shapes (dh = 256, H = 4,
// KV = 1, Sq = 512) the work is ~0.5 GFLOP per layer against ~1 MB of
// q/k/v/out, far above the card's ~20 flop/byte fp32 balance point, so the
// limit is arithmetic. This first version does the products with scalar fp32
// FMAs (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16): it is
// written to be right and simple first.
//
// Design: one CTA of 4 warps per (16-query tile, head, batch). Each warp owns
// 4 query rows; a lane owns dims lane + 32 i of each row's accumulator, so a
// row's acc lives in DV / 32 registers per lane. The CTA walks 32-key tiles
// of K and V staged in shared memory (converted to fp32; each thread keeps up
// to 16 independent 16-byte loads in flight, so a tile costs about one
// memory latency rather than one per element), from the window's
// start to min(kv_len, last query position + 1): tiles wholly above the
// causal diagonal or outside the window are never loaded. For QK^T a lane
// takes one key of the tile (K rows padded by 4 floats, so the float4 reads
// of 8 lanes hit 8 distinct bank groups) against the warp's 4 query rows
// (broadcast reads). For PV the probabilities are shuffled across the warp
// and V is read along dh by consecutive lanes. The cache is read in place
// through the strides it is given: no copy or pad before the launch.
// GQA: kv head = h / (H / KV).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;                 // query rows per CTA
constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;      // query rows per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T (4 floats or 8 bf16) widened to fp32 in dst (16-byte aligned)
__device__ __forceinline__ void widen(const uint4& raw, float* dst, float) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst, __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
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

template <typename T, int DH, int DV>
__global__ void __launch_bounds__(NWARPS * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
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
    const int k_end = min(min(kv_len, qpos_hi + 1), Sk);
    int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
    k_begin = (k_begin / BK) * BK;

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
            const bool live = kp < k_end && kp <= qpos &&
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
    }
}

template <typename T, int DH, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV,
                   const int64_t* st, int q_offset, int kv_len, int window,
                   float scale, cudaStream_t stream) {
    auto kern = flash_prefill_kernel<T, DH, DV>;
    constexpr size_t smem = smem_bytes<DH, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, NWARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, H / KV,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        q_offset, kv_len, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, int dv, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Sk, int H, int KV,
                     const int64_t* st, int q_offset, int kv_len, int window,
                     float scale, cudaStream_t s) {
    if (dh == dv) {
        switch (dh) {
            case 32: return launch<T, 32, 32>(q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
            case 64: return launch<T, 64, 64>(q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
            case 128: return launch<T, 128, 128>(q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
            case 256: return launch<T, 256, 256>(q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
        }
    }
    if (dh == 192 && dv == 128)        // MLA: [k_nope; k_rope] against v
        return launch<T, 192, 128>(q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last axis
// of q, k and v must be contiguous. q and k are dh wide, v dv wide; out is a
// contiguous [B, Sq, H, dv].
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out,
    int dtype, int B, int Sq, int Sk, int H, int KV, int dh, int dv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int q_offset, int kv_len, int window, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV) return cudaErrorInvalidValue;
    const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(dh, dv, q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(dh, dv, q, k, v, out, B, Sq, Sk, H, KV, st, q_offset, kv_len, window, scale, s);
    return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
