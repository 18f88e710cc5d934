// MLA absorbed decode for Hopper (sm_90a): every query head's latent query
// against one latent cache that all heads share.
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
// What bounds it on this card: bytes. deepseek-v3 decodes 128 heads against
// a cache row of 576 values (R = 512 latent + Dr = 64 rotary); each row is
// used by every head, ~2 flops per head per value, so 128 heads make ~0.5
// flop per byte over the whole call: far below the card's balance point.
// The floor is the cache, the queries and the output over 3.35 TB/s (~0.2 us
// at 300 keys in bf16); at that size the launches cost more than the data.
//
// Design. The TPU wrapper concatenates [ckv; krope] over the whole cache on
// every step and runs flash_decode with head groups of at most 4, which
// would re-read the latent cache 32 times for 128 heads. Here ckv and krope
// are read in place through their own pointers and strides (views of the
// [L, B, S, .] cache), and each CTA stages a tile of BK = 32 key rows, both
// parts side by side and widened to fp32, in shared memory once for HG = 16
// heads: the cache is read H / 16 = 8 times, mostly from L2. The keys are
// split across CTAs (grid: key split x head group x batch) so that a long
// cache fills the SMs; each split writes a partial (m, l, acc[R]) per head
// and split_merge.cuh's kernel merges them.
// Inside a CTA, each of the 4 warps owns 4 heads (their queries stay in
// shared memory, read as broadcasts). For the scores a lane takes one key
// of the tile (rows padded by 4 floats, so the float4 reads of 8 lanes hit
// 8 distinct bank groups) against the warp's 4 heads; the online softmax
// reduces across the warp with shuffles; for P·ckv a lane owns latent dims
// lane + 32 i of each head's accumulator, read along the row by consecutive
// lanes. Every product is a scalar fp32 FMA: tensor cores, TMA and wgmma are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int ROWS = 4;                // heads per warp
constexpr int HG = NWARPS * ROWS;      // heads per CTA
constexpr int NT = NWARPS * 32;        // threads
constexpr unsigned FULL = 0xffffffffu;

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

// the largest divisor of n that is at most 16: loads kept in flight at once
__host__ __device__ constexpr int group_of(int n) {
    for (int g = 16; g > 1; --g)
        if (n % g == 0) return g;
    return 1;
}

template <int W>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(HG * W + BK * (W + 4));
}

// partial results: pm, pl [B, H, nsplit]; pacc [B, H, nsplit, R] (fp32)
template <typename T, int R, int DR>
__global__ void __launch_bounds__(NT)
mla_decode_split_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                        const T* __restrict__ ckv, const T* __restrict__ krope,
                        float* __restrict__ pm, float* __restrict__ pl,
                        float* __restrict__ pacc, int H, int nsplit, int chunk,
                        int kv_start, int kv_end,
                        int64_t ql_sb, int64_t ql_sh, int64_t qr_sb, int64_t qr_sh,
                        int64_t c_sb, int64_t c_ss, int64_t r_sb, int64_t r_ss,
                        float scale) {
    constexpr int W = R + DR;          // a key row: latent then rotary part
    constexpr int KSTR = W + 4;        // padded row in shared memory, in floats
    constexpr int VEC = 16 / sizeof(T);
    constexpr int WV = W / VEC;        // 16-byte vectors per row
    constexpr int NI = R / 32;         // accumulator dims per lane
    constexpr int NVEC = BK * WV;      // vectors per key tile
    constexpr int PER = (NVEC + NT - 1) / NT;
    constexpr int GRP = group_of(PER);
    static_assert(R % 32 == 0 && R % VEC == 0 && DR % VEC == 0, "widths");
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);   // [HG][W]
    float* sK = sQ + HG * W;                       // [BK][KSTR]

    const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // this CTA's heads' queries [q_lat; q_rope]; heads past H are zero
    for (int e = tid; e < HG * WV; e += NT) {
        const int r = e / WV, c = (e % WV) * VEC, h = h0 + r;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (h < H)
            raw = c < R ? load16(q_lat + (int64_t)b * ql_sb + (int64_t)h * ql_sh + c)
                        : load16(q_rope + (int64_t)b * qr_sb + (int64_t)h * qr_sh + (c - R));
        widen(raw, sQ + r * W + c, T());
    }

    float m[ROWS], l[ROWS], acc[ROWS][NI];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    }

    const int j0 = kv_start + split * chunk;
    const int j1 = min(j0 + chunk, kv_end);
    const T* cb = ckv + (int64_t)b * c_sb;
    const T* rb = krope + (int64_t)b * r_sb;

    for (int k0 = j0; k0 < j1; k0 += BK) {
        __syncthreads();               // queries staged / previous tile consumed
        // GRP independent 16-byte loads in flight per thread, then widen into
        // shared memory; rows past the split are zero
#pragma unroll
        for (int g = 0; g < PER; g += GRP) {
            uint4 raw[GRP];
#pragma unroll
            for (int u = 0; u < GRP; ++u) {
                const int e = (g + u) * NT + tid;
                const int j = e / WV, c = (e % WV) * VEC, kp = k0 + j;
                raw[u] = make_uint4(0u, 0u, 0u, 0u);
                if (e < NVEC && kp < j1)
                    raw[u] = c < R ? load16(cb + (int64_t)kp * c_ss + c)
                                   : load16(rb + (int64_t)kp * r_ss + (c - R));
            }
#pragma unroll
            for (int u = 0; u < GRP; ++u) {
                const int e = (g + u) * NT + tid;
                if (e < NVEC) widen(raw[u], sK + (e / WV) * KSTR + (e % WV) * VEC, T());
            }
        }
        __syncthreads();

        // scores: this lane's key against the warp's heads
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
        const float4* krow = reinterpret_cast<const float4*>(sK + lane * KSTR);
        const float4* qrow = reinterpret_cast<const float4*>(sQ + warp * ROWS * W);
#pragma unroll 4
        for (int d4 = 0; d4 < W / 4; ++d4) {
            const float4 kk = krow[d4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float4 qq = qrow[r * (W / 4) + d4];
                s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
            }
        }

        // online softmax; s[r] becomes this lane's probability
        const bool live = k0 + lane < j1;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
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

        // acc += P ckv (the latent part of each key row)
#pragma unroll 2
        for (int j = 0; j < BK; ++j) {
            float vv[NI];
#pragma unroll
            for (int i = 0; i < NI; ++i) vv[i] = sK[j * KSTR + lane + 32 * i];
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
        const int h = h0 + warp * ROWS + r;
        if (h >= H) continue;
        const int64_t row = ((int64_t)b * H + h) * nsplit + split;
#pragma unroll
        for (int i = 0; i < NI; ++i) pacc[row * R + lane + 32 * i] = acc[r][i];
        if (lane == 0) {
            pm[row] = m[r];
            pl[row] = l[r];
        }
    }
}

struct Args {
    const void *q_lat, *q_rope, *ckv, *krope;
    void* out;
    float *pm, *pl, *pacc;
    int B, H, nsplit, chunk, kv_start, kv_end;
    int64_t st[8];
    float scale;
    cudaStream_t stream;
};

template <typename T, int R, int DR>
cudaError_t launch(const Args& a) {
    auto kern = mla_decode_split_kernel<T, R, DR>;
    constexpr size_t smem = smem_bytes<R + DR>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.nsplit, (a.H + HG - 1) / HG, a.B);
    kern<<<grid, NT, smem, a.stream>>>(
        (const T*)a.q_lat, (const T*)a.q_rope, (const T*)a.ckv, (const T*)a.krope,
        a.pm, a.pl, a.pacc, a.H, a.nsplit, a.chunk, a.kv_start, a.kv_end,
        a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7],
        a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    split_merge_kernel<T><<<dim3(a.H, a.B), 128, 0, a.stream>>>(
        a.pm, a.pl, a.pacc, (T*)a.out, a.H, a.nsplit, R);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int R, int Dr, const Args& a) {
    if (R == 512 && Dr == 64) return launch<T, 512, 64>(a);   // deepseek-v3
    if (R == 64 && Dr == 16) return launch<T, 64, 16>(a);     // the reference
    if (R == 128 && Dr == 32) return launch<T, 128, 32>(a);   // kernel tests'
    if (R == 32 && Dr == 16) return launch<T, 32, 16>(a);     // widths
    return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q_lat is [B, H, R], q_rope [B, H, Dr],
// ckv [B, S, R], krope [B, S, Dr], each with a contiguous last axis and
// 16-byte aligned rows (strides in elements: q_lat (sb, sh), q_rope (sb, sh),
// ckv (sb, ss), krope (sb, ss)). out is a contiguous [B, H, R]. pm, pl
// ([B, H, nsplit]) and pacc ([B, H, nsplit, R]) are fp32 scratch. Split s
// covers keys [kv_start + s * chunk, min(kv_start + (s + 1) * chunk, kv_end)).
// Returns the launches' cudaError_t (0 on success).
extern "C" int mla_decode_launch(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
    void* out, void* pm, void* pl, void* pacc,
    int dtype, int B, int H, int R, int Dr, int nsplit, int chunk,
    int kv_start, int kv_end,
    int64_t ql_sb, int64_t ql_sh, int64_t qr_sb, int64_t qr_sh,
    int64_t c_sb, int64_t c_ss, int64_t r_sb, int64_t r_ss,
    float scale, void* stream) {
    if (B <= 0 || H <= 0 || nsplit <= 0 || chunk <= 0 || kv_start < 0 ||
        kv_end < kv_start)
        return cudaErrorInvalidValue;
    Args a{q_lat, q_rope, ckv, krope, out, (float*)pm, (float*)pl, (float*)pacc,
           B, H, nsplit, chunk, kv_start, kv_end,
           {ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_ss, r_sb, r_ss},
           scale, (cudaStream_t)stream};
    if (dtype == 0) return by_width<float>(R, Dr, a);
    if (dtype == 1) return by_width<__nv_bfloat16>(R, Dr, a);
    return cudaErrorInvalidValue;
}

extern "C" const char* mla_decode_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
