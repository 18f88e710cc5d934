// Split-KV flash decode for Hopper (sm_90a): one new query token per head
// against a long KV cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (body _kernel :22, pallas_call :89). For each (b, h) the query attends to
// keys kpos < kv_len (and kpos > kv_len - 1 - window when a window is set)
// with an online fp32 softmax; a row with no live key gives 0. The value
// width dv may differ from the key width dh and the scale may be overridden,
// as MLA's absorbed decode needs.
//
// What bounds it on this card: bytes. Each key and value row is used once
// per query head, ~1 flop per byte, so the floor is the K and V bytes over
// 3.35 TB/s: ~0.3 us for the main path's 1024 x 256 bf16 cache per layer.
// At that size a kernel launch costs more than the data, so the design's
// first aim is to put enough CTAs on the 132 SMs to pull the cache at full
// rate when it is long, and to read it once.
//
// Design: on the main path B * KV = 1 and H = 4, so one CTA per (b, h)
// would light 4 SMs and read the cache 4 times. Instead each CTA takes
// (KV split, head group, batch): a contiguous run of keys and HG query heads
// that share one kv head (all H / KV of them when that is <= 4). Each of the
// CTA's 4 warps walks every 4th key of the split: lanes hold dims
// lane + 32 i of q, k and v (coalesced row reads), the warp reduces each
// head's dot product with shuffles, and keeps its own (m, l, acc) per head.
// The 4 warps merge through shared memory and the CTA writes one partial
// (m, l, acc) per head. A second small kernel (split_merge.cuh) merges the
// splits.
// The cache is read in place through its strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// partial results: pm, pl [B, H, nsplit]; pacc [B, H, nsplit, DV] (fp32)
template <typename T, int DH, int DV, int HG>
__global__ void __launch_bounds__(NWARPS * 32)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ pm,
                          float* __restrict__ pl, float* __restrict__ pacc,
                          int H, int rep, int nsplit, int chunk,
                          int kv_start, int kv_end,
                          int64_t q_sb, int64_t q_sh,
                          int64_t k_sb, int64_t k_ss, int64_t k_sh,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          float scale) {
    constexpr int NI = DH / 32, NV = DV / 32;
    __shared__ float s_m[NWARPS][HG], s_l[NWARPS][HG];
    __shared__ float s_acc[NWARPS][HG][DV];

    const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
    const int kvh = h0 / rep;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    float qv[HG][NI], m[HG], l[HG], acc[HG][NV];
#pragma unroll
    for (int r = 0; r < HG; ++r) {
        const T* qr = q + (int64_t)b * q_sb + (int64_t)(h0 + r) * q_sh;
#pragma unroll
        for (int i = 0; i < NI; ++i) qv[r][i] = to_f(qr[lane + 32 * i]);
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
    }

    const int j0 = kv_start + split * chunk;
    const int j1 = min(j0 + chunk, kv_end);
    const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
    const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
#pragma unroll 2
    for (int j = j0 + warp; j < j1; j += NWARPS) {
        float kk[NI], vv[NV];
#pragma unroll
        for (int i = 0; i < NI; ++i) kk[i] = to_f(kb[(int64_t)j * k_ss + lane + 32 * i]);
#pragma unroll
        for (int i = 0; i < NV; ++i) vv[i] = to_f(vb[(int64_t)j * v_ss + lane + 32 * i]);
#pragma unroll
        for (int r = 0; r < HG; ++r) {
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < NI; ++i) dot += qv[r][i] * kk[i];
            const float s = warp_sum(dot) * scale;
            if (s > m[r]) {            // uniform across the warp
                const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - s);
                l[r] *= alpha;
#pragma unroll
                for (int i = 0; i < NV; ++i) acc[r][i] *= alpha;
                m[r] = s;
            }
            const float p = expf(s - m[r]);
            l[r] += p;
#pragma unroll
            for (int i = 0; i < NV; ++i) acc[r][i] += p * vv[i];
        }
    }

#pragma unroll
    for (int r = 0; r < HG; ++r) {
        if (lane == 0) {
            s_m[warp][r] = m[r];
            s_l[warp][r] = l[r];
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) s_acc[warp][r][lane + 32 * i] = acc[r][i];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < HG * DV; idx += NWARPS * 32) {
        const int r = idx / DV, d = idx % DV;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, s_m[w][r]);
        float L = 0.f, A = 0.f;
        if (M != -INFINITY) {
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                const float e = s_m[w][r] == -INFINITY ? 0.f : expf(s_m[w][r] - M);
                L += s_l[w][r] * e;
                A += s_acc[w][r][d] * e;
            }
        }
        const int64_t row = ((int64_t)b * H + h0 + r) * nsplit + split;
        pacc[row * DV + d] = A;
        if (d == 0) {
            pm[row] = M;
            pl[row] = L;
        }
    }
}

struct Args {
    const void *q, *k, *v;
    void* out;
    float *pm, *pl, *pacc;
    int B, H, KV, hg, nsplit, chunk, kv_start, kv_end;
    int64_t st[8];
    float scale;
    cudaStream_t stream;
};

template <typename T, int DH, int DV, int HG>
cudaError_t launch(const Args& a) {
    dim3 grid(a.nsplit, a.H / HG, a.B);
    flash_decode_split_kernel<T, DH, DV, HG><<<grid, NWARPS * 32, 0, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.pm, a.pl, a.pacc,
        a.H, a.H / a.KV, a.nsplit, a.chunk, a.kv_start, a.kv_end,
        a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7],
        a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    split_merge_kernel<T><<<dim3(a.H, a.B), 128, 0, a.stream>>>(
        a.pm, a.pl, a.pacc, (T*)a.out, a.H, a.nsplit, DV);
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
// v [B, Sk, KV, dv], each with a contiguous last axis (strides in elements).
// out is a contiguous [B, H, dv]. pm, pl ([B, H, nsplit]) and pacc
// ([B, H, nsplit, dv]) are fp32 scratch. Split s covers keys
// [kv_start + s * chunk, min(kv_start + (s + 1) * chunk, kv_end)); hg query
// heads (dividing H / KV, at most 4) share a CTA.
// Returns the launches' cudaError_t (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* out,
    void* pm, void* pl, void* pacc,
    int dtype, int B, int H, int KV, int dh, int dv, int hg, int nsplit,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int chunk, int kv_start, int kv_end, float scale, void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV || (H / KV) % hg || nsplit <= 0)
        return cudaErrorInvalidValue;
    Args a{q, k, v, out, (float*)pm, (float*)pl, (float*)pacc,
           B, H, KV, hg, nsplit, chunk, kv_start, kv_end,
           {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh},
           scale, (cudaStream_t)stream};
    if (dtype == 0) return by_width<float>(dh, dv, a);
    if (dtype == 1) return by_width<__nv_bfloat16>(dh, dv, a);
    return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
