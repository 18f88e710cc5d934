// The second pass of a split-KV decode, shared by flash_decode.cu and
// mla_decode.cu. Each split s of a row (b, h) left a partial online softmax:
// its running max m_s, its sum l_s = sum e^(score - m_s) and its unnormalised
// output acc_s = sum e^(score - m_s) v. One CTA per row merges them:
//   M = max m_s,  L = sum l_s e^(m_s - M),  out = sum acc_s e^(m_s - M) / L,
// and a row whose splits saw no live key (M = -inf) gives 0.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// pm, pl: [B, H, nsplit]; pacc: [B, H, nsplit, dv] (fp32); out: [B, H, dv].
// Grid (H, B).
template <typename T>
__global__ void split_merge_kernel(const float* __restrict__ pm,
                                   const float* __restrict__ pl,
                                   const float* __restrict__ pacc,
                                   T* __restrict__ out, int H, int nsplit,
                                   int dv) {
    const int h = blockIdx.x, b = blockIdx.y;
    const int64_t row0 = ((int64_t)b * H + h) * nsplit;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[row0 + s]);
    for (int d = threadIdx.x; d < dv; d += blockDim.x) {
        float L = 0.f, A = 0.f;
        if (M != -INFINITY) {
            for (int s = 0; s < nsplit; ++s) {
                const float ms = pm[row0 + s];
                const float e = ms == -INFINITY ? 0.f : expf(ms - M);
                L += pl[row0 + s] * e;
                A += pacc[(row0 + s) * dv + d] * e;
            }
        }
        store(out + ((int64_t)b * H + h) * dv + d, L > 0.f ? A / L : 0.f);
    }
}

}  // namespace
