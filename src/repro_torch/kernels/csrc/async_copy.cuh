// Asynchronous 16-byte copies from global to shared memory (cp.async), shared
// by flash_prefill.cu and flash_decode.cu, and a tile loader built on them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__host__ __device__ constexpr int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p *= 2;
    return p;
}

// ROWS rows of W elements of T, src rows src_stride elements apart, into
// shared rows DST elements apart, by the NT threads of the block; rows at
// or past `valid` are zero-filled (src itself must be a valid address).
// A thread keeps one 16-byte column of the row and walks down the rows, so
// each copy costs a compare and a pointer step, with no division.
template <typename T, int NT, int ROWS, int W, int DST>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t src_stride,
                                          int valid, int tid) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPR = W / VEC;                          // 16-byte chunks a row
    constexpr int CW = pow2_at_least(CPR < 32 ? CPR : 32);  // threads across a row
    constexpr int CPASS = (CPR + CW - 1) / CW;            // column passes
    constexpr int RPP = NT / CW;                          // rows per pass
    constexpr int PASSES = (ROWS + RPP - 1) / RPP;
    static_assert(W % VEC == 0 && NT % CW == 0, "16-byte rows");
    const int c0 = tid % CW, r0 = tid / CW;
    const int64_t step = (int64_t)RPP * src_stride;
#pragma unroll
    for (int j = 0; j < CPASS; ++j) {
        const int cc = c0 + j * CW;
        if (CPR % CW != 0 && cc >= CPR) break;
        const T* g = src + (int64_t)r0 * src_stride + cc * VEC;
        T* s = dst + r0 * DST + cc * VEC;
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
            const int r = r0 + i * RPP;
            if (ROWS % RPP == 0 || r < ROWS) {
                const bool ok = r < valid;
                cp_async16(s + i * RPP * DST, ok ? g : src, ok);
            }
            g += step;
        }
    }
}

}  // namespace
