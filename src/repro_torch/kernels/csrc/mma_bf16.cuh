// Tensor-core building blocks shared by ssd_scan.cu and mla_decode.cu:
// mma.sync m16n8k16 (bf16 in, fp32 accumulators), ldmatrix, and the split
// of an fp32 value into bf16 pieces, v ~ p0 + p1 (+ p2), so that a product
// with an fp32 operand runs on the tensor cores as a few bf16 products.
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A regs 0..3: (row g, cols c..c+1), (g+8, c), (g, c+8), (g+8, c+8)
//   B regs 0..1: (k c..c+1, col g), (k c+8.., col g)
//   C/D 0..3:    (row g, cols c, c+1), (row g+8, cols c, c+1)
// ldmatrix row addresses of a lane, for a row-major tile:
//   A [m][k]:                    row lane & 15,                  col (lane >> 4) * 8
//   B stored [n][k] (x4, 2 n-tiles): row (lane & 7) + (lane >> 4) * 8, col ((lane >> 3) & 1) * 8
//   B stored [k][n] (x4.trans):  row lane & 15,                  col (lane >> 4) * 8
// Splitting: bf16 keeps 8 significant bits, so two pieces hold ~16 bits of
// an fp32 value (relative error ~2^-17) and three pieces all 24. A product
// of operands split into NA and NB pieces keeps the piece pairs (i, j) with
// i + j < max(NA, NB): the dropped terms are below the last piece kept.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(shared_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(shared_u32(p)));
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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) -> NP pairs of bf16 pieces, into register `slot` of a[0..NP)
template <int NP>
__device__ __forceinline__ void split_pack(float x, float y, uint32_t (&a)[NP][4],
                                           int slot) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
        a[p][slot] = bf16x2_bits(h);
        x -= __low2float(h);
        y -= __high2float(h);
    }
}

// v -> NP bf16 pieces at dst[0], dst[stride], ...
template <int NP>
__device__ __forceinline__ void split_store(float v, __nv_bfloat16* dst, int stride) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const __nv_bfloat16 q = __float2bfloat16_rn(v);
        dst[p * stride] = q;
        v -= __bfloat162float(q);
    }
}

// d += A B over the piece pairs kept (see above); b[p][h], b[p][h + 1] are
// piece p's two B registers of the n-tile
template <int NA, int NB>
__device__ __forceinline__ void mma_pieces(float (&d)[4], const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][4], int h) {
    constexpr int KEEP = NA > NB ? NA : NB;
#pragma unroll
    for (int pa = NA - 1; pa >= 0; --pa)
#pragma unroll
        for (int pb = NB - 1; pb >= 0; --pb)
            if (pa + pb < KEEP) mma_bf16(d, a[pa], b[pb][h], b[pb][h + 1]);
}

}  // namespace
