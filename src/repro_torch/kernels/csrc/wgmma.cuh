// Warpgroup tensor-core products (wgmma, sm_90a only), the shared-memory
// tile layout they read, and the TMA copies and mbarriers that fill it;
// shared by flash_prefill_bwd.cu and moe_gemm.cu.
//
// Layout. A tile of R rows x W bf16 columns lies in shared memory as W / 64
// column blocks, each [R rows][64 columns] of 128-byte rows, R * 128 bytes
// apart; the 16-byte chunk c (0..7) of row r sits at chunk c ^ (r & 7) of
// its row (the 128-byte swizzle, which spreads the 8 rows of a core matrix
// over all banks). Every block starts on 1024 bytes. The same tile serves
// two ways, by its descriptor:
//  - K-major (desc_k): the rows are M or N, the columns the reduction. A
//    k-step of 16 columns is the block's base + 32 bytes a step; the 8-row
//    groups are 1024 bytes apart (SBO).
//  - MN-major (desc_mn, the instruction's transpose flag set): the rows are
//    the reduction, the columns M or N. A k-step of 16 rows is + 2048
//    bytes; the 8-row groups are 1024 bytes apart (SBO) and the 64-column
//    blocks R * 128 bytes apart (LBO).
// (CUTLASS's canonical GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp:
// K-major SW128 ((8,m),(T,2)):((8T,SBO),(1,T)), MN-major SW128
// ((T,8,m),(8,k)):((1,T,LBO),(8T,SBO)), T = 8 bf16.)
//
// Products are m64n64k16, bf16 in, fp32 accumulators: 32 floats a thread,
// d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 (lane & 3) +
// (e & 1) of the warpgroup's 64 x 64 tile (w the warp in the warpgroup, g =
// lane / 4), as mma.sync's C repeated over 8 n-tiles. An A operand in
// registers is mma.sync m16n8k16's A fragment on the warp's 16 rows, so a
// product's accumulators convert to the next product's A operand in place
// (a_frag). Wider N runs as 64-column products side by side.
//
// TMA writes the same layout: a tensor map with a 64-element inner box and
// the 128-byte swizzle lays each box out as one block (tile_map), and its
// copies complete on an mbarrier by bytes. The driver's encoder is reached
// through the runtime, so the libraries link no libcuda.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary in a dynamic shared-memory buffer, kept a
// pointer into it (so the compiler still knows its accesses are shared)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// byte offset of 16-byte chunk `c` (of the full row) of row r in a tile of
// R rows laid out as above
__device__ __forceinline__ uint32_t sw128(int r, int c, int R) {
    return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
    return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the generic proxy's shared-memory writes (cp.async, st.shared) made
// visible to wgmma's reads; before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of d across an asynchronous product
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D32 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D32_OPS(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),    \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])

// d (+)= A B, A and B K-major from shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_k(float (&d)[32], uint64_t da, uint64_t db,
                                           int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32_OPS(d)
        : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, A in registers (a_frag or ldsm_a), B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int acc = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

#undef WG_D32
#undef WG_D32_OPS

// d (+)= A B over 128 columns as one instruction, both operands MN-major
// from shared memory, B over two 64-column blocks LBO apart; d is two
// 64-column accumulator tiles side by side (d[32 t + i] = tile t's d[i])
#define WG_D64 "{" \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D64_OPS(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
    "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
    "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

__device__ __forceinline__ void wgmma_ss_mn128(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", %64, %65, p, 1, 1, 1, 1;\n}\n"
        : WG_D64_OPS(d)
        : "l"(da), "l"(db));
}

// d += A B over 128 columns, A K-major from shared memory (desc_k), B
// MN-major (TB = 1, desc_mn, two 64-column blocks LBO apart) or K-major
// (TB = 0, desc_k over 128 rows)
template <int TB>
__device__ __forceinline__ void wgmma_ss_k128(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", %64, %65, p, 1, 1, 0, %66;\n}\n"
        : WG_D64_OPS(d)
        : "l"(da), "l"(db), "n"(TB));
}
#undef WG_D64
#undef WG_D64_OPS

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// the register A operand of k-step kk of a K-major tile of R rows at shared
// address `tile` (the layout above), for warp w of the warpgroup: rows 16 w
// .. 16 w + 15, columns 16 kk .. 16 kk + 15, by ldmatrix
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t tile, int R, int w,
                                       int kk, int lane) {
    const uint32_t addr = tile + sw128(16 * w + (lane & 15), 2 * kk + (lane >> 4), R);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// mbarriers and TMA (bulk tensor copies into shared memory, completing on
// an mbarrier by bytes)
__device__ __forceinline__ void mb_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mb_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mb_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mb_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mb_wait(uint64_t* bar, uint32_t parity) {
    asm volatile("{\n.reg .pred P1;\nLAB_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
                 "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
                 :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, int c0, int c1,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(smem_u32(bar)) : "memory");
}
// shared -> global by TMA (clipped at the tensor's edges); tma_store_wait
// waits until the shared source has been read
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, const void* src, int c0,
                                           int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1),
           "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(smem_u32(bar)) : "memory");
}

// The driver's cuTensorMapEncodeTiled, reached through the runtime (no link
// to libcuda); null where the driver has none.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return fn;
}

// A map of a bf16 [d0, d1, d2, d3] tensor (d0 contiguous; s1..s3 strides in
// elements, multiples of 8) read in boxes of 64 x 1 x 64 x 1 into the
// 128-byte-swizzled layout above: one [64 rows][64 columns] block a copy,
// columns past d0 and rows past d2 zero-filled.
inline bool tile_map(CUtensorMap* m, const void* base, uint64_t d0, uint64_t d1,
                     uint64_t d2, uint64_t d3, int64_t s1, int64_t s2, int64_t s3) {
    auto enc = tensor_map_encoder();
    if (!enc) return false;
    cuuint64_t dims[4] = {d0, d1, d2, d3};
    cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
    cuuint32_t box[4] = {64, 1, 64, 1}, estr[4] = {1, 1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the A operand of k-step kc (columns 16 kc .. 16 kc + 15 of a 64-column
// accumulator tile d, rounded to bf16)
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[32], int kc) {
    a[0] = pack_bf16x2(d[8 * kc + 0], d[8 * kc + 1]);
    a[1] = pack_bf16x2(d[8 * kc + 2], d[8 * kc + 3]);
    a[2] = pack_bf16x2(d[8 * kc + 4], d[8 * kc + 5]);
    a[3] = pack_bf16x2(d[8 * kc + 6], d[8 * kc + 7]);
}

}  // namespace
