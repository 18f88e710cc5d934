// Grouped expert GEMM for Hopper (sm_90a): the expert FFN's three products
// of a MoE layer, one launch each, with the group offsets read from device
// memory.
//
//   out[r, :] = xs[r, :] · w[e, :, :]   for offsets[e] <= r < offsets[e + 1]
//
// xs [M, K] holds the routed rows sorted by expert, w [E, K, N] every
// expert's weights in the layout the model stores ([E, d, f] for up and
// gate, [E, f, d] for down), offsets [E + 1] int32 the groups' bounds.
// Empty groups (experts no row was routed to, and the padded experts that
// never receive one) cost nothing, and rows outside [offsets[0],
// offsets[E]) are 0, as in jax.lax.ragged_dot.
//
// Replaces no TPU kernel. The reference computes the expert FFN with
// jax.lax.ragged_dot (src/repro/models/moe.py:93, :95, :99), an XLA op and
// not a Pallas kernel. It is written by hand here because PyTorch's way of
// doing the same, a loop of per-expert matmuls, needs the group sizes on the
// host: one device-to-host read per MoE layer per step, which would stall a
// decode step that is already bound by the host's dispatch and would bar a
// CUDA graph of it. This kernel reads no size on the host, so the MoE layer
// around it is device-only.
//
// What bounds it on this card: bytes. A decode step routes 8 rows a token
// (top-8) to at most 8 experts, and the kernel must read those experts'
// weights once: granite-moe-3b-a800m's three products read 8 x 3 x 1536 x
// 512 x 2 B = 37.7 MB a layer in bf16 (0.011 ms at 3.35 TB/s), deepseek-v3's
// 704 MB (0.21 ms), for 2 flops a weight a row. A 512-row prefill bucket
// (4096 rows) touches every expert with ~100 (granite) or ~16 (deepseek)
// rows each, still below the ~295 flops a byte where bf16 products turn
// bound by the tensor cores. The design:
//  - Grid (N tiles of 64 columns, min(E, M) expert slots). The CTA of slot s
//    takes the s-th expert that has rows (warp 0 ballots over offsets, 32
//    experts a step) and leaves when there is none, so a decode step runs
//    8 slots, not E, and reads each live expert's weight columns once. It
//    walks its expert's rows in tiles of 64.
//  - Each (row tile, N tile) runs the K loop through a four-stage ring in
//    shared memory (three stages in flight) filled by 16-byte cp.async
//    (async_copy.cuh); rows past the expert's and columns past N are
//    zero-filled, not read.
//  - bf16: the products on the tensor cores, mma.sync m16n8k16 bf16 -> fp32
//    (mma_bf16.cuh), 4 warps of 16 rows x 64 columns; A by ldmatrix, B by
//    ldmatrix.trans from the [k][n] tile, rows padded by 16 bytes so the 8
//    addresses of each 8x8 matrix fall in distinct bank groups. A warp whose
//    16 rows are all past the expert's rows skips its products (decode: one
//    row an expert), and still helps with the loads. The output is rounded
//    to bf16 once, from the fp32 sums.
//  - fp32: scalar FMAs (the tensor cores take no fp32 input at the 1e-5
//    tolerance), a 64 x 64 tile, each thread 4 rows x 8 columns.
// mma.sync on 64-row tiles is this design's simple first form. At decode a
// tile holds one live row, so the kernel's speed is that of its weight
// loads; wgmma, gate and up fused into one pass over the rows, and a split
// of K for the few CTAs of a decode step are the next steps (ROADMAP).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;                // threads: 4 warps
constexpr int BM = 64;                 // rows of a tile
constexpr int BN = 64;                 // columns of a tile
constexpr int STAGES = 4;              // cp.async ring depth
constexpr unsigned FULL = 0xffffffffu;

// K depth of a stage and the padding of the A ([BM][BK]) and B ([BK][BN])
// rows in shared memory: 16 bytes each
template <typename T> struct Tile;
template <> struct Tile<bf16> {
    static constexpr int BK = 32, LDA = BK + 8, LDB = BN + 8;
};
template <> struct Tile<float> {
    static constexpr int BK = 16, LDA = BK + 4, LDB = BN + 4;
};

struct Args {
    const void* xs;
    const void* w;
    const int* offsets;
    void* out;
    int M, K, N, E;
    int64_t x_sm;                      // xs row stride (elements)
    int64_t w_se, w_sk;                // w expert and k strides
    int64_t o_sm;                      // out row stride
};

__device__ __forceinline__ void store_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void store_zero(bf16* p) { *p = __float2bfloat16(0.f); }

// ROWS x W elements of T from src (rows `stride` apart) into dst (rows LD
// apart), 16 bytes a cp.async; rows at or past `rows` and columns at or past
// `cols` are zero-filled and not read (cols is a multiple of 16 bytes)
template <typename T, int ROWS, int W, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride,
                                          int rows, int cols, int tid) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPR = W / VEC;
    constexpr int CHUNKS = ROWS * CPR;
    static_assert(CHUNKS % NT == 0, "whole passes");
#pragma unroll
    for (int i = tid; i < CHUNKS; i += NT) {
        const int r = i / CPR, c = (i % CPR) * VEC;
        const bool ok = r < rows && c < cols;
        cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
    }
}

// The accumulators of a thread and the products of one shared-memory stage.
template <typename T> struct Mma;

template <> struct Mma<bf16> {
    // warp w: rows 16w..16w+15, the tile's 8 n8 columns tiles
    float acc[8][4];
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    __device__ __forceinline__ void step(const bf16* sA, const bf16* sB, int rows,
                                         int tid) {
        constexpr int BK = Tile<bf16>::BK, LDA = Tile<bf16>::LDA,
                      LDB = Tile<bf16>::LDB;
        const int lane = tid & 31, warp = tid >> 5;
        if (16 * warp >= rows) return;             // warp-uniform
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[4];
            ldsm_x4(a, sA + (16 * warp + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t b[4];
                ldsm_x4_trans(b, sB + (kk + (lane & 15)) * LDB + np * 16
                                     + (lane >> 4) * 8);
                mma_bf16(acc[2 * np], a, b[0], b[1]);
                mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
            }
        }
    }
    __device__ __forceinline__ void store(bf16* O, int64_t o_sm, int rows, int ncols,
                                          int tid) const {
        const int lane = tid & 31, warp = tid >> 5;
        const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + c;
            if (col >= ncols) break;               // ncols is a multiple of 8
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * warp + g + 8 * h;
                if (row < rows)
                    *reinterpret_cast<__nv_bfloat162*>(O + row * o_sm + col) =
                        __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
            }
        }
    }
};

template <> struct Mma<float> {
    // thread (ty, tx) = (tid / 8, tid % 8): rows ty + 16 i, columns
    // 4 tx + {0..3} and 32 + 4 tx + {0..3}
    float acc[4][8];
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __device__ __forceinline__ void step(const float* sA, const float* sB, int rows,
                                         int tid) {
        constexpr int BK = Tile<float>::BK, LDA = Tile<float>::LDA,
                      LDB = Tile<float>::LDB;
        const int ty = tid >> 3, tx = tid & 7;
        if (ty >= rows) return;                    // no live row of the thread's
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = sA[(ty + 16 * i) * LDA + k];
            const float4 b0 = *reinterpret_cast<const float4*>(sB + k * LDB + 4 * tx);
            const float4 b1 = *reinterpret_cast<const float4*>(sB + k * LDB + 32 + 4 * tx);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    __device__ __forceinline__ void store(float* O, int64_t o_sm, int rows, int ncols,
                                          int tid) const {
        const int ty = tid >> 3, tx = tid & 7;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i;
            if (row >= rows) break;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = 32 * h + 4 * tx;   // ncols is a multiple of 4
                if (col < ncols)
                    *reinterpret_cast<float4*>(O + row * o_sm + col) = make_float4(
                        acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
            }
        }
    }
};

template <typename T>
__global__ void __launch_bounds__(NT) moe_gemm_kernel(const Args a) {
    constexpr int BK = Tile<T>::BK, LDA = Tile<T>::LDA, LDB = Tile<T>::LDB;
    __shared__ __align__(16) T sA[STAGES][BM * LDA];
    __shared__ __align__(16) T sB[STAGES][BK * LDB];
    __shared__ int s_expert;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n0 = blockIdx.x * BN;
    const int ncols = min(BN, a.N - n0);
    const int* off = a.offsets;
    T* out = static_cast<T*>(a.out);

    // rows outside every group are 0, as ragged_dot leaves them; written by
    // the first slot of each column tile
    if (blockIdx.y == 0) {
        const int lo = max(0, min(off[0], a.M));
        const int hi = max(lo, min(off[a.E], a.M));
        const int n_out = lo + (a.M - hi);
        for (int i = tid; i < n_out * ncols; i += NT) {
            const int rr = i / ncols, cc = i % ncols;
            const int r = rr < lo ? rr : hi + rr - lo;
            store_zero(out + r * a.o_sm + n0 + cc);
        }
    }

    // this CTA's expert: the blockIdx.y-th one that has rows
    if (tid == 0) s_expert = -1;
    __syncthreads();
    if (warp == 0) {
        const int want = blockIdx.y;
        int seen = 0;
        for (int base = 0; base < a.E; base += 32) {
            const int e = base + lane;
            const bool has = e < a.E && off[e + 1] > off[e];
            const unsigned m = __ballot_sync(FULL, has);
            if (seen + __popc(m) > want) {
                if (has && __popc(m & ((1u << lane) - 1u)) == want - seen)
                    s_expert = e;
                break;
            }
            seen += __popc(m);
        }
    }
    __syncthreads();
    const int e = s_expert;
    if (e < 0) return;
    const int r0 = off[e], r_end = min(off[e + 1], a.M);

    const T* W = static_cast<const T*>(a.w) + e * a.w_se + n0;
    const int nkt = (a.K + BK - 1) / BK;
    for (int m0 = r0; m0 < r_end; m0 += BM) {
        const int rows = min(BM, r_end - m0);
        const T* X = static_cast<const T*>(a.xs) + m0 * a.x_sm;
        Mma<T> mma;
        mma.zero();
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
            if (s < nkt) {
                const int k0 = s * BK;
                load_tile<T, BM, BK, LDA>(sA[s], X + k0, a.x_sm, rows, a.K - k0, tid);
                load_tile<T, BK, BN, LDB>(sB[s], W + k0 * a.w_sk, a.w_sk, a.K - k0,
                                          ncols, tid);
            }
            cp_async_commit();
        }
        for (int kt = 0; kt < nkt; ++kt) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();                       // stage kt landed; kt - 1 read
            const int pf = kt + STAGES - 1;
            if (pf < nkt) {
                const int k0 = pf * BK, st = pf % STAGES;
                load_tile<T, BM, BK, LDA>(sA[st], X + k0, a.x_sm, rows, a.K - k0, tid);
                load_tile<T, BK, BN, LDB>(sB[st], W + k0 * a.w_sk, a.w_sk, a.K - k0,
                                          ncols, tid);
            }
            cp_async_commit();
            mma.step(sA[kt % STAGES], sB[kt % STAGES], rows, tid);
        }
        mma.store(out + m0 * a.o_sm + n0, a.o_sm, rows, ncols, tid);
        __syncthreads();                           // the ring is free again
    }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const dim3 grid((a.N + BN - 1) / BN, a.E < a.M ? a.E : a.M);
    moe_gemm_kernel<T><<<grid, NT, 0, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. xs [M, K] (row stride x_sm), w [E, K, N]
// (strides w_se, w_sk, 1), out [M, N] (row stride o_sm), all of dtype, with
// 16-byte aligned rows: K, N and the strides multiples of 16 bytes. offsets
// [E + 1] int32 in device memory, nondecreasing, 0 <= offsets[0] and
// offsets[E] <= M. One launch; returns its cudaError_t (0 on success).
extern "C" int moe_gemm_launch(const void* xs, const void* w, const void* offsets,
                               void* out, int dtype, int M, int K, int N, int E,
                               int64_t x_sm, int64_t w_se, int64_t w_sk,
                               int64_t o_sm, void* stream) {
    const int vec = dtype == 1 ? 8 : 4;
    if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % vec || N % vec ||
        x_sm % vec || w_se % vec || w_sk % vec || o_sm % vec)
        return cudaErrorInvalidValue;
    Args a{xs, w, static_cast<const int*>(offsets), out, M, K, N, E,
           x_sm, w_se, w_sk, o_sm};
    if (dtype == 0) return launch<float>(a, static_cast<cudaStream_t>(stream));
    if (dtype == 1) return launch<bf16>(a, static_cast<cudaStream_t>(stream));
    return cudaErrorInvalidValue;
}

extern "C" const char* moe_gemm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
