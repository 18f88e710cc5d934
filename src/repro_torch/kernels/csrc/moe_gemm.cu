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
// bound by the tensor cores. So the design keeps as many weight bytes in
// flight as the card can take and reads each once.
//
// bf16, on wgmma (wgmma.cuh), in one of two forms that the wrapper's plan
// (moe_gemm.py::moe_plan) picks from the host-known shapes M, N and E; it
// never reads a group size:
//  - A CTA computes a tile of one expert's rows (64 rows a consumer
//    warpgroup) by 128 columns of N, over the whole of K. Tile slot y
//    takes the y-th row tile of the experts that have rows (warp
//    0 scans the offsets, 32 experts a step; an expert of r rows has
//    ceil(r / rows) tiles) and leaves at once when there is none: the grid's
//    M / rows + min(E, M) slots bound the tiles of any routing.
//  - One producer warp issues TMA loads (128-byte swizzled boxes, 64 deep in
//    K) of the rows and of the weight tile into a ring of stages completed on
//    mbarriers; the consumer warpgroups run m64n128k16 products on each stage
//    as it lands and free it one stage later (a full / empty mbarrier pair a
//    stage). W is read MN-major as it lies for serving (w_sn = 1: two
//    [64 k][64 n] boxes a stage) and K-major for dX (w_sk = 1: one [128 n]
//    [64 k] box).
//  - decode form (few rows an expert): one consumer warpgroup, 64-row tiles,
//    a 4-stage ring of 24 KB stages, two CTAs an SM. K is not split: a K
//    split over a thread-block cluster (partials merged through distributed
//    shared memory) was timed on an H100 and won at no shape by more than
//    the runs' spread (PERF.md).
//  - bucket form (a prefill bucket with ~100 rows an expert): two consumer
//    warpgroups, 128-row tiles (a granite expert's rows in one tile, so its
//    weights are read once a column tile), a 3-stage ring of 32 KB stages,
//    two CTAs an SM.
//  - A tile's rows past its expert's are loaded (they belong to the next
//    expert, or lie past M and are zero-filled) and multiplied, never
//    stored: each thread stores its own bf16 pairs, predicated per row and
//    column, so no tile writes rows another CTA owns. The output is rounded
//    to bf16 once, from the fp32 sums.
//  - The tensor maps are encoded on the host and kept in a cache keyed by
//    (pointer, shape, strides, box), so a layer's weight view is encoded once
//    and a decode step adds no encoder calls.
// fp32 keeps its first form (the tensor cores take no fp32 input at the 1e-5
// tolerance): grid (64-column tiles, min(E, M) expert slots), slot s takes
// the s-th expert that has rows and walks them in 64-row tiles through a
// four-stage cp.async ring (async_copy.cuh), scalar FMAs, a 64 x 64 tile,
// each thread 4 rows x 8 columns.
//
// The backward (training; no TPU kernel, ragged_dot's own transpose rules in
// the reference) reads no size on the host either:
//  - dX[r] = dY[r] · W[e]^T is moe_gemm_launch with w's k and n strides
//    swapped (w_sk = 1): the bf16 kernel then loads [128 n][64 k] boxes of W
//    as they lie and reads them as a K-major B (fp32: [64 n][16 k] tiles,
//    read by row). The [E, K, N] stack is not copied; the plan is the
//    forward's at dX's shapes.
//  - dW[e] = xs[lo:hi]^T · dY[lo:hi] is moe_gemm_wgrad_launch. It reads the
//    offsets from device memory, accumulates in fp32 and writes every
//    element: an expert with no rows (a padded one too) gets zeros. At the
//    training shapes it is bound by its output: ~100-128 rows an expert
//    (4096 routed rows over 40 granite or 32 deepseek experts) make a short
//    reduction, and dW is most of the bytes (deepseek's 32 x 7168 x 2048 x
//    2 B = 940 MB of 1.01 GB; 0.28 ms at 3.35 TB/s). The bf16 design for
//    that (the first form's 64 x 64 mma.sync tiles with 4-byte stores
//    spent most of each short CTA in its prologue and epilogue):
//    - 128 x 128 tiles on two wgmma warpgroups (wgmma.cuh), so xs is read
//      N / 128 times and dY K / 128 times; both operands MN-major, as they
//      lie in memory.
//    - TMA loads into a 2-stage ring of 64-row stages, kept two stages ahead
//      by one thread across the tiles of a persistent CTA (two an SM), so a
//      tile's loads run under the previous tile's products and stores. A
//      partial last stage's dY rows of the next expert are zeroed in shared
//      memory.
//    - The epilogue stages the bf16 tile in shared memory and TMA stores it
//      (full 128-byte rows, asynchronously; the buffer is reused once read).
//    - An expert with no rows gets its zeros by 16-byte stores, no products.
//    fp32 keeps the first form: one CTA a (64-column tile of N, 64-row tile
//    of K, expert) through the four-stage cp.async ring, A = xs^T read by
//    column, scalar FMAs.

#include <array>
#include <atomic>
#include <map>
#include <mutex>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the fp32 kernels
constexpr int NT = 128;                // threads: 4 warps
constexpr int BM = 64;                 // rows of a tile
constexpr int BN = 64;                 // columns of a tile
constexpr int STAGES = 4;              // cp.async ring depth
constexpr unsigned FULL = 0xffffffffu;

// fp32: the K depth of a stage and the padding of the A ([BM][BK]) and B
// ([BK][BN]) rows in shared memory, 16 bytes each; LDBT: a transposed B
// tile's rows ([BN][BK], k contiguous); LDAT: a transposed A tile's rows
// ([BK][BM], m contiguous; the wgrad)
template <typename T> struct Tile;
template <> struct Tile<float> {
    static constexpr int BK = 16, LDA = BK + 4, LDB = BN + 4, LDBT = BK + 4,
                         LDAT = BM + 4;
};

struct Args {
    const void* xs;
    const void* w;
    const int* offsets;
    void* out;
    int M, K, N, E;
    int64_t x_sm;                      // xs row stride (elements)
    int64_t w_se, w_sk, w_sn;          // w expert, k and n strides; one
                                       // of w_sk, w_sn is 1
    int64_t o_sm;                      // out row stride
};

__device__ __forceinline__ void store_zero(float* p) { *p = 0.f; }

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
    template <bool AT = false, bool BT = false>
    __device__ __forceinline__ void step(const float* sA, const float* sB, int rows,
                                         int tid) {
        constexpr int BK = Tile<float>::BK, LDA = Tile<float>::LDA,
                      LDB = Tile<float>::LDB, LDBT = Tile<float>::LDBT,
                      LDAT = Tile<float>::LDAT;
        const int ty = tid >> 3, tx = tid & 7;
        if (ty >= rows) return;                    // no live row of the thread's
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                av[i] = AT ? sA[k * LDAT + ty + 16 * i] : sA[(ty + 16 * i) * LDA + k];
            float bv[8];
            if (BT) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    bv[j] = sB[(32 * (j >> 2) + 4 * tx + (j & 3)) * LDBT + k];
            } else {
                const float4 b0 = *reinterpret_cast<const float4*>(sB + k * LDB + 4 * tx);
                const float4 b1 = *reinterpret_cast<const float4*>(sB + k * LDB + 32 + 4 * tx);
                bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
                bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
            }
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

// fp32. BT: w is read transposed (w_sk = 1, rows of n w_sn apart), for dX
template <typename T, bool BT>
__global__ void __launch_bounds__(NT) moe_gemm_kernel(const Args a) {
    constexpr int BK = Tile<T>::BK, LDA = Tile<T>::LDA, LDB = Tile<T>::LDB,
                  LDBT = Tile<T>::LDBT;
    __shared__ __align__(16) T sA[STAGES][BM * LDA];
    __shared__ __align__(16) T sB[STAGES][BT ? BN * LDBT : BK * LDB];
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

    const T* W = static_cast<const T*>(a.w) + e * a.w_se + n0 * a.w_sn;
    // stage pf's B tile: [BK k][BN n] as it lies, or [BN n][BK k] for BT
    auto load_b = [&](T* dst, int k0) {
        if (BT)
            load_tile<T, BN, BK, LDBT>(dst, W + k0, a.w_sn, ncols, a.K - k0, tid);
        else
            load_tile<T, BK, BN, LDB>(dst, W + k0 * a.w_sk, a.w_sk, a.K - k0, ncols, tid);
    };
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
                load_b(sB[s], k0);
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
                load_b(sB[st], k0);
            }
            cp_async_commit();
            mma.template step<false, BT>(sA[kt % STAGES], sB[kt % STAGES], rows, tid);
        }
        mma.store(out + m0 * a.o_sm + n0, a.o_sm, rows, ncols, tid);
        __syncthreads();                           // the ring is free again
    }
}

template <typename T>
cudaError_t launch_scalar(const Args& a, cudaStream_t stream) {
    const dim3 grid((a.N + BN - 1) / BN, a.E < a.M ? a.E : a.M);
    if (a.w_sn == 1)
        moe_gemm_kernel<T, false><<<grid, NT, 0, stream>>>(a);
    else
        moe_gemm_kernel<T, true><<<grid, NT, 0, stream>>>(a);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 forward on wgmma (the design above). The work of CTA (x, y): column
// tile x, row tile slot y; tests/test_torch_moe_plan.py::moe_tile_walk is
// this arithmetic in Python, and the CPU tests check on it that every
// output element is written once.
namespace fw {
constexpr int BN = 128;                            // columns of a tile
constexpr int BK = 64;                             // K depth of a stage
}  // namespace fw

template <int NWG> struct FwCfg {
    static constexpr int BM = 64 * NWG;            // rows of a tile
    static constexpr int STAGES = NWG == 1 ? 4 : 3;
    static constexpr int A_BYTES = BM * fw::BK * 2;       // [BM][64] bf16
    static constexpr int B_BYTES = fw::BK * fw::BN * 2;   // 2 [64][64] or [128][64]
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int THREADS = 128 * NWG + 32;        // + the producer warp
    static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

struct FArgs {
    const void* xs;
    const void* w;
    const int* offsets;
    void* out;
    int M, K, N, E;
    int64_t o_sm;                      // out row stride
};

struct FMaps {
    CUtensorMap xs, w;
};

// BT: w is read transposed (w_sk = 1), for dX
template <int NWG, bool BT>
__global__ void __launch_bounds__(FwCfg<NWG>::THREADS, 2)
moe_gemm_wgmma_kernel(const FArgs a, const __grid_constant__ FMaps mp) {
    using C = FwCfg<NWG>;
    constexpr int BM = C::BM, BN = fw::BN, BK = fw::BK, S = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * C::STAGE);
    uint64_t* empty = full + S;
    __shared__ int s_tile[3];                      // expert, first row, rows
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n0 = blockIdx.x * BN;
    const int* off = a.offsets;
    bf16* out = static_cast<bf16*>(a.out);

    // rows outside every group are 0, as ragged_dot leaves them; written by
    // the first slot of each column tile
    if (blockIdx.y == 0) {
        const int lo = max(0, min(off[0], a.M));
        const int hi = max(lo, min(off[a.E], a.M));
        const int ncols = min(BN, a.N - n0), n_out = lo + (a.M - hi);
        for (int i = tid; i < n_out * ncols; i += C::THREADS) {
            const int rr = i / ncols, cc = i % ncols;
            const int r = rr < lo ? rr : hi + rr - lo;
            out[(int64_t)r * a.o_sm + n0 + cc] = __float2bfloat16(0.f);
        }
    }

    // this slot's tile: the blockIdx.y-th row tile of the experts with rows
    if (tid == 0) s_tile[0] = -1;
    __syncthreads();
    if (warp == 0) {
        const int want = blockIdx.y;
        int seen = 0;
        for (int base = 0; base < a.E; base += 32) {
            const int e = base + lane;
            int r0 = 0, r1 = 0;
            if (e < a.E) {
                r0 = min(off[e], a.M);
                r1 = max(r0, min(off[e + 1], a.M));
            }
            const int n = (r1 - r0 + BM - 1) / BM;
            int inc = n;                           // inclusive scan over lanes
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int v = __shfl_up_sync(FULL, inc, d);
                if (lane >= d) inc += v;
            }
            const int total = __shfl_sync(FULL, inc, 31);
            if (want < seen + total) {
                const int first = seen + inc - n;
                if (n > 0 && want >= first && want < seen + inc) {
                    const int m0 = r0 + (want - first) * BM;
                    s_tile[0] = e;
                    s_tile[1] = m0;
                    s_tile[2] = min(BM, r1 - m0);
                }
                break;
            }
            seen += total;
        }
    }
    __syncthreads();
    const int e = s_tile[0];
    if (e < 0) return;
    const int m0 = s_tile[1], rows = s_tile[2];
    const int nst = (a.K + BK - 1) / BK;

    if (tid == 0) {
        for (int i = 0; i < S; ++i) {
            mb_init(&full[i], 1);
            mb_init(&empty[i], 128 * NWG);
        }
        mb_init_fence();
    }
    __syncthreads();

    if (warp == 4 * NWG) {                         // the producer warp
        if (lane == 0) {
            prefetch_map(&mp.xs);
            prefetch_map(&mp.w);
            for (int i = 0; i < nst; ++i) {
                const int st = i % S, k0 = i * BK;
                if (i >= S) mb_wait(&empty[st], ((i / S) - 1) & 1);
                uint8_t* s = sm + st * C::STAGE;
                mb_expect(&full[st], C::STAGE);
                tma_load2(s, &mp.xs, k0, m0, &full[st]);
                if (BT) {
                    tma_load3(s + C::A_BYTES, &mp.w, k0, n0, e, &full[st]);
                } else {
                    tma_load3(s + C::A_BYTES, &mp.w, n0, k0, e, &full[st]);
                    tma_load3(s + C::A_BYTES + BK * 128, &mp.w, n0 + 64, k0, e, &full[st]);
                }
            }
        }
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int wg = warp >> 2;
    const bool consumer = warp < 4 * NWG;
    if (consumer) {
        const uint32_t sbase = smem_u32(sm);
        for (int i = 0; i < nst; ++i) {
            const int st = i % S;
            mb_wait(&full[st], (i / S) & 1);
            const uint32_t sa = sbase + st * C::STAGE + wg * 64 * 128;
            const uint32_t sb = sbase + st * C::STAGE + C::A_BYTES;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_ss_k128<BT ? 0 : 1>(acc, desc_k(sa + kk * 32),
                                          BT ? desc_k(sb + kk * 32)
                                             : desc_mn(sb + kk * 2048, BK * 128));
            wg_commit();
            wg_wait<1>();                          // stage i - 1's products are done
            if (i > 0) mb_arrive(&empty[(i - 1) % S]);
        }
        wg_wait<0>();
        reg_fence(acc);
    }

    if (!consumer) return;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int wr = 64 * wg + 16 * (warp & 3) + g;  // the thread's first row
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + c2;
        if (col >= a.N) break;                     // N is a multiple of 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = wr + 8 * h;
            if (row < rows)
                *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(m0 + row) * a.o_sm + col) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
}

// Tensor maps, cached on the host by everything the encoder takes (a cache
// hit is the map it would encode again), so a layer's weight view and a
// reused row buffer are encoded once. The CUDA driver's encoder needs a
// current context on the calling thread.
struct MapCache {
    std::mutex mu;
    std::map<std::array<uint64_t, 12>, CUtensorMap> maps;
};

bool cached_map(CUtensorMap* m, const void* p, int rank, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box) {
    static MapCache cache;
    std::array<uint64_t, 12> key{};
    key[0] = reinterpret_cast<uint64_t>(p);
    key[1] = (uint64_t)rank;
    for (int i = 0; i < rank; ++i) {
        key[2 + i] = dims[i];
        key[5 + i] = box[i];
        if (i + 1 < rank) key[8 + i] = strides[i];
    }
    {
        std::lock_guard<std::mutex> lock(cache.mu);
        auto it = cache.maps.find(key);
        if (it != cache.maps.end()) {
            *m = it->second;
            return true;
        }
    }
    auto enc = tensor_map_encoder();
    if (!enc) return false;
    cuuint64_t d[3], s[2];
    cuuint32_t b[3], estr[3] = {1, 1, 1};
    for (int i = 0; i < rank; ++i) {
        d[i] = dims[i];
        b[i] = box[i];
        if (i + 1 < rank) s[i] = strides[i];
    }
    if (enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), d, s, b, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return false;
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.maps.size() >= 4096) cache.maps.clear();
    cache.maps[key] = *m;
    return true;
}

// xs [M, K] in boxes of 64 x BM rows; w [E, K, N] in boxes of 64 n x 64 k
// (w_sn = 1) or 64 k x 128 n (w_sk = 1)
bool fw_maps(FMaps* m, const FArgs& a, int64_t x_sm, int64_t w_se, int64_t w_sk,
             int64_t w_sn, int bm) {
    const uint64_t xd[2] = {(uint64_t)a.K, (uint64_t)a.M}, xs[1] = {(uint64_t)x_sm * 2};
    const uint32_t xb[2] = {64, (uint32_t)bm};
    if (!cached_map(&m->xs, a.xs, 2, xd, xs, xb)) return false;
    if (w_sn == 1) {
        const uint64_t wd[3] = {(uint64_t)a.N, (uint64_t)a.K, (uint64_t)a.E};
        const uint64_t ws[2] = {(uint64_t)w_sk * 2, (uint64_t)w_se * 2};
        const uint32_t wb[3] = {64, 64, 1};
        return cached_map(&m->w, a.w, 3, wd, ws, wb);
    }
    const uint64_t wd[3] = {(uint64_t)a.K, (uint64_t)a.N, (uint64_t)a.E};
    const uint64_t ws[2] = {(uint64_t)w_sn * 2, (uint64_t)w_se * 2};
    const uint32_t wb[3] = {64, 128, 1};
    return cached_map(&m->w, a.w, 3, wd, ws, wb);
}

template <int NWG, bool BT>
cudaError_t launch_wgmma(const FArgs& a, const FMaps& mp, int row_tiles,
                         cudaStream_t stream) {
    using C = FwCfg<NWG>;
    auto kern = moe_gemm_wgmma_kernel<NWG, BT>;
    static std::atomic<uint32_t> ready{0};         // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint32_t bit = 1u << (dev & 31);
    if (!(ready.load() & bit)) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)C::SMEM);
        if (err != cudaSuccess) return err;
        ready.fetch_or(bit);
    }
    const dim3 grid((a.N + fw::BN - 1) / fw::BN, row_tiles);
    kern<<<grid, C::THREADS, C::SMEM, stream>>>(a, mp);
    return cudaGetLastError();
}

template <bool BT>
cudaError_t launch_bf16(const FArgs& a, const FMaps& mp, int nwg, int row_tiles,
                        cudaStream_t stream) {
    if (nwg == 1) return launch_wgmma<1, BT>(a, mp, row_tiles, stream);
    if (nwg == 2) return launch_wgmma<2, BT>(a, mp, row_tiles, stream);
    return cudaErrorInvalidValue;
}

struct WArgs {
    const void* xs;                    // [M, K], rows x_sm apart
    const void* dy;                    // [M, N], rows y_sm apart
    const int* offsets;
    void* dw;                          // [E, K, N], strides (o_se, o_sk, 1)
    int M, K, N, E;
    int64_t x_sm, y_sm, o_se, o_sk;
};

// fp32: dW[e][k0:k0+64, n0:n0+64] = xs[lo:hi, k-tile]^T dY[lo:hi, n-tile]
template <typename T>
__global__ void __launch_bounds__(NT) moe_wgrad_kernel(const WArgs a) {
    constexpr int BK = Tile<T>::BK, LDB = Tile<T>::LDB, LDAT = Tile<T>::LDAT;
    __shared__ __align__(16) T sA[STAGES][BK * LDAT];
    __shared__ __align__(16) T sB[STAGES][BK * LDB];
    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
    const int ncols = min(BN, a.N - n0), mrows = min(BM, a.K - k0);
    const int r0 = max(0, min(a.offsets[e], a.M));
    const int r_end = max(r0, min(a.offsets[e + 1], a.M));
    const int nkt = (r_end - r0 + BK - 1) / BK;
    const T* X = static_cast<const T*>(a.xs) + r0 * a.x_sm + k0;
    const T* Y = static_cast<const T*>(a.dy) + r0 * a.y_sm + n0;
    auto load = [&](int st, int kt) {
        const int r = kt * BK, left = r_end - r0 - r;
        load_tile<T, BK, BM, LDAT>(sA[st], X + r * a.x_sm, a.x_sm, left, mrows, tid);
        load_tile<T, BK, BN, LDB>(sB[st], Y + r * a.y_sm, a.y_sm, left, ncols, tid);
    };
    Mma<T> mma;
    mma.zero();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkt) load(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < nkt; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();                           // stage kt landed; kt - 1 read
        const int pf = kt + STAGES - 1;
        if (pf < nkt) load(pf % STAGES, pf);
        cp_async_commit();
        mma.template step<true, false>(sA[kt % STAGES], sB[kt % STAGES], mrows, tid);
    }
    cp_async_wait<0>();
    mma.store(static_cast<T*>(a.dw) + e * a.o_se + k0 * a.o_sk + n0, a.o_sk, mrows,
              ncols, tid);
}

// bf16 on wgmma: 128 x 128 tiles of dW (128 rows of K, 128 columns of N, an
// expert), two warpgroups of 64 K-rows each, the expert's rows (the
// reduction) in 64-row stages. Persistent: CTA c takes tiles c, c + grid,
// ..., and one thread keeps a 2-stage TMA ring two stages ahead across them,
// so the next tile's loads run under this tile's last products and its
// store. A stage holds xs[rows, 128 of K] and dY[rows, 128 of N] as two
// 64-column swizzled blocks each, as they lie in memory: both are MN-major
// operands (the reduction runs down the rows). A last, partial stage also
// holds the next expert's first rows: its dY rows past the expert's are
// zeroed in shared memory before the products, so they add nothing. The
// epilogue writes the bf16 tile into shared memory in the same swizzled
// layout and TMA stores send it out, asynchronously; a tile of an expert
// with no rows gets its zeros by plain 16-byte stores. Two CTAs an SM.
namespace wg {
constexpr int NTW = 256, TM = 128, TN = 128, RS = 64, STG = 2;
constexpr int BLK = RS * 128;                      // a [64 rows][64] block, bytes
constexpr int STAGE = 4 * BLK;                     // xs 2 blocks, dY 2 blocks
constexpr int OUT = TM * TN * 2;                   // the bf16 tile: 2 [128][64] blocks
constexpr size_t SMEM = (size_t)STG * STAGE + OUT + 64 + 1024;
}  // namespace wg

struct WMaps {
    CUtensorMap xs, dy, dw;
};

struct WTile {
    int n0, m0, e, r0, rows;
};

__device__ __forceinline__ WTile wtile(const WArgs& a, int tile, int ntn, int ntm) {
    WTile t;
    t.n0 = (tile % ntn) * wg::TN;
    t.m0 = ((tile / ntn) % ntm) * wg::TM;
    t.e = tile / (ntn * ntm);
    t.r0 = max(0, min(a.offsets[t.e], a.M));
    t.rows = max(t.r0, min(a.offsets[t.e + 1], a.M)) - t.r0;
    return t;
}

__global__ void __launch_bounds__(wg::NTW, 2)
moe_wgrad_wgmma_kernel(const WArgs a, const __grid_constant__ WMaps mp, int ntn, int ntm,
                       int ntiles) {
    using namespace wg;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint8_t* so = sm + STG * STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(so + OUT);
    const uint32_t sbase = smem_u32(sm);
    const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;

    // thread 0's loader: stage ls of tile lt, tiles with no rows skipped
    int lt = blockIdx.x, ls = 0, issued = 0;
    WTile lw{};
    auto seek = [&]() {
        for (; lt < ntiles; lt += gridDim.x) {
            lw = wtile(a, lt, ntn, ntm);
            if (lw.rows > 0) break;
        }
    };
    auto load_next = [&]() {
        if (lt >= ntiles) return;
        const int st = issued % STG;
        uint8_t* s = sm + st * STAGE;
        mb_expect(&full[st], STAGE);
        for (int j = 0; j < 2; ++j) {
            tma_load2(s + j * BLK, &mp.xs, lw.m0 + 64 * j, lw.r0 + ls * RS, &full[st]);
            tma_load2(s + (2 + j) * BLK, &mp.dy, lw.n0 + 64 * j, lw.r0 + ls * RS, &full[st]);
        }
        ++issued;
        if (++ls * RS >= lw.rows) {
            ls = 0;
            lt += gridDim.x;
            seek();
        }
    };
    if (tid == 0) {
        for (int i = 0; i < STG; ++i) mb_init(&full[i], 1);
        mb_init_fence();
        prefetch_map(&mp.xs);
        prefetch_map(&mp.dy);
        prefetch_map(&mp.dw);
        seek();
        for (int i = 0; i < STG; ++i) load_next();
    }
    __syncthreads();

    int used = 0;                                  // stages consumed
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const WTile w = wtile(a, tile, ntn, ntm);
        if (w.rows == 0) {                         // no rows: stream zeros
            const int mrows = min(TM, a.K - w.m0), ncols = min(TN, a.N - w.n0);
            bf16* dw = static_cast<bf16*>(a.dw) + w.e * a.o_se + (int64_t)w.m0 * a.o_sk + w.n0;
            const uint4 z = make_uint4(0, 0, 0, 0);
            for (int i = tid; i < TM * (TN / 8); i += NTW) {
                const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
                if (r < mrows && c < ncols)
                    *reinterpret_cast<uint4*>(dw + (int64_t)r * a.o_sk + c) = z;
            }
            continue;
        }
        float acc[2][32];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
        const int nst = (w.rows + RS - 1) / RS;
        for (int t = 0; t < nst; ++t, ++used) {
            const int st = used % STG, left = w.rows - t * RS;
            mb_wait(&full[st], (used / STG) & 1);
            if (left < RS) {                       // dY rows of the next expert -> 0
                uint8_t* y = sm + st * STAGE + 2 * BLK;
                const uint4 z = make_uint4(0, 0, 0, 0);
                for (int i = tid; i < (RS - left) * 16; i += NTW) {
                    const int r = left + (i >> 4), c = i & 15;
                    *reinterpret_cast<uint4*>(y + sw128(r, c, RS)) = z;
                }
                fence_async_smem();
                __syncthreads();
            }
            const uint32_t ss = sbase + st * STAGE;
            const uint32_t xa = ss + wgi * BLK, yb = ss + 2 * BLK;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < RS / 16; ++kk)           // dY's two blocks at once
                wgmma_ss_mn128(*reinterpret_cast<float(*)[64]>(&acc[0][0]),
                                 desc_mn(xa + kk * 2048, BLK), desc_mn(yb + kk * 2048, BLK));
            wg_commit();
            wg_wait<0>();
            reg_fence(acc[0]);
            reg_fence(acc[1]);
            __syncthreads();                       // both warpgroups read the stage
            if (tid == 0) load_next();             // into the slot just read
        }
        // the bf16 tile in the swizzled layout, block j = columns 64 j .., rows
        // the tile's 128 K-rows, once the previous tile's store has read it
        if (tid == 0) tma_store_wait();
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
                const int row = 64 * wgi + 16 * warp + g + 8 * ((i & 3) >> 1);
                const int col = 8 * (i >> 2) + c2;
                *reinterpret_cast<__nv_bfloat162*>(so + j * (TM * 128) +
                                                   sw128(row, col >> 3, TM) + (col & 7) * 2) =
                    __floats2bfloat162_rn(acc[j][i], acc[j][i + 1]);
            }
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {                            // clipped at K and N
            for (int j = 0; j < 2; ++j)
                tma_store3(&mp.dw, so + j * (TM * 128), w.n0 + 64 * j, w.m0, w.e);
            tma_store_commit();
        }
    }
    if (tid == 0) tma_store_wait();
}

// TMA maps of xs [M, K], dY [M, N] (boxes of 64 x 64) and dW [E, K, N]
// (boxes of 64 columns x 128 rows), all 128-byte swizzled; the driver's
// encoder needs the context current on the calling thread
bool wgrad_maps(WMaps* m, const WArgs& a) {
    auto enc = tensor_map_encoder();
    if (!enc) return false;
    const cuuint32_t estr[3] = {1, 1, 1};
    auto map = [&](CUtensorMap* t, const void* p, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
        return enc(t, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    };
    const cuuint64_t xd[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M}, xs[1] = {(cuuint64_t)a.x_sm * 2};
    const cuuint64_t yd[2] = {(cuuint64_t)a.N, (cuuint64_t)a.M}, ys[1] = {(cuuint64_t)a.y_sm * 2};
    const cuuint64_t od[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K, (cuuint64_t)a.E};
    const cuuint64_t os[2] = {(cuuint64_t)a.o_sk * 2, (cuuint64_t)a.o_se * 2};
    const cuuint32_t in_box[2] = {64, 64}, out_box[3] = {64, 128, 1};
    return map(&m->xs, a.xs, 2, xd, xs, in_box) && map(&m->dy, a.dy, 2, yd, ys, in_box) &&
           map(&m->dw, a.dw, 3, od, os, out_box);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. xs [M, K] (row stride x_sm), w [E, K, N]
// (strides w_se, w_sk, w_sn: w_sn = 1, or w_sk = 1 for a transposed read),
// out [M, N] (row stride o_sm), all of dtype, with
// 16-byte aligned rows: K, N and the strides multiples of 16 bytes. offsets
// [E + 1] int32 in device memory, nondecreasing, 0 <= offsets[0] and
// offsets[E] <= M. bf16 runs the plan's form: nwg consumer warpgroups (1:
// decode, 2: bucket) and row_tiles tile slots (at least M / (64 nwg) +
// min(E, M)); fp32 ignores the two. One launch; returns its cudaError_t (0
// on success).
extern "C" int moe_gemm_launch(const void* xs, const void* w, const void* offsets,
                               void* out, int dtype, int M, int K, int N, int E,
                               int nwg, int row_tiles,
                               int64_t x_sm, int64_t w_se, int64_t w_sk,
                               int64_t w_sn, int64_t o_sm, void* stream) {
    const int vec = dtype == 1 ? 8 : 4;
    const int64_t w_row = w_sn == 1 ? w_sk : w_sn;    // the strided axis
    if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % vec || N % vec ||
        x_sm % vec || w_se % vec || w_row % vec || o_sm % vec ||
        (w_sn != 1 && w_sk != 1))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        Args a{xs, w, static_cast<const int*>(offsets), out, M, K, N, E,
               x_sm, w_se, w_sk, w_sn, o_sm};
        return launch_scalar<float>(a, s);
    }
    if (dtype != 1 || row_tiles <= 0 || row_tiles > 65535)
        return cudaErrorInvalidValue;
    FArgs a{xs, w, static_cast<const int*>(offsets), out, M, K, N, E, o_sm};
    FMaps mp;
    if (!fw_maps(&mp, a, x_sm, w_se, w_sk, w_sn, 64 * nwg) &&
        (cudaFree(nullptr) != cudaSuccess ||
         !fw_maps(&mp, a, x_sm, w_se, w_sk, w_sn, 64 * nwg)))
        return cudaErrorInvalidValue;
    return w_sn == 1 ? launch_bf16<false>(a, mp, nwg, row_tiles, s)
                     : launch_bf16<true>(a, mp, nwg, row_tiles, s);
}

// The weight gradient of moe_gemm: dw[e] = xs[lo:hi]^T dy[lo:hi] for
// offsets[e] <= r < offsets[e + 1], every element of dw [E, K, N] (strides
// o_se, o_sk, 1) written. xs [M, K] and dy [M, N] with row strides x_sm,
// y_sm; dtype and alignment as moe_gemm_launch. One launch.
extern "C" int moe_gemm_wgrad_launch(const void* xs, const void* dy,
                                     const void* offsets, void* dw, int dtype,
                                     int M, int K, int N, int E, int64_t x_sm,
                                     int64_t y_sm, int64_t o_se, int64_t o_sk,
                                     void* stream) {
    const int vec = dtype == 1 ? 8 : 4;
    if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % vec || N % vec ||
        x_sm % vec || y_sm % vec || o_se % vec || o_sk % vec)
        return cudaErrorInvalidValue;
    WArgs a{xs, dy, static_cast<const int*>(offsets), dw, M, K, N, E,
            x_sm, y_sm, o_se, o_sk};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
        moe_wgrad_kernel<float><<<grid, NT, 0, s>>>(a);
    } else if (dtype == 1) {
        WMaps mp;
        if (!wgrad_maps(&mp, a) && (cudaFree(nullptr) != cudaSuccess || !wgrad_maps(&mp, a)))
            return cudaErrorInvalidValue;
        cudaError_t err = cudaFuncSetAttribute(moe_wgrad_wgmma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)wg::SMEM);
        if (err != cudaSuccess) return err;
        // persistent: two CTAs an SM of this device
        int dev = 0, sms = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess)
            return err;
        const int ntn = (N + wg::TN - 1) / wg::TN, ntm = (K + wg::TM - 1) / wg::TM;
        const int ntiles = ntn * ntm * E;
        moe_wgrad_wgmma_kernel<<<ntiles < 2 * sms ? ntiles : 2 * sms, wg::NTW, wg::SMEM, s>>>(
            a, mp, ntn, ntm, ntiles);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

extern "C" const char* moe_gemm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
