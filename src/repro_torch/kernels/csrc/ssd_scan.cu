// Mamba-2 SSD chunk scan with an initial state, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel :23, pallas_call :84). For each (b, h) it runs, from h0 over S
// positions in chunks of Q,
//   y_t = h_t C_t,   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T
// in the chunked (state-space dual) form: inside a chunk, with cum the
// inclusive cumsum of dt A over the chunk,
//   y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j + exp(cum_i) C_i . h_in
//   h_out = exp(cum_last) h_in + st,  st = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
// x, B and C are fp32 or bf16; dt, A, h0, y and h_final are fp32.
//
// What bounds it on this card: at the main path's shapes (H = 48, P = 64,
// N = 128, Q = 256, one B/C group, bf16) a 271-token prefill moves ~8 MB
// (0.0025 ms at 3.35 TB/s) for ~0.64 GFLOP (0.0006 ms at 989 TFLOP/s):
// bytes on paper, and in practice the latency of each CTA's chain of global
// round trips and of three short launches (0.0274 ms at S = 271 in bf16,
// 0.09 of the bound, on an H100 80GB HBM3 at 700 W; PERF.md). The design:
//  - Three launches, no host synchronisation; the chunks of a head run in
//    parallel, and only the state passing is sequential.
//    1. ssd_cb_kernel, one CTA per causal 64x64 tile pair of a (batch,
//       group, chunk): C.B once per group, not once per head, into an fp32
//       scratch [B, G, nc, QP, QP] (QP = Q rounded up to 64) that stays in L2.
//    2. ssd_state_kernel, one CTA per (64 state rows p, 64 columns n, chunk,
//       batch x head): the chunk's own state st = (w o x)^T B with
//       w_j = exp(cum_last - cum_j) dt_j, into fp32 scratch [B, H, nc, P, N],
//       and the chunk's decay exp(cum_last) into [B, H, nc].
//    3. ssd_out_kernel, one CTA per (64 positions, 64 state rows p, chunk,
//       batch x head): h_in of its chunk folded from h0 and the states of the
//       chunks before it (h <- exp(cum_last) h + st: the one sequential
//       step, one round of float4 loads a chunk), then y = scores x +
//       exp(cum_i) C h_in with scores = C.B o exp(cum_i - cum_j) o dt_j,
//       masked (j <= i) before the exp; the CTA of the last chunk's first
//       tile writes h_final.
//  - Every product runs on the tensor cores, mma.sync m16n8k16 bf16 -> fp32
//    (4 warps of 16 rows a CTA; operands through ldmatrix from padded rows).
//    bf16 inputs enter as they are, so C.B is exact per product. The fp32
//    operands (scores, w o x, h_in) are split into two bf16 pieces, hi + lo
//    (~16 bits, relative error ~2^-17), one product per piece; the
//    reference's tolerance (atol 2e-4, rtol 1e-3) holds over 256-term sums.
//    With fp32 inputs every operand is split into three pieces (all 24 bits)
//    and each product keeps the six piece pairs above 2^-24, at 6x the bf16
//    products.
//  - Latency: a CTA issues all its staging at once (cp.async for bf16 rows
//    on 16 bytes, float4 loads for fp32, scalar loads for unaligned views)
//    and folds h_in while it lands; C.B is read a key block ahead. Of the
//    intra-chunk exponentials only a warp's diagonal 16 x 16 step calls exp
//    per element: below it exp(cum_i - cum_j) = exp(cum_i - cum_w) exp(cum_w
//    - cum_j), cum_w at the warp's first row, both factors at most 1, the
//    second tabled once per CTA.
//  - Groups: head h reads B and C of group h / (H / G) through their
//    strides; x, B and C may be strided views; nothing is copied or padded.
//    Ragged S: a chunk's positions past S act as dt = 0 with zero inputs.
// The fold reads the earlier chunks' states again for every chunk, O(nc^2)
// state reads, small at nc <= 4 (S <= 1024 at Q = 256).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;          // threads per CTA: 4 warps of 16 rows
constexpr int TQ = 64;           // rows of a tile: positions or state rows p
constexpr int QMAX = 256;        // chunk positions the scan holds (2 a thread)
constexpr int NMAX = 128;        // state width N the tiles hold
constexpr int NB = 64;           // state columns n per CTA of the state kernel
constexpr int LDN = NMAX + 8;    // padded bf16 row of a [*, N] tile
constexpr int LDP = TQ + 8;      // padded bf16 row of a [*, 64] tile
constexpr int LDX = TQ + 4;      // padded fp32 row of an fp32 x block
constexpr int NBLK = QMAX / TQ;  // 64-row blocks of a chunk
constexpr unsigned FULL = 0xffffffffu;
static_assert(QMAX == 2 * NT, "the chunk scan gives each thread two positions");

// bf16 pieces of an input (x, B, C) and of a computed fp32 operand
template <typename T> struct Pieces;
template <> struct Pieces<float> { static constexpr int IN = 3, MID = 3; };
template <> struct Pieces<bf16> { static constexpr int IN = 1, MID = 2; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Params {
    const void *x, *Bm, *Cm;
    const float *dt, *A, *h0;
    float *y, *hout;
    float *cb, *st, *dec;        // scratch: C.B, chunk states, chunk decays
    int S, H, G, P, N, Q, nc, QP;
    int vec;                     // x, B, C rows readable as 16-byte vectors
    int64_t x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh;
    int64_t b_sb, b_st, b_sg, c_sb, c_st, c_sg;
};

template <typename D, int NP>
__device__ __forceinline__ void put(float v, D* p, int pstride) {
    if constexpr (std::is_same<D, float>::value) *p = v;
    else split_store<NP>(v, p, pstride);
}

// TQ rows x W columns of src (row stride st, contiguous columns) into dst[r
// * LD + col]: as they are where D is T, else (fp32 into bf16) as NP bf16
// pieces pstride apart. Rows >= rows and columns >= cols are 0. With vec
// (16-byte aligned rows, stride and cols), a copy goes by cp.async (the
// caller commits and waits) and a split by float4 loads; else a thread holds
// 16 scalar loads in flight before it stores them.
template <typename T, typename D, int NP, int W, int LD>
__device__ __forceinline__ void stage(D* dst, int pstride, const T* __restrict__ src,
                                      int64_t st, int rows, int cols, bool vec) {
    if (vec) {
        constexpr int VEC = 16 / sizeof(T), CPR = W / VEC, PER = TQ * CPR / NT;
        static_assert(PER * NT == TQ * CPR, "tile split");
        if constexpr (std::is_same<T, D>::value) {
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int e = threadIdx.x + NT * k, r = e / CPR, col = (e % CPR) * VEC;
                const bool ok = r < rows && col < cols;
                cp_async16(dst + r * LD + col, ok ? src + (int64_t)r * st + col : src, ok);
            }
        } else {
            constexpr int BATCH = PER < 8 ? PER : 8;
#pragma unroll
            for (int k0 = 0; k0 < PER; k0 += BATCH) {
                float4 v[BATCH];
#pragma unroll
                for (int k = 0; k < BATCH; ++k) {
                    const int e = threadIdx.x + NT * (k0 + k), r = e / CPR, col = (e % CPR) * VEC;
                    v[k] = r < rows && col < cols
                        ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)r * st + col))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
                }
#pragma unroll
                for (int k = 0; k < BATCH; ++k) {
                    const int e = threadIdx.x + NT * (k0 + k);
                    D* d = dst + (e / CPR) * LD + (e % CPR) * VEC;
                    put<D, NP>(v[k].x, d, pstride);
                    put<D, NP>(v[k].y, d + 1, pstride);
                    put<D, NP>(v[k].z, d + 2, pstride);
                    put<D, NP>(v[k].w, d + 3, pstride);
                }
            }
        }
        return;
    }
    constexpr int PER = TQ * W / NT, BATCH = 16;
    static_assert(PER % BATCH == 0, "tile split");
#pragma unroll
    for (int k0 = 0; k0 < PER; k0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            const int e = threadIdx.x + NT * (k0 + k), r = e / W, col = e % W;
            v[k] = (r < rows && col < cols) ? to_f(__ldg(src + (int64_t)r * st + col)) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            const int e = threadIdx.x + NT * (k0 + k);
            put<D, NP>(v[k], dst + (e / W) * LD + e % W, pstride);
        }
    }
}

// dt of the chunk's positions [t0, t0 + L) into sDt (0 past L) and the
// inclusive cumsum of dt A into sCum, over QMAX positions
__device__ void chunk_scan(float* sDt, float* sCum, float* red, const float* dtb,
                           int64_t dt_st, int t0, int L, float A) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j = 2 * tid;
    const float d0 = j < L ? dtb[(int64_t)(t0 + j) * dt_st] : 0.f;
    const float d1 = j + 1 < L ? dtb[(int64_t)(t0 + j + 1) * dt_st] : 0.f;
    const float v0 = d0 * A, v1 = v0 + d1 * A;
    float s = v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += n;
    }
    float ex = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) ex = 0.f;
    if (lane == 31) red[warp] = s;
    __syncthreads();
    for (int w = 0; w < warp; ++w) ex += red[w];
    sDt[j] = d0;
    sDt[j + 1] = d1;
    sCum[j] = ex + v0;
    sCum[j + 1] = ex + v1;
    __syncthreads();
}

// 1. C.B of the causal tile pair (ti, tj <= ti) of chunk blockIdx.y of
// (batch, group) blockIdx.z
template <typename T>
__global__ void __launch_bounds__(NT) ssd_cb_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN;
    extern __shared__ uint4 smem_u4[];
    bf16* sC = reinterpret_cast<bf16*>(smem_u4);   // [NI][TQ][LDN]
    bf16* sB = sC + NI * TQ * LDN;                 // [NI][TQ][LDN]

    int ti = 0, tj = blockIdx.x;
    while (tj > ti) tj -= ++ti;
    const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, g = bg % a.G;
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0);
    if (ti * TQ >= L) return;                      // rows no later launch reads
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    const T* Cb = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)(t0 + ti * TQ) * a.c_st;
    const T* Bb = (const T*)a.Bm + b * a.b_sb + g * a.b_sg + (int64_t)(t0 + tj * TQ) * a.b_st;
    stage<T, bf16, NI, NMAX, LDN>(sC, TQ * LDN, Cb, a.c_st, L - ti * TQ, a.N, a.vec);
    stage<T, bf16, NI, NMAX, LDN>(sB, TQ * LDN, Bb, a.b_st, L - tj * TQ, a.N, a.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
    const int nk = (a.N + 15) / 16;
    for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[NI][4];
#pragma unroll
        for (int p = 0; p < NI; ++p)
            ldsm_x4(af[p], sC + p * TQ * LDN + a_row * LDN + kk * 16 + a_col);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
            uint32_t bf[NI][4];
#pragma unroll
            for (int p = 0; p < NI; ++p)
                ldsm_x4(bf[p], sB + p * TQ * LDN + (16 * jp + b_row) * LDN + kk * 16 + b_col);
            mma_pieces<NI, NI>(acc[2 * jp], af, bf, 0);
            mma_pieces<NI, NI>(acc[2 * jp + 1], af, bf, 2);
        }
    }
    float* out = a.cb + ((int64_t)(bg * a.nc + c) * a.QP + ti * TQ) * a.QP + tj * TQ;
    const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(out + (int64_t)r0 * a.QP + n * 8 + c2) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(out + (int64_t)(r0 + 8) * a.QP + n * 8 + c2) =
            make_float2(acc[n][2], acc[n][3]);
    }
}

// 2. the chunk's own state st[p, n] = sum_j w_j x[j, p] B[j, n] for 64 rows p
// and 64 columns n (blockIdx.x), chunk blockIdx.y, (batch, head) blockIdx.z.
// Every 64-row block of B and x is staged at once, x as it is (w o x is
// formed in the A fragments).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_state_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    constexpr int LXR = std::is_same<T, bf16>::value ? LDP : LDX;   // raw x row
    extern __shared__ uint4 smem_u4[];
    bf16* sB = reinterpret_cast<bf16*>(smem_u4);                 // [NBLK][NI][TQ][LDP]
    T* sX = reinterpret_cast<T*>(sB + NBLK * NI * TQ * LDP);     // [NBLK][TQ][LXR]
    float* sW = reinterpret_cast<float*>(sX + NBLK * TQ * LXR);  // [QMAX]
    float* sCum = sW + QMAX;                                     // [QMAX]
    __shared__ float red[4];

    const int npb = (a.P + TQ - 1) / TQ;
    const int p0 = (blockIdx.x % npb) * TQ, n0 = (blockIdx.x / npb) * NB;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
    const int g = h / (a.H / a.G);
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0);
    const int nblk = (L + TQ - 1) / TQ;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    const T* xb = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)t0 * a.x_st + p0;
    const T* Bb = (const T*)a.Bm + b * a.b_sb + g * a.b_sg + (int64_t)t0 * a.b_st + n0;
    for (int k = 0; k < nblk; ++k) {
        stage<T, bf16, NI, NB, LDP>(sB + k * NI * TQ * LDP, TQ * LDP,
                                    Bb + (int64_t)k * TQ * a.b_st, a.b_st,
                                    L - k * TQ, a.N - n0, a.vec);
        stage<T, T, 1, TQ, LXR>(sX + k * TQ * LXR, 0, xb + (int64_t)k * TQ * a.x_st,
                                a.x_st, L - k * TQ, a.P - p0, a.vec);
    }
    cp_async_commit();

    chunk_scan(sW, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, a.A[h]);
    const float cum_last = sCum[L - 1];
    if (blockIdx.x == 0 && tid == 0) a.dec[(int64_t)bh * a.nc + c] = expf(cum_last);
    for (int j = tid; j < QMAX; j += NT)
        sW[j] = j < L ? expf(cum_last - sCum[j]) * sW[j] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    const int gr = lane >> 2, c2 = 2 * (lane & 3);
    if (p0 + warp * 16 >= a.P) return;
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int k = 0; k < nblk; ++k) {
        const bf16* bk = sB + k * NI * TQ * LDP;
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            const int j = k * TQ + kk * 16 + c2;   // this lane's columns j, j+1, j+8, j+9
            if (j - c2 >= L) break;
            // A = (w o x)^T: rows p, columns j, as NM pieces
            const T* xk = sX + (k * TQ + kk * 16 + c2) * LXR + warp * 16 + gr;
            const float w0 = sW[j], w1 = sW[j + 1], w8 = sW[j + 8], w9 = sW[j + 9];
            uint32_t af[NM][4];
            split_pack<NM>(w0 * to_f(xk[0]), w1 * to_f(xk[LXR]), af, 0);
            split_pack<NM>(w0 * to_f(xk[8]), w1 * to_f(xk[LXR + 8]), af, 1);
            split_pack<NM>(w8 * to_f(xk[8 * LXR]), w9 * to_f(xk[9 * LXR]), af, 2);
            split_pack<NM>(w8 * to_f(xk[8 * LXR + 8]), w9 * to_f(xk[9 * LXR + 8]), af, 3);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bf[NI][4];
#pragma unroll
                for (int p = 0; p < NI; ++p)
                    ldsm_x4_trans(bf[p], bk + p * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NI>(acc[2 * np], af, bf, 0);
                mma_pieces<NM, NI>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    float* out = a.st + ((int64_t)bh * a.nc + c) * a.P * a.N;
    const int p = p0 + warp * 16 + gr;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + nt * 8 + c2;
        if (n >= a.N) break;
        *reinterpret_cast<float2*>(out + (int64_t)p * a.N + n) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (int64_t)(p + 8) * a.N + n) = make_float2(acc[nt][2], acc[nt][3]);
    }
}

// 3. y of 64 positions (blockIdx.x / npb) and 64 state rows p (blockIdx.x %
// npb) of chunk blockIdx.y, (batch, head) blockIdx.z; h_final from the CTA
// of the last chunk's first tile
template <typename T>
__global__ void __launch_bounds__(NT) ssd_out_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    extern __shared__ uint4 smem_u4[];
    bf16* sC = reinterpret_cast<bf16*>(smem_u4);   // [NI][TQ][LDN]  C rows of the tile
    bf16* sH = sC + NI * TQ * LDN;                 // [NM][TQ][LDN]  h_in, rows p
    bf16* sX = sH + NM * TQ * LDN;                 // [NBLK][NI][TQ][LDP]  x blocks
    float* sDt = reinterpret_cast<float*>(sX + NBLK * NI * TQ * LDP);  // [QMAX]
    float* sCum = sDt + QMAX;                      // [QMAX]
    float* sCw = sCum + QMAX;                      // [4 warps][QMAX]
    __shared__ float red[4];

    const int npb = (a.P + TQ - 1) / TQ;
    const int it = blockIdx.x / npb, p0 = (blockIdx.x % npb) * TQ;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
    const int g = h / (a.H / a.G);
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0);
    const int i0 = it * TQ;
    if (i0 >= L) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float A = a.A[h];
    const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;

    // the tile's C rows and the x blocks j0 <= i0, in flight while h_in is
    // folded
    const T* Cb = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)(t0 + i0) * a.c_st;
    stage<T, bf16, NI, NMAX, LDN>(sC, TQ * LDN, Cb, a.c_st, L - i0, a.N, a.vec);
    const T* xb = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)t0 * a.x_st + p0;
    for (int k = 0; k <= it; ++k)
        stage<T, bf16, NI, TQ, LDP>(sX + k * NI * TQ * LDP, TQ * LDP,
                                    xb + (int64_t)k * TQ * a.x_st, a.x_st, L - k * TQ,
                                    a.P - p0, a.vec);
    cp_async_commit();

    // h_in of this chunk, h0 folded with the states of the chunks before
    // it, in registers: this thread's elements are columns 4 q4 .. 4 q4 + 3
    // of rows p0 + rg + RS k, read as float4
    constexpr int N4 = NMAX / 4, RS = NT / N4, PE = TQ / RS;
    const int q4 = tid % N4, rg = tid / N4;
    const float* st_bh = a.st + (int64_t)bh * a.nc * a.P * a.N + 4 * q4;
    const float* h0 = a.h0 + (int64_t)bh * a.P * a.N + 4 * q4;
    const bool col_live = 4 * q4 < a.N;
    const int prow = min(TQ, a.P - p0);            // live rows p of this CTA
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    auto row_of = [&](int k) { return (int64_t)(p0 + rg + RS * k) * a.N; };
    auto live = [&](int k) { return col_live && rg + RS * k < prow; };
    float4 hv[PE];
#pragma unroll
    for (int k = 0; k < PE; ++k)
        hv[k] = live(k) ? __ldg(reinterpret_cast<const float4*>(h0 + row_of(k))) : zero4;
    for (int kc = 0; kc < c; ++kc) {
        const float dec = __ldcg(a.dec + (int64_t)bh * a.nc + kc);
        const float* stk = st_bh + (int64_t)kc * a.P * a.N;
        float4 sv[PE];
#pragma unroll
        for (int k = 0; k < PE; ++k)
            sv[k] = live(k) ? __ldcg(reinterpret_cast<const float4*>(stk + row_of(k))) : zero4;
#pragma unroll
        for (int k = 0; k < PE; ++k) {
            hv[k].x = dec * hv[k].x + sv[k].x;
            hv[k].y = dec * hv[k].y + sv[k].y;
            hv[k].z = dec * hv[k].z + sv[k].z;
            hv[k].w = dec * hv[k].w + sv[k].w;
        }
    }
    chunk_scan(sDt, sCum, red, dtb, a.dt_st, t0, L, A);
    // exp(cum_i - cum_j) = exp(cum_i - cum_w) exp(cum_w - cum_j), with cum_w
    // at warp w's first row w0: for j < w0 <= i both factors are at most 1,
    // so neither overflows, and one that underflows leaves a product below
    // fp32's range. sCw[w][j] = exp(cum_w - cum_j) dt_j for j < w0.
    for (int e = tid; e < 4 * QMAX; e += NT) {
        const int w0 = i0 + 16 * (e / QMAX), j = e % QMAX;
        sCw[e] = j < w0 ? expf(sCum[w0] - sCum[j]) * sDt[j] : 0.f;
    }
    if (it == 0 && c == a.nc - 1) {                // h_final = exp(cum_last) h_in + st
        const float dec = expf(sCum[L - 1]);
        const float* stc = st_bh + (int64_t)c * a.P * a.N;
        float* hout = a.hout + (int64_t)bh * a.P * a.N + 4 * q4;
        float4 sv[PE];
#pragma unroll
        for (int k = 0; k < PE; ++k)
            sv[k] = live(k) ? __ldcg(reinterpret_cast<const float4*>(stc + row_of(k))) : zero4;
#pragma unroll
        for (int k = 0; k < PE; ++k)
            if (live(k))
                *reinterpret_cast<float4*>(hout + row_of(k)) = make_float4(
                    dec * hv[k].x + sv[k].x, dec * hv[k].y + sv[k].y,
                    dec * hv[k].z + sv[k].z, dec * hv[k].w + sv[k].w);
    }
#pragma unroll
    for (int k = 0; k < PE; ++k) {
        bf16* d = sH + (rg + RS * k) * LDN + 4 * q4;
        split_store<NM>(hv[k].x, d, TQ * LDN);
        split_store<NM>(hv[k].y, d + 1, TQ * LDN);
        split_store<NM>(hv[k].z, d + 2, TQ * LDN);
        split_store<NM>(hv[k].w, d + 3, TQ * LDN);
    }

    // this lane's C.B values of a key block (rows ir, ir + 8, columns j, j+1
    // of each 16-column step kk and half), read a block ahead
    const int gr = lane >> 2, c2 = 2 * (lane & 3);
    const int ir = i0 + warp * 16 + gr;            // this lane's rows ir, ir + 8
    const float* cbt = a.cb + (int64_t)(b * a.G + g) * a.nc * a.QP * a.QP
                     + ((int64_t)c * a.QP + ir) * a.QP;
    float2 cbv[TQ / 16][2][2];
    auto load_cb = [&](int j0, float2 (&v)[TQ / 16][2][2]) {
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = j0 + kk * 16 + c2 + 8 * half;
                v[kk][half][0] = __ldg(reinterpret_cast<const float2*>(cbt + j));
                v[kk][half][1] = __ldg(reinterpret_cast<const float2*>(cbt + 8 * a.QP + j));
            }
    };
    load_cb(0, cbv);
    cp_async_wait<0>();
    __syncthreads();

    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

    // inter-chunk part: C_i . h_in (exp(cum_i) applied at the end)
    float ye[8][4], ya[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        ye[n][0] = ye[n][1] = ye[n][2] = ye[n][3] = 0.f;
        ya[n][0] = ya[n][1] = ya[n][2] = ya[n][3] = 0.f;
    }
    const int nk = (a.N + 15) / 16;
    for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[NI][4];
#pragma unroll
        for (int p = 0; p < NI; ++p)
            ldsm_x4(af[p], sC + p * TQ * LDN + a_row * LDN + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t bf[NM][4];
#pragma unroll
            for (int p = 0; p < NM; ++p)
                ldsm_x4(bf[p], sH + p * TQ * LDN + (16 * np + b_row) * LDN + kk * 16 + b_col);
            mma_pieces<NI, NM>(ye[2 * np], af, bf, 0);
            mma_pieces<NI, NM>(ye[2 * np + 1], af, bf, 2);
        }
    }

    // intra-chunk part: scores x over the key blocks j0 <= i0
    const int i_last = i0 + warp * 16 + 15;        // the warp's last row
    const float cum_r0 = sCum[ir], cum_r1 = sCum[ir + 8];
    const int w0 = i0 + warp * 16;
    const float rw0 = expf(cum_r0 - sCum[w0]), rw1 = expf(cum_r1 - sCum[w0]);
    const float* cw = sCw + warp * QMAX;
    for (int j0 = 0; j0 <= i0; j0 += TQ) {
        float2 cur[TQ / 16][2][2];
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                cur[kk][half][0] = cbv[kk][half][0];
                cur[kk][half][1] = cbv[kk][half][1];
            }
        if (j0 + TQ <= i0) load_cb(j0 + TQ, cbv);
        const bf16* xk = sX + (j0 / TQ) * NI * TQ * LDP;
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            const int jk = j0 + kk * 16;
            if (jk > i_last || jk >= L) break;
            uint32_t af[NM][4];
            if (jk < w0) {                 // columns before the warp's rows
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = jk + c2 + 8 * half;
                    const float2 v0 = cur[kk][half][0], v1 = cur[kk][half][1];
                    const float2 f = *reinterpret_cast<const float2*>(cw + j);
                    split_pack<NM>(v0.x * rw0 * f.x, v0.y * rw0 * f.y, af, 2 * half);
                    split_pack<NM>(v1.x * rw1 * f.x, v1.y * rw1 * f.y, af, 2 * half + 1);
                }
            } else {                       // the warp's diagonal 16 x 16 step
#pragma unroll
                for (int half = 0; half < 2; ++half) {       // columns jk + c2 (+8)
                    const int j = jk + c2 + 8 * half;
                    const float2 v0 = cur[kk][half][0], v1 = cur[kk][half][1];
                    const float d0 = sDt[j], d1 = sDt[j + 1];
                    const float m0 = sCum[j], m1 = sCum[j + 1];
                    // mask before exp: j > i would overflow
                    const float s00 = j <= ir ? v0.x * expf(cum_r0 - m0) * d0 : 0.f;
                    const float s01 = j + 1 <= ir ? v0.y * expf(cum_r0 - m1) * d1 : 0.f;
                    const float s10 = j <= ir + 8 ? v1.x * expf(cum_r1 - m0) * d0 : 0.f;
                    const float s11 = j + 1 <= ir + 8 ? v1.y * expf(cum_r1 - m1) * d1 : 0.f;
                    split_pack<NM>(s00, s01, af, 2 * half);
                    split_pack<NM>(s10, s11, af, 2 * half + 1);
                }
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bf[NI][4];
#pragma unroll
                for (int p = 0; p < NI; ++p)
                    ldsm_x4_trans(bf[p], xk + p * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NI>(ya[2 * np], af, bf, 0);
                mma_pieces<NM, NI>(ya[2 * np + 1], af, bf, 2);
            }
        }
    }

    const float e0 = expf(cum_r0), e1 = expf(cum_r1);
    const int64_t y_st = (int64_t)a.H * a.P;
    float* yb = a.y + ((int64_t)b * a.S + t0) * y_st + (int64_t)h * a.P + p0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const int p = n * 8 + c2;
        if (p0 + p >= a.P) break;
        if (ir < L)
            *reinterpret_cast<float2*>(yb + ir * y_st + p) =
                make_float2(ya[n][0] + e0 * ye[n][0], ya[n][1] + e0 * ye[n][1]);
        if (ir + 8 < L)
            *reinterpret_cast<float2*>(yb + (ir + 8) * y_st + p) =
                make_float2(ya[n][2] + e1 * ye[n][2], ya[n][3] + e1 * ye[n][3]);
    }
}

template <typename T>
struct Smem {
    static constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    static constexpr int LXR = std::is_same<T, bf16>::value ? LDP : LDX;
    static constexpr int CB = 2 * NI * TQ * LDN * (int)sizeof(bf16);
    static constexpr int STATE = NBLK * NI * TQ * LDP * (int)sizeof(bf16)
                               + NBLK * TQ * LXR * (int)sizeof(T)
                               + 2 * QMAX * (int)sizeof(float);
    static constexpr int OUT = ((NI + NM) * TQ * LDN + NBLK * NI * TQ * LDP) * (int)sizeof(bf16)
                             + 6 * QMAX * (int)sizeof(float);
};

template <typename T>
cudaError_t launch(const Params& a, int B, cudaStream_t stream) {
    using M = Smem<T>;
    static bool ready = false;         // the shared-memory opt-in, once
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(
            ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::CB);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::STATE);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_out_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::OUT);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    const int nt = (a.Q + TQ - 1) / TQ, npb = (a.P + TQ - 1) / TQ;
    const int nnb = (a.N + NB - 1) / NB;
    ssd_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, a.nc, B * a.G), NT, M::CB, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_state_kernel<T><<<dim3(npb * nnb, a.nc, B * a.H), NT, M::STATE, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_out_kernel<T><<<dim3(nt * npb, a.nc, B * a.H), NT, M::OUT, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16. x is [B, S, H, P], dt
// [B, S, H] (fp32, post-softplus), B and C [B, S, G, N] with G dividing H,
// each with a contiguous last axis and the strides given (in elements).
// A [H], h0 [B, H, P, N], y [B, S, H, P] and hout [B, H, P, N] are
// contiguous fp32, h0 on 16 bytes. scratch holds, in fp32, C.B [B, G, nc,
// QP, QP], the chunks' states [B, H, nc, P, N] and their decays [B, H, nc]
// (nc = ceil(S / Q), QP = Q rounded up to 64). P must be a multiple of 16,
// N a multiple of 4 up to 128, Q (the chunk length) at most 256; vec says
// that x, B and C rows may be read as 16-byte vectors. Three launches;
// returns the first cudaError_t (0 on success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, void* y, void* hout, void* scratch,
    int dtype, int B, int S, int H, int G, int P, int N, int Q, int vec,
    int64_t x_sb, int64_t x_st, int64_t x_sh,
    int64_t dt_sb, int64_t dt_st, int64_t dt_sh,
    int64_t b_sb, int64_t b_st, int64_t b_sg,
    int64_t c_sb, int64_t c_st, int64_t c_sg, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 ||
        N <= 0 || N > NMAX || N % 4 || Q <= 0 || Q > QMAX)
        return cudaErrorInvalidValue;
    const int nc = (S + Q - 1) / Q, QP = (Q + TQ - 1) / TQ * TQ;
    float* cb = (float*)scratch;
    float* st = cb + (int64_t)B * G * nc * QP * QP;
    Params a{x, Bm, Cm, (const float*)dt, (const float*)A, (const float*)h0,
             (float*)y, (float*)hout, cb, st, st + (int64_t)B * H * nc * P * N,
             S, H, G, P, N, Q, nc, QP, vec,
             x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh,
             b_sb, b_st, b_sg, c_sb, c_st, c_sg};
    if (dtype == 0) return launch<float>(a, B, (cudaStream_t)stream);
    if (dtype == 1) return launch<bf16>(a, B, (cudaStream_t)stream);
    return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
