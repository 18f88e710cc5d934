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
//
// The backward (ssd_scan_bwd_launch; no TPU kernel has one: the reference
// trains through JAX's autodiff of src/repro/models/ssm.py::_ssd_scan :90)
// is the chunked form's own gradient, as arXiv:2405.21060 sec. 6-7 and
// mamba_ssm/ops/triton/ssd_combined.py (state-spaces/mamba) lay it out. Per
// (b, h) and chunk, L_ij = exp(cum_i - cum_j) (i >= j), G_c the gradient of
// the state entering chunk c (G_nc = dh_final), dM_ij = dy_i . x_j:
//   U_c = sum_i exp(cum_i) dy_i C_i^T,  G_c = exp(cum_last) G_{c+1} + U_c,  dh0 = G_0
//   dx_j = sum_{i>=j} (C_i . B_j) L_ij dt_j dy_i + w_j G_{c+1} B_j
//   dC_i = sum_{j<=i} dM_ij L_ij dt_j B_j + exp(cum_i) h_in^T dy_i
//   dB_j = sum_{i>=j} dM_ij L_ij dt_j C_i + w_j G_{c+1}^T x_j
// and d(dt), dA through dcum, summed from the end of each chunk. Six
// launches: U (the state kernel on dy and C); the fold (h_in forward from
// the forward's chunk states, G backward); dC, dB and dx, each a CTA per
// 64-position tile (dC and dB also per 64 columns of N, dx per 64 of P)
// that recomputes dM over P on mma.sync with the forward's piece split;
// and a last launch for dcum, d(dt) and dA (a CTA per head, its batches
// and chunks in order) and for dB and dC summed over a group's heads. No
// atomics: per-head parts go to fp32 scratch and are summed in a fixed
// order, so two calls give the same bits. What bounds it: at mamba2-780m's
// training shape (S = 1024, bf16) ~30 MB and ~8.1 GFLOP, 0.0089 ms at 3.35
// TB/s; it takes 0.385 ms on an H100 80GB HBM3 at 700 W (PERF.md),
// latency-bound: the dC and dB kernels hold 255 registers (two CTAs an SM)
// and stage, wait and compute one tile pair at a time.

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
    // the backward's (ssd_scan_bwd_launch; unset in the forward): dy and
    // dh_final in, the gradients out, and its fp32 scratch
    const float *dy, *dhf;
    void *dx, *dB, *dC;
    float *ddt, *dA, *dh0;
    float *U, *hin, *gn, *dbh, *dch, *rsum, *ddtd, *xT, *dotp;
    int Bsz, npb, nnb, parts;    // batch; 64-row blocks of P and of N; fold CTAs a state
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
// formed in the A fragments). With BWD the same product gives the
// backward's U[p, n] = sum_i exp(cum_i) dy[i, p] C[i, n]: dy (fp32) in
// place of x, C in place of B.
template <typename T, bool BWD>
__global__ void __launch_bounds__(NT) ssd_state_kernel(Params a) {
    using TX = typename std::conditional<BWD, float, T>::type;   // x, or dy
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    constexpr int LXR = std::is_same<TX, bf16>::value ? LDP : LDX;   // raw x row
    extern __shared__ uint4 smem_u4[];
    bf16* sB = reinterpret_cast<bf16*>(smem_u4);                 // [NBLK][NI][TQ][LDP]
    TX* sX = reinterpret_cast<TX*>(sB + NBLK * NI * TQ * LDP);   // [NBLK][TQ][LXR]
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

    const TX* xb;
    const T* Bb;
    int64_t xst, bst;
    if constexpr (BWD) {              // dy is contiguous [B, S, H, P]
        xst = (int64_t)a.H * a.P;
        xb = a.dy + ((int64_t)b * a.S + t0) * xst + (int64_t)h * a.P + p0;
        bst = a.c_st;
        Bb = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)t0 * bst + n0;
    } else {
        xst = a.x_st;
        xb = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)t0 * xst + p0;
        bst = a.b_st;
        Bb = (const T*)a.Bm + b * a.b_sb + g * a.b_sg + (int64_t)t0 * bst + n0;
    }
    for (int k = 0; k < nblk; ++k) {
        stage<T, bf16, NI, NB, LDP>(sB + k * NI * TQ * LDP, TQ * LDP,
                                    Bb + (int64_t)k * TQ * bst, bst,
                                    L - k * TQ, a.N - n0, a.vec);
        stage<TX, TX, 1, TQ, LXR>(sX + k * TQ * LXR, 0, xb + (int64_t)k * TQ * xst,
                                  xst, L - k * TQ, a.P - p0, BWD || a.vec);
    }
    cp_async_commit();

    chunk_scan(sW, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, a.A[h]);
    const float cum_last = sCum[L - 1];
    if (!BWD && blockIdx.x == 0 && tid == 0) a.dec[(int64_t)bh * a.nc + c] = expf(cum_last);
    for (int j = tid; j < QMAX; j += NT)
        sW[j] = j >= L ? 0.f : BWD ? expf(sCum[j]) : expf(cum_last - sCum[j]) * sW[j];
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
            const TX* xk = sX + (k * TQ + kk * 16 + c2) * LXR + warp * 16 + gr;
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
    float* out = (BWD ? a.U : a.st) + ((int64_t)bh * a.nc + c) * a.P * a.N;
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

// ---- the backward (ssd_scan_bwd_launch) ------------------------------------

constexpr int FOLD_E = 8 * NT;       // state elements a fold CTA carries
constexpr int LDC = TQ + 4;          // fp32 row of a staged C.B tile

// the sum of v over the CTA, in a fixed order, to every thread; buf[4]
// shared, free again on return
__device__ __forceinline__ float block_sum(float v, float* buf) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
    __syncthreads();
    const float s = (buf[0] + buf[1]) + (buf[2] + buf[3]);
    __syncthreads();
    return s;
}

// the sum over the 4 lanes of a quad (a row of an mma fragment)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(FULL, v, 1);
    return v + __shfl_xor_sync(FULL, v, 2);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
    if constexpr (std::is_same<T, float>::value) *reinterpret_cast<float2*>(p) = make_float2(x, y);
    else *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the C.B tile of rows i0.., columns j0.. of a chunk (row stride QP) into
// sCB [TQ][LDC] by cp.async (the caller commits and waits)
__device__ __forceinline__ void stage_cb(float* sCB, const float* cbt, int64_t QP) {
    for (int e = threadIdx.x; e < TQ * TQ / 4; e += NT) {
        const int r = e / (TQ / 4), col = (e % (TQ / 4)) * 4;
        cp_async16(sCB + r * LDC + col, cbt + r * QP + col, true);
    }
}

// 5. per (batch, head) and FOLD_E elements of the [P, N] state (blockIdx.x):
// h_in of every chunk, folded forward from h0 and the forward's chunk states
// and decays (the forward's fold, kept); then G walked back from dh_final,
// G_c = exp(cum_last,c) G_{c+1} + U_c, writing G_{c+1} of each chunk into gn
// and G_0 into dh0; and per chunk this block's share of exp(cum_last)
// <G_{c+1}, h_in>, the last position's dcum term of the state passing
__global__ void __launch_bounds__(NT) ssd_fold_kernel(Params a) {
    __shared__ float red[4];
    const int bh = blockIdx.y, tid = threadIdx.x;
    const int64_t PN = (int64_t)a.P * a.N, base = (int64_t)bh * a.nc * PN;
    int64_t e[2];
    bool ok[2];
    float4 hv[2], gv[2];
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        e[k] = (int64_t)blockIdx.x * FOLD_E + 4 * (tid + NT * k);
        ok[k] = e[k] < PN;
        hv[k] = ok[k] ? __ldg(reinterpret_cast<const float4*>(a.h0 + bh * PN + e[k])) : zero4;
        gv[k] = ok[k] && a.dhf ? __ldg(reinterpret_cast<const float4*>(a.dhf + bh * PN + e[k]))
                               : zero4;
    }
    for (int c = 0; c < a.nc; ++c) {
        const float dec = __ldg(a.dec + (int64_t)bh * a.nc + c);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (!ok[k]) continue;
            const int64_t o = base + c * PN + e[k];
            *reinterpret_cast<float4*>(a.hin + o) = hv[k];
            const float4 s = __ldg(reinterpret_cast<const float4*>(a.st + o));
            hv[k] = make_float4(dec * hv[k].x + s.x, dec * hv[k].y + s.y,
                                dec * hv[k].z + s.z, dec * hv[k].w + s.w);
        }
    }
    for (int c = a.nc - 1; c >= 0; --c) {
        const float dec = __ldg(a.dec + (int64_t)bh * a.nc + c);
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (!ok[k]) continue;
            const int64_t o = base + c * PN + e[k];
            *reinterpret_cast<float4*>(a.gn + o) = gv[k];
            const float4 hi = *reinterpret_cast<const float4*>(a.hin + o);   // this thread's
            dot += gv[k].x * hi.x + gv[k].y * hi.y + gv[k].z * hi.z + gv[k].w * hi.w;
            const float4 u = __ldg(reinterpret_cast<const float4*>(a.U + o));
            gv[k] = make_float4(dec * gv[k].x + u.x, dec * gv[k].y + u.y,
                                dec * gv[k].z + u.z, dec * gv[k].w + u.w);
        }
        dot = block_sum(dot, red);
        if (tid == 0) a.dotp[((int64_t)bh * a.nc + c) * a.parts + blockIdx.x] = dec * dot;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
        if (ok[k]) *reinterpret_cast<float4*>(a.dh0 + bh * PN + e[k]) = gv[k];
}

// 6. dC of one head for the 64 positions i of tile blockIdx.x / nnb and the
// 64 columns n of block blockIdx.x % nnb, chunk blockIdx.y, (batch, head)
// blockIdx.z, into fp32 scratch dch (the last launch sums a group's heads),
// and each position's row part of dcum:
//   dC_i = sum_{j<=i} V_ij B_j + exp(cum_i) h_in^T dy_i,
//   V_ij = (dy_i . x_j) exp(cum_i - cum_j) dt_j,
//   rsum_i = sum_j V_ij (C_i . B_j) + C_i . exp(cum_i) h_in^T dy_i,
// the first term from n block 0, the second from each block into its own
// slot. dy . x is taken over P in 64-wide blocks; V is formed in registers.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dc_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    extern __shared__ uint4 smem_u4[];
    bf16* sDy = reinterpret_cast<bf16*>(smem_u4);  // [NM][TQ][LDP] dy rows i, a p block
    bf16* sX = sDy + NM * TQ * LDP;                 // [NI][TQ][LDP] x rows j, a p block
    bf16* sH = sX + NI * TQ * LDP;                  // [NM][TQ][LDP] h_in rows p, the n block
    bf16* sB = sH + NM * TQ * LDP;                  // [NI][TQ][LDP] B rows j, the n block
    bf16* sC = sB + NI * TQ * LDP;                  // [NI][TQ][LDP] C rows i, the n block
    float* sDt = reinterpret_cast<float*>(sC + NI * TQ * LDP);   // [QMAX]
    float* sCum = sDt + QMAX;                                    // [QMAX]
    __shared__ float red[4];

    const int it = blockIdx.x / a.nnb, nb = blockIdx.x % a.nnb, n0 = nb * NB;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
    const int g = h / (a.H / a.G);
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0), i0 = it * TQ;
    if (i0 >= L) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, c2 = 2 * (lane & 3);
    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
    const int npb = a.npb, ncol = min(NB, a.N - n0), nkn = (ncol + 15) / 16;
    const int64_t hp = (int64_t)a.H * a.P, PN = (int64_t)a.P * a.N;
    const float* dyi = a.dy + ((int64_t)b * a.S + t0 + i0) * hp + (int64_t)h * a.P;
    const T* xb = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)t0 * a.x_st;
    const T* Bb = (const T*)a.Bm + b * a.b_sb + g * a.b_sg + (int64_t)t0 * a.b_st + n0;
    const T* Ci = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)(t0 + i0) * a.c_st + n0;
    const float* hin = a.hin + ((int64_t)bh * a.nc + c) * PN + n0;

    stage<T, bf16, NI, TQ, LDP>(sC, TQ * LDP, Ci, a.c_st, L - i0, ncol, a.vec);
    chunk_scan(sDt, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, a.A[h]);

    // inter-chunk part: dy_i h_in over P (exp(cum_i) applied below)
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int pb = 0; pb < npb; ++pb) {
        const int p0 = pb * TQ;
        if (pb) __syncthreads();
        stage<float, bf16, NM, TQ, LDP>(sDy, TQ * LDP, dyi + p0, hp, L - i0, a.P - p0, true);
        stage<float, bf16, NM, TQ, LDP>(sH, TQ * LDP, hin + (int64_t)p0 * a.N, a.N, a.P - p0,
                                        ncol, true);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int nkp = min(TQ, a.P - p0) / 16;
        for (int kk = 0; kk < nkp; ++kk) {
            uint32_t af[NM][4];
#pragma unroll
            for (int q = 0; q < NM; ++q)
                ldsm_x4(af[q], sDy + q * TQ * LDP + a_row * LDP + kk * 16 + a_col);
#pragma unroll
            for (int np = 0; np < NB / 16; ++np) {
                if (np >= nkn) break;
                uint32_t bf[NM][4];
#pragma unroll
                for (int q = 0; q < NM; ++q)
                    ldsm_x4_trans(bf[q], sH + q * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NM>(acc[2 * np], af, bf, 0);
                mma_pieces<NM, NM>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    // rows r0, r0 + 8 of the tile are this lane's: C_i . (h_in^T dy_i) over
    // the block's columns, then exp(cum_i) on the row
    const int r0 = warp * 16 + gr, ir = i0 + r0;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + c2;
        if (n >= ncol) break;
        float cv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NI; ++q) {
            const bf16* sp = sC + q * TQ * LDP + r0 * LDP + n;
            cv[0] += __bfloat162float(sp[0]);
            cv[1] += __bfloat162float(sp[1]);
            cv[2] += __bfloat162float(sp[8 * LDP]);
            cv[3] += __bfloat162float(sp[8 * LDP + 1]);
        }
        q0 += acc[nt][0] * cv[0] + acc[nt][1] * cv[1];
        q1 += acc[nt][2] * cv[2] + acc[nt][3] * cv[3];
    }
    const float e0 = ir < L ? expf(sCum[ir]) : 0.f, e1 = ir + 8 < L ? expf(sCum[ir + 8]) : 0.f;
    q0 = e0 * quad_sum(q0);
    q1 = e1 * quad_sum(q1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        acc[n][0] *= e0; acc[n][1] *= e0; acc[n][2] *= e1; acc[n][3] *= e1;
    }

    // intra-chunk part over the key tiles j0 <= i0
    const float cum0 = sCum[ir], cum1 = sCum[ir + 8];
    const float* cbt = a.cb + ((int64_t)(b * a.G + g) * a.nc + c) * a.QP * a.QP
                     + (int64_t)ir * a.QP;
    float rs0 = 0.f, rs1 = 0.f;
    for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        float dm[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) dm[n][0] = dm[n][1] = dm[n][2] = dm[n][3] = 0.f;
        for (int pb = 0; pb < npb; ++pb) {
            const int p0 = pb * TQ;
            __syncthreads();           // the reads of the last staging are done
            if (npb > 1)
                stage<float, bf16, NM, TQ, LDP>(sDy, TQ * LDP, dyi + p0, hp, L - i0, a.P - p0,
                                                true);
            stage<T, bf16, NI, TQ, LDP>(sX, TQ * LDP, xb + (int64_t)j0 * a.x_st + p0, a.x_st,
                                        L - j0, a.P - p0, a.vec);
            if (pb == 0)
                stage<T, bf16, NI, TQ, LDP>(sB, TQ * LDP, Bb + (int64_t)j0 * a.b_st, a.b_st,
                                            L - j0, ncol, a.vec);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            const int nkp = min(TQ, a.P - p0) / 16;
            for (int kk = 0; kk < nkp; ++kk) {    // dM = dy_i x_j^T
                uint32_t af[NM][4];
#pragma unroll
                for (int q = 0; q < NM; ++q)
                    ldsm_x4(af[q], sDy + q * TQ * LDP + a_row * LDP + kk * 16 + a_col);
#pragma unroll
                for (int jp = 0; jp < 4; ++jp) {
                    uint32_t bf[NI][4];
#pragma unroll
                    for (int q = 0; q < NI; ++q)
                        ldsm_x4(bf[q], sX + q * TQ * LDP + (16 * jp + b_row) * LDP + kk * 16
                                       + b_col);
                    mma_pieces<NM, NI>(dm[2 * jp], af, bf, 0);
                    mma_pieces<NM, NI>(dm[2 * jp + 1], af, bf, 2);
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            if (jt == it && kk > warp) break;     // columns past the warp's rows
            uint32_t af[NM][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nt = 2 * kk + half, j = j0 + nt * 8 + c2;
                const float2 cb0 = __ldg(reinterpret_cast<const float2*>(cbt + j));
                const float2 cb1 = __ldg(reinterpret_cast<const float2*>(cbt + 8 * a.QP + j));
                const float d0 = sDt[j], d1 = sDt[j + 1], m0 = sCum[j], m1 = sCum[j + 1];
                // mask before exp: j > i would overflow
                const float v00 = j <= ir ? dm[nt][0] * expf(cum0 - m0) * d0 : 0.f;
                const float v01 = j + 1 <= ir ? dm[nt][1] * expf(cum0 - m1) * d1 : 0.f;
                const float v10 = j <= ir + 8 ? dm[nt][2] * expf(cum1 - m0) * d0 : 0.f;
                const float v11 = j + 1 <= ir + 8 ? dm[nt][3] * expf(cum1 - m1) * d1 : 0.f;
                rs0 += v00 * cb0.x + v01 * cb0.y;
                rs1 += v10 * cb1.x + v11 * cb1.y;
                split_pack<NM>(v00, v01, af, 2 * half);
                split_pack<NM>(v10, v11, af, 2 * half + 1);
            }
#pragma unroll
            for (int np = 0; np < NB / 16; ++np) {       // dC += V B_j
                if (np >= nkn) break;
                uint32_t bf[NI][4];
#pragma unroll
                for (int q = 0; q < NI; ++q)
                    ldsm_x4_trans(bf[q], sB + q * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NI>(acc[2 * np], af, bf, 0);
                mma_pieces<NM, NI>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    rs0 = (nb == 0 ? quad_sum(rs0) : 0.f) + q0;
    rs1 = (nb == 0 ? quad_sum(rs1) : 0.f) + q1;
    float* out = a.dch + ((int64_t)bh * a.S + t0) * a.N + n0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + c2;
        if (n >= ncol) break;
        if (ir < L)
            *reinterpret_cast<float2*>(out + (int64_t)ir * a.N + n) = make_float2(acc[nt][0], acc[nt][1]);
        if (ir + 8 < L)
            *reinterpret_cast<float2*>(out + (int64_t)(ir + 8) * a.N + n) = make_float2(acc[nt][2], acc[nt][3]);
    }
    if ((lane & 3) == 0) {
        float* rs = a.rsum + ((int64_t)bh * a.nnb + nb) * a.S + t0;
        if (ir < L) rs[ir] = rs0;
        if (ir + 8 < L) rs[ir + 8] = rs1;
    }
}

// 7. dB of one head for the 64 positions j of tile blockIdx.x / nnb and the
// 64 columns n of block blockIdx.x % nnb, chunk blockIdx.y, (batch, head)
// blockIdx.z, into fp32 scratch dbh, and (from n block 0) each position's
// direct d(dt) of the intra-chunk term:
//   dB_j = sum_{i>=j} V_ij C_i + w_j x_j^T G_{c+1},   w_j = exp(cum_last - cum_j) dt_j,
//   ddtd_j = sum_{i>=j} (dy_i . x_j) (C_i . B_j) exp(cum_i - cum_j).
// dM^T = x_j dy_i^T is taken over P in 64-wide blocks; V^T in registers.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_db_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    extern __shared__ uint4 smem_u4[];
    bf16* sX = reinterpret_cast<bf16*>(smem_u4);  // [NI][TQ][LDP] x rows j, a p block
    bf16* sDy = sX + NI * TQ * LDP;                // [NM][TQ][LDP] dy rows i, a p block
    bf16* sG = sDy + NM * TQ * LDP;                // [NM][TQ][LDP] G_{c+1} rows p, the n block
    bf16* sC = sG + NM * TQ * LDP;                 // [NI][TQ][LDP] C rows i, the n block
    float* sCB = reinterpret_cast<float*>(sC + NI * TQ * LDP);   // [TQ][LDC] C.B rows i
    float* sDt = sCB + TQ * LDC;                                 // [QMAX]
    float* sCum = sDt + QMAX;                                    // [QMAX]
    __shared__ float red[4];

    const int jt = blockIdx.x / a.nnb, nb = blockIdx.x % a.nnb, n0 = nb * NB;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
    const int g = h / (a.H / a.G);
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0), j0 = jt * TQ;
    if (j0 >= L) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, c2 = 2 * (lane & 3);
    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
    const int npb = a.npb, ncol = min(NB, a.N - n0), nkn = (ncol + 15) / 16;
    const int nti = (L + TQ - 1) / TQ;
    const int64_t hp = (int64_t)a.H * a.P, PN = (int64_t)a.P * a.N;
    const float* dyb = a.dy + ((int64_t)b * a.S + t0) * hp + (int64_t)h * a.P;
    const T* xj = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)(t0 + j0) * a.x_st;
    const T* Cb = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)t0 * a.c_st + n0;
    const float* gn = a.gn + ((int64_t)bh * a.nc + c) * PN + n0;
    const float* cbt = a.cb + ((int64_t)(b * a.G + g) * a.nc + c) * a.QP * a.QP + j0;

    chunk_scan(sDt, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, a.A[h]);

    // the state passing's part: x_j G_{c+1} over P, then w_j on the row
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int pb = 0; pb < npb; ++pb) {
        const int p0 = pb * TQ;
        if (pb) __syncthreads();
        stage<T, bf16, NI, TQ, LDP>(sX, TQ * LDP, xj + p0, a.x_st, L - j0, a.P - p0, a.vec);
        stage<float, bf16, NM, TQ, LDP>(sG, TQ * LDP, gn + (int64_t)p0 * a.N, a.N, a.P - p0,
                                        ncol, true);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int nkp = min(TQ, a.P - p0) / 16;
        for (int kk = 0; kk < nkp; ++kk) {
            uint32_t af[NI][4];
#pragma unroll
            for (int q = 0; q < NI; ++q)
                ldsm_x4(af[q], sX + q * TQ * LDP + a_row * LDP + kk * 16 + a_col);
#pragma unroll
            for (int np = 0; np < NB / 16; ++np) {
                if (np >= nkn) break;
                uint32_t bf[NM][4];
#pragma unroll
                for (int q = 0; q < NM; ++q)
                    ldsm_x4_trans(bf[q], sG + q * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NI, NM>(acc[2 * np], af, bf, 0);
                mma_pieces<NI, NM>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    const int r0 = warp * 16 + gr, jr = j0 + r0;  // this lane's rows jr, jr + 8
    const float cum_last = sCum[L - 1];
    const float cj0 = sCum[jr], cj1 = sCum[jr + 8], dt0 = sDt[jr], dt1 = sDt[jr + 8];
    const float w0 = jr < L ? expf(cum_last - cj0) * dt0 : 0.f;
    const float w1 = jr + 8 < L ? expf(cum_last - cj1) * dt1 : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        acc[n][0] *= w0; acc[n][1] *= w0; acc[n][2] *= w1; acc[n][3] *= w1;
    }

    // intra-chunk part over the query tiles i0 >= j0
    float dd0 = 0.f, dd1 = 0.f;
    for (int it = jt; it < nti; ++it) {
        const int i0 = it * TQ;
        float dm[8][4];              // dM^T: rows j, columns i
#pragma unroll
        for (int n = 0; n < 8; ++n) dm[n][0] = dm[n][1] = dm[n][2] = dm[n][3] = 0.f;
        for (int pb = 0; pb < npb; ++pb) {
            const int p0 = pb * TQ;
            __syncthreads();
            if (npb > 1)
                stage<T, bf16, NI, TQ, LDP>(sX, TQ * LDP, xj + p0, a.x_st, L - j0, a.P - p0,
                                            a.vec);
            stage<float, bf16, NM, TQ, LDP>(sDy, TQ * LDP, dyb + (int64_t)i0 * hp + p0, hp,
                                            L - i0, a.P - p0, true);
            if (pb == 0) {
                stage<T, bf16, NI, TQ, LDP>(sC, TQ * LDP, Cb + (int64_t)i0 * a.c_st, a.c_st,
                                            L - i0, ncol, a.vec);
                stage_cb(sCB, cbt + (int64_t)i0 * a.QP, a.QP);
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            const int nkp = min(TQ, a.P - p0) / 16;
            for (int kk = 0; kk < nkp; ++kk) {
                uint32_t af[NI][4];
#pragma unroll
                for (int q = 0; q < NI; ++q)
                    ldsm_x4(af[q], sX + q * TQ * LDP + a_row * LDP + kk * 16 + a_col);
#pragma unroll
                for (int ip = 0; ip < 4; ++ip) {
                    uint32_t bf[NM][4];
#pragma unroll
                    for (int q = 0; q < NM; ++q)
                        ldsm_x4(bf[q], sDy + q * TQ * LDP + (16 * ip + b_row) * LDP + kk * 16
                                       + b_col);
                    mma_pieces<NI, NM>(dm[2 * ip], af, bf, 0);
                    mma_pieces<NI, NM>(dm[2 * ip + 1], af, bf, 2);
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            if (it == jt && kk < warp) continue;  // columns before the warp's rows
            uint32_t af[NM][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nt = 2 * kk + half, il = nt * 8 + c2, i = i0 + il;
                const float* cb = sCB + il * LDC + r0;   // C.B[i][j], read transposed
                const float ci0 = sCum[i], ci1 = sCum[i + 1];
                // mask before exp: i < j would overflow
                const float t00 = i >= jr ? dm[nt][0] * expf(ci0 - cj0) : 0.f;
                const float t01 = i + 1 >= jr ? dm[nt][1] * expf(ci1 - cj0) : 0.f;
                const float t10 = i >= jr + 8 ? dm[nt][2] * expf(ci0 - cj1) : 0.f;
                const float t11 = i + 1 >= jr + 8 ? dm[nt][3] * expf(ci1 - cj1) : 0.f;
                dd0 += t00 * cb[0] + t01 * cb[LDC];
                dd1 += t10 * cb[8] + t11 * cb[LDC + 8];
                split_pack<NM>(t00 * dt0, t01 * dt0, af, 2 * half);
                split_pack<NM>(t10 * dt1, t11 * dt1, af, 2 * half + 1);
            }
#pragma unroll
            for (int np = 0; np < NB / 16; ++np) {       // dB += V^T C_i
                if (np >= nkn) break;
                uint32_t bf[NI][4];
#pragma unroll
                for (int q = 0; q < NI; ++q)
                    ldsm_x4_trans(bf[q], sC + q * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NI>(acc[2 * np], af, bf, 0);
                mma_pieces<NM, NI>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    dd0 = quad_sum(dd0);
    dd1 = quad_sum(dd1);
    float* out = a.dbh + ((int64_t)bh * a.S + t0) * a.N + n0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + c2;
        if (n >= ncol) break;
        if (jr < L)
            *reinterpret_cast<float2*>(out + (int64_t)jr * a.N + n) = make_float2(acc[nt][0], acc[nt][1]);
        if (jr + 8 < L)
            *reinterpret_cast<float2*>(out + (int64_t)(jr + 8) * a.N + n) = make_float2(acc[nt][2], acc[nt][3]);
    }
    if ((lane & 3) == 0 && nb == 0) {
        float* dd = a.ddtd + (int64_t)bh * a.S + t0;
        if (jr < L) dd[jr] = dd0;
        if (jr + 8 < L) dd[jr + 8] = dd1;
    }
}

// 8. dx of one head for the 64 positions j of tile blockIdx.x / npb and 64
// columns p (blockIdx.x % npb) of chunk blockIdx.y, (batch, head)
// blockIdx.z, and this p block's share of x_j . T_j, T_j = G_{c+1} B_j:
//   dx_j = sum_{i>=j} S_ij dy_i + w_j T_j,   S_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dx_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    extern __shared__ uint4 smem_u4[];
    bf16* sB = reinterpret_cast<bf16*>(smem_u4);  // [NI][TQ][LDN] B rows j
    bf16* sG = sB + NI * TQ * LDN;                 // [NM][TQ][LDN] G_{c+1} rows p of the block
    bf16* sDy = sG + NM * TQ * LDN;                // [NM][TQ][LDP] dy rows i, the p block
    float* sCB = reinterpret_cast<float*>(sDy + NM * TQ * LDP);  // [TQ][LDC]
    float* sDt = sCB + TQ * LDC;                                 // [QMAX]
    float* sCum = sDt + QMAX;                                    // [QMAX]
    __shared__ float red[4];

    const int npb = a.npb, jt = blockIdx.x / npb, p0 = (blockIdx.x % npb) * TQ;
    const int c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
    const int g = h / (a.H / a.G);
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0), j0 = jt * TQ;
    if (j0 >= L) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, c2 = 2 * (lane & 3);
    const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
    const int nkn = (a.N + 15) / 16, nti = (L + TQ - 1) / TQ;
    const int64_t hp = (int64_t)a.H * a.P, PN = (int64_t)a.P * a.N;
    const float* dyb = a.dy + ((int64_t)b * a.S + t0) * hp + (int64_t)h * a.P + p0;
    const T* xj = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)(t0 + j0) * a.x_st + p0;
    const T* Bj = (const T*)a.Bm + b * a.b_sb + g * a.b_sg + (int64_t)(t0 + j0) * a.b_st;
    const float* gn = a.gn + ((int64_t)bh * a.nc + c) * PN + (int64_t)p0 * a.N;
    const float* cbt = a.cb + ((int64_t)(b * a.G + g) * a.nc + c) * a.QP * a.QP + j0;

    stage<T, bf16, NI, NMAX, LDN>(sB, TQ * LDN, Bj, a.b_st, L - j0, a.N, a.vec);
    stage<float, bf16, NM, NMAX, LDN>(sG, TQ * LDN, gn, a.N, a.P - p0, a.N, true);
    cp_async_commit();
    chunk_scan(sDt, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, a.A[h]);
    cp_async_wait<0>();
    __syncthreads();

    // T = B_j G^T over N: rows j, columns p
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kk = 0; kk < nkn; ++kk) {
        uint32_t af[NI][4];
#pragma unroll
        for (int q = 0; q < NI; ++q)
            ldsm_x4(af[q], sB + q * TQ * LDN + a_row * LDN + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t bf[NM][4];
#pragma unroll
            for (int q = 0; q < NM; ++q)
                ldsm_x4(bf[q], sG + q * TQ * LDN + (16 * np + b_row) * LDN + kk * 16 + b_col);
            mma_pieces<NI, NM>(acc[2 * np], af, bf, 0);
            mma_pieces<NI, NM>(acc[2 * np + 1], af, bf, 2);
        }
    }
    const int r0 = warp * 16 + gr, jr = j0 + r0;  // this lane's rows jr, jr + 8
    const float cum_last = sCum[L - 1];
    const float cj0 = sCum[jr], cj1 = sCum[jr + 8], dt0 = sDt[jr], dt1 = sDt[jr + 8];
    {
        float xt0 = 0.f, xt1 = 0.f;
        const T* x0 = xj + (int64_t)r0 * a.x_st;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int p = nt * 8 + c2;
            if (p0 + p >= a.P) break;
            if (jr < L) xt0 += acc[nt][0] * to_f(x0[p]) + acc[nt][1] * to_f(x0[p + 1]);
            if (jr + 8 < L)
                xt1 += acc[nt][2] * to_f(x0[8 * a.x_st + p]) + acc[nt][3] * to_f(x0[8 * a.x_st + p + 1]);
        }
        xt0 = quad_sum(xt0);
        xt1 = quad_sum(xt1);
        if ((lane & 3) == 0) {
            float* xt = a.xT + ((int64_t)bh * npb + blockIdx.x % npb) * a.S + t0;
            if (jr < L) xt[jr] = xt0;
            if (jr + 8 < L) xt[jr + 8] = xt1;
        }
    }
    const float w0 = jr < L ? expf(cum_last - cj0) * dt0 : 0.f;
    const float w1 = jr + 8 < L ? expf(cum_last - cj1) * dt1 : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        acc[n][0] *= w0; acc[n][1] *= w0; acc[n][2] *= w1; acc[n][3] *= w1;
    }

    // intra-chunk part: S^T dy over the query tiles i0 >= j0
    for (int it = jt; it < nti; ++it) {
        const int i0 = it * TQ;
        __syncthreads();
        stage<float, bf16, NM, TQ, LDP>(sDy, TQ * LDP, dyb + (int64_t)i0 * hp, hp, L - i0,
                                        a.P - p0, true);
        stage_cb(sCB, cbt + (int64_t)i0 * a.QP, a.QP);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            if (it == jt && kk < warp) continue;  // columns before the warp's rows
            uint32_t af[NM][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int il = kk * 16 + 8 * half + c2, i = i0 + il;
                const float* cb = sCB + il * LDC + r0;
                const float ci0 = sCum[i], ci1 = sCum[i + 1];
                const float s00 = i >= jr ? cb[0] * expf(ci0 - cj0) * dt0 : 0.f;
                const float s01 = i + 1 >= jr ? cb[LDC] * expf(ci1 - cj0) * dt0 : 0.f;
                const float s10 = i >= jr + 8 ? cb[8] * expf(ci0 - cj1) * dt1 : 0.f;
                const float s11 = i + 1 >= jr + 8 ? cb[LDC + 8] * expf(ci1 - cj1) * dt1 : 0.f;
                split_pack<NM>(s00, s01, af, 2 * half);
                split_pack<NM>(s10, s11, af, 2 * half + 1);
            }
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bf[NM][4];
#pragma unroll
                for (int q = 0; q < NM; ++q)
                    ldsm_x4_trans(bf[q], sDy + q * TQ * LDP + (kk * 16 + (lane & 15)) * LDP
                                         + np * 16 + (lane >> 4) * 8);
                mma_pieces<NM, NM>(acc[2 * np], af, bf, 0);
                mma_pieces<NM, NM>(acc[2 * np + 1], af, bf, 2);
            }
        }
    }
    T* out = (T*)a.dx + (((int64_t)b * a.S + t0) * a.H + h) * a.P + p0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + c2;
        if (p0 + p >= a.P) break;
        if (jr < L) store_pair(out + (int64_t)jr * hp + p, acc[nt][0], acc[nt][1]);
        if (jr + 8 < L) store_pair(out + (int64_t)(jr + 8) * hp + p, acc[nt][2], acc[nt][3]);
    }
}

// 9. the last launch. CTAs 0 .. H-1: head blockIdx.x, its batches and
// chunks in order: dcum_i = rsum_i (its n blocks' slots summed) - dt_i
// ddtd_i - W_i, W_j = w_j x_j . T_j
// (plus sum_j W_j and the fold's exp(cum_last) <G_{c+1}, h_in> at the
// chunk's last position); da = dcum summed from the end of the chunk;
// d(dt)_j = ddtd_j + exp(cum_last - cum_j) x_j . T_j + A da_j, and dA the sum
// of dt da over the head's batches and positions. The other CTAs: dB and
// dC, 4 columns n a thread, the group's heads summed in order, in the
// input dtype.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_final_kernel(Params a) {
    __shared__ float sDt[QMAX], sCum[QMAX];
    __shared__ float red[4], red2[4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (blockIdx.x >= a.H) {
        const int n4 = a.N / 4, rep = a.H / a.G;
        const int64_t e = (int64_t)(blockIdx.x - a.H) * NT + tid;   // [B, S, G, N / 4]
        if (e >= (int64_t)a.Bsz * a.S * a.G * n4) return;
        int64_t r = e / n4;
        const int gg = (int)(r % a.G);
        r /= a.G;
        const int t = (int)(r % a.S), b = (int)(r / a.S);
        const int64_t hs = (int64_t)a.S * a.N;
        const int64_t src = (((int64_t)b * a.H + (int64_t)gg * rep) * a.S + t) * a.N + 4 * (e % n4);
        float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
        for (int k = 0; k < rep; ++k) {
            const float4 vb = __ldg(reinterpret_cast<const float4*>(a.dbh + src + k * hs));
            const float4 vc = __ldg(reinterpret_cast<const float4*>(a.dch + src + k * hs));
            sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
            sc.x += vc.x; sc.y += vc.y; sc.z += vc.z; sc.w += vc.w;
        }
        T* dB = (T*)a.dB + 4 * e;
        T* dC = (T*)a.dC + 4 * e;
        store_pair(dB, sb.x, sb.y);
        store_pair(dB + 2, sb.z, sb.w);
        store_pair(dC, sc.x, sc.y);
        store_pair(dC + 2, sc.z, sc.w);
        return;
    }
    const int h = blockIdx.x;
    const float A = a.A[h];
    float dA_acc = 0.f;
    for (int b = 0; b < a.Bsz; ++b) {
        const int64_t bh = (int64_t)b * a.H + h;
        for (int c = 0; c < a.nc; ++c) {
            const int t0 = c * a.Q, L = min(a.Q, a.S - t0);
            chunk_scan(sDt, sCum, red, a.dt + b * a.dt_sb + h * a.dt_sh, a.dt_st, t0, L, A);
            const float cum_last = sCum[L - 1];
            float dc[2], part[2], W[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int j = 2 * tid + k;
                dc[k] = part[k] = W[k] = 0.f;
                if (j >= L) continue;
                const int64_t o = bh * a.S + t0 + j;
                float xt = 0.f;
                for (int pb = 0; pb < a.npb; ++pb) xt += a.xT[(bh * a.npb + pb) * a.S + t0 + j];
                const float ds = expf(cum_last - sCum[j]) * xt;   // the state passing's d(dt)
                const float dd = a.ddtd[o];
                W[k] = sDt[j] * ds;
                float rs = 0.f;
                for (int nb = 0; nb < a.nnb; ++nb) rs += a.rsum[(bh * a.nnb + nb) * a.S + t0 + j];
                dc[k] = rs - sDt[j] * dd - W[k];
                part[k] = dd + ds;
            }
            const float wsum = block_sum(W[0] + W[1], red2);
            if (tid == (L - 1) / 2) {
                float d = 0.f;
                for (int q = 0; q < a.parts; ++q) d += a.dotp[(bh * a.nc + c) * a.parts + q];
                dc[(L - 1) & 1] += wsum + d;
            }
            // da_j = sum_{i >= j} dcum_i: a suffix scan over the chunk
            float s = dc[0] + dc[1];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float n = __shfl_down_sync(FULL, s, o);
                if (lane + o < 32) s += n;
            }
            float ex = __shfl_down_sync(FULL, s, 1);
            if (lane == 31) ex = 0.f;
            if (lane == 0) red2[warp] = s;
            __syncthreads();
            for (int w = 3; w > warp; --w) ex += red2[w];
            __syncthreads();
            const float da1 = ex + dc[1], da0 = da1 + dc[0];
            const int j = 2 * tid;
            float* ddt = a.ddt + ((int64_t)b * a.S + t0) * a.H + h;
            if (j < L) {
                ddt[(int64_t)j * a.H] = part[0] + A * da0;
                dA_acc += sDt[j] * da0;
            }
            if (j + 1 < L) {
                ddt[(int64_t)(j + 1) * a.H] = part[1] + A * da1;
                dA_acc += sDt[j + 1] * da1;
            }
        }
    }
    const float dA = block_sum(dA_acc, red2);
    if (tid == 0) a.dA[h] = dA;
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
    // the backward's
    static constexpr int STATE_BWD = NBLK * NI * TQ * LDP * (int)sizeof(bf16)
                                   + NBLK * TQ * LDX * (int)sizeof(float)
                                   + 2 * QMAX * (int)sizeof(float);
    static constexpr int DC = (2 * NM + 3 * NI) * TQ * LDP * (int)sizeof(bf16)
                            + 2 * QMAX * (int)sizeof(float);
    static constexpr int DB = 2 * (NI + NM) * TQ * LDP * (int)sizeof(bf16)
                            + (TQ * LDC + 2 * QMAX) * (int)sizeof(float);
    static constexpr int DX = (NM * TQ * LDP + (NI + NM) * TQ * LDN) * (int)sizeof(bf16)
                            + (TQ * LDC + 2 * QMAX) * (int)sizeof(float);
    static_assert(STATE_BWD <= 232448 - 64 && DC <= 232448 - 64 && DB <= 232448 - 64 &&
                  DX <= 232448 - 64, "shared memory of an sm_90 block");
};

template <typename T>
cudaError_t launch(const Params& a, int B, cudaStream_t stream) {
    using M = Smem<T>;
    static bool ready = false;         // the shared-memory opt-in, once
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(
            ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::CB);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_state_kernel<T, false>,
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
    ssd_state_kernel<T, false><<<dim3(npb * nnb, a.nc, B * a.H), NT, M::STATE, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_out_kernel<T><<<dim3(nt * npb, a.nc, B * a.H), NT, M::OUT, stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Params& a, cudaStream_t stream) {
    using M = Smem<T>;
    static bool ready = false;         // the shared-memory opt-in, once
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(
            ssd_state_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::STATE_BWD);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dc_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DC);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_db_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DB);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dx_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DX);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    const int BH = a.Bsz * a.H, nt = (a.Q + TQ - 1) / TQ, nnb = (a.N + NB - 1) / NB;
    ssd_state_kernel<T, true><<<dim3(a.npb * nnb, a.nc, BH), NT, M::STATE_BWD, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_fold_kernel<<<dim3(a.parts, BH), NT, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_dc_kernel<T><<<dim3(nt * a.nnb, a.nc, BH), NT, M::DC, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_db_kernel<T><<<dim3(nt * a.nnb, a.nc, BH), NT, M::DB, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_bwd_dx_kernel<T><<<dim3(nt * a.npb, a.nc, BH), NT, M::DX, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int64_t quads = (int64_t)a.Bsz * a.S * a.G * (a.N / 4);
    ssd_bwd_final_kernel<T><<<a.H + (int)((quads + NT - 1) / NT), NT, 0, stream>>>(a);
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

// The gradient of ssd_scan_launch's (y, hout) with respect to x, dt, A, B, C
// and h0. The inputs and their strides as ssd_scan_launch takes them, and
// fwd_scratch as that call left it (C.B, chunk states, decays); dy [B, S,
// H, P] contiguous fp32 on 16 bytes, dhf [B, H, P, N] fp32 on 16 bytes or
// null (zero). Out: dx [B, S, H, P], dB and dC [B, S, G, N] contiguous in the
// dtype of x; ddt [B, S, H], dA [H] and dh0 [B, H, P, N] contiguous fp32.
// scratch holds, in fp32: U, h_in and G_{c+1} [B, H, nc, P, N] each; dB and
// dC of each head [B, H, S, N] each; rsum [B, H, nnb, S]; ddtd [B, H, S];
// x . T [B, H, npb, S]; the fold's dots [B, H, nc, parts] (npb = ceil(P /
// 64), nnb = ceil(N / 64), parts = ceil(P N / 1024)). Six launches, no
// atomics; returns the first cudaError_t (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, const void* dy, const void* dhf, void* fwd_scratch, void* scratch,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
    int dtype, int B, int S, int H, int G, int P, int N, int Q, int vec,
    int64_t x_sb, int64_t x_st, int64_t x_sh,
    int64_t dt_sb, int64_t dt_st, int64_t dt_sh,
    int64_t b_sb, int64_t b_st, int64_t b_sg,
    int64_t c_sb, int64_t c_st, int64_t c_sg, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 ||
        N <= 0 || N > NMAX || N % 4 || Q <= 0 || Q > QMAX)
        return cudaErrorInvalidValue;
    const int nc = (S + Q - 1) / Q, QP = (Q + TQ - 1) / TQ * TQ;
    float* cb = (float*)fwd_scratch;
    float* st = cb + (int64_t)B * G * nc * QP * QP;
    Params a{x, Bm, Cm, (const float*)dt, (const float*)A, (const float*)h0,
             nullptr, nullptr, cb, st, st + (int64_t)B * H * nc * P * N,
             S, H, G, P, N, Q, nc, QP, vec,
             x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh,
             b_sb, b_st, b_sg, c_sb, c_st, c_sg};
    a.dy = (const float*)dy;
    a.dhf = (const float*)dhf;
    a.dx = dx;
    a.dB = dB;
    a.dC = dC;
    a.ddt = (float*)ddt;
    a.dA = (float*)dA;
    a.dh0 = (float*)dh0;
    a.Bsz = B;
    a.npb = (P + TQ - 1) / TQ;
    a.nnb = (N + NB - 1) / NB;
    a.parts = (int)(((int64_t)P * N + FOLD_E - 1) / FOLD_E);
    const int64_t states = (int64_t)B * H * nc * P * N, rows = (int64_t)B * H * S;
    a.U = (float*)scratch;
    a.hin = a.U + states;
    a.gn = a.hin + states;
    a.dbh = a.gn + states;
    a.dch = a.dbh + rows * N;
    a.rsum = a.dch + rows * N;
    a.ddtd = a.rsum + rows * a.nnb;
    a.xT = a.ddtd + rows;
    a.dotp = a.xT + rows * a.npb;
    if (dtype == 0) return launch_bwd<float>(a, (cudaStream_t)stream);
    if (dtype == 1) return launch_bwd<bf16>(a, (cudaStream_t)stream);
    return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
