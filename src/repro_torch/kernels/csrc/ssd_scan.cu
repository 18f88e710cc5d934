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
//   dC_i = sum_{j<=i} dCB_ij B_j + sum_h exp(cum^h_i) h_in^h^T dy^h_i
//   dB_j = sum_{i>=j} dCB_ij C_i + sum_h w^h_j G^h_{c+1}^T x^h_j
// with dCB_ij = sum_h dM^h_ij L^h_ij dt^h_j over a group's heads: B and C
// belong to the group, so their products run once a group, not once a
// head. d(dt) and dA come through dcum, summed from the end of each chunk.
// Six launches, on two streams. On the caller's: U (the state kernel on dy
// and C) and the fold (h_in forward from the forward's chunk states, G
// backward), while dCB runs on a second one (a CTA per causal 64 x 64 tile
// pair and slice of a group's heads, dM over P on wgmma in bf16 and on
// mma.sync in fp32, the slices of a cluster summed through distributed
// shared memory); then dC and dB (a CTA per 64 rows and 64 columns of N,
// K = the dCB tiles and the group's H P rows of the state term, split over
// a cluster, on wgmma) beside dx (per tile and 64 rows of P); and, after
// both, a last launch for dcum, d(dt) and dA (a CTA per head). No atomics:
// every partial goes to its own slot or CTA and is summed in a fixed order,
// so two calls give the same bits. What bounds it: at mamba2-780m's
// training shape (S = 1024, bf16) ~30 MB and ~4.9 GFLOP, 0.0089 ms at 3.35
// TB/s: bytes on paper; in practice the latency of short dependent steps in
// CTAs of 4 warps, two an SM (their registers), so the design fills the
// card with CTAs (slices and a K split, sized by ssd_scan.py::bwd_plan to
// one wave) and runs launches that do not wait for each other side by side
// (PERF.md has the times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "async_copy.cuh"
#include "mma_bf16.cuh"
#include "wgmma.cuh"

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
    float *U, *hin, *gn, *dcb, *rsum, *ddtd, *ecum, *wj, *xT, *dotp;
    int Bsz, npb, nnb, parts;    // batch; 64-row blocks of P and of N; fold CTAs a state
    int ntq, nrs;                // 64-row tiles of a chunk; rsum's slots a position
    int slices, hps, ks;         // the plan: dCB slices, heads a slice; dB / dC K split
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
// (the scan of d0, d1 = dt at positions 2 tid, 2 tid + 1, as scan_dt)
__device__ void scan_dt(float* sDt, float* sCum, float* red, float d0, float d1, float A);

__device__ void chunk_scan(float* sDt, float* sCum, float* red, const float* dtb,
                           int64_t dt_st, int t0, int L, float A) {
    const int j = 2 * threadIdx.x;
    const float d0 = j < L ? dtb[(int64_t)(t0 + j) * dt_st] : 0.f;
    const float d1 = j + 1 < L ? dtb[(int64_t)(t0 + j + 1) * dt_st] : 0.f;
    scan_dt(sDt, sCum, red, d0, d1, A);
}

__device__ void scan_dt(float* sDt, float* sCum, float* red, float d0, float d1, float A) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j = 2 * tid;
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
constexpr int LDR = TQ + 8;          // row of a raw 64-column tile, fp32 or the input's
constexpr int PIECE = TQ * TQ * (int)sizeof(bf16);   // a swizzled [64][64] bf16 piece
constexpr int HPS_MAX = 16;          // heads of a dCB slice (their tables in shared memory)
constexpr int CLUSTER_MAX = 16;      // CTAs of a cluster (past 8: non-portable)
constexpr int DCB_TAB = 7 * TQ;      // a head's table in the dCB kernel (floats)

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

// thread-block clusters (along x: a CTA's rank is blockIdx.x mod the
// cluster's size): a barrier of every thread of the cluster (ordering shared
// memory cluster-wide), and 16 bytes of the shared memory of CTA `rank` at
// the address p has in this one
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
    uint32_t addr;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
    return v;
}

// A fp32 tile [TQ][LDR] of each CTA of the cluster (the same address in
// each), summed over the ns CTAs in rank order: this CTA's share of the
// rows, rank * ceil(TQ / ns) onwards, as float4 (r, col, sum) to `out`
template <typename F>
__device__ __forceinline__ void cluster_tile_sum(const float* part, int rank, int ns, F out) {
    const int rr = (TQ + ns - 1) / ns, lo = rank * rr, hi = min(TQ, lo + rr);
    for (int e = threadIdx.x; e < (hi - lo) * (TQ / 4); e += NT) {
        const int r = lo + e / (TQ / 4), col = (e % (TQ / 4)) * 4;
        float4 s = ld_cluster_f4(part + r * LDR + col, 0);
        for (int q = 1; q < ns; ++q) {
            const float4 v = ld_cluster_f4(part + r * LDR + col, q);
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        out(r, col, s);
    }
}

// 4 bytes global -> shared by cp.async (zero-filled when !valid), for rows
// of fp32 that do not start on 16 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// TQ rows x 64 bf16 columns of src (row stride st) into the 128-byte-swizzled
// tile at dst (wgmma.cuh's layout): by cp.async where vec (the caller
// commits and waits), else by scalar loads; rows >= rows and columns >=
// cols are 0
__device__ __forceinline__ void stage_sw(uint8_t* dst, const bf16* __restrict__ src, int64_t st,
                                         int rows, int cols, bool vec) {
#pragma unroll
    for (int k = 0; k < TQ * 8 / NT; ++k) {
        const int e = threadIdx.x + NT * k, r = e >> 3, ch = e & 7;
        const bool ok = r < rows && 8 * ch < cols;
        uint8_t* d = dst + sw128(r, ch, TQ);
        if (vec) {
            cp_async16(d, ok ? src + (int64_t)r * st + 8 * ch : src, ok);
        } else {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (ok) {
                const bf16* q = src + (int64_t)r * st + 8 * ch;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    w[i] = bf16x2_bits(__halves2bfloat162(q[2 * i], q[2 * i + 1]));
            }
            *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

// 8 fp32 values as NP bf16 pieces (v ~ p0 + p1 + ...), 16 bytes a piece,
// pstride bytes apart
template <int NP>
__device__ __forceinline__ void put8(float (&v)[8], uint8_t* dst, int pstride) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
            w[k] = bf16x2_bits(h);
            v[2 * k] -= __low2float(h);
            v[2 * k + 1] -= __high2float(h);
        }
        *reinterpret_cast<uint4*>(dst + p * pstride) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// 5. per (batch, head) and FOLD_E elements of the [P, N] state (blockIdx.x):
// h_in of every chunk, folded forward from h0 and the forward's chunk states
// and decays (the forward's fold, kept); then G walked back from dh_final,
// G_c = exp(cum_last,c) G_{c+1} + U_c, writing G_{c+1} of each chunk into gn
// and G_0 into dh0; and per chunk this block's share of exp(cum_last)
// <G_{c+1}, h_in>, the last position's dcum term of the state passing.
// h_in and G_{c+1} lie [B, nc, H, P, N]: a chunk's are one [H P, N] matrix,
// the B operand of the group products (7).
__global__ void __launch_bounds__(NT) ssd_fold_kernel(Params a) {
    __shared__ float red[4];
    const int bh = blockIdx.y, tid = threadIdx.x, b = bh / a.H, h = bh % a.H;
    const int64_t PN = (int64_t)a.P * a.N, base = (int64_t)bh * a.nc * PN;
    auto hg = [&](int c) { return (((int64_t)b * a.nc + c) * a.H + h) * PN; };
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
            *reinterpret_cast<float4*>(a.hin + hg(c) + e[k]) = hv[k];
            const float4 s = __ldg(reinterpret_cast<const float4*>(a.st + base + c * PN + e[k]));
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
            *reinterpret_cast<float4*>(a.gn + hg(c) + e[k]) = gv[k];
            const float4 hi = *reinterpret_cast<const float4*>(a.hin + hg(c) + e[k]);   // this thread's
            dot += gv[k].x * hi.x + gv[k].y * hi.y + gv[k].z * hi.z + gv[k].w * hi.w;
            const float4 u = __ldg(reinterpret_cast<const float4*>(a.U + base + c * PN + e[k]));
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

// 6. dCB, the gradient of the scores C.B summed over a group's heads, for the
// causal 64 x 64 tile pair (it, jt <= it) of blockIdx.x / slices, chunk
// blockIdx.y, (batch, group) blockIdx.z. The group's heads are cut into
// a.slices slices of a.hps (the last may be shorter), one a CTA (its rank in
// a cluster of a.slices along x). For each head of its slice a CTA forms
//   dM_ij = dy_i . x_j over P (bf16: wgmma m64n64k16, dy split into two
//   bf16 pieces in registers, x as it lies in a swizzled tile; fp32:
//   mma.sync, the forward's three-piece split),
//   V_ij = dM_ij L_ij dt_j,  L_ij = exp(cum_i - cum_j), masked (j <= i) before exp,
// writes the head's row sums sum_j V_ij (C_i . B_j) into rsum's slot jt and
// its column sums sum_i dM_ij L_ij (C_i . B_j) into ddtd's slot it, and adds
// V to the slice's fp32 sum (in shared memory, so that it holds no registers
// across the heads); the cluster then adds its slices' sums through
// distributed shared memory in rank order into dcb [B, G, nc, QP, QP].
// The chunk scans of all the slice's heads run first, their dt loaded at
// once, into per-head tables, so the loop over heads holds no scan; the (0,
// 0) CTAs also write each head's exp(cum_i) and w_j = exp(cum_last - cum_j)
// dt_j, the row scales of the group products (7). dy and x go through a
// 2-stage cp.async ring: the next (head, 64 rows p) block lands while this
// one is multiplied. C.B is the forward's, staged once.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dcb_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    constexpr bool WG = std::is_same<T, bf16>::value;   // dM on wgmma; fp32 on mma.sync
    constexpr int YB = TQ * LDR * (int)sizeof(float);
    constexpr int XB = WG ? TQ * TQ * (int)sizeof(bf16) : TQ * LDR * (int)sizeof(T);
    extern __shared__ uint4 smem_u4[];
    uint8_t* ring = align1024(reinterpret_cast<uint8_t*>(smem_u4));   // 2 x x rows j, 2 x dy rows i
    float* sCB = reinterpret_cast<float*>(ring + 2 * (YB + XB));   // [TQ][LDR] the tile's C.B
    float* sV = sCB + TQ * LDR;                                    // [TQ][LDR] the slice's V
    float* sCol = sV + TQ * LDR;                                   // [2][4 warps][TQ]
    float* sTab = sCol + 8 * TQ;                                   // [hps][DCB_TAB]
    __shared__ float red[4][HPS_MAX], last[HPS_MAX];

    const int s = blockIdx.x % a.slices;
    int it = 0, jt = blockIdx.x / a.slices;
    while (jt > it) jt -= ++it;
    const int c = blockIdx.y, bg = blockIdx.z, b = bg / a.G, g = bg % a.G;
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0), i0 = it * TQ, j0 = jt * TQ;
    if (i0 >= L) return;                           // the whole cluster's pair
    const int rep = a.H / a.G, h_lo = g * rep + s * a.hps, h_hi = min(h_lo + a.hps, (g + 1) * rep);
    const int nh = h_hi - h_lo;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16 + gr, ir = i0 + r0;
    const int w0 = i0 + warp * 16;                 // the warp's first row
    const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
    const int npb = a.npb, nu = nh * npb;
    const int64_t hp = (int64_t)a.H * a.P, QP = a.QP;

    // x first (a swizzled tile on 1024 bytes in bf16), then dy
    auto sx = [&](int k) { return ring + k * XB; };
    auto sy = [&](int k) { return reinterpret_cast<float*>(ring + 2 * XB + k * YB); };
    auto issue = [&](int u) {          // (head, p block) u into stage u & 1
        const int h = h_lo + u / npb, p0 = (u % npb) * TQ;
        stage<float, float, 1, TQ, LDR>(
            sy(u & 1), 0, a.dy + ((int64_t)b * a.S + t0 + i0) * hp + (int64_t)h * a.P + p0, hp,
            L - i0, a.P - p0, true);
        const T* xj = (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)(t0 + j0) * a.x_st + p0;
        if constexpr (WG)
            stage_sw(sx(u & 1), xj, a.x_st, L - j0, a.P - p0, a.vec);
        else
            stage<T, T, 1, TQ, LDR>(reinterpret_cast<T*>(sx(u & 1)), 0, xj, a.x_st, L - j0,
                                    a.P - p0, a.vec);
        cp_async_commit();
    };
    // ddtd of head hh: the 4 warps' column sums, added in order
    auto flush_cols = [&](int hh) {
        const float* col = sCol + (hh & 1) * 4 * TQ;
        if (tid < TQ && j0 + tid < L)
            a.ddtd[(((int64_t)b * a.H + h_lo + hh) * a.ntq + it) * a.S + t0 + j0 + tid] =
                (col[tid] + col[TQ + tid]) + (col[2 * TQ + tid] + col[3 * TQ + tid]);
    };

    // the tile's C.B and the first (head, p block) land while the scans run
    stage<float, float, 1, TQ, LDR>(
        sCB, 0, a.cb + (((int64_t)bg * a.nc + c) * QP + i0) * QP + j0, QP, TQ, TQ, true);
    issue(0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {               // this lane's elements of V (its own)
        *reinterpret_cast<float2*>(sV + r0 * LDR + nt * 8 + c2) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(sV + (r0 + 8) * LDR + nt * 8 + c2) = make_float2(0.f, 0.f);
    }

    // every head's chunk scan at once: this thread's positions 2 tid, 2 tid +
    // 1 of each head in registers, one barrier for the warps' carries. A
    // head's table: cum of the tile's rows [TQ] and of its columns [TQ], dt
    // of its columns [TQ], and per warp w exp(cum_w - cum_j) for j < w
    // [4][TQ], cum_w at w's first row: L_ij = exp(cum_i - cum_w) exp(cum_w -
    // cum_j) below the warp's diagonal block, both factors at most 1, so
    // neither overflows (one that underflows leaves a product below fp32's
    // range)
    {
        const int j = 2 * tid;
        float d0[HPS_MAX], d1[HPS_MAX], c0[HPS_MAX], c1[HPS_MAX];
#pragma unroll
        for (int hh = 0; hh < HPS_MAX; ++hh) {
            if (hh >= nh) break;
            const float* dtb = a.dt + b * a.dt_sb + (h_lo + hh) * a.dt_sh;
            d0[hh] = j < L ? __ldg(dtb + (int64_t)(t0 + j) * a.dt_st) : 0.f;
            d1[hh] = j + 1 < L ? __ldg(dtb + (int64_t)(t0 + j + 1) * a.dt_st) : 0.f;
            c1[hh] = __ldg(a.A + h_lo + hh);
        }
#pragma unroll
        for (int hh = 0; hh < HPS_MAX; ++hh) {     // the warp's inclusive scans
            if (hh >= nh) break;
            const float v0 = d0[hh] * c1[hh], v1 = v0 + d1[hh] * c1[hh];
            float sc = v1;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float n = __shfl_up_sync(FULL, sc, o);
                if (lane >= o) sc += n;
            }
            float ex = __shfl_up_sync(FULL, sc, 1);
            if (lane == 0) ex = 0.f;
            if (lane == 31) red[warp][hh] = sc;
            c0[hh] = ex + v0;
            c1[hh] = ex + v1;
        }
        __syncthreads();
        const bool row = j - i0 >= 0 && j - i0 < TQ, col = j - j0 >= 0 && j - j0 < TQ;
#pragma unroll
        for (int hh = 0; hh < HPS_MAX; ++hh) {
            if (hh >= nh) break;
            float off = 0.f;
            for (int w = 0; w < warp; ++w) off += red[w][hh];
            c0[hh] += off;
            c1[hh] += off;
            float* tab = sTab + hh * DCB_TAB;
            if (row) {
                tab[j - i0] = c0[hh];
                tab[j - i0 + 1] = c1[hh];
            }
            if (col) {
                tab[TQ + j - j0] = c0[hh];
                tab[TQ + j - j0 + 1] = c1[hh];
                tab[2 * TQ + j - j0] = d0[hh];
                tab[2 * TQ + j - j0 + 1] = d1[hh];
            }
            if (j == L - 1) last[hh] = c0[hh];
            if (j + 1 == L - 1) last[hh] = c1[hh];
        }
        __syncthreads();
#pragma unroll
        for (int hh = 0; hh < HPS_MAX; ++hh) {
            if (hh >= nh) break;
            float* tab = sTab + hh * DCB_TAB;
            for (int e = tid; e < 4 * TQ; e += NT) {
                const int w = e / TQ, jj = e % TQ;
                tab[3 * TQ + e] = j0 + jj < i0 + 16 * w ? expf(tab[16 * w] - tab[TQ + jj]) : 0.f;
            }
            if (it == 0 && jt == 0) {              // the group products' row scales
                float* ec = a.ecum + ((int64_t)b * a.H + h_lo + hh) * a.S + t0;
                float* wj = a.wj + ((int64_t)b * a.H + h_lo + hh) * a.S + t0;
                if (j < L) {
                    ec[j] = expf(c0[hh]);
                    wj[j] = expf(last[hh] - c0[hh]) * d0[hh];
                }
                if (j + 1 < L) {
                    ec[j + 1] = expf(c1[hh]);
                    wj[j + 1] = expf(last[hh] - c1[hh]) * d1[hh];
                }
            }
        }
        // published by the ring's first barrier
    }

    for (int hh = 0; hh < nh; ++hh) {
        const int h = h_lo + hh;
        float dm[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) dm[n][0] = dm[n][1] = dm[n][2] = dm[n][3] = 0.f;
        for (int pb = 0; pb < npb; ++pb) {
            const int u = hh * npb + pb;
            if (u + 1 < nu) issue(u + 1);
            else cp_async_commit();
            cp_async_wait<1>();
            if constexpr (WG) fence_async_smem();
            __syncthreads();
            if (pb == 0 && hh > 0) flush_cols(hh - 1);   // written before the barrier
            const float* y = sy(u & 1);
            const int nkp = min(TQ, a.P - pb * TQ) / 16;
            if constexpr (WG) {
                // dM += dy_i x_j^T on wgmma m64n64k16: A (dy, split into NM
                // pieces) in registers, B the swizzled x tile (K-major)
                uint32_t af[4][NM][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    if (kk >= nkp) break;
                    const float* ya = y + r0 * LDR + kk * 16 + c2;
                    const float2 v0 = *reinterpret_cast<const float2*>(ya);
                    const float2 v1 = *reinterpret_cast<const float2*>(ya + 8 * LDR);
                    const float2 v2 = *reinterpret_cast<const float2*>(ya + 8);
                    const float2 v3 = *reinterpret_cast<const float2*>(ya + 8 * LDR + 8);
                    split_pack<NM>(v0.x, v0.y, af[kk], 0);
                    split_pack<NM>(v1.x, v1.y, af[kk], 1);
                    split_pack<NM>(v2.x, v2.y, af[kk], 2);
                    split_pack<NM>(v3.x, v3.y, af[kk], 3);
                }
                float (&d)[32] = *reinterpret_cast<float(*)[32]>(&dm[0][0]);
                const uint32_t ub = smem_u32(sx(u & 1));
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    if (kk >= nkp) break;
#pragma unroll
                    for (int pa = NM - 1; pa >= 0; --pa) wgmma_rs<0>(d, af[kk][pa], desc_k(ub + kk * 32));
                }
                wg_commit();
                wg_wait<0>();
                reg_fence(d);
            } else
            for (int kk = 0; kk < nkp; ++kk) {     // dM += dy_i x_j^T, A and B split here
                const T* xs = reinterpret_cast<const T*>(sx(u & 1));
                uint32_t af[NM][4];
                const float* ya = y + r0 * LDR + kk * 16 + c2;
                const float2 v0 = *reinterpret_cast<const float2*>(ya);
                const float2 v1 = *reinterpret_cast<const float2*>(ya + 8 * LDR);
                const float2 v2 = *reinterpret_cast<const float2*>(ya + 8);
                const float2 v3 = *reinterpret_cast<const float2*>(ya + 8 * LDR + 8);
                split_pack<NM>(v0.x, v0.y, af, 0);
                split_pack<NM>(v1.x, v1.y, af, 1);
                split_pack<NM>(v2.x, v2.y, af, 2);
                split_pack<NM>(v3.x, v3.y, af, 3);
#pragma unroll
                for (int jp = 0; jp < 4; ++jp) {
                    uint32_t bf[NI][4];
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const T* xb = xs + (16 * jp + 8 * hf + gr) * LDR + kk * 16 + c2;
                        const float2 q0 = make_float2(to_f(xb[0]), to_f(xb[1]));
                        const float2 q1 = make_float2(to_f(xb[8]), to_f(xb[9]));
                        split_pack<NI>(q0.x, q0.y, bf, 2 * hf);
                        split_pack<NI>(q1.x, q1.y, bf, 2 * hf + 1);
                    }
                    mma_pieces<NM, NI>(dm[2 * jp], af, bf, 0);
                    mma_pieces<NM, NI>(dm[2 * jp + 1], af, bf, 2);
                }
            }
            __syncthreads();                   // the stage is free for unit u + 2
        }
        // the head's V, its row and column sums against C.B
        const float* tab = sTab + hh * DCB_TAB;
        const float cum0 = tab[r0], cum1 = tab[r0 + 8], cw = tab[16 * warp];
        const float rf0 = expf(cum0 - cw), rf1 = expf(cum1 - cw);
        const float* lw = tab + (3 + warp) * TQ;
        float rs0 = 0.f, rs1 = 0.f, cs[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int jj = nt * 8 + c2, j = j0 + jj;
            const float2 d = *reinterpret_cast<const float2*>(tab + 2 * TQ + jj);
            float l00, l01, l10, l11;              // L_ij; the branch is the warp's
            if (j < w0) {
                const float2 f = *reinterpret_cast<const float2*>(lw + jj);
                l00 = rf0 * f.x;
                l01 = rf0 * f.y;
                l10 = rf1 * f.x;
                l11 = rf1 * f.y;
            } else if (j < w0 + 16) {              // the warp's diagonal block
                const float m0 = tab[TQ + jj], m1 = tab[TQ + jj + 1];
                // mask before exp: j > i would overflow
                l00 = j <= ir ? expf(cum0 - m0) : 0.f;
                l01 = j + 1 <= ir ? expf(cum0 - m1) : 0.f;
                l10 = j <= ir + 8 ? expf(cum1 - m0) : 0.f;
                l11 = j + 1 <= ir + 8 ? expf(cum1 - m1) : 0.f;
            } else {                               // past the warp's rows
                l00 = l01 = l10 = l11 = 0.f;
            }
            const float t00 = dm[nt][0] * l00, t01 = dm[nt][1] * l01;
            const float t10 = dm[nt][2] * l10, t11 = dm[nt][3] * l11;
            const float2 cb0 = *reinterpret_cast<const float2*>(sCB + r0 * LDR + jj);
            const float2 cb1 = *reinterpret_cast<const float2*>(sCB + (r0 + 8) * LDR + jj);
            cs[nt][0] = t00 * cb0.x + t10 * cb1.x;
            cs[nt][1] = t01 * cb0.y + t11 * cb1.y;
            const float v00 = t00 * d.x, v01 = t01 * d.y, v10 = t10 * d.x, v11 = t11 * d.y;
            rs0 += v00 * cb0.x + v01 * cb0.y;
            rs1 += v10 * cb1.x + v11 * cb1.y;
            float2* va = reinterpret_cast<float2*>(sV + r0 * LDR + jj);
            float2* vb = reinterpret_cast<float2*>(sV + (r0 + 8) * LDR + jj);
            const float2 pa = *va, pb = *vb;
            *va = make_float2(pa.x + v00, pa.y + v01);
            *vb = make_float2(pb.x + v10, pb.y + v11);
        }
        rs0 = quad_sum(rs0);
        rs1 = quad_sum(rs1);
        if ((lane & 3) == 0) {
            float* rs = a.rsum + (((int64_t)b * a.H + h) * a.nrs + jt) * a.S + t0;
            if (ir < L) rs[ir] = rs0;
            if (ir + 8 < L) rs[ir + 8] = rs1;
        }
        // column sums over the warp's 16 rows (lanes of one lane & 3): each
        // exchange halves the columns a lane keeps, so lane (gr, c2) ends
        // with columns 8 gr + c2, + 1
#pragma unroll
        for (int st = 4; st >= 1; st >>= 1) {
            const bool up = lane & (4 * st);
#pragma unroll
            for (int n = 0; n < st; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float keep = up ? cs[n + st][e] : cs[n][e];
                    const float send = up ? cs[n][e] : cs[n + st][e];
                    cs[n][e] = keep + __shfl_xor_sync(FULL, send, 4 * st);
                }
        }
        *reinterpret_cast<float2*>(sCol + ((hh & 1) * 4 + warp) * TQ + 8 * gr + c2) =
            make_float2(cs[0][0], cs[0][1]);
    }
    __syncthreads();
    flush_cols(nh - 1);

    // the cluster's slices added in rank order
    cluster_sync();
    float* out = a.dcb + (((int64_t)bg * a.nc + c) * QP + i0) * QP + j0;
    cluster_tile_sum(sV, s, a.slices, [&](int r, int col, float4 v) {
        *reinterpret_cast<float4*>(out + r * QP + col) = v;
    });
    cluster_sync();                                // no CTA leaves while its tile is read
}

// 7. dC (side 0) or dB (side 1) of a group, in the input dtype, for 64 rows
// (tile blockIdx.x / ks of the chunks' tiles, chunk-major) and 64 columns n
// (blockIdx.y), (batch, group, side) blockIdx.z:
//   dC_i = sum_{j<=i} dCB_ij B_j + sum_h exp(cum^h_i) dy^h_i h_in^h,
//   dB_j = sum_{i>=j} dCB_ij C_i + sum_h w^h_j x^h_j G^h_{c+1}.
// The reduction runs over units of 64: the dCB tiles of the row tile, then
// each (head, 64 rows p) of the state term, K = H P (a row of dy, and of x,
// is contiguous over (h, p); h_in and G lie [H P, N] a chunk). A cluster of
// a.ks CTAs along x splits the units in order. Each unit goes through a
// 2-stage cp.async ring as it lies (fp32, or the input's rows); B is then
// split into bf16 pieces in the 128-byte-swizzled layout (MN-major), A is
// formed in registers with its row scale (exp(cum^h_i), w^h_j: the dCB
// kernel's tables) and split, and the products run on wgmma m64n64k16, the
// piece pairs of mma_pieces. The cluster adds its ks partial tiles through
// distributed shared memory in rank order. The dC side also writes, per
// head and 64 rows p, its share of rsum's state term, C_i . (exp(cum^h_i)
// dy^h_i h_in^h) over its 64 columns: the change the unit makes to C_i .
// acc_i (no second accumulator).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dbc_kernel(Params a) {
    constexpr int NI = Pieces<T>::IN, NM = Pieces<T>::MID;
    constexpr int NP = NI > NM ? NI : NM;        // pieces of B
    constexpr int KEEP = NM > NP ? NM : NP;
    constexpr int RAW = TQ * LDR * (int)sizeof(float);
    extern __shared__ uint4 smem_u4[];
    uint8_t* sBp = align1024(reinterpret_cast<uint8_t*>(smem_u4));   // [NP][64 k][64 n] swizzled
    uint8_t* ring = sBp + NP * PIECE;                     // 2 x [raw A | raw B | A's row scales]

    const int ks = a.ks, rank = blockIdx.x % ks, tile = blockIdx.x / ks;
    const int c = tile / a.ntq, it = tile % a.ntq;
    const int n0 = blockIdx.y * TQ, ncol = min(TQ, a.N - n0);
    const int side = blockIdx.z & 1, bg = blockIdx.z >> 1, b = bg / a.G, g = bg % a.G;
    const int t0 = c * a.Q, L = min(a.Q, a.S - t0), r0 = it * TQ;
    if (r0 >= L) return;                           // the whole cluster's tile
    const int rows = min(TQ, L - r0), ntc = (L + TQ - 1) / TQ;
    const int rep = a.H / a.G, npb = a.npb;
    const int ndcb = side == 0 ? it + 1 : ntc - it;    // dCB tiles of the row tile
    const int nk = ndcb + rep * npb;
    const int u_lo = rank * nk / ks, u_hi = (rank + 1) * nk / ks;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gr = lane >> 2, c2 = 2 * (lane & 3), rw = warp * 16 + gr;   // rows rw, rw + 8
    const int64_t hp = (int64_t)a.H * a.P, PN = (int64_t)a.P * a.N, QP = a.QP;
    const T* other = side == 0 ? (const T*)a.Bm + b * a.b_sb + g * a.b_sg
                               : (const T*)a.Cm + b * a.c_sb + g * a.c_sg;
    const int64_t ost = side == 0 ? a.b_st : a.c_st;
    const float* dcbc = a.dcb + ((int64_t)bg * a.nc + c) * QP * QP;

    constexpr int STAGE = 2 * RAW + TQ * (int)sizeof(float);
    auto rawA = [&](int k) { return ring + k * STAGE; };
    auto rawB = [&](int k) { return ring + k * STAGE + RAW; };
    auto scales = [&](int k) { return reinterpret_cast<float*>(ring + k * STAGE + 2 * RAW); };
    auto issue = [&](int u, int k) {
        if (u < ndcb) {
            // A: the dCB tile (it, kt) of dC, (kt, it) of dB (read transposed);
            // B: rows kt of B (dC) or C (dB)
            const int kt = side == 0 ? u : it + u;
            const int ti = side == 0 ? it : kt, tj = side == 0 ? kt : it;
            stage<float, float, 1, TQ, LDR>(reinterpret_cast<float*>(rawA(k)), 0,
                                            dcbc + (int64_t)ti * TQ * QP + tj * TQ, QP, TQ, TQ,
                                            true);
            stage<T, T, 1, TQ, LDR>(reinterpret_cast<T*>(rawB(k)), 0,
                                    other + (int64_t)(t0 + kt * TQ) * ost + n0, ost,
                                    L - kt * TQ, ncol, a.vec);
        } else {
            // A: dy (dC) or x (dB) rows of the tile, head h, 64 columns p;
            // B: h_in (dC) or G_{c+1} (dB) rows p of head h
            const int h = g * rep + (u - ndcb) / npb, p0 = ((u - ndcb) % npb) * TQ;
            if (side == 0)
                stage<float, float, 1, TQ, LDR>(
                    reinterpret_cast<float*>(rawA(k)), 0,
                    a.dy + ((int64_t)b * a.S + t0 + r0) * hp + (int64_t)h * a.P + p0, hp, rows,
                    a.P - p0, true);
            else
                stage<T, T, 1, TQ, LDR>(
                    reinterpret_cast<T*>(rawA(k)), 0,
                    (const T*)a.x + b * a.x_sb + h * a.x_sh + (int64_t)(t0 + r0) * a.x_st + p0,
                    a.x_st, rows, a.P - p0, a.vec);
            const float* st = (side == 0 ? a.hin : a.gn)
                            + (((int64_t)b * a.nc + c) * a.H + h) * PN + (int64_t)p0 * a.N + n0;
            stage<float, float, 1, TQ, LDR>(reinterpret_cast<float*>(rawB(k)), 0, st, a.N,
                                            a.P - p0, ncol, true);
            // A's row scales: exp(cum^h_i) (dC) or w^h_j (dB), the dCB kernel's
            if (tid < TQ) {
                const float* sc = (side == 0 ? a.ecum : a.wj) + ((int64_t)b * a.H + h) * a.S + t0 + r0;
                cp_async4(scales(k) + tid, tid < rows ? sc + tid : sc, tid < rows);
            }
        }
        cp_async_commit();
    };

    // the dC side's C of this lane's rows and columns (rsum's share), as
    // pairs of the input's dtype (bf16 pairs hold half the registers)
    using T2 = typename std::conditional<std::is_same<T, bf16>::value, __nv_bfloat162,
                                         float2>::type;
    T2 cv[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
        float lo = 0.f, hi = 0.f;
        const int r = rw + 8 * (m & 1), col = 8 * (m >> 1) + c2;
        if (side == 0 && r < rows && col < ncol) {
            const T* cr = (const T*)a.Cm + b * a.c_sb + g * a.c_sg + (int64_t)(t0 + r0 + r) * a.c_st
                        + n0 + col;
            lo = to_f(cr[0]);
            hi = to_f(cr[1]);
        }
        if constexpr (std::is_same<T, bf16>::value) cv[m] = __floats2bfloat162_rn(lo, hi);
        else cv[m] = make_float2(lo, hi);
    }

    float acc[32], cacc0 = 0.f, cacc1 = 0.f;      // the sum, C_i . acc_i of rows rw, rw + 8
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (u_lo < u_hi) issue(u_lo, 0);
    for (int u = u_lo; u < u_hi; ++u) {
        const int k = (u - u_lo) & 1;
        if (u + 1 < u_hi) issue(u + 1, k ^ 1);
        else cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bool dcbu = u < ndcb;
        // B into NP bf16 pieces, [64 k][64 n] 128-byte swizzled (MN-major)
        for (int e = tid; e < TQ * 8; e += NT) {
            const int kr = e >> 3, ch = e & 7;
            float v[8];
            if (dcbu) {
                const T* p = reinterpret_cast<const T*>(rawB(k)) + kr * LDR + 8 * ch;
#pragma unroll
                for (int q = 0; q < 8; ++q) v[q] = to_f(p[q]);
            } else {
                const float* p = reinterpret_cast<const float*>(rawB(k)) + kr * LDR + 8 * ch;
                const float4 lo = *reinterpret_cast<const float4*>(p);
                const float4 hi = *reinterpret_cast<const float4*>(p + 4);
                v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
                v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
            }
            put8<NP>(v, sBp + sw128(kr, ch, TQ), PIECE);
        }
        fence_async_smem();
        __syncthreads();

        // A of the unit's k-steps in registers: scaled, split into NM pieces
        int h = 0, nks = TQ / 16;
        float s0 = 1.f, s1 = 1.f;
        if (!dcbu) {
            h = g * rep + (u - ndcb) / npb;
            nks = min(TQ, a.P - ((u - ndcb) % npb) * TQ) / 16;
            s0 = scales(k)[rw];
            s1 = scales(k)[rw + 8];
        }
        uint32_t af[4][NM][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            if (kk >= nks) break;
            const int kc = kk * 16 + c2;
            float2 v0, v1, v2, v3;
            if (dcbu && side == 1) {               // dCB^T: rows j, columns i
                const float* p = reinterpret_cast<const float*>(rawA(k));
                v0 = make_float2(p[kc * LDR + rw], p[(kc + 1) * LDR + rw]);
                v1 = make_float2(p[kc * LDR + rw + 8], p[(kc + 1) * LDR + rw + 8]);
                v2 = make_float2(p[(kc + 8) * LDR + rw], p[(kc + 9) * LDR + rw]);
                v3 = make_float2(p[(kc + 8) * LDR + rw + 8], p[(kc + 9) * LDR + rw + 8]);
            } else if (!dcbu && side == 1) {       // x rows, the input's dtype
                const T* p = reinterpret_cast<const T*>(rawA(k)) + rw * LDR + kc;
                v0 = make_float2(to_f(p[0]), to_f(p[1]));
                v1 = make_float2(to_f(p[8 * LDR]), to_f(p[8 * LDR + 1]));
                v2 = make_float2(to_f(p[8]), to_f(p[9]));
                v3 = make_float2(to_f(p[8 * LDR + 8]), to_f(p[8 * LDR + 9]));
            } else {                               // dCB or dy rows, fp32
                const float* p = reinterpret_cast<const float*>(rawA(k)) + rw * LDR + kc;
                v0 = *reinterpret_cast<const float2*>(p);
                v1 = *reinterpret_cast<const float2*>(p + 8 * LDR);
                v2 = *reinterpret_cast<const float2*>(p + 8);
                v3 = *reinterpret_cast<const float2*>(p + 8 * LDR + 8);
            }
            split_pack<NM>(s0 * v0.x, s0 * v0.y, af[kk], 0);
            split_pack<NM>(s1 * v1.x, s1 * v1.y, af[kk], 1);
            split_pack<NM>(s0 * v2.x, s0 * v2.y, af[kk], 2);
            split_pack<NM>(s1 * v3.x, s1 * v3.y, af[kk], 3);
        }
        const uint32_t ub = smem_u32(sBp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            if (kk >= nks) break;
#pragma unroll
            for (int pa = NM - 1; pa >= 0; --pa)
#pragma unroll
                for (int pb = NP - 1; pb >= 0; --pb)
                    if (pa + pb < KEEP)
                        wgmma_rs<1>(acc, af[kk][pa], desc_mn(ub + pb * PIECE + kk * 2048, TQ * 128));
        }
        wg_commit();
        wg_wait<0>();
        reg_fence(acc);
        if (side == 0) {
            // C_i . acc_i after the unit; a state unit's own share is the
            // change (a head's term, small against fp32's 24 bits of the sum)
            float q0 = 0.f, q1 = 0.f;
#pragma unroll
            for (int m = 0; m < 16; ++m) {          // acc[2 m], acc[2 m + 1]: row rw + 8 (m & 1)
                float2 cf;
                if constexpr (std::is_same<T, bf16>::value) cf = __bfloat1622float2(cv[m]);
                else cf = cv[m];
                const float q = acc[2 * m] * cf.x + acc[2 * m + 1] * cf.y;
                if (m & 1) q1 += q;
                else q0 += q;
            }
            q0 = quad_sum(q0);
            q1 = quad_sum(q1);
            if (!dcbu && (lane & 3) == 0) {
                const int slot = a.ntq + ((u - ndcb) % npb) * a.nnb + blockIdx.y;
                float* rs = a.rsum + (((int64_t)b * a.H + h) * a.nrs + slot) * a.S + t0 + r0;
                if (rw < rows) rs[rw] = q0 - cacc0;
                if (rw + 8 < rows) rs[rw + 8] = q1 - cacc1;
            }
            cacc0 = q0;
            cacc1 = q1;
        }
        __syncthreads();                           // the stage and the pieces are free
    }

    // the CTA's partial tile into shared memory, then the cluster's sum
    cp_async_wait<0>();
    __syncthreads();
    float* part = reinterpret_cast<float*>(ring);  // [TQ][LDR]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(part + rw * LDR + 8 * j + c2) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (rw + 8) * LDR + 8 * j + c2) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();
    T* out = (T*)(side == 0 ? a.dC : a.dB) + (((int64_t)b * a.S + t0 + r0) * a.G + g) * a.N + n0;
    const int64_t ost_out = (int64_t)a.G * a.N;
    cluster_tile_sum(part, rank, ks, [&](int r, int col, float4 v) {
        if (r < rows && col < ncol) {
            store_pair(out + r * ost_out + col, v.x, v.y);
            store_pair(out + r * ost_out + col + 2, v.z, v.w);
        }
    });
    cluster_sync();                                // no CTA leaves while its tile is read
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
    const float* gn = a.gn + (((int64_t)b * a.nc + c) * a.H + h) * PN + (int64_t)p0 * a.N;
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


// p[0], p[st], ..., p[7 st] where q < n, else 0 (the loads go out together)
__device__ __forceinline__ void gather8(float (&v)[8], const float* p, int64_t st, int n) {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q < n ? p[q * st] : 0.f;
}
// their sum in order, then p[8 st] ... p[(n - 1) st] (slots past 8: P > 512)
__device__ __forceinline__ float sum8(const float (&v)[8], const float* p, int64_t st, int n) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += v[q];
    for (int q = 8; q < n; ++q) s += p[q * st];
    return s;
}

// 9. the last launch, a CTA per head (blockIdx.x), its batches and chunks
// in order: dcum_i = rsum_i (its slots: the key tiles jt <= i's, then the
// state term's 64 rows p x 64 columns n) - dt_i ddtd_i (its slots: the
// query tiles it >= i's) - W_i, W_j = w_j x_j . T_j (plus sum_j W_j and the
// fold's exp(cum_last) <G_{c+1}, h_in> at the chunk's last position); da =
// dcum summed from the end of the chunk; d(dt)_j = ddtd_j + exp(cum_last -
// cum_j) x_j . T_j + A da_j, and dA the sum of dt da over the head's
// batches and positions.
__global__ void __launch_bounds__(NT) ssd_bwd_final_kernel(Params a) {
    __shared__ float sDt[QMAX], sCum[QMAX];
    __shared__ float red[4], red2[4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h = blockIdx.x;
    const float A = a.A[h];
    float dA_acc = 0.f;
    for (int b = 0; b < a.Bsz; ++b) {
        const int64_t bh = (int64_t)b * a.H + h;
        for (int c = 0; c < a.nc; ++c) {
            const int t0 = c * a.Q, L = min(a.Q, a.S - t0), ntc = (L + TQ - 1) / TQ;
            // the chunk's loads first, so that they are in flight together
            const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
            float dtv[2], xt[2], dd[2], rs[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int j = 2 * tid + k;
                dtv[k] = j < L ? dtb[(int64_t)(t0 + j) * a.dt_st] : 0.f;
            }
            {
                const int64_t S = a.S;
                const float* px[2], *pd[2], *pr[2], *pq[2];
                int nd[2], nr[2];
                float vx[2][8], vd[2][8], vr[2][8], vq[2][8];
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int j = 2 * tid + k, jt = j / TQ, live = j < L;
                    const int64_t o = bh * S + t0 + min(j, L - 1);
                    px[k] = a.xT + bh * (a.npb - 1) * S + o;
                    pd[k] = a.ddtd + bh * (a.ntq - 1) * S + o + jt * S;
                    pr[k] = a.rsum + bh * (a.nrs - 1) * S + o;
                    pq[k] = pr[k] + a.ntq * S;
                    nd[k] = live * (ntc - jt);
                    nr[k] = live * (jt + 1);
                    gather8(vx[k], px[k], S, live * a.npb);
                    gather8(vd[k], pd[k], S, nd[k]);
                    gather8(vr[k], pr[k], S, nr[k]);
                    gather8(vq[k], pq[k], S, live * (a.nrs - a.ntq));
                }
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int live = 2 * tid + k < L;
                    xt[k] = sum8(vx[k], px[k], S, live * a.npb);
                    dd[k] = sum8(vd[k], pd[k], S, nd[k]);
                    rs[k] = sum8(vr[k], pr[k], S, nr[k])
                          + sum8(vq[k], pq[k], S, live * (a.nrs - a.ntq));
                }
            }
            scan_dt(sDt, sCum, red, dtv[0], dtv[1], A);
            const float cum_last = sCum[L - 1];
            float dc[2], part[2], W[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int j = 2 * tid + k;
                dc[k] = part[k] = W[k] = 0.f;
                if (j >= L) continue;
                const float ds = expf(cum_last - sCum[j]) * xt[k];   // the state passing's d(dt)
                W[k] = sDt[j] * ds;
                dc[k] = rs[k] - sDt[j] * dd[k] - W[k];
                part[k] = dd[k] + ds;
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
    // the dCB kernel's with hps heads a slice (their scan tables)
    static constexpr int dcb(int hps) {
        return 1024 + 2 * (std::is_same<T, bf16>::value ? TQ * TQ * (int)sizeof(bf16)
                                                        : TQ * LDR * (int)sizeof(T))
             + (4 * TQ * LDR + 8 * TQ + hps * DCB_TAB) * (int)sizeof(float);
    }
    static constexpr int DCB = dcb(HPS_MAX);
    static constexpr int NP = NI > NM ? NI : NM;
    static constexpr int DBC = 1024 + NP * PIECE + 2 * (2 * TQ * LDR + TQ) * (int)sizeof(float);
    static constexpr int DX = (NM * TQ * LDP + (NI + NM) * TQ * LDN) * (int)sizeof(bf16)
                            + (TQ * LDC + 2 * QMAX) * (int)sizeof(float);
    static_assert(STATE_BWD <= 232448 - 64 && DCB <= 232448 - 64 && DBC <= 232448 - 64 &&
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

// a launch with thread-block clusters of `cluster` CTAs along x (past 8, the
// non-portable sizes an H100 takes, up to 16)
template <typename K>
cudaError_t launch_clustered(K kern, dim3 grid, int cluster, int smem, cudaStream_t stream,
                             const Params& a) {
    if (cluster > 8) {
        const cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// A second stream a device for the backward's launches that need neither U
// nor the fold (dCB) or not dx (dC / dB), and the events that fork it from
// the caller's stream and join it back; made at a device's first backward.
struct SideStream {
    cudaStream_t s = nullptr;
    cudaEvent_t fork = nullptr, folded = nullptr, join = nullptr;
};

cudaError_t side_stream(SideStream*& out) {
    static SideStream sides[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    SideStream& sd = sides[dev];
    if (!sd.s) {
        err = cudaStreamCreateWithFlags(&sd.s, cudaStreamNonBlocking);
        for (cudaEvent_t* e : {&sd.fork, &sd.folded, &sd.join})
            if (err == cudaSuccess) err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
        if (err != cudaSuccess) return err;
    }
    out = &sd;
    return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const Params& a, cudaStream_t stream) {
    using M = Smem<T>;
    static bool ready = false;         // the shared-memory opt-in, once
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(
            ssd_state_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, M::STATE_BWD);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dcb_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DCB);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DBC);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dx_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M::DX);
        // the largest shared-memory carveout, so that two CTAs fit an SM
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dcb_kernel<T>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel<T>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    // caller's stream: U, the fold, dx, the last launch; the side stream:
    // dCB beside U and the fold, then dC / dB (after the fold) beside dx;
    // the last launch waits for both, so the caller's stream orders
    // everything after it
    SideStream* sd = nullptr;
    cudaError_t err = side_stream(sd);
    if (err != cudaSuccess) return err;
    const int BH = a.Bsz * a.H, nt = a.ntq;
    if ((err = cudaEventRecord(sd->fork, stream)) != cudaSuccess) return err;
    if ((err = cudaStreamWaitEvent(sd->s, sd->fork, 0)) != cudaSuccess) return err;
    err = launch_clustered(ssd_bwd_dcb_kernel<T>,
                           dim3(nt * (nt + 1) / 2 * a.slices, a.nc, a.Bsz * a.G), a.slices,
                           M::dcb(a.hps), sd->s, a);
    if (err != cudaSuccess) return err;
    ssd_state_kernel<T, true><<<dim3(a.npb * a.nnb, a.nc, BH), NT, M::STATE_BWD, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_fold_kernel<<<dim3(a.parts, BH), NT, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = cudaEventRecord(sd->folded, stream)) != cudaSuccess) return err;
    if ((err = cudaStreamWaitEvent(sd->s, sd->folded, 0)) != cudaSuccess) return err;
    err = launch_clustered(ssd_bwd_dbc_kernel<T>, dim3(a.nc * nt * a.ks, a.nnb, a.Bsz * a.G * 2),
                           a.ks, M::DBC, sd->s, a);
    if (err != cudaSuccess) return err;
    if ((err = cudaEventRecord(sd->join, sd->s)) != cudaSuccess) return err;
    ssd_bwd_dx_kernel<T><<<dim3(nt * a.npb, a.nc, BH), NT, M::DX, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = cudaStreamWaitEvent(stream, sd->join, 0)) != cudaSuccess) return err;
    ssd_bwd_final_kernel<<<a.H, NT, 0, stream>>>(a);
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
// The plan (ssd_scan.py::bwd_plan): hps heads of a group a dCB slice
// (slices = ceil(H / G / hps) <= 16, a cluster; hps <= 16), ks <= 16 CTAs a
// dB / dC cluster. scratch holds, in fp32: U [B, H, nc, P, N]; h_in and
// G_{c+1} [B, nc, H, P, N] each; dCB [B, G, nc, QP, QP]; rsum [B, H, nt +
// nnb npb, S]; ddtd [B, H, nt, S]; exp(cum) and w [B, H, S] each; x . T [B,
// H, npb, S]; the fold's dots [B, H, nc, parts] (nt = QP / 64, npb = ceil(P
// / 64), nnb = ceil(N / 64), parts = ceil(P N / 1024)). Six launches, no
// atomics; returns the first cudaError_t (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, const void* dy, const void* dhf, void* fwd_scratch, void* scratch,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
    int dtype, int B, int S, int H, int G, int P, int N, int Q, int vec, int hps, int ks,
    int64_t x_sb, int64_t x_st, int64_t x_sh,
    int64_t dt_sb, int64_t dt_st, int64_t dt_sh,
    int64_t b_sb, int64_t b_st, int64_t b_sg,
    int64_t c_sb, int64_t c_st, int64_t c_sg, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 ||
        N <= 0 || N > NMAX || N % 4 || Q <= 0 || Q > QMAX || hps <= 0 || hps > H / G ||
        hps > HPS_MAX ||
        (H / G + hps - 1) / hps > CLUSTER_MAX || ks <= 0 || ks > CLUSTER_MAX)
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
    a.ntq = QP / TQ;
    a.nrs = a.ntq + a.nnb * a.npb;
    a.hps = hps;
    a.slices = (H / G + hps - 1) / hps;
    a.ks = ks;
    const int64_t states = (int64_t)B * H * nc * P * N, rows = (int64_t)B * H * S;
    a.U = (float*)scratch;
    a.hin = a.U + states;
    a.gn = a.hin + states;
    a.dcb = a.gn + states;
    a.rsum = a.dcb + (int64_t)B * G * nc * QP * QP;
    a.ddtd = a.rsum + rows * a.nrs;
    a.ecum = a.ddtd + rows * a.ntq;
    a.wj = a.ecum + rows;
    a.xT = a.wj + rows;
    a.dotp = a.xT + rows * a.npb;
    if (dtype == 0) return launch_bwd<float>(a, (cudaStream_t)stream);
    if (dtype == 1) return launch_bwd<bf16>(a, (cudaStream_t)stream);
    return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
