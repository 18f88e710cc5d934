// Mamba-2 SSD chunk scan with an initial state, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel :23, pallas_call :84). For each (b, h) it runs, from h0 over S
// positions in chunks of Q,
//   y_t = h_t C_t,   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T
// in the chunked (state-space dual) form: inside a chunk, with cum the
// inclusive cumsum of dt A over the chunk,
//   y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j + exp(cum_i) C_i . h_in
//   h_out = exp(cum_last) h_in + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
// x, B and C are fp32 or bf16; dt, A, h0, y and h_final are fp32, and every
// sum is taken in fp32.
//
// What bounds it on this card: operations. At the main path's shapes
// (H = 48, P = 64, N = 128, Q = 256, one B/C group) a 271-token prefill is
// ~0.6 GFLOP per layer against ~10 MB of inputs and outputs (fp32), ~60
// flops a byte, above the card's ~20 flop/byte fp32 balance point. This
// first version does the products with scalar fp32 FMAs (67 TFLOP/s peak),
// not the tensor cores: it is written to be right and simple first.
//
// Design. The TPU kernel holds a whole chunk in VMEM and runs one grid step
// per (b, h, chunk), in order. Here:
// * One CTA of 256 threads per (16 state rows p, head, batch): rows of the
//   state are independent (y[:, p] needs only h[p, :] and x[:, p]), so
//   B = 1, H = 48, P = 64 gives 192 CTAs on the 132 SMs instead of 48. Each
//   CTA keeps its h[16, N] in shared memory and walks the chunks in order, a
//   loop inside the block in place of the TPU's sequential grid axis. The
//   CTAs of one head recompute the same C . B tile; that is the price of
//   filling the card.
// * A chunk's B and C do not fit one block's shared memory at Q = 256,
//   N = 128 (256 KB in fp32), so the chunk is tiled: 64-row query tiles of C
//   against 64-row key tiles of B and x, with only the j <= i tiles visited.
//   A thread computes a 4 x 4 block of C . B (rows ti + 16 r, columns
//   tj + 16 c; rows padded to N + 1 floats, so the reads are free of bank
//   conflicts), scales it into the scores tile, and the tile times x adds to
//   the thread's 4 outputs y[i, p]. The last query tile visits every key
//   tile of the chunk, so the state update rides along with it.
// * exp(cum_i - cum_j) is computed only where j <= i: on the other side the
//   difference is positive and can overflow to inf (and inf * 0 to NaN).
// * Groups: head h reads B and C of group h / (H / G) through their strides;
//   no broadcast copy is made. x, B and C may be strided views.
// * Ragged S: a chunk's positions past S act as dt = 0 (no decay, no input),
//   which is the TPU kernel's zero padding; nothing is padded or copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int PT = 16;           // state rows p per CTA
constexpr int TQ = 64;           // rows of a query or key tile
constexpr int QMAX = 256;        // chunk positions the scan holds (one per thread)
constexpr int NMAX = 128;        // state width N the tiles hold
constexpr int LDN = NMAX + 1;    // padded row of a B, C or h tile
constexpr int LDS = TQ + 1;      // padded row of the scores tile
constexpr int NK = NMAX / 16;    // state columns per thread in the update
constexpr int SMEM_FLOATS = 2 * TQ * LDN + TQ * LDS + TQ * PT + PT * LDN + 2 * QMAX;
static_assert(QMAX == NT, "the chunk scan gives each thread one position");
static_assert(TQ * PT % NT == 0 && TQ * NMAX % NT == 0, "tile loads");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
    const void *x, *Bm, *Cm;
    const float *dt, *A, *h0;
    float *y, *hout;
    int S, H, G, P, N, Q;
    int64_t x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh;
    int64_t b_sb, b_st, b_sg, c_sb, c_st, c_sg;
};

// rows [0, rows) of a [*, N] operand with row stride st -> dst [TQ][LDN] in
// fp32; rows past `rows` and columns past N are 0. A thread loads 8
// values before storing them, so 8 loads are in flight together without
// holding a whole tile's worth of registers.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t st,
                                          int rows, int N) {
    constexpr int PER = TQ * NMAX / NT, BATCH = 8;
#pragma unroll 1
    for (int k0 = 0; k0 < PER; k0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            const int e = threadIdx.x + NT * (k0 + k);
            const int r = e / NMAX, n = e % NMAX;
            v[k] = (r < rows && n < N) ? to_f(src[(int64_t)r * st + n]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            const int e = threadIdx.x + NT * (k0 + k);
            dst[(e / NMAX) * LDN + e % NMAX] = v[k];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_scan_kernel(Params a) {
    extern __shared__ float smem[];
    float* sC = smem;                 // [TQ][LDN]  C rows of the query tile
    float* sB = sC + TQ * LDN;        // [TQ][LDN]  B rows of the key tile
    float* sS = sB + TQ * LDN;        // [TQ][LDS]  scores of the tile pair
    float* sX = sS + TQ * LDS;        // [TQ][PT]   x of the key tile, this CTA's p
    float* sH = sX + TQ * PT;         // [PT][LDN]  state entering the chunk
    float* sDt = sH + PT * LDN;       // [QMAX]
    float* sCum = sDt + QMAX;         // [QMAX]

    const int tid = threadIdx.x;
    const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
    const int g = h / (a.H / a.G);
    const int N = a.N;
    const float A = a.A[h];
    const T* xb = (const T*)a.x + b * a.x_sb + h * a.x_sh + p0;
    const T* Bb = (const T*)a.Bm + b * a.b_sb + g * a.b_sg;
    const T* Cb = (const T*)a.Cm + b * a.c_sb + g * a.c_sg;
    const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
    float* yb = a.y + (int64_t)b * a.S * a.H * a.P + (int64_t)h * a.P + p0;
    const int64_t y_st = (int64_t)a.H * a.P;
    const int64_t hoff = (((int64_t)b * a.H + h) * a.P + p0) * N;

    for (int e = tid; e < PT * NMAX; e += NT) {
        const int p = e / NMAX, n = e % NMAX;
        sH[p * LDN + n] = n < N ? a.h0[hoff + p * N + n] : 0.f;
    }

    const int ti = tid / 16, tj = tid % 16;   // C.B block: rows ti+16r, cols tj+16c
    const int yi = tid / 16, yp = tid % 16;   // y: rows yi+16r, column p = yp
    const int hp = tid / 16, hn = tid % 16;   // state: row hp, columns hn+16k

    for (int t0 = 0; t0 < a.S; t0 += a.Q) {
        const int L = min(a.Q, a.S - t0);
        __syncthreads();              // the previous chunk is done with sDt, sCum, sH
        const float d = tid < L ? dtb[(int64_t)(t0 + tid) * a.dt_st] : 0.f;
        sDt[tid] = d;
        sCum[tid] = d * A;
        __syncthreads();
        for (int off = 1; off < QMAX; off <<= 1) {   // inclusive scan
            const float v = tid >= off ? sCum[tid - off] : 0.f;
            __syncthreads();
            sCum[tid] += v;
            __syncthreads();
        }
        const float cum_last = sCum[L - 1];
        const float dec_chunk = expf(cum_last);
        float hacc[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) hacc[k] = dec_chunk * sH[hp * LDN + hn + 16 * k];

        const int ntiles = (L + TQ - 1) / TQ;
        for (int it = 0; it < ntiles; ++it) {
            const int i0 = it * TQ, rows_i = min(TQ, L - i0);
            __syncthreads();          // sC is free
            load_rows(sC, Cb + (int64_t)(t0 + i0) * a.c_st, a.c_st, rows_i, N);
            __syncthreads();
            float yacc[TQ / 16];      // inter-chunk part: exp(cum_i) C_i . h_in
#pragma unroll
            for (int r = 0; r < TQ / 16; ++r) {
                const int i = yi + 16 * r;
                float s = 0.f;
#pragma unroll 4
                for (int n = 0; n < N; ++n) s += sC[i * LDN + n] * sH[yp * LDN + n];
                yacc[r] = i < rows_i ? expf(sCum[i0 + i]) * s : 0.f;
            }
            for (int jt = 0; jt <= it; ++jt) {
                const int j0 = jt * TQ, rows_j = min(TQ, L - j0);
                __syncthreads();      // sB, sX and sS are free
                load_rows(sB, Bb + (int64_t)(t0 + j0) * a.b_st, a.b_st, rows_j, N);
#pragma unroll
                for (int k = 0; k < TQ * PT / NT; ++k) {
                    const int e = tid + NT * k, r = e / PT, p = e % PT;
                    sX[r * PT + p] = r < rows_j
                        ? to_f(xb[(int64_t)(t0 + j0 + r) * a.x_st + p]) : 0.f;
                }
                __syncthreads();
                float cb[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
#pragma unroll 4
                for (int n = 0; n < N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) cv[r] = sC[(ti + 16 * r) * LDN + n];
#pragma unroll
                    for (int c = 0; c < 4; ++c) bv[c] = sB[(tj + 16 * c) * LDN + n];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) cb[r][c] += cv[r] * bv[c];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int i = ti + 16 * r, j = tj + 16 * c;
                        const int gi = i0 + i, gj = j0 + j;
                        float s = 0.f;
                        if (gj <= gi && gi < L)   // mask before exp
                            s = cb[r][c] * expf(sCum[gi] - sCum[gj]) * sDt[gj];
                        sS[i * LDS + j] = s;
                    }
                }
                __syncthreads();
#pragma unroll
                for (int r = 0; r < TQ / 16; ++r) {
                    const int i = yi + 16 * r;
                    float s = 0.f;
#pragma unroll 8
                    for (int j = 0; j < TQ; ++j) s += sS[i * LDS + j] * sX[j * PT + yp];
                    yacc[r] += s;
                }
                if (it == ntiles - 1) {   // state update over every key tile
                    for (int j = 0; j < rows_j; ++j) {
                        const float w = expf(cum_last - sCum[j0 + j]) * sDt[j0 + j]
                                        * sX[j * PT + hp];
#pragma unroll
                        for (int k = 0; k < NK; ++k) hacc[k] += w * sB[j * LDN + hn + 16 * k];
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < TQ / 16; ++r) {
                const int i = yi + 16 * r;
                if (i < rows_i) yb[(int64_t)(t0 + i0 + i) * y_st + yp] = yacc[r];
            }
        }
        __syncthreads();              // every thread is done reading sH
#pragma unroll
        for (int k = 0; k < NK; ++k) sH[hp * LDN + hn + 16 * k] = hacc[k];
    }
    __syncthreads();
    for (int e = tid; e < PT * NMAX; e += NT) {
        const int p = e / NMAX, n = e % NMAX;
        if (n < N) a.hout[hoff + p * N + n] = sH[p * LDN + n];
    }
}

template <typename T>
cudaError_t launch(const Params& a, int B, cudaStream_t stream) {
    const int smem = SMEM_FLOATS * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<T><<<dim3(a.P / PT, a.H, B), NT, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16. x is [B, S, H, P], dt
// [B, S, H] (fp32, post-softplus), B and C [B, S, G, N] with G dividing H,
// each with a contiguous last axis and the strides given (in elements).
// A [H], h0 [B, H, P, N], y [B, S, H, P] and hout [B, H, P, N] are
// contiguous fp32. P must be a multiple of 16, N at most 128, Q (the chunk
// length) at most 256. Returns the launch's cudaError_t (0 on success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, void* y, void* hout,
    int dtype, int B, int S, int H, int G, int P, int N, int Q,
    int64_t x_sb, int64_t x_st, int64_t x_sh,
    int64_t dt_sb, int64_t dt_st, int64_t dt_sh,
    int64_t b_sb, int64_t b_st, int64_t b_sg,
    int64_t c_sb, int64_t c_st, int64_t c_sg, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % PT ||
        N <= 0 || N > NMAX || Q <= 0 || Q > QMAX)
        return cudaErrorInvalidValue;
    Params a{x, Bm, Cm, (const float*)dt, (const float*)A, (const float*)h0,
             (float*)y, (float*)hout, S, H, G, P, N, Q,
             x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh,
             b_sb, b_st, b_sg, c_sb, c_st, c_sg};
    if (dtype == 0) return launch<float>(a, B, (cudaStream_t)stream);
    if (dtype == 1) return launch<__nv_bfloat16>(a, B, (cudaStream_t)stream);
    return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
