// Hand-written Hopper (sm_90a) kernel: the Mamba2 SSD forward scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_fwd
// and computes what it computes, one chunk of Q steps at a time, in order,
// with the (P, N) state carried across chunks:
//   da = dt * a;  cum = inclusive cumsum(da);  seg = cum[Q-1]
//   L[i][j] = exp(cum_i - cum_j) for i >= j, else 0
//   y  = ((C B^T) * L * dt_j) x + (C * exp(cum)) h^T + d * x
//   h' = exp(seg) h + x^T (dt * exp(seg - cum) * B)
// with x (BH, S, P), dt (BH, S), a and d (BH,), B and C (BG, S, N) read at
// group bh / groups; y (BH, S, P) in x's dtype and the final state
// (BH, P, N) in f32.
//
// The inf trap. exp(cum_i - cum_j) is evaluated only where i >= j; nothing
// is multiplied by a 0/1 mask. For i < j the exponent is positive, and with
// large dt (the reference's full-width weights give dt of 3 to 20) it
// passes 88 and the exp is +inf in f32, where inf * 0 would be NaN.
//
// Bound on the card: bytes at hymba-1.5b's shape (BH 100, S 2048, P 64,
// N 16, Q 64: x in and y out are 105 MB, 0.031 ms at 3.35 TB/s, against
// 1.9 GFLOP of lower-triangle work, 0.028 ms at 67 TFLOP/s f32);
// operations at mamba2-370m's N 128 (5.9 GFLOP, 0.089 ms). This first
// kernel runs on the CUDA cores in f32 and gives one CTA a whole head, so
// at hymba's shape 100 CTAs leave 32 of the 132 SMs idle; splitting P
// across CTAs (each p row of the state evolves on its own) is later work.
//
// Design. One CTA of 256 threads per bh loops over its S / Q chunks. The
// chunk's x, B, C and dt, the state h, the (Q, Q) product M = G * L * dt_j
// and the chunk's cum, exp(cum) and dt * exp(seg - cum) live in shared
// memory as f32; the intra-chunk tiles never reach device memory. The
// threads form a 16 x 16 grid and each computes a register tile of its
// products (rows ty + 16 r, columns tx + 16 c), so one shared-memory load
// feeds four multiply-adds instead of one half: shared-memory bandwidth,
// not arithmetic, bounds a CUDA-core kernel like this one. Rows of B, C, h
// and M are padded by one float against bank conflicts. Shapes are
// template parameters: Q = 64, P = 64 and N one of 16, 32, 64, 128 (hymba
// 16, mamba2 128); the wrapper refuses others. The cumsum runs in one
// thread, in order, with explicitly rounded adds, so the plain PyTorch
// version (which runs the same sequential sum) gets the same cum bit for
// bit. Every dot product sums in a fixed order; nothing is carried across
// blocks and nothing accumulates with atomics, so a rerun is bit-equal.
// Shared memory above 48 KB (mamba2's shape needs 133 KB) is opted into
// with cudaFuncSetAttribute.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// dtype code 0 = f32, 1 = bf16 for x, dt, B and C (a and d are f32).
// Returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kQ = 64, kP = 64;    // chunk and head dim the kernel takes

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <int Q, int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)Q * (N + 1) +
                          (size_t)P * (N + 1) + (size_t)Q * (Q + 1) +
                          4 * (size_t)Q);
}

template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ d,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ y, float* __restrict__ state, int S,
               int groups) {
  static_assert(Q % 16 == 0 && P % 16 == 0 && N % 16 == 0, "tile sizes");
  constexpr int RQ = Q / 16;        // chunk rows per thread
  constexpr int CQ = Q / 16;        // chunk columns (M) per thread
  constexpr int CP = P / 16;        // head-dim columns (y) per thread
  constexpr int RP = P / 16;        // head-dim rows (state) per thread
  constexpr int CN = N / 16;        // state columns per thread
  constexpr int NS = N + 1, MS = Q + 1;
  extern __shared__ float smem[];
  float* xs = smem;                 // (Q, P)
  float* Bs = xs + Q * P;           // (Q, N+1): B, then w = coef * B
  float* Cs = Bs + Q * NS;          // (Q, N+1)
  float* hs = Cs + Q * NS;          // (P, N+1): the carried state
  float* Ms = hs + P * NS;          // (Q, Q+1)
  float* dts = Ms + Q * MS;         // (Q,)
  float* cum = dts + Q;             // (Q,)
  float* ec = cum + Q;              // exp(cum)
  float* coef = ec + Q;             // dt * exp(seg - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const float av = a[bh], dv = d[bh];
  const T* xb = x + (size_t)bh * S * P;
  const T* db = dt + (size_t)bh * S;
  const T* Bb = Bm + (size_t)(bh / groups) * S * N;
  const T* Cb = Cm + (size_t)(bh / groups) * S * N;
  T* yb = y + (size_t)bh * S * P;

  for (int e = tid; e < P * N; e += kThreads)
    hs[(e / N) * NS + e % N] = 0.f;

  const int nc = S / Q;
  for (int ch = 0; ch < nc; ++ch) {
    const size_t t0 = (size_t)ch * Q;
    __syncthreads();                 // last chunk's reads of xs, Bs done
    for (int e = tid; e < Q * P; e += kThreads)
      xs[e] = ld(xb, t0 * P + e);
    for (int e = tid; e < Q * N; e += kThreads) {
      const int r = e / N, c = e % N;
      Bs[r * NS + c] = ld(Bb, t0 * N + e);
      Cs[r * NS + c] = ld(Cb, t0 * N + e);
    }
    for (int e = tid; e < Q; e += kThreads) dts[e] = ld(db, t0 + e);
    __syncthreads();

    if (tid == 0) {                  // the cumsum, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], av));
        cum[i] = run;
      }
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int e = tid; e < Q; e += kThreads) {
      ec[e] = expf(cum[e]);
      coef[e] = __fmul_rn(dts[e], expf(__fsub_rn(seg, cum[e])));
    }

    // M[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for i >= j, else 0
    {
      float g[RQ][CQ] = {};
      for (int n = 0; n < N; ++n) {
        float cv[RQ], bv[CQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) cv[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < CQ; ++c) bv[c] = Bs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int j = tx + 16 * c;
          // exp only where i >= j: for i < j the exponent is positive and
          // may be +inf, which a 0/1 product would turn into NaN
          Ms[i * MS + j] = i >= j
              ? __fmul_rn(__fmul_rn(g[r][c],
                                    expf(__fsub_rn(cum[i], cum[j]))),
                          dts[j])
              : 0.f;
        }
      }
    }
    __syncthreads();

    // y = (M x + (C * exp(cum)) h^T) + d * x: rows i = ty + 16 r, columns
    // p = tx + 16 c; M is 0 above the diagonal, so j stops at the
    // thread's last row
    {
      float intra[RQ][CP] = {}, inter[RQ][CP] = {};
      for (int j = 0; j <= ty + 16 * (RQ - 1); ++j) {
        float mv[RQ], xv[CP];
#pragma unroll
        for (int r = 0; r < RQ; ++r) mv[r] = Ms[(ty + 16 * r) * MS + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) xv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            intra[r][c] = fmaf(mv[r], xv[c], intra[r][c]);
      }
      float eci[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) eci[r] = ec[ty + 16 * r];
      for (int n = 0; n < N; ++n) {
        float cv[RQ], hv[CP];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
          cv[r] = __fmul_rn(Cs[(ty + 16 * r) * NS + n], eci[r]);
#pragma unroll
        for (int c = 0; c < CP; ++c) hv[c] = hs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int p = tx + 16 * c;
          st(yb, (t0 + i) * P + p,
             __fadd_rn(__fadd_rn(intra[r][c], inter[r][c]),
                       __fmul_rn(dv, xs[i * P + p])));
        }
      }
    }
    // w = coef * B, in place (the y block above reads neither)
    for (int e = tid; e < Q * N; e += kThreads) {
      const int r = e / N, c = e % N;
      Bs[r * NS + c] = __fmul_rn(coef[r], Bs[r * NS + c]);
    }
    __syncthreads();

    // h' = exp(seg) h + x^T w: rows p = ty + 16 r, columns n = tx + 16 c
    {
      const float eseg = expf(seg);
      float upd[RP][CN] = {};
      for (int j = 0; j < Q; ++j) {
        float xv[RP], wv[CN];
#pragma unroll
        for (int r = 0; r < RP; ++r) xv[r] = xs[j * P + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < CN; ++c) wv[c] = Bs[j * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int c = 0; c < CN; ++c) upd[r][c] = fmaf(xv[r], wv[c], upd[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          float* h = hs + (ty + 16 * r) * NS + tx + 16 * c;
          *h = __fadd_rn(__fmul_rn(eseg, *h), upd[r][c]);
        }
    }
  }
  __syncthreads();
  float* sb = state + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    sb[e] = hs[(e / N) * NS + e % N];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const float* a, const float* d,
           const void* B, const void* C, void* y, float* state, int BH,
           int S, int groups, cudaStream_t stream) {
  auto kern = ssd_fwd_kernel<T, kQ, kP, N>;
  constexpr size_t smem = smem_bytes<kQ, kP, N>();
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<BH, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dt, a, d, (const T*)B, (const T*)C, (T*)y,
      state, S, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* x, const void* dt, const float* a,
               const float* d, const void* B, const void* C, void* y,
               float* state, int BH, int S, int groups, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, a, d, B, C, y, state, BH, S, groups, s);
    case 32:
      return launch<T, 32>(x, dt, a, d, B, C, y, state, BH, S, groups, s);
    case 64:
      return launch<T, 64>(x, dt, a, d, B, C, y, state, BH, S, groups, s);
    case 128:
      return launch<T, 128>(x, dt, a, d, B, C, y, state, BH, S, groups, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_fwd(int dtype, const void* x, const void* dt, const float* a,
            const float* d, const void* B, const void* C, void* y,
            float* state, int BH, int S, int P, int N, int Q, int groups,
            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q != kQ || P != kP) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_n<float>(N, x, dt, a, d, B, C, y, state, BH, S, groups,
                             s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, x, dt, a, d, B, C, y, state, BH, S,
                                     groups, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
