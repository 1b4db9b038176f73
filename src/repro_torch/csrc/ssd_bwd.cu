// Hand-written Hopper (sm_90a) kernels: the gradient of the Mamba2 SSD
// chunked scan (csrc/ssd.cu), in four launches.
//
// No pallas_call stands behind this kernel: the Pallas ssd_fwd is forward-
// only, and the JAX reference trains through jax's autodiff of the jnp
// chunked scan src/repro/models/ssm.py::ssd_apply. This replaces that
// autodiff. Per chunk of Q steps (x, dy (Q, P); dt, cum (Q,); B, C (Q, N)
// of the head's group; h the state entering the chunk and dh the gradient
// of the state leaving it, both (P, N); seg = cum[Q-1]; G = C B^T and
// L[i][j] = exp(cum_i - cum_j) for i >= j):
//   M   = G * L * dt_j (the forward's),   dM = dy x^T (i >= j)
//   W   = dM * L,  dG = W * dt_j,  Z = W * G
//   v_j = dh B_j,  dcoef_j = x_j . v_j,  coef_j = dt_j exp(seg - cum_j)
//   dx  = M^T dy + coef * v + d * dy
//   dB  = dG^T C + coef * (x dh)          (this head's part)
//   dC  = dG B + exp(cum) * (dy h)        (this head's part)
//   dda_t = sum_{i>=t>j} Z_ij dt_j + sum_{i>=t} exp(cum_i) C_i . (dy h)_i
//           + sum_{j<t} dcoef_j coef_j + exp(seg) sum(dh * h)
//   ddt = sum_{i>=j} Z_ij + dcoef * exp(seg - cum) + a * dda
//   da  = sum dt * dda,  dd = sum dy * x
// and the state gradient runs backwards over the chunks,
//   dh_c = exp(seg_c) dh_{c+1} + dy_c^T (C_c * exp(cum_c)),
// from the final state's gradient (zero when it has none).
//
// The NaN trap (ROADMAP C-11). Every exp here has an argument <= 0 for
// a < 0 and dt > 0: L only where i >= j, exp(cum), exp(seg - cum),
// exp(seg). exp(cum_i - cum_j) for i < j is never evaluated, not even under
// a branch that discards it: at the reference's full-width dt (3 to 20) it
// is +inf, and autodiff of a where over it gives 0 * inf = NaN, which is
// what the reference's gradient does.
//
// Bound on the card: operations. Per chunk 2 tri (2P + 2N) + 8 Q P N
// products (tri = Q (Q + 1) / 2): at hymba-1.5b's training shape (BH 50,
// S 2048, P 64, N 16, Q 64) 1.9 GFLOP, 0.028 ms at 67 TFLOP/s f32, against
// 86 MB of x, dy, dx, the saved states and B, C, dB, dC (0.026 ms); at
// mamba2-370m's (BH 32, N 128) 5.9 GFLOP, 0.088 ms.
//
// Design. A simple first kernel, right before fast:
//   1. ssd_bwd_state_kernel, one CTA per (bh, chunk): the chunk-local part
//      of the state gradient, dy^T (C * exp(cum)), into the scratch dH
//      (BH, nc, P, N).
//   2. ssd_bwd_scan_kernel, one thread per (bh, four state entries): the
//      scan over the chunks in reverse; overwrites dH[c] with the gradient
//      of the state leaving chunk c.
//   3. ssd_bwd_chunk_kernel, one CTA per (bh, chunk): everything else, from
//      the forward's saved state entering the chunk (hst), its cum and G.
//      Operands sit in shared memory (rows padded by four floats), and each
//      product runs on register tiles of up to 4 x 8 outputs a thread, the
//      reduction index ascending from 0 with fmaf; the phases reuse one
//      region (M and Z, then M and v, then h). dB and dC are written per
//      head, da and dd per chunk.
//   4. ssd_bwd_sum_kernel: dB and dC summed over the heads of each group,
//      da and dd over the chunks, each in order.
// Nothing accumulates with atomics and every sum has a fixed order, so a
// rerun is bit-equal; the reverse cumsum runs in one thread, in order.
// f32 only (training runs SSD in f32). Template shapes: P = 64, N one of
// 16, 32, 64, 128 and Q one of 8, 16, 32, 64, as the forward; the wrapper
// zero-pads P and N as it does there, which adds exact zeros to every sum.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// the caller allocates outputs and scratch. Returns the first
// cudaGetLastError() that is not cudaSuccess after the launches, or
// cudaSuccess.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 64;
constexpr int kScanThreads = 256;
constexpr int kSumThreads = 256;

// an (R, C) output over the CTA's threads: a thread owns TM x TN outputs at
// rows tr + RT m and columns tc + CT n
template <int R, int C>
struct Tiling {
  static constexpr int TM = R >= 16 ? R / 16 : 1;
  static constexpr int TN = C >= 16 ? C / 16 : 1;
  static constexpr int RT = R / TM;
  static constexpr int CT = C / TN;
  static constexpr int kActive = RT * CT;
  static_assert(kActive <= kThreads, "tiling");
};

// acc[m][n] = fmaf chain over k = 0 .. K-1 of A(row m, k) * B(column n, k)
template <int R, int C, int K, typename FA, typename FB>
__device__ __forceinline__ void mm(
    const FA& A, const FB& B, int tr, int tc,
    float (&acc)[Tiling<R, C>::TM][Tiling<R, C>::TN]) {
  using T = Tiling<R, C>;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[T::TM], bv[T::TN];
#pragma unroll
    for (int m = 0; m < T::TM; ++m) av[m] = A(tr + T::RT * m, k);
#pragma unroll
    for (int n = 0; n < T::TN; ++n) bv[n] = B(tc + T::CT * n, k);
#pragma unroll
    for (int m = 0; m < T::TM; ++m)
#pragma unroll
      for (int n = 0; n < T::TN; ++n)
        acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

// a (R, K) row-major tile of global memory into shared memory with row
// stride K + 4, in 16-byte vectors (K % 4 == 0, 16-byte aligned source)
template <int R, int K>
__device__ __forceinline__ void load_rows(const float* src, float* dst) {
  for (int e = 4 * threadIdx.x; e < R * K; e += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + (e / K) * (K + 4) + e % K) =
        *reinterpret_cast<const float4*>(src + e);
}

// ---- launch 1: per (bh, chunk), dy^T (C * exp(cum)) ----------------------

template <int Q, int N>
constexpr size_t state_smem_bytes() {
  return sizeof(float) * ((size_t)Q * (kP + 4) + (size_t)Q * (N + 4) + Q);
}

template <int Q, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ dy,
                     const float* __restrict__ Cm,
                     const float* __restrict__ cum_in,
                     float* __restrict__ dH, int S, int groups) {
  constexpr int P = kP, XS = P + 4, NS = N + 4;
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                // (Q, P+4)
  float* Cs = dys + Q * XS;         // (Q, N+4)
  float* ec = Cs + Q * NS;          // exp(cum)
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const size_t t0 = (size_t)ch * Q;
  load_rows<Q, P>(dy + ((size_t)bh * S + t0) * P, dys);
  load_rows<Q, N>(Cm + ((size_t)(bh / groups) * S + t0) * N, Cs);
  for (int e = tid; e < Q; e += kThreads)
    ec[e] = expf(cum_in[(size_t)bh * S + t0 + e]);
  __syncthreads();
  using T = Tiling<P, N>;
  if (tid >= T::kActive) return;
  const int tr = tid / T::CT, tc = tid % T::CT;
  float acc[T::TM][T::TN] = {};
  mm<P, N, Q>([&](int p, int i) { return dys[i * XS + p]; },
              [&](int n, int i) { return __fmul_rn(ec[i], Cs[i * NS + n]); },
              tr, tc, acc);
  float* out = dH + ((size_t)bh * nc + ch) * P * N;
#pragma unroll
  for (int m = 0; m < T::TM; ++m)
#pragma unroll
    for (int n = 0; n < T::TN; ++n)
      out[(tr + T::RT * m) * N + tc + T::CT * n] = acc[m][n];
}

// ---- launch 2: per (bh, 4 state entries), the reverse scan ---------------

__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_scan_kernel(float* __restrict__ dH, const float* __restrict__ cum,
                    const float* __restrict__ dstate, int PN, int nc, int Q,
                    int S, int blocks_per_bh) {
  const int bh = blockIdx.x / blocks_per_bh;
  const int e = 4 * ((blockIdx.x % blocks_per_bh) * kScanThreads +
                     threadIdx.x);
  if (e >= PN) return;
  float* hb = dH + (size_t)bh * nc * PN + e;
  const float* cb = cum + (size_t)bh * S;
  float4 h = dstate != nullptr
      ? *reinterpret_cast<const float4*>(dstate + (size_t)bh * PN + e)
      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float4* slot = reinterpret_cast<float4*>(hb + (size_t)c * PN);
    const float4 u = *slot;
    const float es = expf(cb[(size_t)c * Q + Q - 1]);
    *slot = h;                      // the gradient of the state leaving c
    h.x = __fadd_rn(__fmul_rn(es, h.x), u.x);
    h.y = __fadd_rn(__fmul_rn(es, h.y), u.y);
    h.z = __fadd_rn(__fmul_rn(es, h.z), u.z);
    h.w = __fadd_rn(__fmul_rn(es, h.w), u.w);
  }
}

// ---- launch 3: per (bh, chunk), the gradients ----------------------------

template <int Q, int N>
struct ChunkSmem {
  static constexpr int QP = Q * (kP + 4), QQ = Q * (Q + 4);
  static constexpr int QN = Q * (N + 4), PN = kP * (N + 4);
  static constexpr int R1a = QQ + (QQ > QP ? QQ : QP);   // M and Z, or v
  static constexpr int R1 = R1a > PN ? R1a : PN;         // or h
  static constexpr int kSmall = 10 * Q + 2 * kThreads;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(2 * QP + QQ + 2 * QN + PN + R1 + kSmall);
};

template <int Q, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ d,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ cum_in,
                     const float* __restrict__ G,
                     const float* __restrict__ hst,
                     const float* __restrict__ dH, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBp,
                     float* __restrict__ dCp, float* __restrict__ dad, int S,
                     int groups) {
  constexpr int P = kP, XS = P + 4, QS = Q + 4, NS = N + 4;
  using Sm = ChunkSmem<Q, N>;
  static_assert(Q % 4 == 0 && N % 16 == 0, "tile sizes");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // (Q, P+4)
  float* dys = xs + Sm::QP;         // (Q, P+4)
  float* dGs = dys + Sm::QP;        // (Q, Q+4)
  float* Bs = dGs + Sm::QQ;         // (Q, N+4)
  float* Cs = Bs + Sm::QN;          // (Q, N+4)
  float* dhs = Cs + Sm::QN;         // (P, N+4): dh of the state leaving
  float* r1 = dhs + Sm::PN;
  float* Ms = r1;                   // (Q, Q+4)         phases A, B
  float* Zs = r1 + Sm::QQ;          // (Q, Q+4): G, Z   phase A
  float* Vs = Zs;                   // (Q, P+4): v      phase B
  float* hs = r1;                   // (P, N+4): h      phase D
  float* dts = r1 + Sm::R1;
  float* cum = dts + Q;
  float* ec = cum + Q;              // exp(cum)
  float* ecoef = ec + Q;            // exp(seg - cum)
  float* coef = ecoef + Q;          // dt exp(seg - cum)
  float* dcoef = coef + Q;
  float* ddaL = dcoef + Q;          // sum_{j<t} ZS[t][j] dt_j
  float* ddtM = ddaL + Q;           // sum_{i>=j} Z[i][j]
  float* dcumE = ddtM + Q;          // exp(cum_i) C_i . (dy h)_i
  float* dda = dcumE + Q;
  float* red = dda + Q;             // (2, kThreads)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const int bg = bh / groups;
  const size_t t0 = (size_t)ch * Q;
  const size_t row0 = (size_t)bh * S + t0;       // first step of the chunk
  const size_t grow0 = (size_t)bg * S + t0;

  load_rows<Q, P>(x + row0 * P, xs);
  load_rows<Q, P>(dy + row0 * P, dys);
  load_rows<Q, N>(Bm + grow0 * N, Bs);
  load_rows<Q, N>(Cm + grow0 * N, Cs);
  load_rows<P, N>(dH + ((size_t)bh * nc + ch) * P * N, dhs);
  load_rows<Q, Q>(G + ((size_t)bg * nc + ch) * Q * Q, Zs);
  for (int e = tid; e < Q; e += kThreads) {
    dts[e] = dt[row0 + e];
    cum[e] = cum_in[row0 + e];
  }
  __syncthreads();
  const float seg = cum[Q - 1];
  for (int e = tid; e < Q; e += kThreads) {
    ec[e] = expf(cum[e]);
    ecoef[e] = expf(__fsub_rn(seg, cum[e]));
    coef[e] = __fmul_rn(dts[e], ecoef[e]);
  }

  // phase A: dM = dy x^T, then M, dG and Z where i >= j (0 elsewhere)
  {
    using T = Tiling<Q, Q>;
    if (tid < T::kActive) {
      const int tr = tid / T::CT, tc = tid % T::CT;
      float acc[T::TM][T::TN] = {};
      mm<Q, Q, P>([&](int i, int k) { return dys[i * XS + k]; },
                  [&](int j, int k) { return xs[j * XS + k]; }, tr, tc, acc);
#pragma unroll
      for (int m = 0; m < T::TM; ++m)
#pragma unroll
        for (int n = 0; n < T::TN; ++n) {
          const int i = tr + T::RT * m, j = tc + T::CT * n;
          float mv = 0.f, dg = 0.f, z = 0.f;
          if (i >= j) {             // the only exp of a cum difference
            const float g = Zs[i * QS + j];
            const float L = expf(__fsub_rn(cum[i], cum[j]));
            mv = __fmul_rn(__fmul_rn(g, L), dts[j]);
            const float w = __fmul_rn(acc[m][n], L);
            dg = __fmul_rn(w, dts[j]);
            z = __fmul_rn(w, g);
          }
          Ms[i * QS + j] = mv;
          dGs[i * QS + j] = dg;
          Zs[i * QS + j] = z;       // G[i][j] was read by this thread only
        }
    }
  }
  __syncthreads();
  // Z's column suffix sums ZS[t][j] = sum_{i>=t} Z[i][j] in place, each
  // column in order from the bottom; ddt's sum over i >= j is ZS[j][j]
  for (int j = tid; j < Q; j += kThreads) {
    float run = 0.f;
    for (int i = Q - 1; i >= j; --i) {
      run = __fadd_rn(run, Zs[i * QS + j]);
      Zs[i * QS + j] = run;
    }
    ddtM[j] = run;
  }
  __syncthreads();
  // da_t's gradient through the L entries that span t: sum_{j<t} ZS[t][j]
  // dt_j (no cancellation: every term is an entry with i >= t > j)
  for (int t = tid; t < Q; t += kThreads) {
    float s = 0.f;
    for (int j = 0; j < t; ++j) s = fmaf(Zs[t * QS + j], dts[j], s);
    ddaL[t] = s;
  }
  __syncthreads();

  // phase B: v = B dh^T, dcoef = x . v, dx = M^T dy + coef v + d dy
  {
    using T = Tiling<Q, P>;
    if (tid < T::kActive) {
      const int tr = tid / T::CT, tc = tid % T::CT;
      float acc[T::TM][T::TN] = {};
      mm<Q, P, N>([&](int j, int n) { return Bs[j * NS + n]; },
                  [&](int p, int n) { return dhs[p * NS + n]; }, tr, tc, acc);
#pragma unroll
      for (int m = 0; m < T::TM; ++m)
#pragma unroll
        for (int n = 0; n < T::TN; ++n)
          Vs[(tr + T::RT * m) * XS + tc + T::CT * n] = acc[m][n];
    }
  }
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = fmaf(xs[j * XS + p], Vs[j * XS + p], s);
    dcoef[j] = s;
  }
  {
    using T = Tiling<Q, P>;
    if (tid < T::kActive) {
      const int tr = tid / T::CT, tc = tid % T::CT;
      const float dv = d[bh];
      float acc[T::TM][T::TN] = {};
      mm<Q, P, Q>([&](int j, int i) { return Ms[i * QS + j]; },
                  [&](int p, int i) { return dys[i * XS + p]; }, tr, tc, acc);
#pragma unroll
      for (int m = 0; m < T::TM; ++m)
#pragma unroll
        for (int n = 0; n < T::TN; ++n) {
          const int j = tr + T::RT * m, p = tc + T::CT * n;
          dx[(row0 + j) * P + p] = __fadd_rn(
              __fadd_rn(acc[m][n], __fmul_rn(coef[j], Vs[j * XS + p])),
              __fmul_rn(dv, dys[j * XS + p]));
        }
    }
  }

  // phase C: this head's dB = dG^T C + coef (x dh)
  {
    using T = Tiling<Q, N>;
    if (tid < T::kActive) {
      const int tr = tid / T::CT, tc = tid % T::CT;
      float acc[T::TM][T::TN] = {}, acc2[T::TM][T::TN] = {};
      mm<Q, N, Q>([&](int j, int i) { return dGs[i * QS + j]; },
                  [&](int n, int i) { return Cs[i * NS + n]; }, tr, tc, acc);
      mm<Q, N, P>([&](int j, int p) { return xs[j * XS + p]; },
                  [&](int n, int p) { return dhs[p * NS + n]; }, tr, tc,
                  acc2);
#pragma unroll
      for (int m = 0; m < T::TM; ++m)
#pragma unroll
        for (int n = 0; n < T::TN; ++n) {
          const int j = tr + T::RT * m;
          dBp[(row0 + j) * N + tc + T::CT * n] =
              __fadd_rn(acc[m][n], __fmul_rn(coef[j], acc2[m][n]));
        }
    }
  }
  __syncthreads();                  // M and v are dead: h takes their place

  // phase D: this head's dC = dG B + exp(cum) (dy h), and dda's exp(cum)
  // terms; sum(dh * h) and sum(dy * x) for dda's exp(seg) term and dd
  load_rows<P, N>(hst + ((size_t)bh * nc + ch) * P * N, hs);
  __syncthreads();
  {
    using T = Tiling<Q, N>;
    static_assert(T::CT == 16, "a row's 16 lanes share a half-warp");
    if (tid < T::kActive) {
      const int tr = tid / T::CT, tc = tid % T::CT;
      float acc[T::TM][T::TN] = {}, acc2[T::TM][T::TN] = {};
      mm<Q, N, Q>([&](int i, int j) { return dGs[i * QS + j]; },
                  [&](int n, int j) { return Bs[j * NS + n]; }, tr, tc, acc);
      mm<Q, N, P>([&](int i, int p) { return dys[i * XS + p]; },
                  [&](int n, int p) { return hs[p * NS + n]; }, tr, tc,
                  acc2);
#pragma unroll
      for (int m = 0; m < T::TM; ++m) {
        const int i = tr + T::RT * m;
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < T::TN; ++n) {
          const int col = tc + T::CT * n;
          dCp[(row0 + i) * N + col] =
              __fadd_rn(acc[m][n], __fmul_rn(ec[i], acc2[m][n]));
          part = fmaf(Cs[i * NS + col], acc2[m][n], part);
        }
        // the row's 16 lanes, in a fixed tree
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
        if (tc == 0) dcumE[i] = __fmul_rn(ec[i], part);
      }
    }
  }
  {
    float s1 = 0.f, s2 = 0.f;
    for (int e = tid; e < P * N; e += kThreads)
      s1 = fmaf(dhs[(e / N) * NS + e % N], hs[(e / N) * NS + e % N], s1);
    for (int e = tid; e < Q * P; e += kThreads)
      s2 = fmaf(dys[(e / P) * XS + e % P], xs[(e / P) * XS + e % P], s2);
    red[tid] = s1;
    red[kThreads + tid] = s2;
  }
  __syncthreads();

  // phase E: the gradient of da_t: the L entries that span t, exp(cum_i)
  // for i >= t (a reverse cumsum), coef_j for j < t (an exclusive
  // cumsum), exp(seg); then ddt, and the da, dd partials. One thread, in
  // order.
  if (tid == 0) {
    float hsum = 0.f, ddsum = 0.f;
    for (int t = 0; t < kThreads; ++t) {
      hsum = __fadd_rn(hsum, red[t]);
      ddsum = __fadd_rn(ddsum, red[kThreads + t]);
    }
    const float hterm = __fmul_rn(expf(seg), hsum);
    float run = 0.f;
    for (int t = Q - 1; t >= 0; --t) {
      run = __fadd_rn(run, dcumE[t]);
      dda[t] = run;
    }
    float before = 0.f, dap = 0.f;
    for (int t = 0; t < Q; ++t) {
      const float v = __fadd_rn(
          __fadd_rn(__fadd_rn(ddaL[t], dda[t]), before), hterm);
      dda[t] = v;
      before = fmaf(dcoef[t], coef[t], before);
      dap = fmaf(dts[t], v, dap);
    }
    float* o = dad + ((size_t)bh * nc + ch) * 2;
    o[0] = dap;
    o[1] = ddsum;
  }
  __syncthreads();
  const float av = a[bh];
  for (int i = tid; i < Q; i += kThreads)
    ddt[row0 + i] = __fadd_rn(
        __fadd_rn(ddtM[i], __fmul_rn(dcoef[i], ecoef[i])),
        __fmul_rn(av, dda[i]));
}

// ---- launch 4: dB, dC over the heads of a group; da, dd over chunks ------

__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_sum_kernel(const float* __restrict__ dBp,
                   const float* __restrict__ dCp,
                   const float* __restrict__ dad, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ da,
                   float* __restrict__ dd, long long per_group, int BG,
                   int groups, int BH, int nc) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  const long long nbc = (long long)BG * per_group;
  if (e < nbc) {
    const long long bg = e / per_group, r = e % per_group;
    const float* pb = dBp + bg * groups * per_group + r;
    const float* pc = dCp + bg * groups * per_group + r;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < groups; ++g) {
      sb = __fadd_rn(sb, pb[(long long)g * per_group]);
      sc = __fadd_rn(sc, pc[(long long)g * per_group]);
    }
    dB[e] = sb;
    dC[e] = sc;
  } else if (e < nbc + BH) {
    const int bh = (int)(e - nbc);
    float sa = 0.f, sd = 0.f;
    for (int c = 0; c < nc; ++c) {
      sa = __fadd_rn(sa, dad[((size_t)bh * nc + c) * 2]);
      sd = __fadd_rn(sd, dad[((size_t)bh * nc + c) * 2 + 1]);
    }
    da[bh] = sa;
    dd[bh] = sd;
  }
}

template <typename K>
cudaError_t opt_in(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const float *x, *dt, *a, *d, *B, *C, *dy, *dstate, *cum, *G, *hst;
  float *dx, *ddt, *da, *dd, *dB, *dC;
  float *dH, *dBp, *dCp, *dad;
  int BH, S, groups;
  cudaStream_t s;
};

template <int Q, int N>
int launch(const Args& r) {
  auto k1 = ssd_bwd_state_kernel<Q, N>;
  auto k3 = ssd_bwd_chunk_kernel<Q, N>;
  constexpr size_t smem1 = state_smem_bytes<Q, N>();
  constexpr size_t smem3 = ChunkSmem<Q, N>::bytes;
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr1 = opt_in(k1, smem1);
  static const cudaError_t attr3 = opt_in(k3, smem3);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  const int nc = r.S / Q, PN = kP * N;
  const dim3 grid(r.BH, nc);
  k1<<<grid, kThreads, smem1, r.s>>>(r.dy, r.C, r.cum, r.dH, r.S, r.groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bpb = (PN / 4 + kScanThreads - 1) / kScanThreads;
  ssd_bwd_scan_kernel<<<r.BH * bpb, kScanThreads, 0, r.s>>>(
      r.dH, r.cum, r.dstate, PN, nc, Q, r.S, bpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3<<<grid, kThreads, smem3, r.s>>>(
      r.x, r.dt, r.a, r.d, r.B, r.C, r.dy, r.cum, r.G, r.hst, r.dH, r.dx,
      r.ddt, r.dBp, r.dCp, r.dad, r.S, r.groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int BG = r.BH / r.groups;
  const long long per_group = (long long)r.S * N;
  const long long total = BG * per_group + r.BH;
  const unsigned blocks = (unsigned)((total + kSumThreads - 1) / kSumThreads);
  ssd_bwd_sum_kernel<<<blocks, kSumThreads, 0, r.s>>>(
      r.dBp, r.dCp, r.dad, r.dB, r.dC, r.da, r.dd, per_group, BG, r.groups,
      r.BH, nc);
  return (int)cudaGetLastError();
}

template <int Q>
int dispatch_n(int N, const Args& r) {
  switch (N) {
    case 16: return launch<Q, 16>(r);
    case 32: return launch<Q, 32>(r);
    case 64: return launch<Q, 64>(r);
    case 128: return launch<Q, 128>(r);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, dy, dx (BH, S, P); dt, cum, ddt (BH, S); a, d, da, dd (BH,); B, C, dB,
// dC (BH / groups, S, N); dstate (BH, P, N) or null for a zero gradient;
// G (BH / groups, S / Q, Q, Q) and hst (BH, S / Q, P, N) as the forward
// left them. f32 scratch: dH (BH, S / Q, P, N), dBp and dCp (BH, S, N),
// dad (BH, S / Q, 2).
int ssd_bwd(const float* x, const float* dt, const float* a, const float* d,
            const float* B, const float* C, const float* dy,
            const float* dstate, const float* cum, const float* G,
            const float* hst, float* dx, float* ddt, float* da, float* dd,
            float* dB, float* dC, float* dH, float* dBp, float* dCp,
            float* dad, int BH, int S, int P, int N, int Q, int groups,
            void* stream) {
  if (P != kP || Q < 1 || S % Q != 0 || S / Q > 65535 || groups < 1 ||
      BH % groups != 0)
    return (int)cudaErrorInvalidValue;
  const Args r{x,   dt, a,  d,  B,   C,   dy,  dstate, cum, G,  hst,
               dx,  ddt, da, dd, dB,  dC,  dH,  dBp,    dCp, dad,
               BH,  S,  groups, (cudaStream_t)stream};
  switch (Q) {
    case 8: return dispatch_n<8>(N, r);
    case 16: return dispatch_n<16>(N, r);
    case 32: return dispatch_n<32>(N, r);
    case 64: return dispatch_n<64>(N, r);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
