// Hand-written Hopper (sm_90a) kernels: the Mamba2 SSD forward scan, as a
// chunk-parallel scan in three launches.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_fwd
// and computes what it computes, one chunk of Q steps at a time with the
// (P, N) state carried across chunks:
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
// operations at mamba2-370m's N 128 (5.9 GFLOP, 0.089 ms).
//
// Design. Only the state couples chunks, and h' = e^{seg} h + upd, where
// upd = x^T (dt e^{seg - cum} B) does not depend on h. So the scan runs in
// three launches, in order on one stream, where the TPU's grid walked the
// chunks in sequence:
//   1. ssd_chunk_state, one CTA per (bh, chunk): cum (one thread, in
//      order), seg and upd_c; writes upd_c to an f32 scratch (BH, nc, P, N),
//      e^{seg_c} to (BH, nc) and cum to (BH, S). The CTA of the first head
//      of each group also forms G = C B^T for the chunk into (BG, nc, Q, Q):
//      B and C are the group's, so the heads of a group (50 in hymba, 32 in
//      mamba2) share one G instead of forming it each.
//   2. ssd_state_scan, one thread per (bh, four state entries): h_c =
//      e^{seg_c} h_{c-1} + upd_c over the chunks in order; overwrites the
//      scratch with the state entering each chunk and writes the final
//      state.
//   3. ssd_chunk_output, one CTA per (bh, chunk): M = G * L * dt_j from
//      the stored G and cum, y = M x + (C e^{cum}) h_in^T + d x.
// At hymba's shape that is 3,200 CTAs in launches 1 and 3 (2,048 at
// mamba2's) on 132 SMs; a CTA a head would be 100, each on a chain of 32
// dependent chunks. Every product sums over its reduction index in
// ascending order from 0 with fmaf, every other operation is an explicitly
// rounded intrinsic in the plain version's association order, and nothing
// accumulates with atomics, so the split into launches changes no bit of
// y or the state, and a rerun is bit-equal. The CUDA cores compute in f32
// (the model hands the kernel f32). Threads form a 16 x 16 grid with
// register tiles of 4 x 4 (or 4 x N/16) outputs; operands sit in shared
// memory laid out so that the reduction index is contiguous and every
// load is a 16-byte vector (x and B are stored transposed in launch 1),
// rows padded by four floats so that those vectors do not conflict on
// banks. In launch 3 a thread owns rows 2 ty, 2 ty + 1, 62 - 2 ty and
// 63 - 2 ty, and each row's sum over the lower triangle of M stops after
// its own index: half the work of full rows, the same for every warp.
// Shapes are template parameters: P = 64, N one of 16, 32, 64, 128 and the
// chunk Q one of 8, 16, 32, 64 (hymba-1.5b and mamba2-370m take Q 64; the
// zoo's reduced configs Q 8). The wrapper zero-pads a smaller P or N to
// the next of those: zero columns of x, or of B and C, add exact zeros at
// the end of every fmaf chain, so y and the state keep every bit. The chunk
// cannot be padded (it changes which steps share a cumsum), so every Q has
// its own instantiation. At Q 64 the products run on 4 x 4 register tiles
// as described above; below 64 (reduced configs only) G and y are formed
// one output a thread at a time, with the same sums in the same order.
//
// The bf16-tile variant (TB, ssd_fwd_tile_bf16; the reference's
// ssd_apply(tile_bf16=True)) rounds to bf16 where the reference computes in
// bf16: G from bf16 C and B (products exact in f32, summed in f32 in the
// same order, rounded), L = exp(cum_i - cum_j), M = G L, dt_j's factor of
// M and x inside the intra sum, and the intra sum itself; cum, exp(cum),
// the states, the scan and the C h term stay f32, as there. The f32 path's
// code and numbers do not change (TB is a template constant). Built for
// f32 inputs at chunk 64 and 8 and N 16 and 128 only (the zoo's shapes,
// eight kernels), so the build stays near its f32 time.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// dtype code 0 = f32, 1 = bf16 for x, dt, B and C (a and d are f32); the
// caller allocates the four scratch buffers. Returns the first
// cudaGetLastError() that is not cudaSuccess after the three launches, or
// cudaSuccess.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kP = 64;             // the head dim the kernels take
constexpr int kScanThreads = 256;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// x rounded to bf16 and back (the bf16-tile variant's rounding)
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// cum = inclusive cumsum(dt * a) over the chunk, one rounded add at a time
// from the left (the plain version runs the same sequential sum)
template <int Q>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             float av) {
  if (threadIdx.x == 0) {
    float run = 0.f;
#pragma unroll 16
    for (int i = 0; i < Q; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], av));
      cum[i] = run;
    }
  }
}

// 4 consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 ld4g(const float* p, size_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 ld4g(const __nv_bfloat16* p, size_t i) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + i);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// a (Q, K) row-major tile of global memory into shared memory transposed,
// (K, Q) with row stride Q + 4: each thread reads four neighbouring
// elements of a row, and neighbouring threads take neighbouring rows, so
// each of the four stores of a warp hits 32 banks once
template <int Q, int K, typename T>
__device__ __forceinline__ void load_transposed(const T* src, float* dst) {
  for (int e = threadIdx.x; e < Q * K / 4; e += kThreads) {
    const int r = e % Q, c = 4 * (e / Q);
    const float4 v = ld4g(src, (size_t)r * K + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[(c + k) * (Q + 4) + r] = comp(v, k);
  }
}
// a (Q, K) row-major tile into shared memory with row stride K + 4
template <int Q, int K, typename T>
__device__ __forceinline__ void load_rows(const T* src, float* dst) {
  for (int e = 4 * threadIdx.x; e < Q * K; e += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + (e / K) * (K + 4) + e % K) =
        ld4g(src, e);
}

// ---- launch 1: per (bh, chunk), cum and upd = x^T (dt e^{seg-cum} B); the
// first head of each group also forms G = C B^T for the chunk ------------

template <int Q, int P, int N>
constexpr size_t state_smem_bytes() {
  constexpr size_t a = (size_t)(P + N) * (Q + 4) + 3 * (size_t)Q;
  constexpr size_t b = 2 * (size_t)Q * (N + 4);
  return sizeof(float) * (a > b ? a : b);
}

template <typename T, int Q, int P, int N, bool TB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, float* __restrict__ upd,
                       float* __restrict__ eseg, float* __restrict__ cum_out,
                       float* __restrict__ G, int S, int groups) {
  static_assert(Q % 4 == 0 && P % 16 == 0 && N % 16 == 0, "tile sizes");
  constexpr int RP = P / 16;        // state rows p = ty + 16 r per thread
  constexpr int CN = N / 16;        // state columns n = tx + 16 c
  constexpr int XS = Q + 4;         // row stride of xT and wT
  constexpr int NS = N + 4;
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;                 // (P, Q+4): x transposed
  float* wT = xT + P * XS;          // (N, Q+4): B transposed
  float* dts = wT + N * XS;         // (Q,)
  float* cum = dts + Q;             // (Q,)
  float* coef = cum + Q;            // dt * exp(seg - cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const size_t t0 = (size_t)ch * Q;
  const T* Bb = Bm + ((size_t)(bh / groups) * S + t0) * N;

  load_transposed<Q, P>(x + ((size_t)bh * S + t0) * P, xT);
  load_transposed<Q, N>(Bb, wT);
  for (int e = tid; e < Q; e += kThreads)
    dts[e] = ld(dt, (size_t)bh * S + t0 + e);
  __syncthreads();
  if (tid < 32) {                    // warp 0: cum, then coef
    chunk_cumsum<Q>(dts, cum, a[bh]);
    __syncwarp();
    const float seg = cum[Q - 1];
    for (int e = tid; e < Q; e += 32) {
      cum_out[(size_t)bh * S + t0 + e] = cum[e];
      coef[e] = __fmul_rn(dts[e], expf(__fsub_rn(seg, cum[e])));
    }
    if (tid == 0) eseg[(size_t)bh * nc + ch] = expf(seg);
  }
  __syncthreads();

  {
    // upd[p][n] = sum_j x[j][p] w[j][n], w = coef * B formed in the loop
    float acc[RP][CN] = {};
    for (int j = 0; j < Q; j += 4) {
      float4 xv[RP], bv[CN];
      const float4 cv = ld4(coef + j);
#pragma unroll
      for (int r = 0; r < RP; ++r) xv[r] = ld4(xT + (ty + 16 * r) * XS + j);
#pragma unroll
      for (int c = 0; c < CN; ++c) bv[c] = ld4(wT + (tx + 16 * c) * XS + j);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const float w = __fmul_rn(comp(cv, k), comp(bv[c], k));
#pragma unroll
          for (int r = 0; r < RP; ++r)
            acc[r][c] = fmaf(comp(xv[r], k), w, acc[r][c]);
        }
    }
    float* ub = upd + ((size_t)bh * nc + ch) * P * N;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        ub[(ty + 16 * r) * N + tx + 16 * c] = acc[r][c];
  }

  if (bh % groups != 0) return;     // G depends on the group alone
  __syncthreads();                   // xT and wT are free
  float* Bs = smem;                 // (Q, N+4)
  float* Cs = Bs + Q * NS;          // (Q, N+4)
  load_rows<Q, N>(Bb, Bs);
  load_rows<Q, N>(Cm + ((size_t)(bh / groups) * S + t0) * N, Cs);
  __syncthreads();
  float* gb = G + ((size_t)(bh / groups) * nc + ch) * Q * Q;
  if constexpr (Q == 64) {
    // G[i][j] = C_i . B_j: rows i = 4 ty + r, columns j = tx + 16 c
    constexpr int RQ = Q / 16, CQ = Q / 16;
    float g[RQ][CQ] = {};
    for (int n = 0; n < N; n += 4) {
      float4 cv[RQ], bv[CQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) cv[r] = ld4(Cs + (4 * ty + r) * NS + n);
#pragma unroll
      for (int c = 0; c < CQ; ++c) bv[c] = ld4(Bs + (tx + 16 * c) * NS + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c)
            g[r][c] = TB ? fmaf(rb(comp(cv[r], k)), rb(comp(bv[c], k)),
                                g[r][c])
                         : fmaf(comp(cv[r], k), comp(bv[c], k), g[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CQ; ++c)
        gb[(4 * ty + r) * Q + tx + 16 * c] = TB ? rb(g[r][c]) : g[r][c];
  } else {
    // one output a thread: the same sum over n, ascending from 0
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e % Q;
      float g = 0.f;
      for (int n = 0; n < N; ++n)
        g = TB ? fmaf(rb(Cs[i * NS + n]), rb(Bs[j * NS + n]), g)
               : fmaf(Cs[i * NS + n], Bs[j * NS + n], g);
      gb[e] = TB ? rb(g) : g;
    }
  }
}

// ---- launch 2: per (bh, 4 state entries), the scan over chunks -----------

__global__ void __launch_bounds__(kScanThreads)
ssd_state_scan_kernel(float* __restrict__ hst, const float* __restrict__ eseg,
                      float* __restrict__ state, int PN, int nc,
                      int blocks_per_bh) {
  constexpr int U = 8;              // chunks whose loads are issued together
  const int bh = blockIdx.x / blocks_per_bh;
  const int e = 4 * ((blockIdx.x % blocks_per_bh) * kScanThreads +
                     threadIdx.x);
  if (e >= PN) return;
  float* hb = hst + (size_t)bh * nc * PN + e;
  const float* eb = eseg + (size_t)bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 u[U];
    float es[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (c0 + k < nc) {
        u[k] = ld4(hb + (size_t)(c0 + k) * PN);
        es[k] = eb[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (c0 + k < nc) {
        // the state entering chunk c0 + k
        *reinterpret_cast<float4*>(hb + (size_t)(c0 + k) * PN) = h;
        h.x = __fadd_rn(__fmul_rn(es[k], h.x), u[k].x);
        h.y = __fadd_rn(__fmul_rn(es[k], h.y), u[k].y);
        h.z = __fadd_rn(__fmul_rn(es[k], h.z), u[k].z);
        h.w = __fadd_rn(__fmul_rn(es[k], h.w), u[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(state + (size_t)bh * PN + e) = h;
}

// ---- launch 3: per (bh, chunk), y from the state entering the chunk ------

template <int Q, int P, int N>
constexpr size_t output_smem_bytes() {
  return sizeof(float) * ((size_t)P * (Q + 4) + (size_t)Q * (N + 4) +
                          (size_t)P * (N + 4) + (size_t)Q * (Q + 4) +
                          3 * (size_t)Q);
}

// M[i][j] for i >= j: G * exp(cum_i - cum_j) * dt_j in f32, or with bf16
// tiles (TB) rb(rb(G * rb(L)) * rb(dt_j)), G already rounded
template <bool TB>
__device__ __forceinline__ float m_entry(float g, float ci, float cj,
                                         float dtj) {
  const float L = expf(__fsub_rn(ci, cj));
  return TB ? rb(__fmul_rn(rb(__fmul_rn(g, rb(L))), rb(dtj)))
            : __fmul_rn(__fmul_rn(g, L), dtj);
}

template <typename T, int Q, int P, int N, bool TB>
__global__ void __launch_bounds__(kThreads, N <= 32 ? 3 : 2)
ssd_chunk_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ d,
                        const T* __restrict__ Cm,
                        const float* __restrict__ cum_in,
                        const float* __restrict__ G,
                        const float* __restrict__ hin, T* __restrict__ y,
                        int S, int groups) {
  static_assert(Q % 4 == 0 && P % 16 == 0 && N % 16 == 0, "tile sizes");
  constexpr int XS = Q + 4, NS = N + 4, MS = Q + 4;
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;                 // (P, Q+4): x transposed
  float* Cs = xT + P * XS;          // (Q, N+4)
  float* hs = Cs + Q * NS;          // (P, N+4): the state entering the chunk
  float* Ms = hs + P * NS;          // (Q, Q+4)
  float* dts = Ms + Q * MS;         // (Q,)
  float* cum = dts + Q;             // (Q,)
  float* ec = cum + Q;              // exp(cum)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const size_t t0 = (size_t)ch * Q;
  const float dv = d[bh];
  const float* gb = G + ((size_t)(bh / groups) * nc + ch) * Q * Q;
  T* yb = y + ((size_t)bh * S + t0) * P;

  load_transposed<Q, P>(x + ((size_t)bh * S + t0) * P, xT);
  load_rows<Q, N>(Cm + ((size_t)(bh / groups) * S + t0) * N, Cs);
  load_rows<P, N>(hin + ((size_t)bh * nc + ch) * P * N, hs);
  for (int e = tid; e < Q; e += kThreads) {
    dts[e] = ld(dt, (size_t)bh * S + t0 + e);
    cum[e] = cum_in[(size_t)bh * S + t0 + e];
  }

  if constexpr (Q == 64) {
    constexpr int RQ = 4;             // chunk rows row(r) per thread
    constexpr int CQ = Q / 16;        // M columns j = tx + 16 c
    constexpr int CP = P / 16;        // y columns p = tx + 16 c
    // rows 2 ty, 2 ty + 1 and 62 - 2 ty, 63 - 2 ty: every thread's share
    // of the lower triangle of M is the same
    auto row = [&](int r) { return r < 2 ? 2 * ty + r : Q - 4 - 2 * ty + r; };
    // G of this (group, chunk) straight into registers
    float g[RQ][CQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CQ; ++c)
        g[r][c] = gb[row(r) * Q + tx + 16 * c];
    __syncthreads();
    for (int e = tid; e < Q; e += kThreads) ec[e] = expf(cum[e]);

    // M[i][j] = G[i][j] * exp(cum_i - cum_j) * dt_j for i >= j, else 0
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = row(r);
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int j = tx + 16 * c;
        // exp only where i >= j: for i < j the exponent is positive and
        // may be +inf, which a 0/1 product would turn into NaN
        Ms[i * MS + j] = i >= j ? m_entry<TB>(g[r][c], cum[i], cum[j], dts[j])
                                : 0.f;
      }
    }
    __syncthreads();

    // y = (M x + (C * exp(cum)) h^T) + d * x: rows row(r), columns
    // p = tx + 16 c. M is 0 above the diagonal, so a row's sum stops after
    // its own index (a zero term adds nothing): the two low rows stop at
    // 2 ty + 1, the two high rows run on to 63 - 2 ty, each in order.
    float intra[RQ][CP] = {}, inter[RQ][CP] = {};
    int j = 0;
    for (; j < 2 * ty + 2; j += 4) {
      float4 mv[RQ], xv[CP];
#pragma unroll
      for (int r = 0; r < RQ; ++r) mv[r] = ld4(Ms + row(r) * MS + j);
#pragma unroll
      for (int c = 0; c < CP; ++c) xv[c] = ld4(xT + (tx + 16 * c) * XS + j);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            intra[r][c] = fmaf(comp(mv[r], k),
                               TB ? rb(comp(xv[c], k)) : comp(xv[c], k),
                               intra[r][c]);
    }
    for (; j < Q - 2 * ty; j += 4) {
      float4 mv[2], xv[CP];
#pragma unroll
      for (int r = 0; r < 2; ++r) mv[r] = ld4(Ms + row(r + 2) * MS + j);
#pragma unroll
      for (int c = 0; c < CP; ++c) xv[c] = ld4(xT + (tx + 16 * c) * XS + j);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c)
            intra[r + 2][c] =
                fmaf(comp(mv[r], k), TB ? rb(comp(xv[c], k)) : comp(xv[c], k),
                     intra[r + 2][c]);
    }
    float eci[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) eci[r] = ec[row(r)];
    for (int n = 0; n < N; n += 4) {
      float4 cv[RQ], hv[CP];
#pragma unroll
      for (int r = 0; r < RQ; ++r) cv[r] = ld4(Cs + row(r) * NS + n);
#pragma unroll
      for (int c = 0; c < CP; ++c) hv[c] = ld4(hs + (tx + 16 * c) * NS + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float cs = __fmul_rn(comp(cv[r], k), eci[r]);
#pragma unroll
          for (int c = 0; c < CP; ++c)
            inter[r][c] = fmaf(cs, comp(hv[c], k), inter[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = row(r);
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int p = tx + 16 * c;
        st(yb, (size_t)i * P + p,
           __fadd_rn(__fadd_rn(TB ? rb(intra[r][c]) : intra[r][c],
                               inter[r][c]),
                     __fmul_rn(dv, xT[p * XS + i])));
      }
    }
  } else {
    // reduced chunks: one output a thread, the same sums in the same order
    __syncthreads();
    for (int e = tid; e < Q; e += kThreads) ec[e] = expf(cum[e]);
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e % Q;
      // exp only where i >= j (see above)
      Ms[i * MS + j] = i >= j ? m_entry<TB>(gb[e], cum[i], cum[j], dts[j])
                              : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e % P;
      float intra = 0.f, inter = 0.f;
      for (int j = 0; j < Q; ++j)
        intra = fmaf(Ms[i * MS + j], TB ? rb(xT[p * XS + j]) : xT[p * XS + j],
                     intra);
      for (int n = 0; n < N; ++n)
        inter = fmaf(__fmul_rn(Cs[i * NS + n], ec[i]), hs[p * NS + n], inter);
      st(yb, (size_t)i * P + p,
         __fadd_rn(__fadd_rn(TB ? rb(intra) : intra, inter),
                   __fmul_rn(dv, xT[p * XS + i])));
    }
  }
}

template <typename K>
cudaError_t opt_in(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Scratch {
  float* hst;    // (BH, nc, P, N): chunk updates, then entering states
  float* eseg;   // (BH, nc): e^{seg}
  float* cum;    // (BH, S): the chunks' cumsums
  float* G;      // (BG, nc, Q, Q): C B^T per group and chunk
};

template <typename T, int Q, int N, bool TB>
int launch(const void* x, const void* dt, const float* a, const float* d,
           const void* B, const void* C, void* y, float* state,
           const Scratch& w, int BH, int S, int groups,
           cudaStream_t stream) {
  auto k1 = ssd_chunk_state_kernel<T, Q, kP, N, TB>;
  auto k3 = ssd_chunk_output_kernel<T, Q, kP, N, TB>;
  constexpr size_t smem1 = state_smem_bytes<Q, kP, N>();
  constexpr size_t smem3 = output_smem_bytes<Q, kP, N>();
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr1 = opt_in(k1, smem1);
  static const cudaError_t attr3 = opt_in(k3, smem3);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  const int nc = S / Q, PN = kP * N;
  const dim3 grid(BH, nc);
  k1<<<grid, kThreads, smem1, stream>>>(
      (const T*)x, (const T*)dt, a, (const T*)B, (const T*)C, w.hst, w.eseg,
      w.cum, w.G, S, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bpb = (PN / 4 + kScanThreads - 1) / kScanThreads;
  ssd_state_scan_kernel<<<BH * bpb, kScanThreads, 0, stream>>>(
      w.hst, w.eseg, state, PN, nc, bpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3<<<grid, kThreads, smem3, stream>>>(
      (const T*)x, (const T*)dt, d, (const T*)C, w.cum, w.G, w.hst, (T*)y,
      S, groups);
  return (int)cudaGetLastError();
}

struct Args {
  const void *x, *dt;
  const float *a, *d;
  const void *B, *C;
  void* y;
  float* state;
  Scratch w;
  int BH, S, groups;
  cudaStream_t s;
};

template <typename T, int Q>
int dispatch_n(int N, const Args& r) {
#define SSD_LAUNCH(NN)                                                      \
  launch<T, Q, NN, false>(r.x, r.dt, r.a, r.d, r.B, r.C, r.y, r.state, \
                          r.w, r.BH, r.S, r.groups, r.s)
  switch (N) {
    case 16: return SSD_LAUNCH(16);
    case 32: return SSD_LAUNCH(32);
    case 64: return SSD_LAUNCH(64);
    case 128: return SSD_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_LAUNCH
}

template <typename T>
int dispatch_q(int Q, int N, const Args& r) {
  switch (Q) {
    case 8: return dispatch_n<T, 8>(N, r);
    case 16: return dispatch_n<T, 16>(N, r);
    case 32: return dispatch_n<T, 32>(N, r);
    case 64: return dispatch_n<T, 64>(N, r);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16-tile variant, built for the zoo's shapes only: f32 inputs (the
// model casts x, B and C to f32), chunk 64 (the full configs) or 8 (the
// reduced ones), N 16 (hymba-1.5b, reduced configs) or 128 (mamba2-370m)
int dispatch_tile_bf16(int Q, int N, const Args& r) {
#define SSD_LAUNCH_TB(QQ, NN)                                                \
  launch<float, QQ, NN, true>(r.x, r.dt, r.a, r.d, r.B, r.C, r.y, r.state, \
                              r.w, r.BH, r.S, r.groups, r.s)
  if (Q == 64 && N == 16) return SSD_LAUNCH_TB(64, 16);
  if (Q == 64 && N == 128) return SSD_LAUNCH_TB(64, 128);
  if (Q == 8 && N == 16) return SSD_LAUNCH_TB(8, 16);
  if (Q == 8 && N == 128) return SSD_LAUNCH_TB(8, 128);
  return (int)cudaErrorInvalidValue;
#undef SSD_LAUNCH_TB
}

}  // namespace

extern "C" {

// f32 scratch: hst (BH, S / Q, P, N), eseg (BH, S / Q), cum (BH, S),
// G (BH / groups, S / Q, Q, Q)
int ssd_fwd(int dtype, const void* x, const void* dt, const float* a,
            const float* d, const void* B, const void* C, void* y,
            float* state, float* hst, float* eseg, float* cum, float* G,
            int BH, int S, int P, int N, int Q, int groups, void* stream) {
  if (P != kP || Q < 1 || S % Q != 0 || S / Q > 65535)
    return (int)cudaErrorInvalidValue;
  const Args r{x, dt, a, d, B, C, y, state, Scratch{hst, eseg, cum, G},
               BH, S, groups, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_q<float>(Q, N, r);
  if (dtype == 1) return dispatch_q<__nv_bfloat16>(Q, N, r);
  return (int)cudaErrorInvalidValue;
}

// ssd_fwd with bf16 tiles (f32 inputs only; the shapes dispatch_tile_bf16
// takes): G from bf16 C and B rounded to bf16, L, M and dt_j's factor
// rounded, the intra sum over bf16 x rounded; cum, the states, the scan
// and the C h term stay f32
int ssd_fwd_tile_bf16(const float* x, const float* dt, const float* a,
                      const float* d, const float* B, const float* C,
                      float* y, float* state, float* hst, float* eseg,
                      float* cum, float* G, int BH, int S, int P, int N,
                      int Q, int groups, void* stream) {
  if (P != kP || Q < 1 || S % Q != 0 || S / Q > 65535)
    return (int)cudaErrorInvalidValue;
  const Args r{x, dt, a, d, B, C, y, state, Scratch{hst, eseg, cum, G},
               BH, S, groups, (cudaStream_t)stream};
  return dispatch_tile_bf16(Q, N, r);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
