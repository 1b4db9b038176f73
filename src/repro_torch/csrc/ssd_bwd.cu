// Hand-written Hopper (sm_90a) kernels: the gradient of the Mamba2 SSD
// chunked scan (csrc/ssd.cu), in four launches.
//
// No pallas_call stands behind this kernel: the Pallas ssd_fwd is forward-
// only, and the JAX reference trains through jax's autodiff of the jnp
// chunked scan src/repro/models/ssm.py:67 (ssd_apply). This replaces that
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
// Design. Four launches:
//   1. ssd_bwd_state_kernel, one CTA per (bh, chunk): the chunk-local part
//      of the state gradient, dy^T (C * exp(cum)), into the scratch dH
//      (BH, nc, P, N); a thread owns N / 16 rows x 4 columns of it and
//      reads dy and C * exp(cum) as 16-byte vectors along them.
//   2. ssd_bwd_scan_kernel, one thread per (bh, four state entries): the
//      scan over the chunks in reverse, the loads of eight chunks issued
//      together; overwrites dH[c] with the gradient of the state leaving
//      chunk c.
//   3. ssd_bwd_chunk_kernel, one CTA of 256 threads (a 16 x 16 grid, tx
//      the fast index) per (bh, chunk): everything else, from the forward's
//      saved state entering the chunk (hst), its cum and G. B, C, dh and h
//      stream through in slices of min(N, 32) state columns, each read
//      into registers one slice ahead, so the CTA holds 91 KB (N 16) to
//      108 KB (N >= 32) of shared memory and two CTAs fit an SM; v
//      accumulates over the slices in registers. Every product runs on
//      register tiles of 4 x 4 (dB and dC: 4 x N/16 up to 4 x 4): each
//      thread's operand for one reduction step reaches it as a 16-byte
//      vector along the reduction index (x and dy rows, M stored
//      transposed, C transposed per slice) or as scalars along its rows
//      that 8 or 16 lanes read side by side (dG, B, dh, h), rows padded
//      by four floats so that no load conflicts on banks. What binds the
//      products is the shared memory's bytes a FLOP: a 4 x 4 tile reads
//      half a float a lane for each FMA, 256 bytes a cycle for the SM's
//      128 FMAs where it serves 128. The triangle is skipped in all four
//      Q x Q products: dM on 10 of a thread's 16 (row, column) pairs, rows
//      paired (2 ty, 2 ty + 1 with 62 - 2 ty, 63 - 2 ty) so that every warp
//      skips the same share;
//      M^T dy, dG^T C and dG B in segments of 16 of the reduction index,
//      where a segment feeds only the columns at or past (before) it, the
//      same for every lane of a warp (the segment index is a template
//      constant: nvcc leaves such a loop rolled, with a branch at every
//      FMA). The serial phases run on the whole CTA: Z's column suffix sums
//      in four segments of 16 rows and a carry (256 threads), ddaL and
//      dcoef as four partial sums a row combined by shuffles, the sums of
//      dh * h and dy * x as per-thread chains, a warp butterfly and the
//      eight warps in order, C . dy h over 8 lanes by shuffles, the two
//      Q-long scans of dda (a reverse cumsum of exp(cum) C . dy h and an
//      exclusive cumsum of dcoef coef) as warp scans, da's sum as a warp
//      butterfly. dB and dC are written per head in 32-byte runs, da and dd
//      per chunk. The chunk Q 64 takes the tiles above; a reduced chunk (8,
//      16, 32) forms each product one output a thread, with the same
//      reduction orders elsewhere.
//   4. ssd_bwd_sum_kernel: dB and dC summed over the heads of each group,
//      da and dd over the chunks, each in order.
// Nothing accumulates with atomics and every sum has a fixed order, so a
// rerun is bit-equal; kernel.py's ssd_bwd_plain sums in the same orders.
// f32 only (training runs SSD in f32). Template shapes: P = 64, N one of
// 16, 32, 64, 128 and Q one of 8, 16, 32, 64, as the forward; the wrapper
// zero-pads P and N as it does there, which adds exact zeros to every sum.
//
// bf16 tiles (ssd_bwd_tile_bf16, the gradient of ssd_fwd_tile_bf16): the
// forward rounds G, L, M, dt_j's factor, x inside the intra sum and that
// sum to bf16. This backward rounds where a tile enters a product: G comes
// rounded from the forward's saved state and the chunk launch rounds L
// (put_dm, a template constant TB), so M = G L dt_j, W = dM L and Z = W G
// are formed from the bf16 tiles; the other roundings pass their gradient
// through unchanged (the derivative of a rounding taken as 1), and every
// cotangent and sum stays f32. JAX's autodiff of the bf16 reference rounds
// its cotangents of L, G, M and intra to bf16 as well; the two differ by
// bf16 rounding, and both are held to a float64 oracle at bf16 tolerance.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// the caller allocates outputs and scratch. Returns the first
// cudaGetLastError() that is not cudaSuccess after the launches, or
// cudaSuccess. ssd_bwd_kernel_attrs gives a launch's registers a thread
// and CTAs an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;     // the chunk kernel: 16 x 16
constexpr int kP = 64;
constexpr int kScanThreads = 64;
constexpr int kSumThreads = 256;
constexpr int kSlice = 32;        // state columns a slice of the chunk kernel
constexpr unsigned kFull = 0xffffffffu;

// a compile-time int, so that a lambda can take a segment index as a
// constant (nvcc leaves some loops over segments rolled, with the bounds
// that depend on the segment tested at every step)
template <int V>
struct Int {
  static constexpr int value = V;
};

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// the sum over a warp: a butterfly, the same value in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// an (R, K) row-major tile of global memory into shared memory with row
// stride LD, in 16-byte vectors (K % 4 == 0, 16-byte aligned source)
template <int R, int K, int LD>
__device__ __forceinline__ void load_rows(const float* src, size_t src_ld,
                                          float* dst) {
  for (int e = threadIdx.x; e < R * K / 4; e += kThreads) {
    const int r = e / (K / 4), c = 4 * (e % (K / 4));
    *reinterpret_cast<float4*>(dst + r * LD + c) = ld4(src + r * src_ld + c);
  }
}

// ---- launch 1: per (bh, chunk), dy^T (C * exp(cum)) ----------------------

template <int Q, int N>
constexpr size_t state_smem_bytes() {
  return sizeof(float) * ((size_t)Q * kP + (size_t)Q * N + Q);
}

template <int Q, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ dy,
                     const float* __restrict__ Cm,
                     const float* __restrict__ cum_in,
                     float* __restrict__ dH, int S, int groups) {
  constexpr int P = kP;
  constexpr int TP = P * N / (4 * kThreads);     // rows a thread (x 4 cols)
  static_assert(TP >= 1 && TP <= 8, "tile");
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                // (Q, P)
  float* cs = dys + Q * P;          // (Q, N): C, then C * exp(cum)
  float* ec = cs + Q * N;           // exp(cum)
  const int tid = threadIdx.x;
  const int ng = tid % (N / 4), pg = tid / (N / 4);
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const size_t t0 = (size_t)ch * Q;
  const float* dyb = dy + ((size_t)bh * S + t0) * P;
  const float* cb = Cm + ((size_t)(bh / groups) * S + t0) * N;
  for (int e = tid; e < Q * P / 4; e += kThreads)
    *reinterpret_cast<float4*>(dys + 4 * e) = ld4(dyb + 4 * e);
  for (int e = tid; e < Q * N / 4; e += kThreads)
    *reinterpret_cast<float4*>(cs + 4 * e) = ld4(cb + 4 * e);
  for (int e = tid; e < Q; e += kThreads)
    ec[e] = expf(cum_in[(size_t)bh * S + t0 + e]);
  __syncthreads();
  for (int e = tid; e < Q * N; e += kThreads)
    cs[e] = __fmul_rn(ec[e / N], cs[e]);
  __syncthreads();
  // outputs p = TP pg + r, n = 4 ng + q; i ascending
  float acc[TP][4] = {};
#pragma unroll 4
  for (int i = 0; i < Q; ++i) {
    const float4 cv = ld4(cs + i * N + 4 * ng);
    float yv[TP];
    if constexpr (TP % 4 == 0) {
#pragma unroll
      for (int r = 0; r < TP; r += 4) {
        const float4 y4 = ld4(dys + i * P + TP * pg + r);
        yv[r] = y4.x; yv[r + 1] = y4.y; yv[r + 2] = y4.z; yv[r + 3] = y4.w;
      }
    } else if constexpr (TP == 2) {
      const float2 y2 = ld2(dys + i * P + 2 * pg);
      yv[0] = y2.x; yv[1] = y2.y;
    } else {
      yv[0] = dys[i * P + pg];
    }
#pragma unroll
    for (int r = 0; r < TP; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[r][q] = fmaf(yv[r], comp(cv, q), acc[r][q]);
  }
  float* out = dH + ((size_t)bh * nc + ch) * P * N;
#pragma unroll
  for (int r = 0; r < TP; ++r)
    *reinterpret_cast<float4*>(out + (TP * pg + r) * N + 4 * ng) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// ---- launch 2: per (bh, 4 state entries), the reverse scan ---------------

__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_scan_kernel(float* __restrict__ dH, const float* __restrict__ cum,
                    const float* __restrict__ dstate, int PN, int nc, int Q,
                    int S, int blocks_per_bh) {
  constexpr int U = 8;              // chunks whose loads are issued together
  const int bh = blockIdx.x / blocks_per_bh;
  const int e = 4 * ((blockIdx.x % blocks_per_bh) * kScanThreads +
                     threadIdx.x);
  if (e >= PN) return;
  float* hb = dH + (size_t)bh * nc * PN + e;
  const float* cb = cum + (size_t)bh * S;
  float4 h = dstate != nullptr ? ld4(dstate + (size_t)bh * PN + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= U) {
    float4 u[U];
    float es[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (c0 - k >= 0) {
        u[k] = ld4(hb + (size_t)(c0 - k) * PN);
        es[k] = expf(cb[(size_t)(c0 - k) * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (c0 - k >= 0) {
        // the gradient of the state leaving chunk c0 - k
        *reinterpret_cast<float4*>(hb + (size_t)(c0 - k) * PN) = h;
        h.x = __fadd_rn(__fmul_rn(es[k], h.x), u[k].x);
        h.y = __fadd_rn(__fmul_rn(es[k], h.y), u[k].y);
        h.z = __fadd_rn(__fmul_rn(es[k], h.z), u[k].z);
        h.w = __fadd_rn(__fmul_rn(es[k], h.w), u[k].w);
      }
    }
  }
}

// ---- launch 2: per (bh, chunk), the gradients ------------------------------

template <int Q, int N>
struct ChunkSmem {
  static constexpr int NS = N < kSlice ? N : kSlice;   // a slice's columns
  static constexpr int XS = kP + 4, QS = Q + 4, SS = NS + 4;
  static constexpr int X = 0;                    // x (Q, XS)
  static constexpr int DY = X + Q * XS;          // dy (Q, XS)
  static constexpr int MT = DY + Q * XS;         // M^T (Q, QS)
  static constexpr int DG = MT + Q * QS;         // dG (Q, QS)
  // the region R: Z (Q, QS) in phases 1-2; a slice's B (Q, SS), C^T
  // (NS, QS), dh (P, SS), h (P, SS) and (reduced chunks) dy h (Q, SS);
  // then v (Q, XS)
  static constexpr int R = DG + Q * QS;
  static constexpr int RB = R, RCT = RB + Q * SS, RDH = RCT + NS * QS;
  static constexpr int RH = RDH + kP * SS, RU = RH + kP * SS;
  static constexpr int REND = RU + (Q < 64 ? Q * SS : 0);
  static constexpr int R1 = R + Q * QS > REND ? R + Q * QS : REND;
  static constexpr int R2 = R + Q * XS > R1 ? R + Q * XS : R1;
  // Q-long vectors, the segment totals (4, Q) and the warps' partial sums
  // (2, 8)
  static constexpr int SM = R2;
  static constexpr int kVecs = 12;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(SM + kVecs * Q + 4 * Q + 16);
};

// M, dG, Z at (i, j) from dM and G: zero where i < j, the only exp of a
// cum difference where i >= j; with bf16 tiles (TB) L is rounded to bf16
// as the forward rounds it (G comes rounded from the forward)
template <bool TB>
__device__ __forceinline__ void put_dm(int i, int j, float dm, float g,
                                       const float* cum, const float* dts,
                                       float* MT, float* dG, float* Z,
                                       int QS) {
  float mv = 0.f, dg = 0.f, z = 0.f;
  if (i >= j) {
    const float e = expf(__fsub_rn(cum[i], cum[j]));
    const float L = TB ? __bfloat162float(__float2bfloat16_rn(e)) : e;
    mv = __fmul_rn(__fmul_rn(g, L), dts[j]);
    const float w = __fmul_rn(dm, L);
    dg = __fmul_rn(w, dts[j]);
    z = __fmul_rn(w, g);
  }
  MT[j * QS + i] = mv;
  dG[i * QS + j] = dg;
  Z[i * QS + j] = z;
}

// inclusive scan of v[0..Q) (reversed when REV: out[t] = sum_{i>=t} v[i])
// by one warp: lane l holds E = ceil(Q / 32) entries from E l on, sums
// them in order, the lanes' totals run through a Hillis-Steele scan and
// each lane adds its exclusive prefix to its own partial sums
template <int Q, bool REV>
__device__ __forceinline__ void warp_scan(const float* v, float* out,
                                          int lane) {
  constexpr int E = (Q + 31) / 32;
  float loc[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = E * lane + e;
    const float x = k < Q ? v[REV ? Q - 1 - k : k] : 0.f;
    run = e == 0 ? x : __fadd_rn(run, x);
    loc[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc = __fadd_rn(inc, u);
  }
  float ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = E * lane + e;
    if (k < Q) out[REV ? Q - 1 - k : k] = __fadd_rn(ex, loc[e]);
  }
}

template <int Q, int N, bool TB>
__global__ void __launch_bounds__(kThreads, 2)
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
  using L = ChunkSmem<Q, N>;
  constexpr int P = kP, XS = L::XS, QS = L::QS, NS = L::NS, SS = L::SS;
  constexpr int NSL = N / NS;
  static_assert(Q % 8 == 0 && N % NS == 0 && 4 * Q <= kThreads, "shapes");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + L::X;
  float* dys = smem + L::DY;
  float* MT = smem + L::MT;
  float* dGs = smem + L::DG;
  float* Zs = smem + L::R;
  float* Bs = smem + L::RB;
  float* CT = smem + L::RCT;
  float* dhs = smem + L::RDH;
  float* hs = smem + L::RH;
  float* Us = smem + L::RU;
  float* VS = smem + L::R;
  float* dts = smem + L::SM;
  float* cum = dts + Q;
  float* ec = cum + Q;              // exp(cum)
  float* ecoef = ec + Q;            // exp(seg - cum)
  float* coef = ecoef + Q;          // dt exp(seg - cum)
  float* dcoef = coef + Q;
  float* ddaL = dcoef + Q;          // sum_{j<t} ZS[t][j] dt_j
  float* ddtM = ddaL + Q;           // sum_{i>=j} Z[i][j]
  float* dcumE = ddtM + Q;          // exp(cum_i) C_i . (dy h)_i
  float* dda = dcumE + Q;
  float* kc = dda + Q;              // dcoef coef, then its cumsum
  float* dcacc = kc + Q;            // C . dy h, summed over the slices
  float* segT = dcacc + Q;          // (4, Q): Z's segment totals
  float* wred = segT + 4 * Q;       // (2, 8): the warps' partial sums

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const int bg = bh / groups;
  const size_t t0 = (size_t)ch * Q;
  const size_t row0 = (size_t)bh * S + t0;       // first step of the chunk
  const size_t grow0 = (size_t)bg * S + t0;
  const size_t st0 = ((size_t)bh * nc + ch) * P * N;
  const float* gb = G + ((size_t)bg * nc + ch) * Q * Q;

  load_rows<Q, P, XS>(x + row0 * P, P, xs);
  load_rows<Q, P, XS>(dy + row0 * P, P, dys);
  for (int e = tid; e < Q; e += kThreads) {
    dts[e] = dt[row0 + e];
    cum[e] = cum_in[row0 + e];
  }
  // a slice of NS state columns: PPT 16-byte pieces a thread of B (Q, NS),
  // C (Q, NS; stored transposed), dh and h (P, NS), read into registers
  // one slice ahead, so that the loads are in flight while the phases
  // before it (and the slice before it) run
  constexpr int PPT = P * NS / 4 / kThreads;
  static_assert(PPT * 4 * kThreads == P * NS, "whole pieces of dh and h");
  float4 pb[PPT], pc[PPT], pdh[PPT], ph[PPT];
  auto fetch = [&](int sl) {
    const int n0 = sl * NS;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int e = tid + kThreads * k;
      const int r = e / (NS / 4), q = 4 * (e % (NS / 4));
      if (e < Q * NS / 4) {
        pb[k] = ld4(Bm + (grow0 + r) * N + n0 + q);
        pc[k] = ld4(Cm + (grow0 + e % Q) * N + n0 + 4 * (e / Q));
      }
      pdh[k] = ld4(dH + st0 + (size_t)r * N + n0 + q);
      ph[k] = ld4(hst + st0 + (size_t)r * N + n0 + q);
    }
  };
  fetch(0);

  // phase 1: dM = dy x^T where i >= j, then M, dG and Z (0 elsewhere)
  if constexpr (Q == 64) {
    // a thread's rows r0, r0 + 1 (low) and r2, r2 + 1 (high), columns
    // tx + 16 c: the low rows need c = 0 (and 1 in warps 4-7), the high
    // rows c = 0..2 (and 3 in warps 0-3); that last unit is the "flex"
    // pair (fr, fr + 1) x fc, so every thread forms 10 outputs
    const bool lowflex = warp >= 4;
    const int r0 = 2 * ty, r2 = Q - 2 - 2 * ty;
    const int fr = lowflex ? r0 : r2, fc = tx + (lowflex ? 16 : 48);
    // (a warp-uniform choice, so the flex rows are a0, a1 or a2, a3)
    const int oi[10] = {r0, r0 + 1, r2, r2 + 1, r2, r2 + 1, r2, r2 + 1,
                        fr, fr + 1};
    const int oj[10] = {tx, tx, tx, tx, tx + 16, tx + 16, tx + 32, tx + 32,
                        fc, fc};
    float g[10];
#pragma unroll
    for (int o = 0; o < 10; ++o)
      g[o] = oi[o] >= oj[o] ? gb[oi[o] * Q + oj[o]] : 0.f;
    __syncthreads();
    float acc[10] = {};
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      const float4 a0 = ld4(dys + r0 * XS + p);
      const float4 a1 = ld4(dys + (r0 + 1) * XS + p);
      const float4 a2 = ld4(dys + r2 * XS + p);
      const float4 a3 = ld4(dys + (r2 + 1) * XS + p);
      const float4 f0 = lowflex ? a0 : a2;   // the flex rows, no reload
      const float4 f1 = lowflex ? a1 : a3;
      const float4 b0 = ld4(xs + tx * XS + p);
      const float4 b1 = ld4(xs + (tx + 16) * XS + p);
      const float4 b2 = ld4(xs + (tx + 32) * XS + p);
      const float4 bf = ld4(xs + fc * XS + p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[0] = fmaf(comp(a0, k), comp(b0, k), acc[0]);
        acc[1] = fmaf(comp(a1, k), comp(b0, k), acc[1]);
        acc[2] = fmaf(comp(a2, k), comp(b0, k), acc[2]);
        acc[3] = fmaf(comp(a3, k), comp(b0, k), acc[3]);
        acc[4] = fmaf(comp(a2, k), comp(b1, k), acc[4]);
        acc[5] = fmaf(comp(a3, k), comp(b1, k), acc[5]);
        acc[6] = fmaf(comp(a2, k), comp(b2, k), acc[6]);
        acc[7] = fmaf(comp(a3, k), comp(b2, k), acc[7]);
        acc[8] = fmaf(comp(f0, k), comp(bf, k), acc[8]);
        acc[9] = fmaf(comp(f1, k), comp(bf, k), acc[9]);
      }
    }
    // the six pairs no thread forms lie above the diagonal, outside the
    // diagonal blocks of 16 x 16: no product reads them (each reads the
    // upper triangle only inside the diagonal block of its segment)
#pragma unroll
    for (int o = 0; o < 10; ++o)
      put_dm<TB>(oi[o], oj[o], acc[o], g[o], cum, dts, MT, dGs, Zs, QS);
  } else {
    __syncthreads();
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e % Q;
      float dm = 0.f, g = 0.f;
      if (i >= j) {
        for (int p = 0; p < P; ++p)
          dm = fmaf(dys[i * XS + p], xs[j * XS + p], dm);
        g = gb[e];
      }
      put_dm<TB>(i, j, dm, g, cum, dts, MT, dGs, Zs, QS);
    }
  }
  {
    const float seg = cum[Q - 1];
    for (int e = tid; e < Q; e += kThreads) {
      ec[e] = expf(cum[e]);
      ecoef[e] = expf(__fsub_rn(seg, cum[e]));
      coef[e] = __fmul_rn(dts[e], ecoef[e]);
    }
  }
  __syncthreads();

  // phase 2: Z's column suffix sums ZS[t][j] = sum_{i>=t} Z[i][j] in place:
  // each segment of 16 rows from its bottom, then the totals of the
  // segments below it, nearest first; ddt's sum over i >= j is ZS[j][j]
  // (a thread's segment of a column in registers: its 16 reads issued
  // together, then the chain)
  constexpr int NSEG = (Q + 15) / 16;
  const bool zcol = tid < NSEG * Q;
  const int zj = tid % Q, zs = tid / Q;
  const int zlo = max(16 * zs, zj), zhi = min(16 * zs + 16, Q);
  float zr[16];
  if (zcol) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * zs + r;
      zr[r] = i >= zlo && i < zhi ? Zs[i * QS + zj] : 0.f;
    }
    float run = 0.f;
#pragma unroll
    for (int r = 15; r >= 0; --r) {
      const int i = 16 * zs + r;
      if (i >= zlo && i < zhi) {
        run = __fadd_rn(run, zr[r]);
        zr[r] = run;
      }
    }
    segT[zs * Q + zj] = run;
  }
  __syncthreads();
  if (zcol) {
    float carry = 0.f;
    for (int s2 = NSEG - 1; s2 > zs; --s2)
      carry = __fadd_rn(segT[s2 * Q + zj], carry);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * zs + r;
      if (i >= zlo && i < zhi) {
        const float v = zs < NSEG - 1 ? __fadd_rn(zr[r], carry) : zr[r];
        Zs[i * QS + zj] = v;
        if (i == zj) ddtM[zj] = v;
      }
    }
  }
  __syncthreads();
  // da_t's gradient through the L entries that span t: sum_{j<t} ZS[t][j]
  // dt_j, four partial sums over j in [16 s, 16 s + 16), (p0 + p1) +
  // (p2 + p3) (no cancellation: every term is an entry with i >= t > j)
  if (tid < 4 * Q) {
    const int t = tid >> 2, s = tid & 3;
    float v = 0.f;
    for (int j = 16 * s; j < min(16 * s + 16, t); ++j)
      v = fmaf(Zs[t * QS + j], dts[j], v);
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
    if (s == 0) ddaL[t] = v;
  }
  __syncthreads();                  // Z is dead: the slices take its place

  // phase 3: per slice of NS state columns, v += B dh^T, this head's
  // dB = dG^T C + coef (x dh) and dC = dG B + exp(cum) (dy h); the sum of
  // dh * h (each thread's entries of a slice in order, the slices in order)
  constexpr int VPT = Q * P / kThreads;          // v entries a thread
  float vT[4][4] = {};              // Q 64: v[j][p], p = 4 ty + e, j = tx + 16c
  float vg[Q == 64 ? 1 : VPT] = {}; // reduced chunks: v at e = tid + 256 k
  float dce[4] = {};                // Q 64, dC threads: C . dy h by row
  float hsum = 0.f;
  for (int sl = 0; sl < NSL; ++sl) {
    const int n0 = sl * NS;
    if (sl) __syncthreads();        // the last slice is read
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int e = tid + kThreads * k;
      const int r = e / (NS / 4), q = 4 * (e % (NS / 4));
      if (e < Q * NS / 4) {
        *reinterpret_cast<float4*>(Bs + r * SS + q) = pb[k];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          CT[(4 * (e / Q) + u) * QS + e % Q] = comp(pc[k], u);
      }
      *reinterpret_cast<float4*>(dhs + r * SS + q) = pdh[k];
      *reinterpret_cast<float4*>(hs + r * SS + q) = ph[k];
    }
    if (sl + 1 < NSL) fetch(sl + 1);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < P * NS / kThreads; ++k) {
      const int e = tid + kThreads * k, p = e / NS, n = e % NS;
      hsum = fmaf(dhs[p * SS + n], hs[p * SS + n], hsum);
    }
    if constexpr (Q == 64) {
      // v[j][p] += sum_n dh[p][n] B[j][n], n ascending across the slices
      for (int n = 0; n < NS; n += 4) {
        float4 hv[4], bv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[e] = ld4(dhs + (4 * ty + e) * SS + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(Bs + (tx + 16 * c) * SS + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              vT[e][c] = fmaf(comp(hv[e], k), comp(bv[c], k), vT[e][c]);
      }
      // warps 0-3 dB, warps 4-7 dC: rows tj + 16 c, columns n0 + np + 8 m
      // (m < TN; np the fast lane index, conflict-free rows of C^T and
      // 32-byte runs of each stored row)
      constexpr int TN = NS / 8;
      const int t = tid & 127, np = t & 7, tj = t >> 3;
      float s1[4][TN] = {}, s2[4][TN] = {};
      if (tid < 128) {
        // dG^T C: i in segment q feeds the columns j = tj + 16 c, c <= q
        auto seg = [&](auto qc) {
          constexpr int q = decltype(qc)::value;
#pragma unroll
          for (int i = 16 * q; i < 16 * q + 16; i += 4) {
            float4 cv[TN];
#pragma unroll
            for (int m = 0; m < TN; ++m)
              cv[m] = ld4(CT + (np + 8 * m) * QS + i);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float gv[4];
#pragma unroll
              for (int c = 0; c <= q; ++c)
                gv[c] = dGs[(i + k) * QS + tj + 16 * c];
#pragma unroll
              for (int c = 0; c <= q; ++c)
#pragma unroll
                for (int m = 0; m < TN; ++m)
                  s1[c][m] = fmaf(gv[c], comp(cv[m], k), s1[c][m]);
            }
          }
        };
        seg(Int<0>{}); seg(Int<1>{}); seg(Int<2>{}); seg(Int<3>{});
        // x dh
#pragma unroll 4
        for (int p = 0; p < P; p += 4) {
          float4 xv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = ld4(xs + (tj + 16 * c) * XS + p);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float hv[TN];
#pragma unroll
            for (int m = 0; m < TN; ++m) hv[m] = dhs[(p + k) * SS + np + 8 * m];
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int m = 0; m < TN; ++m)
                s2[c][m] = fmaf(comp(xv[c], k), hv[m], s2[c][m]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
#pragma unroll
          for (int m = 0; m < TN; ++m)
            dBp[(row0 + j) * N + n0 + np + 8 * m] =
                __fadd_rn(s1[c][m], __fmul_rn(coef[j], s2[c][m]));
        }
      } else {
        // dG B: j in segment q feeds the rows i = tj + 16 c, c >= q
        auto seg = [&](auto qc) {
          constexpr int q = decltype(qc)::value;
#pragma unroll
          for (int j = 16 * q; j < 16 * q + 16; j += 4) {
            float4 gv[4];
#pragma unroll
            for (int c = q; c < 4; ++c)
              gv[c] = ld4(dGs + (tj + 16 * c) * QS + j);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float bv[TN];
#pragma unroll
              for (int m = 0; m < TN; ++m)
                bv[m] = Bs[(j + k) * SS + np + 8 * m];
#pragma unroll
              for (int c = q; c < 4; ++c)
#pragma unroll
                for (int m = 0; m < TN; ++m)
                  s1[c][m] = fmaf(comp(gv[c], k), bv[m], s1[c][m]);
            }
          }
        };
        seg(Int<0>{}); seg(Int<1>{}); seg(Int<2>{}); seg(Int<3>{});
        // dy h
#pragma unroll 4
        for (int p = 0; p < P; p += 4) {
          float4 yv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) yv[c] = ld4(dys + (tj + 16 * c) * XS + p);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float hv[TN];
#pragma unroll
            for (int m = 0; m < TN; ++m) hv[m] = hs[(p + k) * SS + np + 8 * m];
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int m = 0; m < TN; ++m)
                s2[c][m] = fmaf(comp(yv[c], k), hv[m], s2[c][m]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tj + 16 * c;
          float part = 0.f;
#pragma unroll
          for (int m = 0; m < TN; ++m) {
            dCp[(row0 + i) * N + n0 + np + 8 * m] =
                __fadd_rn(s1[c][m], __fmul_rn(ec[i], s2[c][m]));
            // C . dy h: the lane's columns in order (m), then the 8 lanes
            part = m == 0 ? __fmul_rn(CT[np * QS + i], s2[c][0])
                          : fmaf(CT[(np + 8 * m) * QS + i], s2[c][m], part);
          }
#pragma unroll
          for (int off = 4; off > 0; off >>= 1)
            part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
          dce[c] = sl == 0 ? part : __fadd_rn(dce[c], part);
        }
      }
    } else {
      // reduced chunks: one output a thread
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int e = tid + kThreads * k, j = e / P, p = e % P;
        for (int n = 0; n < NS; ++n)
          vg[k] = fmaf(dhs[p * SS + n], Bs[j * SS + n], vg[k]);
      }
      for (int e = tid; e < Q * NS; e += kThreads) {
        const int j = e / NS, n = e % NS;
        float s1 = 0.f, s2 = 0.f, t1 = 0.f, t2 = 0.f;
        for (int i = 0; i < Q; ++i) {
          s1 = fmaf(dGs[i * QS + j], CT[n * QS + i], s1);   // dB's dG^T C
          t1 = fmaf(dGs[j * QS + i], Bs[i * SS + n], t1);   // dC's dG B
        }
        for (int p = 0; p < P; ++p) {
          s2 = fmaf(xs[j * XS + p], dhs[p * SS + n], s2);
          t2 = fmaf(dys[j * XS + p], hs[p * SS + n], t2);
        }
        dBp[(row0 + j) * N + n0 + n] = __fadd_rn(s1, __fmul_rn(coef[j], s2));
        dCp[(row0 + j) * N + n0 + n] = __fadd_rn(t1, __fmul_rn(ec[j], t2));
        Us[j * SS + n] = t2;
      }
      __syncthreads();
      // C . dy h as the Q 64 lanes sum it: lane np's columns np + 8 m in
      // order, the 8 lanes as xor shuffles 4, 2, 1, the slices in order
      for (int i = tid; i < Q; i += kThreads) {
        float v[8];
        for (int np = 0; np < 8; ++np) {
          v[np] = __fmul_rn(CT[np * QS + i], Us[i * SS + np]);
          for (int m = 1; m < NS / 8; ++m)
            v[np] = fmaf(CT[(np + 8 * m) * QS + i], Us[i * SS + np + 8 * m],
                         v[np]);
        }
        for (int off = 4; off > 0; off >>= 1)
          for (int l = 0; l < off; ++l) v[l] = __fadd_rn(v[l], v[l + off]);
        dcacc[i] = sl == 0 ? v[0] : __fadd_rn(dcacc[i], v[0]);
      }
    }
  }
  __syncthreads();                  // the last slice is read: v takes R

  // phase 4: dcoef = x . v, dx = M^T dy + coef v + d dy, exp(cum) C . dy h
  const float dv = d[bh];
  if constexpr (Q == 64) {
    if (tid >= 128 && (tid & 7) == 0) {  // the dC lanes of np 0
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dcacc[((tid & 127) >> 3) + 16 * c] = dce[c];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        VS[(tx + 16 * c) * XS + 4 * ty + e] = vT[e][c];
    // M^T dy: i in segment q feeds the columns j = tx + 16 c, c <= q
    float dxT[4][4] = {};           // [e][c]: p = 4 ty + e, j = tx + 16 c
    auto seg = [&](auto qc) {
      constexpr int q = decltype(qc)::value;
#pragma unroll
      for (int i = 16 * q; i < 16 * q + 16; i += 4) {
        float4 mv[4];
#pragma unroll
        for (int c = 0; c <= q; ++c) mv[c] = ld4(MT + (tx + 16 * c) * QS + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 yv = ld4(dys + (i + k) * XS + 4 * ty);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c <= q; ++c)
              dxT[e][c] = fmaf(comp(yv, e), comp(mv[c], k), dxT[e][c]);
        }
      }
    };
    seg(Int<0>{}); seg(Int<1>{}); seg(Int<2>{}); seg(Int<3>{});
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __fadd_rn(__fadd_rn(dxT[e][c], __fmul_rn(coef[j], vT[e][c])),
                         __fmul_rn(dv, dys[j * XS + 4 * ty + e]));
      *reinterpret_cast<float4*>(dx + (row0 + j) * P + 4 * ty) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int e = tid + kThreads * k;
      VS[(e / P) * XS + e % P] = vg[k];
    }
    __syncthreads();
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e % P;
      float s = 0.f;
      for (int i = j; i < Q; ++i) s = fmaf(MT[j * QS + i], dys[i * XS + p], s);
      dx[(row0 + j) * P + p] = __fadd_rn(
          __fadd_rn(s, __fmul_rn(coef[j], VS[j * XS + p])),
          __fmul_rn(dv, dys[j * XS + p]));
    }
  }
  // the sum of dy * x: each thread's entries (row-major, tid + 256 k) in
  // order; then with the sum of dh * h, a warp butterfly each
  float ddsum = 0.f;
#pragma unroll
  for (int k = 0; k < Q * P / kThreads; ++k) {
    const int e = tid + kThreads * k, i = e / P, p = e % P;
    ddsum = fmaf(dys[i * XS + p], xs[i * XS + p], ddsum);
  }
  hsum = warp_sum(hsum);
  ddsum = warp_sum(ddsum);
  if (lane == 0) {
    wred[warp] = hsum;
    wred[8 + warp] = ddsum;
  }
  __syncthreads();
  // dcoef_j: four partial sums over p in [16 s, 16 s + 16), (p0 + p1) +
  // (p2 + p3); exp(cum_i) times dcumE's partials in order
  {
    const int j = tid >> 2, s = tid & 3;
    float v = 0.f;
    if (j < Q)
      for (int p = 16 * s; p < 16 * s + 16; ++p)
        v = fmaf(xs[j * XS + p], VS[j * XS + p], v);
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
    if (j < Q && s == 0) {
      dcoef[j] = v;
      kc[j] = __fmul_rn(v, coef[j]);
    }
  }
  for (int i = tid; i < Q; i += kThreads)
    dcumE[i] = __fmul_rn(ec[i], dcacc[i]);
  __syncthreads();

  // phase 5: the gradient of da_t: the L entries that span t, exp(cum_i)
  // for i >= t (warp 0: a reverse scan), coef_j for j < t (warp 1: a scan,
  // shifted by one), exp(seg) sum(dh * h); then ddt, and the da, dd
  // partials of the chunk
  if (warp == 0) warp_scan<Q, true>(dcumE, dda, lane);
  if (warp == 1) warp_scan<Q, false>(kc, kc, lane);
  __syncthreads();
  if (tid < Q) {
    float hs8 = wred[0];
#pragma unroll
    for (int w = 1; w < 8; ++w) hs8 = __fadd_rn(hs8, wred[w]);
    const float hterm = __fmul_rn(expf(cum[Q - 1]), hs8);
    const float before = tid == 0 ? 0.f : kc[tid - 1];
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(ddaL[tid], dda[tid]),
                                        before), hterm);
    ddt[row0 + tid] = __fadd_rn(
        __fadd_rn(ddtM[tid], __fmul_rn(dcoef[tid], ecoef[tid])),
        __fmul_rn(a[bh], v));
    dda[tid] = v;
  }
  __syncthreads();
  if (warp == 0) {
    float dap = 0.f;
    for (int t = lane; t < Q; t += 32) dap = fmaf(dts[t], dda[t], dap);
    dap = warp_sum(dap);
    if (lane == 0) {
      float dd8 = wred[8];
#pragma unroll
      for (int w = 1; w < 8; ++w) dd8 = __fadd_rn(dd8, wred[8 + w]);
      float* o = dad + ((size_t)bh * nc + ch) * 2;
      o[0] = dap;
      o[1] = dd8;
    }
  }
}

// ---- launch 3: dB, dC over the heads of a group; da, dd over chunks ------

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
#pragma unroll 16
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

template <int Q, int N, bool TB = false>
struct Launcher {
  static constexpr size_t smem1 = state_smem_bytes<Q, N>();
  static constexpr size_t smem2 = ChunkSmem<Q, N>::bytes;
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static cudaError_t ready() {
    static const cudaError_t err = [] {
      const cudaError_t e1 = opt_in(ssd_bwd_state_kernel<Q, N>, smem1);
      return e1 != cudaSuccess
          ? e1 : opt_in(ssd_bwd_chunk_kernel<Q, N, TB>, smem2);
    }();
    return err;
  }
  static int run(const Args& r) {
    const cudaError_t ok = ready();
    if (ok != cudaSuccess) return (int)ok;
    const int nc = r.S / Q, PN = kP * N;
    ssd_bwd_state_kernel<Q, N><<<dim3(r.BH, nc), kThreads, smem1, r.s>>>(
        r.dy, r.C, r.cum, r.dH, r.S, r.groups);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int bpb = (PN / 4 + kScanThreads - 1) / kScanThreads;
    ssd_bwd_scan_kernel<<<r.BH * bpb, kScanThreads, 0, r.s>>>(
        r.dH, r.cum, r.dstate, PN, nc, Q, r.S, bpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_chunk_kernel<Q, N, TB><<<dim3(r.BH, nc), kThreads, smem2, r.s>>>(
        r.x, r.dt, r.a, r.d, r.B, r.C, r.dy, r.cum, r.G, r.hst, r.dH, r.dx,
        r.ddt, r.dBp, r.dCp, r.dad, r.S, r.groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int BG = r.BH / r.groups;
    const long long per_group = (long long)r.S * N;
    const long long total = BG * per_group + r.BH;
    const unsigned blocks =
        (unsigned)((total + kSumThreads - 1) / kSumThreads);
    ssd_bwd_sum_kernel<<<blocks, kSumThreads, 0, r.s>>>(
        r.dBp, r.dCp, r.dad, r.dB, r.dC, r.da, r.dd, per_group, BG,
        r.groups, r.BH, nc);
    return (int)cudaGetLastError();
  }
  // registers a thread and resident CTAs an SM of launch 1 (which 0) or
  // launch 2 (which 1)
  static int attrs(int which, int* regs, int* ctas) {
    cudaError_t err = ready();
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    if (which == 0) {
      err = cudaFuncGetAttributes(&fa, ssd_bwd_state_kernel<Q, N>);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            ctas, ssd_bwd_state_kernel<Q, N>, kThreads, smem1);
    } else {
      err = cudaFuncGetAttributes(&fa, ssd_bwd_chunk_kernel<Q, N, TB>);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            ctas, ssd_bwd_chunk_kernel<Q, N, TB>, kThreads, smem2);
    }
    if (err == cudaSuccess) *regs = fa.numRegs;
    return (int)err;
  }
};

// F(Launcher<Q, N>) for the instantiation of (Q, N)
template <int Q, typename F>
int with_n(int N, F f) {
  switch (N) {
    case 16: return f(Launcher<Q, 16>{});
    case 32: return f(Launcher<Q, 32>{});
    case 64: return f(Launcher<Q, 64>{});
    case 128: return f(Launcher<Q, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename F>
int with_shape(int Q, int N, F f) {
  switch (Q) {
    case 8: return with_n<8>(N, f);
    case 16: return with_n<16>(N, f);
    case 32: return with_n<32>(N, f);
    case 64: return with_n<64>(N, f);
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
  return with_shape(Q, N, [&](auto l) { return decltype(l)::run(r); });
}

// ssd_bwd of the bf16-tile forward (ssd_fwd_tile_bf16): the chunk launch
// rounds L to bf16, G is the forward's rounded one; built at chunk 64 and
// 8 and N 16 and 128 only, as the forward
int ssd_bwd_tile_bf16(const float* x, const float* dt, const float* a,
                      const float* d, const float* B, const float* C,
                      const float* dy, const float* dstate, const float* cum,
                      const float* G, const float* hst, float* dx, float* ddt,
                      float* da, float* dd, float* dB, float* dC, float* dH,
                      float* dBp, float* dCp, float* dad, int BH, int S,
                      int P, int N, int Q, int groups, void* stream) {
  if (P != kP || Q < 1 || S % Q != 0 || S / Q > 65535 || groups < 1 ||
      BH % groups != 0)
    return (int)cudaErrorInvalidValue;
  const Args r{x,   dt, a,  d,  B,   C,   dy,  dstate, cum, G,  hst,
               dx,  ddt, da, dd, dB,  dC,  dH,  dBp,    dCp, dad,
               BH,  S,  groups, (cudaStream_t)stream};
  if (Q == 64 && N == 16) return Launcher<64, 16, true>::run(r);
  if (Q == 64 && N == 128) return Launcher<64, 128, true>::run(r);
  if (Q == 8 && N == 16) return Launcher<8, 16, true>::run(r);
  if (Q == 8 && N == 128) return Launcher<8, 128, true>::run(r);
  return (int)cudaErrorInvalidValue;
}

// the registers a thread (*regs) and resident CTAs an SM (*ctas) of the
// state kernel (which 0) or the chunk kernel (which 1) at (Q, N)
int ssd_bwd_kernel_attrs(int Q, int N, int which, int* regs, int* ctas) {
  return with_shape(Q, N, [&](auto l) {
    return decltype(l)::attrs(which, regs, ctas);
  });
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
