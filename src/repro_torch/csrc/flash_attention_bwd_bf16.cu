// Hand-written Hopper (sm_90a) kernels: the flash-attention backward in
// bf16, on the tensor cores.
//
// Replaces the backward that the JAX reference differentiates in place of a
// TPU kernel when the model runs in bf16: jax.grad through
// src/repro/models/attention.py::chunked_attention (:97) on bf16 q, k, v,
// which does its arithmetic in f32 and returns out.astype(q.dtype); the
// Pallas forward kernel (src/repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd) is forward-only. Given bf16 q (BH, Sq, hd), k/v
// (BKV, Skv, hd) with BH = BKV * groups, the forward's bf16 out and the
// incoming bf16 dout (BH, Sq, hd), and the forward's f32 row log-sum-exp
// lse (BH, Sq), it computes
//   delta_i = sum_d dout_id out_id                            (f32)
//   P_ij    = exp(s_ij scale - lse_i), 0 where the causal / window mask or
//             the tails hide (i, j), s = q k^T                (f32)
//   dP      = dout v^T,  dS = P (dP - delta)                  (f32)
//   dv = P^T dout,  dk = scale dS^T q,  dq = scale dS k
// with P rounded to bf16 as dv's operand (the forward rounds p the same way
// before p v) and dS split into two bf16 terms, hi = bf16(dS) and lo =
// bf16(dS - hi), as dk's and dq's (dk and dq take hi and lo in turn): dS's
// rows sum to zero, and one bf16 rounding of it would leave dq several
// times farther from a float64 run than the reference's f32 dS does. Every
// product takes bf16 operands and sums in f32; dq, dk, dv are rounded to
// bf16 once, at the end. GQA: query head bh reads kv head bh / groups, so
// dk and dv sum over the group's query heads.
//
// Bound on the card: operations. Five products over the unmasked pairs, 2
// hd FLOP each (the kernel does seven: dS's lo term doubles dk's and dq's):
// at stablelm-3b's training shape (BH 32, S 2048, hd 80, causal) 53.7
// GFLOP, 0.054 ms at the bf16 tensor cores' 989 TFLOP/s,
// against 2 x 10.5 MB of bf16 q, k, v, out, dout in and dq, dk, dv out
// (0.0063 ms at 3.35 TB/s).
//
// Design: the f32 kernel's schedule (csrc/flash_attention_bwd.cu) on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from shared memory
// through ldmatrix (.trans where a product reads a tile along its other
// dim). Two launches from one call:
//   delta — one warp per row (16-byte loads of 8 bf16, a fixed xor-shuffle
//           tree); it also zeroes the turn counters, and the dq rows of
//           query tiles that no kv tile reaches.
//   main  — a persistent grid of at most the CTAs that fit on the card. A
//           CTA of 8 warps claims a work item (kv head b, kv tile j of BKV
//           keys) from a counter, ascending j with all heads at each j,
//           keeps that tile's K and V in shared memory and walks, for each
//           query head of b's group, the query tiles (64 rows) that the
//           forward's tile test pairs with j, from the last down; each
//           tile's q, dout, lse and delta are copied with cp.async one tile
//           ahead (two buffers). Per tile:
//     phase A: S^T = K q^T and dP^T = V dout^T (keys x queries); warp w
//           takes a 16-key strip and BQ / (8 / strips) queries; then, on the
//           accumulator fragments, P = exp2(s scale log2 e - lse log2 e) (0
//           where masked) and dS = P (dP - delta); P in bf16, dS as its hi
//           and lo bf16 terms, written key-major to shared memory.
//     phase B: dv += P^T dout and dk += dS^T q, in registers across the
//           item's tiles (warp w: a 16-key strip and a slice of the head
//           dim), and this tile's dq part dS k (warp w: a 16-query strip
//           and half the head dim), read as the transpose of dS^T; hi, then
//           lo, at each 16-wide step.
//   dq is summed in f32 in a scratch buffer in device memory (in L2) in a
//   fixed order: a turn counter per (query head, query tile), the kv tiles
//   j_lo(i) .. j_hi(i) taking turns in ascending j, as in the f32 kernel
//   (whose source note gives the argument for progress). The first
//   contributor stores its part, the others read-add-write, and the last
//   scales, rounds to bf16 and writes dq; a tile with one contributor
//   writes dq directly. After the next tile's first barrier thread 0 fences
//   and bumps the counter, so a CTA never waits on a turn while it holds a
//   bump.
// Every sum runs in a fixed order (no atomics in the arithmetic; the
// tensor cores' order inside one mma is fixed), so a rerun is bit-equal.
//
// Memory. Tiles (query rows x keys): 64 x 64 at hd 64, 80 and 128; 64 x 32
// at hd 256, where dk and dv of a 64-key tile would take 128 registers a
// thread on their own. Shared memory is bf16 with rows padded by 8 (16
// bytes), so ldmatrix's eight row addresses fall in distinct banks: K and
// V, two buffers of q and dout, P^T and dS^T (hi and lo), and the f32 lse
// and delta: 96 KB at hd 80 (two CTAs an SM, 128 registers a thread at
// most), 132 KB at hd 128 and 184 KB at hd 256 (one CTA, 255 registers at
// most). The f32
// dq partials live in device memory (BH * Sq * hd floats, 4 bytes an
// element against the 2 of bf16), never in shared memory, and are read only
// by the next contributor of the same tile.
//
// Plain C interface (loaded with ctypes): contiguous bf16 q, k, v, out,
// dout, dq, dk, dv and f32 lse, 16-byte aligned; head_dim 64, 80, 128 or
// 256; `scratch` holds BH * Sq + BH * ceil(Sq / 64) + 1 floats (delta, then
// the turn counters and the work counter), `dqacc` BH * Sq * hd floats.
// Returns cudaGetLastError() after the launches, or the first error.
// flash_attention_bwd_bf16_ctas_per_sm(hd) gives the main kernel's CTAs an
// SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // both kernels: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;             // query rows a tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: four (x4) or two (x2) 8 x 8 b16 matrices; lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment addresses (lane l) in a bf16 tile of row stride ST elements.
// A (16 x 16) at (m0, k0) from [m][k] storage (non-trans), or from [k][m]
// storage (.trans); B (16 x 8) at (k0, n0) from [n][k] storage
// (non-trans), or from [k][n] storage (.trans), lanes 0-15 used.
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int ST, int m0,
                                           int k0, int l) {
  return smem_u32(t + (m0 + l % 16) * ST + k0 + (l / 16) * 8);
}
__device__ __forceinline__ uint32_t a_addr_t(const bf16* t, int ST, int m0,
                                             int k0, int l) {
  return smem_u32(t + (k0 + l % 8 + (l / 16) * 8) * ST + m0 +
                  ((l / 8) % 2) * 8);
}
__device__ __forceinline__ uint32_t b_addr(const bf16* t, int ST, int k0,
                                           int n0, int l) {
  return smem_u32(t + (n0 + l % 8) * ST + k0 + ((l / 8) % 2) * 8);
}
__device__ __forceinline__ uint32_t b_addr_t(const bf16* t, int ST, int k0,
                                             int n0, int l) {
  return smem_u32(t + (k0 + l % 16) * ST + n0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  return qp < Sq && kp < Skv && (!causal || qp >= kp) &&
         (!window || qp - kp < window);
}

// The forward's tile test, from both sides (as csrc/flash_attention_bwd.cu)
struct Tiles {
  int Sq, Skv, BQ, BKV, causal, window, nq, nkv;
  __device__ int j_lo(int i) const {
    const int lo = i * BQ - window + 1;
    return window && lo > 0 ? lo / BKV : 0;
  }
  __device__ int j_hi(int i) const {
    return causal ? min(nkv - 1, (i * BQ + BQ - 1) / BKV) : nkv - 1;
  }
  __device__ int i_lo(int j) const {
    return causal ? min(nq, j * BKV / BQ) : 0;
  }
  __device__ int i_hi(int j) const {
    return window ? min(nq, (j * BKV + BKV + window - 2) / BQ + 1) : nq;
  }
};

template <int HD, int BKV>
struct Cfg {
  static constexpr int BQ = kBQ;
  static constexpr int RS = HD + 8;          // K, V, q, dout rows (bf16)
  static constexpr int TS = BQ + 8;          // P^T, dS^T rows (by key)
  // phase A: warp = a 16-key strip x NA n8 tiles of queries
  static constexpr int KSTRIPS = BKV / 16;
  static constexpr int NA = BQ / (kWarps / KSTRIPS) / 8;
  // phase B: dv, dk: a 16-key strip x NB n8 tiles of the head dim; dq: a
  // 16-query strip x NQ n8 tiles
  static constexpr int NB = HD / (kWarps / KSTRIPS) / 8;
  static constexpr int NQ = HD / (kWarps / (BQ / 16)) / 8;
  static constexpr int CTAS = HD <= 80 ? 2 : 1;
  // bytes: K, V, q x 2, dout x 2, P^T, dS^T hi, dS^T lo (bf16), lse x 2,
  // delta x 2 (f32), the claimed item
  static constexpr int K_OFF = 0, V_OFF = K_OFF + 2 * BKV * RS;
  static constexpr int Q_OFF = V_OFF + 2 * BKV * RS;
  static constexpr int D_OFF = Q_OFF + 2 * 2 * BQ * RS;
  static constexpr int P_OFF = D_OFF + 2 * 2 * BQ * RS;
  static constexpr int S_OFF = P_OFF + 2 * BKV * TS;
  static constexpr int SL_OFF = S_OFF + 2 * BKV * TS;
  static constexpr int L_OFF = SL_OFF + 2 * BKV * TS;
  static constexpr int E_OFF = L_OFF + 4 * 2 * BQ;
  static constexpr int I_OFF = E_OFF + 4 * 2 * BQ;
  static constexpr size_t smem = I_OFF + 16;
  static_assert(HD % 16 == 0 && BKV % 16 == 0, "tiles");
  static_assert(kWarps % KSTRIPS == 0 && NA % 2 == 0 && NA >= 2, "phase A");
  static_assert(NB >= 1 && NQ >= 1 &&
                NB * 8 * (kWarps / KSTRIPS) == HD &&
                NQ * 8 * (kWarps / (BQ / 16)) == HD, "phase B");
  static_assert(smem <= 232448 / CTAS, "shared memory");
};

// ---- delta -----------------------------------------------------------------

// One warp per row: delta = rowsum(dout * out) in f32 (8 bf16 a lane a
// step); the bf16 dq row is zeroed when its query tile meets no kv tile.
// Threads below ncnt zero the counters.
__global__ void __launch_bounds__(kThreads)
bwd_bf16_delta_kernel(const bf16* __restrict__ out,
                      const bf16* __restrict__ dout,
                      float* __restrict__ delta, int* __restrict__ cnt,
                      int ncnt, bf16* __restrict__ dq, Tiles t, int rows,
                      int hd) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid < ncnt) cnt[gid] = 0;
  const int row = gid / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                      // whole warps leave
  const bf16* o = out + (size_t)row * hd;
  const bf16* d = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int c = 8 * lane; c < hd; c += 256) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + c);
    const uint4 b = *reinterpret_cast<const uint4*>(d + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]);
      const float2 y = __bfloat1622float2(b2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
  const int i = (row % t.Sq) / t.BQ;
  if (t.j_lo(i) > t.j_hi(i))
    for (int c = 8 * lane; c < hd; c += 256)
      *reinterpret_cast<uint4*>(dq + (size_t)row * hd + c) =
          make_uint4(0u, 0u, 0u, 0u);
}

// ---- the main kernel ---------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <int HD, int BKV>
__global__ void __launch_bounds__(kThreads, Cfg<HD, BKV>::CTAS)
bwd_bf16_main_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dqacc, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int* __restrict__ cnt, int* __restrict__ work, Tiles tl,
                     int n_kv_heads, int groups, float scale) {
  using C = Cfg<HD, BKV>;
  constexpr int BQ = C::BQ, RS = C::RS, TS = C::TS;
  constexpr int NA = C::NA, NB = C::NB, NQ = C::NQ;
  constexpr int HD8 = HD / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + C::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::V_OFF);
  bf16* Pt = reinterpret_cast<bf16*>(smem + C::P_OFF);
  bf16* St = reinterpret_cast<bf16*>(smem + C::S_OFF);
  bf16* Sl = reinterpret_cast<bf16*>(smem + C::SL_OFF);
  int* item_s = reinterpret_cast<int*>(smem + C::I_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;     // fragment row, column pair
  // phase A: keys 16 ka + .., queries qa0 + ..
  const int ka = warp % C::KSTRIPS;
  const int qa0 = (warp / C::KSTRIPS) * NA * 8;
  // phase B: dv / dk keys 16 ka + .., columns cb0 + ..; dq queries
  // 16 qb + .., columns cq0 + ..
  const int cb0 = (warp / C::KSTRIPS) * NB * 8;
  const int qb = warp % (BQ / 16);
  const int cq0 = (warp / (BQ / 16)) * NQ * 8;
  const int Sq = tl.Sq, Skv = tl.Skv, nq = tl.nq;
  const int items = n_kv_heads * tl.nkv;
  const float scale_log2 = scale * kLog2e;

  if (tid == 0) *item_s = atomicAdd(work, 1);
  __syncthreads();
  int item = *item_s;
  while (item < items) {
    // ascending kv tile, all heads at each: see the source note
    const int j = item / n_kv_heads;
    const int b = item % n_kv_heads;
    const int k0 = j * BKV;
    const int ihi = tl.i_hi(j), ni = max(0, ihi - tl.i_lo(j));
    const int ntiles = groups * ni;

    const bf16* kb = k + (size_t)b * Skv * HD;
    const bf16* vb = v + (size_t)b * Skv * HD;
    for (int e = tid; e < BKV * HD8; e += kThreads) {
      const int r = e / HD8, c = e % HD8;
      const bool in = k0 + r < Skv;
      const size_t g = in ? (size_t)(k0 + r) * HD + 8 * c : 0;
      cp_async16(Ks + r * RS + 8 * c, kb + g, in);
      cp_async16(Vs + r * RS + 8 * c, vb + g, in);
    }
    // q, dout, lse and delta of tile n into buffer n & 1; tile n is query
    // tile ihi - 1 - n % ni of query head b * groups + n / ni
    auto load_tile = [&](int n) {
      const int h = b * groups + n / ni, q0 = (ihi - 1 - n % ni) * BQ;
      bf16* Qb = reinterpret_cast<bf16*>(smem + C::Q_OFF) + (n & 1) * BQ * RS;
      bf16* Db = reinterpret_cast<bf16*>(smem + C::D_OFF) + (n & 1) * BQ * RS;
      const bf16* qh = q + (size_t)h * Sq * HD;
      const bf16* dh = dout + (size_t)h * Sq * HD;
      for (int e = tid; e < BQ * HD8; e += kThreads) {
        const int r = e / HD8, c = e % HD8;
        const bool in = q0 + r < Sq;
        const size_t g = in ? (size_t)(q0 + r) * HD + 8 * c : 0;
        cp_async16(Qb + r * RS + 8 * c, qh + g, in);
        cp_async16(Db + r * RS + 8 * c, dh + g, in);
      }
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        const size_t g = in ? (size_t)h * Sq + q0 + tid : 0;
        float* Lb = reinterpret_cast<float*>(smem + C::L_OFF) + (n & 1) * BQ;
        float* Eb = reinterpret_cast<float*>(smem + C::E_OFF) + (n & 1) * BQ;
        cp_async4(Lb + tid, lse + g, in);
        cp_async4(Eb + tid, delta + g, in);
      }
    };
    if (ntiles > 0) load_tile(0);
    cp_async_commit();

    float dva[NB][4], dka[NB][4];
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[t][e] = dka[t][e] = 0.f;

    // the last tile's dq counter, bumped by thread 0 after a barrier
    int* pending = nullptr;
    for (int n = 0; n < ntiles; ++n) {
      cp_async_wait_all();
      __syncthreads();        // tile n landed; tile n - 1 fully consumed
      if (n + 1 < ntiles) load_tile(n + 1);
      cp_async_commit();

      const int g = n / ni, i = ihi - 1 - n % ni;
      const int h = b * groups + g, q0 = i * BQ;
      const bf16* Qb =
          reinterpret_cast<const bf16*>(smem + C::Q_OFF) + (n & 1) * BQ * RS;
      const bf16* Db =
          reinterpret_cast<const bf16*>(smem + C::D_OFF) + (n & 1) * BQ * RS;
      const float* Ls =
          reinterpret_cast<const float*>(smem + C::L_OFF) + (n & 1) * BQ;
      const float* Es =
          reinterpret_cast<const float*>(smem + C::E_OFF) + (n & 1) * BQ;
      // this CTA's turn at dq tile (h, i): after the kv tiles below j
      const int turn = j - tl.j_lo(i);
      const bool first = turn == 0, last = j == tl.j_hi(i);
      int* ctr = cnt + (size_t)h * nq + i;

      // phase A: S^T = K q^T and dP^T = V dout^T for keys 16 ka + .. and
      // queries qa0 + ..; then P (bf16) and dS (hi and lo bf16 terms),
      // key-major
      {
        float s[NA][4], dp[NA][4];
#pragma unroll
        for (int t = 0; t < NA; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t ak[4], av[4];
          ldsm_x4(ak, a_addr(Ks, RS, 16 * ka, 16 * kk, lane));
          ldsm_x4(av, a_addr(Vs, RS, 16 * ka, 16 * kk, lane));
#pragma unroll
          for (int t = 0; t < NA; ++t) {
            uint32_t bq[2], bd[2];
            ldsm_x2(bq, b_addr(Qb, RS, 16 * kk, qa0 + 8 * t, lane));
            ldsm_x2(bd, b_addr(Db, RS, 16 * kk, qa0 + 8 * t, lane));
            mma16816(s[t], ak, bq);
            mma16816(dp[t], av, bd);
          }
        }
        // element e of n8 tile t: key 16 ka + g8 (+ 8 for e >= 2), query
        // qa0 + 8 t + 2 t4 (+ 1 for odd e)
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          float pv[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 16 * ka + g8 + (e >= 2 ? 8 : 0);
            const int qq = qa0 + 8 * t + 2 * t4 + (e & 1);
            const bool ok =
                visible(q0 + qq, k0 + kk, Sq, Skv, tl.causal, tl.window);
            pv[e] = ok ? exp2f(fmaf(s[t][e], scale_log2, -Ls[qq] * kLog2e))
                       : 0.f;
            ds[e] = pv[e] * (dp[t][e] - Es[qq]);
          }
          const int r0 = 16 * ka + g8, c = qa0 + 8 * t + 2 * t4;
          *reinterpret_cast<uint32_t*>(Pt + r0 * TS + c) =
              pack_bf16(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(Pt + (r0 + 8) * TS + c) =
              pack_bf16(pv[2], pv[3]);
          float hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = __bfloat162float(__float2bfloat16_rn(ds[e]));
            lo[e] = ds[e] - hi[e];
          }
          *reinterpret_cast<uint32_t*>(St + r0 * TS + c) =
              pack_bf16(hi[0], hi[1]);
          *reinterpret_cast<uint32_t*>(St + (r0 + 8) * TS + c) =
              pack_bf16(hi[2], hi[3]);
          *reinterpret_cast<uint32_t*>(Sl + r0 * TS + c) =
              pack_bf16(lo[0], lo[1]);
          *reinterpret_cast<uint32_t*>(Sl + (r0 + 8) * TS + c) =
              pack_bf16(lo[2], lo[3]);
        }
      }
      __syncthreads();        // P^T, dS^T written; last tile's dq stored
      // the last tile's dq turn passes on: the barrier ordered every
      // thread's stores before thread 0's fence (cumulative), and the
      // bump waits on no turn of this tile
      if (tid == 0 && pending) {
        __threadfence();
        atomicAdd(pending, 1);
      }
      pending = ctr;

      // phase B: dv += P^T dout, dk += dS^T q (hi, then lo) over this
      // tile's queries
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], as[4], al[4];
        ldsm_x4(ap, a_addr(Pt, TS, 16 * ka, 16 * kk, lane));
        ldsm_x4(as, a_addr(St, TS, 16 * ka, 16 * kk, lane));
        ldsm_x4(al, a_addr(Sl, TS, 16 * ka, 16 * kk, lane));
#pragma unroll
        for (int t = 0; t < NB; ++t) {
          uint32_t bd[2], bq[2];
          ldsm_x2_t(bd, b_addr_t(Db, RS, 16 * kk, cb0 + 8 * t, lane));
          ldsm_x2_t(bq, b_addr_t(Qb, RS, 16 * kk, cb0 + 8 * t, lane));
          mma16816(dva[t], ap, bd);
          mma16816(dka[t], as, bq);
          mma16816(dka[t], al, bq);
        }
      }
      // this tile's dq part dS k: queries 16 qb + .., columns cq0 + ..
      float dqa[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t a[4], al[4];
        ldsm_x4_t(a, a_addr_t(St, TS, 16 * qb, 16 * kk, lane));
        ldsm_x4_t(al, a_addr_t(Sl, TS, 16 * qb, 16 * kk, lane));
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          uint32_t bk[2];
          ldsm_x2_t(bk, b_addr_t(Ks, RS, 16 * kk, cq0 + 8 * t, lane));
          mma16816(dqa[t], a, bk);
          mma16816(dqa[t], al, bk);
        }
      }
      // dq rows: the first turn stores, the others add in turn order, the
      // last scales and rounds to bf16
      if (!first) {
        if (lane == 0)
          for (int spins = 0; ld_acquire(ctr) != turn; ++spins) {
            // a wait this long means a broken order: fail, not hang
            if (spins > (1 << 24)) __trap();
            __nanosleep(64);
          }
        __syncwarp();
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qp = q0 + 16 * qb + g8 + 8 * half;
        if (qp >= Sq) continue;
        const size_t row = ((size_t)h * Sq + qp) * HD;
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          const int col = cq0 + 8 * t + 2 * t4;
          float2 o = make_float2(dqa[t][2 * half], dqa[t][2 * half + 1]);
          float2* acc = reinterpret_cast<float2*>(dqacc + row + col);
          if (!first) {
            const float2 old = __ldcg(acc);
            o = make_float2(old.x + o.x, old.y + o.y);
          }
          if (last)
            *reinterpret_cast<__nv_bfloat162*>(dq + row + col) =
                __floats2bfloat162_rn(o.x * scale, o.y * scale);
          else
            __stcg(acc, o);
        }
      }
    }
    cp_async_wait_all();      // K, V of an item with no query tile
    __syncthreads();          // every dq add stored; smem free
    if (tid == 0 && pending) {
      __threadfence();
      atomicAdd(pending, 1);
    }
    if (tid == 0) *item_s = atomicAdd(work, 1);

    // dk, dv of this warp's keys and columns (dk scaled at the store)
    bf16* dkb = dk + (size_t)b * Skv * HD;
    bf16* dvb = dv + (size_t)b * Skv * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kp = k0 + 16 * ka + g8 + 8 * half;
      if (kp >= Skv) continue;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const size_t at = (size_t)kp * HD + cb0 + 8 * t + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) = __floats2bfloat162_rn(
            dva[t][2 * half], dva[t][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) = __floats2bfloat162_rn(
            dka[t][2 * half] * scale, dka[t][2 * half + 1] * scale);
      }
    }
    __syncthreads();          // the next item's claim is visible
    item = *item_s;
  }
}

template <int HD, int BKV>
struct Launcher {
  using C = Cfg<HD, BKV>;
  // opt in and read the occupancy once per instantiation (thread-safe
  // static init), so a launch inside CUDA graph capture makes no attribute
  // call
  static int ctas_per_sm() {
    static const int occ = [] {
      auto kern = bwd_bf16_main_kernel<HD, BKV>;
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kern, kThreads, C::smem) != cudaSuccess)
        return -1;
      return n;
    }();
    return occ;
  }
  static int sms() {
    static const int n = [] {
      int dev = 0, count = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 dev) != cudaSuccess)
        return -1;
      return count;
    }();
    return n;
  }

  static int run(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* out, const bf16* dout, const float* lse,
                 float* scratch, float* dqacc, bf16* dq, bf16* dk, bf16* dv,
                 int BH, int Sq, int Skv, int groups, int causal, int window,
                 float scale, cudaStream_t stream) {
    const int occ = ctas_per_sm(), nsm = sms();
    if (occ <= 0 || nsm <= 0) return (int)cudaErrorInvalidConfiguration;
    Tiles t{Sq, Skv, kBQ, BKV, causal, window, (Sq + kBQ - 1) / kBQ,
            (Skv + BKV - 1) / BKV};
    const int rows = BH * Sq;
    float* delta = scratch;
    int* cnt = reinterpret_cast<int*>(scratch + (size_t)rows);
    const int ncnt = BH * t.nq + 1;               // turns, then the work
    const long long threads =
        (long long)rows * 32 > ncnt ? (long long)rows * 32 : ncnt;
    bwd_bf16_delta_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(out, dout, delta, cnt,
                                                   ncnt, dq, t, rows, HD);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int kv_heads = BH / groups;
    const int items = kv_heads * t.nkv;
    const int grid = items < occ * nsm ? items : occ * nsm;
    bwd_bf16_main_kernel<HD, BKV><<<grid, kThreads, C::smem, stream>>>(
        q, k, v, dout, lse, delta, dqacc, dq, dk, dv, cnt, cnt + BH * t.nq,
        t, kv_heads, groups, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int flash_attention_bwd_bf16(int hd, const void* q, const void* k,
                             const void* v, const void* out, const void* dout,
                             const void* lse, void* scratch, void* dqacc,
                             void* dq, void* dk, void* dv, int BH, int Sq,
                             int Skv, int groups, int causal, int window,
                             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *bq = (const bf16*)q, *bk = (const bf16*)k, *bv = (const bf16*)v,
             *bo = (const bf16*)out, *bd = (const bf16*)dout;
  const float* fl = (const float*)lse;
  float *fs = (float*)scratch, *fa = (float*)dqacc;
  bf16 *gq = (bf16*)dq, *gk = (bf16*)dk, *gv = (bf16*)dv;
  switch (hd) {
    case 64:
      return Launcher<64, 64>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk,
                                   gv, BH, Sq, Skv, groups, causal, window,
                                   scale, s);
    case 80:
      return Launcher<80, 64>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk,
                                   gv, BH, Sq, Skv, groups, causal, window,
                                   scale, s);
    case 128:
      return Launcher<128, 64>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk,
                                    gv, BH, Sq, Skv, groups, causal, window,
                                    scale, s);
    case 256:
      return Launcher<256, 32>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk,
                                    gv, BH, Sq, Skv, groups, causal, window,
                                    scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

int flash_attention_bwd_bf16_ctas_per_sm(int hd) {
  switch (hd) {
    case 64: return Launcher<64, 64>::ctas_per_sm();
    case 80: return Launcher<80, 64>::ctas_per_sm();
    case 128: return Launcher<128, 64>::ctas_per_sm();
    case 256: return Launcher<256, 32>::ctas_per_sm();
  }
  return -1;
}

const char* flash_attention_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
