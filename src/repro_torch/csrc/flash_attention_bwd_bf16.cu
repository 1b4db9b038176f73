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
// Two launches from one call:
//   delta — one warp per row (16-byte loads of 8 bf16, a fixed xor-shuffle
//           tree); it also zeroes the turn counters, and the dq rows of
//           query tiles that no kv tile reaches.
//   main  — by head dim: wgmma and TMA at hd 64, 80 and 128
//           (bwd_bf16_main_kernel), mma.sync at hd 256 (bwd_bf16_mma_kernel).
//
// hd 64, 80, 128: FlashAttention-3's backward, made deterministic. A
// persistent grid of one CTA an SM (every CTA resident); a CTA is three
// warpgroups: a producer and two consumers. Work items are (kv tile j of
// 128 keys, kv head b, part of b's query heads), claimed in ascending order
// from a counter by the producer, which hands each to the consumers through
// a two-slot ring in shared memory. For an item the producer's one warp
// loads with TMA (cp.async.bulk.tensor, the forward's 3-D maps and 128-byte
// swizzle, 64 x 64 slabs), for each query tile (64 rows) that the
// forward's tile test pairs with j, per query head, from the last tile
// down, q and dout into a two-stage ring (its lanes copy the tile's lse
// (times log2 e) and delta beside them, loaded before the wait for the
// stage), and K and V once, after the item's first tile (so that tile
// loads while the last item ends). Full and empty mbarriers pace each
// ring. Consumer warpgroup w owns keys 64 w .. 64 w + 63 of the tile
// (wgmma's M). Per query tile:
//   1. S^T = K q^T and dP^T = V dout^T, wgmma m64n64k16 with both operands
//      K-major in shared memory, in one commit group (hd / 16 steps: the
//      zero columns of hd 80's second slab are skipped).
//   2. On the f32 accumulator fragments (keys x queries): P = 2^(s scale
//      log2 e - lse log2 e), 0 where masked (a strip that every pair of the
//      tile sees takes no mask), dS = P (dP - delta); P rounded to bf16 and
//      dS split into hi and lo, packed as wgmma's A fragments: the
//      accumulator layout of a keys x queries product is the register A
//      layout of a product with M = keys and K = queries.
//   3. dv += P^T dout and dk += dS^T q (hi, then lo, at each 16-query step):
//      wgmma with A from registers and dout / q from shared memory MN-major
//      (the transpose bit), as the forward reads V; n64 per full 64-column
//      slab, and n16 for hd 80's last 16 columns. dk and dv stay in f32
//      registers across the item (64 keys x hd each a warpgroup). P never
//      leaves registers.
//   4. dS^T hi and lo go to shared memory (two buffers, so a tile's writes
//      never meet the other warpgroup's reads of the tile before), in the
//      128-byte swizzle, conflict-free 4-byte stores; fence.proxy.async and
//      one barrier of the two consumers.
//   5. dq part = dS K over the tile's 128 keys: wgmma SS, M = 64 queries,
//      K = 128 keys, A = dS from shared memory MN-major (transpose bit), B =
//      the K tile MN-major. The consumers split the head dim: hd 128 one
//      slab each (n64); hd 64 32 columns each (n32); hd 80 32 columns of the
//      first slab and 8 of the second each (n32 + n8). dS enters as hi, then
//      lo, at each 16-key step.
//   6. The q / dout stage is released once step 3 has completed
//      (wgmma.wait_group 1, while step 5 runs).
// dq is summed in f32 in a scratch buffer in device memory (in L2) in a
// fixed order: a turn counter per (query head, query tile), the kv tiles
// j_lo(i) .. j_hi(i) taking turns in ascending j. The first contributor
// stores its part, the others read-add-write, and the last scales, rounds
// to bf16 and writes dq; a tile with one contributor writes dq directly.
// A part's old sums are all loaded before any is added (one round trip to
// L2 a part). At hd 64 and 80 a tile's part waits in registers for the
// next tile: its turn is awaited and its old sums loaded while that tile's
// S^T / dP^T run, and it is added after that tile's step 2 (hd 128 has no
// registers to spare and adds at once). Once a part is stored, the
// consumers hand its counter through an mbarrier to the bump warp (the
// producer warpgroup's second warp), whose one thread fences and bumps
// it: the next contributor waits on no later work of this CTA, and a CTA
// never waits on a turn while it holds a bump. Progress: items are claimed
// in ascending order and every turn a CTA waits on belongs to an item with
// a smaller j, claimed before its own, which a resident CTA holds, so the
// chain of waits ends at a first turn. No atomics in the arithmetic.
// When the card would have fewer than two items an SM (few kv heads, as
// hymba-1.5b's 5 at B 1), an item takes one query head of the group
// (`parts` = groups): each part stores its f32 dk, dv sums to a slot of
// its own, and the part that finishes last (by a counter per (kv head, kv
// tile)) sums the slots in ascending part order and rounds them to bf16;
// no part waits on another. Otherwise an item takes the whole group and
// writes dk, dv directly. The choice is by shape and the SM count of the
// launch's device, so reruns are bit-equal on one card model; a card with
// another SM count may split items otherwise and sum dk, dv in another
// order.
// Registers: setmaxnreg gives the consumers 240 a thread and the producer
// 24 (launched at 168). Shared memory at hd 80 and 128 (tiles cover 128
// columns; the TMA zero-fills hd 80's columns 80-127): K and V 32 KB each,
// q and dout 2 x 16 KB each, dS^T 2 x 32 KB, 194 KB in all; hd 64 130 KB.
//
// hd 256: 64 keys x 256 columns of dk plus dv would take 256 registers a
// consumer thread, so that head dim keeps the first design (a choice by
// shape): the same item schedule and dq turns (one part an item), 8 warps
// of mma.sync.m16n8k16 (bf16 in, f32 accumulate) with operands from shared
// memory through ldmatrix (.trans where a product reads a tile along its
// other dim), tiles of 64 query rows x 32 keys, q, dout, lse, delta copied
// with cp.async one tile ahead; per tile phase A (S^T, dP^T; P and dS^T hi
// and lo written key-major to shared memory), a barrier, phase B (dv, dk,
// and the dq part read as the transpose of dS^T); 184 KB of shared memory,
// one CTA an SM.
//
// Plain C interface (loaded with ctypes): contiguous bf16 q, k, v, out,
// dout, dq, dk, dv and f32 lse, 16-byte aligned; head_dim 64, 80, 128 or
// 256; `scratch` holds flash_attention_bwd_bf16_scratch(...) floats (delta,
// the dq turn counters, the dk / dv part counters and the work counter,
// then each part's f32 dk and dv where items take one head of a group),
// `dqacc` BH * Sq * hd floats. Returns cudaGetLastError() after the
// launches, or the first error. flash_attention_bwd_bf16_ctas_per_sm(hd)
// gives the main kernel's CTAs an SM, flash_attention_bwd_bf16_attrs its
// registers a thread (at launch, and the consumers' after setmaxnreg),
// local memory a thread and dynamic shared memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // delta, mma kernel: 8 warps
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

// ---- hd 256: the mma.sync kernel --------------------------------------------

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
bwd_bf16_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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


// ---- hd 64, 80, 128: wgmma, TMA, warp specialisation -----------------------

constexpr int kWgThreads = 384;      // two consumer warpgroups, a producer
constexpr int kBKV = 128;            // keys a kv tile: two 64-key strips
constexpr int kStages = 2;           // the q / dout ring
constexpr int kSlab = 64 * 64 * 2;   // one 64 x 64 bf16 slab (8 KB)

template <int HD>
struct WCfg {
  // the tiles cover HDP columns (the TMA zero-fills HD .. HDP - 1)
  static constexpr int HDP = HD <= 64 ? 64 : 128;
  static constexpr int NS = HDP / 64;            // slabs a 64-row block
  // dv, dk: NF full slabs (n64) and a rest of NR columns (n16 at hd 80)
  static constexpr int NF = HD / 64, NR = HD % 64;
  static constexpr int NRA = NR ? NR / 2 : 1;    // the rest's accumulators
  // dq: consumer w takes NQ columns of slab QS(w) from column QC(w), and at
  // hd 80 NQR more of slab 1 from column 8 w
  static constexpr int NQ = HD == 128 ? 64 : 32;
  static constexpr int NQR = HD == 80 ? 8 : 0;
  static constexpr int NQRA = NQR ? NQR / 2 : 1;
  // shared memory (bytes from a 1024-aligned base): K and V [strip][slab],
  // q and dout [stage][slab], dS^T [buffer][hi, lo][strip], lse log2 e and
  // delta [stage][64], fourteen mbarriers, the bump queue, the item ring
  // and the last-part flag
  static constexpr int KV = 2 * NS * kSlab;
  static constexpr int QD = NS * kSlab;
  static constexpr int K_OFF = 0, V_OFF = KV, Q_OFF = 2 * KV;
  static constexpr int D_OFF = Q_OFF + kStages * QD;
  static constexpr int S_OFF = D_OFF + kStages * QD;
  static constexpr int L_OFF = S_OFF + 8 * kSlab;
  static constexpr int E_OFF = L_OFF + 4 * kStages * kBQ;
  static constexpr int B_OFF = E_OFF + 4 * kStages * kBQ;
  static constexpr size_t smem = B_OFF + 256 + 1024;
  // registers a thread after setmaxnreg: the consumers hold dk and dv (64 x
  // hd each a warpgroup)
  static constexpr int CREGS = 240, PREGS = 24;
  static_assert(HD % 16 == 0 && HD <= HDP, "head dim");
  static_assert(smem <= 232448, "shared memory");
  static_assert(kWgThreads * 168 >= 128 * PREGS + 256 * CREGS,
                "setmaxnreg");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// the two consumer warpgroups (256 threads) meet; the producer never joins
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// generic-proxy shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// Every descriptor here has SBO 1024 (8 rows of 128 bytes) and an operand
// that spans at most one 64-column slab, so LBO is not read.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D32_OUT(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x N, f32) (+)= A (64 x 16) B (16 x N), A and B both MN-major in
// shared memory (the transpose bits); scale_d 0 overwrites d. N = 2 x the
// accumulators a thread: 64, 32, 8.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x N, f32) += A (64 x 16, bf16 fragments in registers) B (16 x N),
// B MN-major in shared memory (the transpose bit): N 64 and 16
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ex2.approx: 2^x, one MUFU op
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The item order: ascending kv tile j, then kv head b, then part g of b's
// query heads (see the source note)
struct Items {
  int n_kv_heads, parts, count;
  __device__ void decode(int item, int& j, int& b, int& g) const {
    g = item % parts;
    const int jb = item / parts;
    j = jb / n_kv_heads;
    b = jb % n_kv_heads;
  }
};

// lane 0 waits until the counter reaches `turn`; the warp then reads what
// the turns before it stored
__device__ __forceinline__ void wait_turn(const int* ctr, int turn,
                                          int lane) {
  if (lane == 0)
    for (int spins = 0; ld_acquire(ctr) != turn; ++spins) {
      // a wait this long means a broken order: fail, not hang
      if (spins > (1 << 24)) __trap();
      __nanosleep(64);
    }
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_bf16_main_kernel(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const __grid_constant__ CUtensorMap tmD,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dqacc, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dkvacc, int* __restrict__ cnt,
                     int* __restrict__ kvcnt, int* __restrict__ work,
                     Tiles tl, Items it, int groups, float scale) {
  using C = WCfg<HD>;
  constexpr int NS = C::NS, NF = C::NF, NR = C::NR;
  constexpr int NQ = C::NQ, NQR = C::NQR;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = base + C::K_OFF;                 // [strip][slab]
  uint8_t* sV = base + C::V_OFF;
  uint8_t* sQ = base + C::Q_OFF;                 // [stage][slab]
  uint8_t* sD = base + C::D_OFF;
  uint8_t* sS = base + C::S_OFF;                 // [buffer][hi, lo][strip]
  float* sL = reinterpret_cast<float*>(base + C::L_OFF);  // [stage][64]
  float* sE = reinterpret_cast<float*>(base + C::E_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::B_OFF);
  uint64_t* fullT = bars;            // [stage] q, dout, lse, delta landed
  uint64_t* emptyT = bars + 2;       // [stage] the consumers are done
  uint64_t* fullKV = bars + 4;       // K and V of an item landed
  uint64_t* emptyKV = bars + 5;      // the consumers are done with them
  uint64_t* fullI = bars + 6;        // [slot] an item published
  uint64_t* emptyI = bars + 8;       // [slot] the item read
  uint64_t* added = bars + 10;       // [slot] a tile's dq adds stored
  uint64_t* bumped = bars + 12;      // [slot] its counter bumped
  int** bumpq = reinterpret_cast<int**>(bars + 14);  // [slot] the counter
  int* islot = reinterpret_cast<int*>(bars + 16);    // [slot], last part
  const int hpi = groups / it.parts;                // query heads an item

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(fullT + s, 32);      // the producer warp's lanes
      mbar_init(emptyT + s, 8);      // one arrive a consumer warp
      mbar_init(fullI + s, 1);
      mbar_init(emptyI + s, 8);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(added + s, 8);
      mbar_init(bumped + s, 1);
    }
    mbar_init(fullKV, 1);
    mbar_init(emptyKV, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one warp claims the items and issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PREGS));
    if (threadIdx.x == 256 + 32) {
      // the bump warp's one thread: once the consumers have stored a tile's
      // dq adds, pass the turn on (the mbarrier orders their stores before
      // this fence, which orders them before the bump at gpu scope), so
      // the next contributor never waits on this CTA's next tile
      for (int bc = 0;; ++bc) {
        const int s = bc & 1;
        mbar_wait(added + s, (bc >> 1) & 1);
        int* ctr = bumpq[s];
        if (ctr == nullptr) break;               // the consumers are done
        __threadfence();
        atomicAdd(ctr, 1);
        mbar_arrive(bumped + s);
      }
    }
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x % 32;
    int tc = 0;                                  // tiles loaded
    for (int ic = 0;; ++ic) {
      const int slot = ic & 1;
      int item = 0;
      if (lane == 0) item = atomicAdd(work, 1);
      item = __shfl_sync(0xffffffffu, item, 0);
      if (lane == 0) {
        mbar_wait(emptyI + slot, ((ic >> 1) & 1) ^ 1);  // round 0 at once
        islot[slot] = item;
        mbar_arrive(fullI + slot);
      }
      if (item >= it.count) break;
      int j, b, gp;
      it.decode(item, j, b, gp);
      const int k0 = j * kBKV;
      const int ihi = tl.i_hi(j), ni = max(0, ihi - tl.i_lo(j));
      const int ntiles = hpi * ni;
      // K and V once the consumers are done with the last item's (after
      // this item's first tile, which a free stage can take meanwhile)
      auto load_kv = [&]() {
        if (lane != 0) return;
        mbar_wait(emptyKV, (ic & 1) ^ 1);
        mbar_expect_tx(fullKV, 2 * C::KV);
        for (int w = 0; w < 2; ++w)
          for (int s = 0; s < NS; ++s) {
            tma_load_3d(sK + (w * NS + s) * kSlab, &tmK, fullKV, 64 * s,
                        k0 + 64 * w, b);
            tma_load_3d(sV + (w * NS + s) * kSlab, &tmV, fullKV, 64 * s,
                        k0 + 64 * w, b);
          }
      };
      if (ntiles == 0) load_kv();
      for (int n = 0; n < ntiles; ++n, ++tc) {
        const int st = tc & 1;
        const int h = b * groups + gp * hpi + n / ni;
        const int q0 = (ihi - 1 - n % ni) * kBQ;
        // lse log2 e and delta of the tile's rows (0 past Sq), loaded before
        // the wait for the stage
        float lv[kBQ / 32], ev[kBQ / 32];
#pragma unroll
        for (int x = 0; x < kBQ / 32; ++x) {
          const int r = lane + 32 * x;
          const bool in = q0 + r < tl.Sq;
          const size_t g = in ? (size_t)h * tl.Sq + q0 + r : 0;
          lv[x] = in ? lse[g] * kLog2e : 0.f;
          ev[x] = in ? delta[g] : 0.f;
        }
        mbar_wait(emptyT + st, ((tc >> 1) & 1) ^ 1);
#pragma unroll
        for (int x = 0; x < kBQ / 32; ++x) {
          sL[st * kBQ + lane + 32 * x] = lv[x];
          sE[st * kBQ + lane + 32 * x] = ev[x];
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(fullT + st, 2 * C::QD);   // lane 0's arrive
          for (int s = 0; s < NS; ++s) {
            tma_load_3d(sQ + (st * NS + s) * kSlab, &tmQ, fullT + st,
                        64 * s, q0, h);
            tma_load_3d(sD + (st * NS + s) * kSlab, &tmD, fullT + st,
                        64 * s, q0, h);
          }
        } else {
          mbar_arrive(fullT + st);
        }
        if (n == 0) load_kv();
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns keys 64 w .. 64 w + 63 of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CREGS));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int Sq = tl.Sq, Skv = tl.Skv;
  const float scale_log2 = scale * kLog2e;
  // dq columns of this warpgroup: NQ of slab qs from column qc, and at hd
  // 80 NQR of slab 1 from column 8 wg
  const int qs = HD == 128 ? wg : 0, qc = HD == 128 ? 0 : 32 * wg;
  int tc = 0;                                    // tiles consumed
  // A tile's dq part (f32, this warpgroup's columns) is added to dqacc in
  // its turn. At hd 64 and 80 the add waits for the next tile: the old sums
  // load while that tile's S^T / dP^T and P / dS run, and are added after
  // them. hd 128 has no registers to spare and adds at once.
  constexpr bool kPipe = HD <= 80;
  constexpr int NC = NQ / 8;
  const int cmain = 64 * qs + qc, crest = 64 + 8 * wg;
  float pq[NQ / 2], pr[C::NQRA];                 // the part
  float2 old[2][NC], oldr[2];                    // the old sums
  int* pctr = nullptr;                           // its counter; null: none
  int pturn = 0;
  bool pfirst = false, plast = false, pin[2];
  size_t prb[2];                                 // its two rows, columns
  int bc = 0;                                    // parts handed on
  // the old sums, once the turn has come (the first turn has none)
  auto fetch = [&]() {
    if (pfirst) return;
    wait_turn(pctr, pturn, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!pin[half]) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        old[half][c] = __ldcg(reinterpret_cast<const float2*>(
            dqacc + prb[half] + cmain + 8 * c));
      if constexpr (NQR > 0)
        oldr[half] = __ldcg(
            reinterpret_cast<const float2*>(dqacc + prb[half] + crest));
    }
  };
  // the sums stored (the last turn: scaled and rounded into dq), and the
  // counter handed to the bump warp (its slot is free once it bumped the
  // one two parts back)
  auto finish = [&]() {
    auto put = [&](size_t at, float x, float y, float2 o) {
      if (!pfirst) {
        x += o.x;
        y += o.y;
      }
      if (plast)
        *reinterpret_cast<__nv_bfloat162*>(dq + at) =
            __floats2bfloat162_rn(x * scale, y * scale);
      else
        __stcg(reinterpret_cast<float2*>(dqacc + at), make_float2(x, y));
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!pin[half]) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        put(prb[half] + cmain + 8 * c, pq[4 * c + 2 * half],
            pq[4 * c + 2 * half + 1], old[half][c]);
      if constexpr (NQR > 0)
        put(prb[half] + crest, pr[2 * half], pr[2 * half + 1], oldr[half]);
    }
    if (threadIdx.x == 0) {
      mbar_wait(bumped + (bc & 1), ((bc >> 1) & 1) ^ 1);
      bumpq[bc & 1] = pctr;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(added + (bc & 1));
    ++bc;
    pctr = nullptr;
  };
  for (int ic = 0;; ++ic) {
    const int slot = ic & 1;
    mbar_wait(fullI + slot, (ic >> 1) & 1);
    const int item = islot[slot];
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyI + slot);
    if (item >= it.count) break;
    int j, b, gp;
    it.decode(item, j, b, gp);
    const int k0 = j * kBKV;
    const int ihi = tl.i_hi(j), ni = max(0, ihi - tl.i_lo(j));
    const int ntiles = hpi * ni;
    const int ks0 = k0 + 64 * wg;                // this strip's first key
    const int kr0 = ks0 + 16 * warp + lane / 4;  // this thread's keys
    const uint32_t aK = smem_u32(sK + wg * NS * kSlab);
    const uint32_t aV = smem_u32(sV + wg * NS * kSlab);

    float dva[NF][32], dka[NF][32], dvr[C::NRA], dkr[C::NRA];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 32; ++e) dva[f][e] = dka[f][e] = 0.f;
#pragma unroll
    for (int e = 0; e < C::NRA; ++e) dvr[e] = dkr[e] = 0.f;

    mbar_wait(fullKV, ic & 1);
    for (int n = 0; n < ntiles; ++n, ++tc) {
      const int st = tc & 1, buf = tc & 1;
      const int i = ihi - 1 - n % ni;
      const int h = b * groups + gp * hpi + n / ni, q0 = i * kBQ;
      // this CTA's turn at dq tile (h, i): after the kv tiles below j
      const int turn = j - tl.j_lo(i);
      const bool first = turn == 0, last = j == tl.j_hi(i);
      int* ctr = cnt + (size_t)h * tl.nq + i;
      const uint32_t bQ = smem_u32(sQ + st * NS * kSlab);
      const uint32_t bD = smem_u32(sD + st * NS * kSlab);
      mbar_wait(fullT + st, (tc >> 1) & 1);

      // 1. S^T = K q^T, dP^T = V dout^T (keys x queries)
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
        wgmma_ss(s, desc_sw128(aK + off), desc_sw128(bQ + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
        wgmma_ss(dp, desc_sw128(aV + off), desc_sw128(bD + off), kk > 0);
      }
      wgmma_commit();
      if (kPipe && pctr) fetch();  // the last tile's old sums
      wgmma_wait0();
      reg_fence(s);
      reg_fence(dp);

      // 2. P and dS on the fragments: element 4 c + e is key kr0 (+ 8 for
      // e & 2), query q0 + 8 c + 2 t4 + (e & 1)
      const float* Ls = sL + st * kBQ;
      const float* Es = sE + st * kBQ;
      const bool whole = ks0 + 63 < Skv && q0 + kBQ <= Sq &&
                         (!tl.causal || ks0 + 63 <= q0) &&
                         (!tl.window || q0 + kBQ - 1 - ks0 < tl.window);
      // p = 2^(s scale log2 e - lse log2 e) for element x at column pair
      // c; then dS = P (dP - delta)
      auto pds = [&](int c, float2 l2, float2 e2, auto&& keep) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * c + e;
          float p = ex2(fmaf(s[x], scale_log2, (e & 1) ? -l2.y : -l2.x));
          if (!keep(e)) p = 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - ((e & 1) ? e2.y : e2.x));
        }
      };
      if (whole) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          pds(c, *reinterpret_cast<const float2*>(Ls + 8 * c + 2 * t4),
              *reinterpret_cast<const float2*>(Es + 8 * c + 2 * t4),
              [](int) { return true; });
      } else {
        // visible: q - k in [dlo, dhi), q < Sq, k < Skv
        const int dlo = tl.causal ? 0 : -(1 << 30);
        const int dhi = tl.window ? tl.window : (1 << 30);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int qp = q0 + 8 * c + 2 * t4;
          pds(c, *reinterpret_cast<const float2*>(Ls + 8 * c + 2 * t4),
              *reinterpret_cast<const float2*>(Es + 8 * c + 2 * t4),
              [&](int e) {
                const int qe = qp + (e & 1), ke = kr0 + (e & 2) * 4;
                const int d = qe - ke;
                return qe < Sq && ke < Skv && d >= dlo && d < dhi;
              });
        }
      }
      // as wgmma A fragments, 16 queries a step: P in bf16, dS as hi + lo
      uint32_t pa[4][4], dh[4][4], dl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kk + 2 * r;
          pa[kk][r] = pack_bf16(s[x], s[x + 1]);
          const __nv_bfloat162 hv = __floats2bfloat162_rn(dp[x], dp[x + 1]);
          const float2 hf = __bfloat1622float2(hv);
          dh[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
          dl[kk][r] = pack_bf16(dp[x] - hf.x, dp[x + 1] - hf.y);
        }

      if (kPipe && pctr) finish();  // the last tile's add

      // 3. dv += P^T dout, dk += dS^T q (hi, then lo)
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        reg_fence(dva[f]);
        reg_fence(dka[f]);
      }
      reg_fence(dvr);
      reg_fence(dkr);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < NF; ++f)
          wgmma_rs(dva[f], pa[kk],
                   desc_sw128(bD + f * kSlab + kk * 16 * 128));
        if constexpr (NR > 0)
          wgmma_rs(dvr, pa[kk], desc_sw128(bD + NF * kSlab + kk * 16 * 128));
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const uint64_t dq_ = desc_sw128(bQ + f * kSlab + kk * 16 * 128);
          wgmma_rs(dka[f], dh[kk], dq_);
          wgmma_rs(dka[f], dl[kk], dq_);
        }
        if constexpr (NR > 0) {
          const uint64_t dq_ = desc_sw128(bQ + NF * kSlab + kk * 16 * 128);
          wgmma_rs(dkr, dh[kk], dq_);
          wgmma_rs(dkr, dl[kk], dq_);
        }
      }
      wgmma_commit();

      // 4. dS^T hi and lo of this strip to shared memory (128-byte
      // swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8))
      {
        uint8_t* hiS = sS + ((buf * 2 + 0) * 2 + wg) * kSlab;
        uint8_t* loS = sS + ((buf * 2 + 1) * 2 + wg) * kSlab;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + lane / 4 + 8 * half;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int at = r * 128 + ((c ^ (r & 7)) << 4) + 4 * t4;
            *reinterpret_cast<uint32_t*>(hiS + at) =
                dh[c >> 1][2 * (c & 1) + half];
            *reinterpret_cast<uint32_t*>(loS + at) =
                dl[c >> 1][2 * (c & 1) + half];
          }
        }
      }
      fence_async_smem();
      consumers_sync();            // dS^T of both strips written

      // 5. this tile's dq part dS K (queries x this warpgroup's columns)
      float dqa[NQ / 2], dqr[C::NQRA];
      {
        const uint32_t aH = smem_u32(sS + (buf * 2 + 0) * 2 * kSlab);
        const uint32_t aL = smem_u32(sS + (buf * 2 + 1) * 2 * kSlab);
        const uint32_t k0s = smem_u32(sK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          const uint32_t offA = (kk / 4) * kSlab + (kk % 4) * 16 * 128;
          const uint32_t kb =
              k0s + (kk / 4) * NS * kSlab + (kk % 4) * 16 * 128;
          const uint64_t bk = desc_sw128(kb + qs * kSlab + 2 * qc);
          wgmma_ss_tt(dqa, desc_sw128(aH + offA), bk, kk > 0);
          wgmma_ss_tt(dqa, desc_sw128(aL + offA), bk, 1);
          if constexpr (NQR > 0) {
            const uint64_t br = desc_sw128(kb + kSlab + 16 * wg);
            wgmma_ss_tt(dqr, desc_sw128(aH + offA), br, kk > 0);
            wgmma_ss_tt(dqr, desc_sw128(aL + offA), br, 1);
          }
        }
        wgmma_commit();
        // 6. once step 3 has completed the q / dout stage is free
        wgmma_wait1();
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          reg_fence(dva[f]);
          reg_fence(dka[f]);
        }
        reg_fence(dvr);
        reg_fence(dkr);
        __syncwarp();
        if (lane == 0) mbar_arrive(emptyT + st);
        wgmma_wait0();             // step 5 complete
      }
      reg_fence(dqa);
      reg_fence(dqr);

      // this tile's part waits for its add: the first turn stores, the
      // others add in turn order, the last scales and rounds to bf16; every
      // old sum of a part is loaded before any is added (one round trip to
      // L2 a part)
#pragma unroll
      for (int x = 0; x < NQ / 2; ++x) pq[x] = dqa[x];
#pragma unroll
      for (int x = 0; x < C::NQRA; ++x) pr[x] = dqr[x];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qp = q0 + 16 * warp + lane / 4 + 8 * half;
        prb[half] = ((size_t)h * Sq + qp) * HD + 2 * t4;
        pin[half] = qp < Sq;
      }
      pctr = ctr;
      pturn = turn;
      pfirst = first;
      plast = last;
      if constexpr (!kPipe) {
        fetch();
        finish();
      }
    }
    if (kPipe && pctr) {           // the item's last part
      fetch();
      finish();
    }
    // every product that reads K and V has completed: they are free
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyKV);

    // dk, dv of this thread's keys (dk scaled at the rounding): stored; or,
    // where an item is one part of the group's query heads, this part's f32
    // sums stored to its own slot, and the part that finishes last (by the
    // counter) sums the slots in ascending part order and rounds them
    const size_t kvsize = (size_t)it.n_kv_heads * Skv * HD;
    const bool parted = it.parts > 1;
    float* mine = dkvacc + (size_t)gp * 2 * kvsize;
    // each (row, column) pair of this thread once: slab f < NF, or the rest
    auto each = [&](auto&& fn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kp = kr0 + 8 * half;
        if (kp >= Skv) continue;
        const size_t row = ((size_t)b * Skv + kp) * HD + 2 * t4;
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            fn(row + 64 * f + 8 * c, dva[f] + 4 * c + 2 * half,
               dka[f] + 4 * c + 2 * half);
#pragma unroll
        for (int c = 0; c < NR / 8; ++c)
          fn(row + 64 * NF + 8 * c, dvr + 4 * c + 2 * half,
             dkr + 4 * c + 2 * half);
      }
    };
    auto round_out = [&](size_t at, float* v, float* d) {
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(d[0] * scale, d[1] * scale);
    };
    if (!parted) {
      each(round_out);
    } else {
      each([&](size_t at, float* v, float* d) {
        __stcg(reinterpret_cast<float2*>(mine + at), make_float2(d[0], d[1]));
        __stcg(reinterpret_cast<float2*>(mine + kvsize + at),
               make_float2(v[0], v[1]));
      });
      int* last_s = islot + 2;
      consumers_sync();            // every partial of the item stored
      if (threadIdx.x == 0) {
        __threadfence();
        *last_s = atomicAdd(kvcnt + (size_t)b * tl.nkv + j, 1) ==
                  it.parts - 1;
        __threadfence();
      }
      consumers_sync();
      if (*last_s) {
        for (int g = 0; g < it.parts; ++g) {
          const float* slot = dkvacc + (size_t)g * 2 * kvsize;
          each([&](size_t at, float* v, float* d) {
            const float2 x =
                __ldcg(reinterpret_cast<const float2*>(slot + at));
            const float2 y =
                __ldcg(reinterpret_cast<const float2*>(slot + kvsize + at));
            d[0] = g ? d[0] + x.x : x.x;
            d[1] = g ? d[1] + x.y : x.y;
            v[0] = g ? v[0] + y.x : y.x;
            v[1] = g ? v[1] + y.y : y.y;
          });
        }
        each(round_out);
      }
    }
  }
  // the bump warp stops at a null counter
  if (threadIdx.x == 0) {
    mbar_wait(bumped + (bc & 1), ((bc >> 1) & 1) ^ 1);
    bumpq[bc & 1] = nullptr;
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(added + (bc & 1));
}

// ---- launchers ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up once through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D map (hd, rows, heads) of a contiguous (heads, rows, hd) bf16
// tensor, boxes of 64 x 64 x 1 in the 128-byte swizzle; out-of-bounds
// elements of a box read as zero
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                int hd, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the SM count of the current device (the launch's), read once a device
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  if (counts[dev] == 0) {
    int count = 0;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return -1;
    counts[dev] = count;
  }
  return counts[dev];
}

// The scratch of one call, in floats: delta (BH * Sq), the dq turn
// counters (BH * nq), the dk / dv part counters (kv heads * nkv), the work
// counter, then (16-byte aligned) each part's f32 dk and dv when items
// take one query head of a group (parts * 2 * kv heads * Skv * hd), else
// nothing.
struct Plan {
  Tiles t;
  Items it;
  size_t rows, ncnt, acc_off, floats;
};

Plan plan(int hd, int BH, int Sq, int Skv, int groups) {
  Plan p;
  const int bkv = hd == 256 ? 32 : kBKV;
  p.t = Tiles{Sq, Skv, kBQ, bkv, 0, 0, (Sq + kBQ - 1) / kBQ,
              (Skv + bkv - 1) / bkv};
  const int kv_heads = BH / groups;
  const int base_items = kv_heads * p.t.nkv;
  // one query head an item where the card would have fewer than two
  // items an SM (the mma kernel at hd 256 always takes the whole group)
  const int parts =
      hd != 256 && groups > 1 && base_items < 2 * sm_count() ? groups : 1;
  p.it = Items{kv_heads, parts, base_items * parts};
  p.rows = (size_t)BH * Sq;
  p.ncnt = (size_t)BH * p.t.nq + (size_t)base_items + 1;
  p.acc_off = (p.rows + p.ncnt + 3) / 4 * 4;
  p.floats = p.acc_off +
             (parts > 1 ? (size_t)parts * 2 * kv_heads * Skv * hd : 0);
  return p;
}

// the delta launch (also zeroes every counter and the dq rows no kv tile
// reaches)
int launch_delta(const bf16* out, const bf16* dout, float* scratch, bf16* dq,
                 const Plan& p, int hd, cudaStream_t stream) {
  int* cnt = reinterpret_cast<int*>(scratch + p.rows);
  const long long threads = (long long)p.rows * 32 > (long long)p.ncnt
                                ? (long long)p.rows * 32
                                : (long long)p.ncnt;
  bwd_bf16_delta_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      out, dout, scratch, cnt, (int)p.ncnt, dq, p.t, (int)p.rows, hd);
  return (int)cudaGetLastError();
}

template <int HD>
struct WLauncher {
  using C = WCfg<HD>;
  // opt in and read the occupancy once per instantiation (thread-safe
  // static init), so a launch inside CUDA graph capture makes no attribute
  // call
  static int ctas_per_sm() {
    static const int occ = [] {
      auto kern = bwd_bf16_main_kernel<HD>;
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kern, kWgThreads, C::smem) != cudaSuccess)
        return -1;
      return n;
    }();
    return occ;
  }
  static int attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err =
        cudaFuncGetAttributes(&a, bwd_bf16_main_kernel<HD>);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = C::CREGS;
    out[2] = (int)a.localSizeBytes;
    out[3] = (int)C::smem;
    out[4] = ctas_per_sm();
    return 0;
  }

  static int run(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* out, const bf16* dout, const float* lse,
                 float* scratch, float* dqacc, bf16* dq, bf16* dk, bf16* dv,
                 int BH, int Sq, int Skv, int groups, int causal, int window,
                 float scale, cudaStream_t stream) {
    const int occ = ctas_per_sm(), nsm = sm_count();
    if (occ <= 0 || nsm <= 0) return (int)cudaErrorInvalidConfiguration;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    const int kv_heads = BH / groups;
    CUtensorMap tq, tk, tv, td;
    if (!tensor_map(&tq, encode, q, HD, Sq, BH) ||
        !tensor_map(&tk, encode, k, HD, Skv, kv_heads) ||
        !tensor_map(&tv, encode, v, HD, Skv, kv_heads) ||
        !tensor_map(&td, encode, dout, HD, Sq, BH))
      return (int)cudaErrorInvalidValue;
    Plan p = plan(HD, BH, Sq, Skv, groups);
    p.t.causal = causal;
    p.t.window = window;
    int err = launch_delta(out, dout, scratch, dq, p, HD, stream);
    if (err != cudaSuccess) return err;
    int* cnt = reinterpret_cast<int*>(scratch + p.rows);
    int* kvcnt = cnt + (size_t)BH * p.t.nq;
    int* work = kvcnt + (size_t)kv_heads * p.t.nkv;
    const int grid = p.it.count < occ * nsm ? p.it.count : occ * nsm;
    bwd_bf16_main_kernel<HD><<<grid, kWgThreads, C::smem, stream>>>(
        tq, tk, tv, td, lse, scratch, dqacc, dq, dk, dv,
        scratch + p.acc_off, cnt, kvcnt, work, p.t, p.it, groups, scale);
    return (int)cudaGetLastError();
  }
};

// hd 256: the mma.sync kernel
struct MmaLauncher {
  static constexpr int HD = 256, BKV = 32;
  using C = Cfg<HD, BKV>;
  static int ctas_per_sm() {
    static const int occ = [] {
      auto kern = bwd_bf16_mma_kernel<HD, BKV>;
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
  static int attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t err =
        cudaFuncGetAttributes(&a, bwd_bf16_mma_kernel<HD, BKV>);
    if (err != cudaSuccess) return (int)err;
    out[0] = out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    out[3] = (int)C::smem;
    out[4] = ctas_per_sm();
    return 0;
  }

  static int run(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* out, const bf16* dout, const float* lse,
                 float* scratch, float* dqacc, bf16* dq, bf16* dk, bf16* dv,
                 int BH, int Sq, int Skv, int groups, int causal, int window,
                 float scale, cudaStream_t stream) {
    const int occ = ctas_per_sm(), nsm = sm_count();
    if (occ <= 0 || nsm <= 0) return (int)cudaErrorInvalidConfiguration;
    Plan p = plan(HD, BH, Sq, Skv, groups);
    p.t.causal = causal;
    p.t.window = window;
    int err = launch_delta(out, dout, scratch, dq, p, HD, stream);
    if (err != cudaSuccess) return err;
    int* cnt = reinterpret_cast<int*>(scratch + p.rows);
    const int kv_heads = BH / groups;
    int* work = cnt + (size_t)BH * p.t.nq + (size_t)kv_heads * p.t.nkv;
    const int grid = p.it.count < occ * nsm ? p.it.count : occ * nsm;
    bwd_bf16_mma_kernel<HD, BKV><<<grid, kThreads, C::smem, stream>>>(
        q, k, v, dout, lse, scratch, dqacc, dq, dk, dv, cnt, work, p.t,
        kv_heads, groups, scale);
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
      return WLauncher<64>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk, gv,
                                BH, Sq, Skv, groups, causal, window, scale,
                                s);
    case 80:
      return WLauncher<80>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk, gv,
                                BH, Sq, Skv, groups, causal, window, scale,
                                s);
    case 128:
      return WLauncher<128>::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk, gv,
                                 BH, Sq, Skv, groups, causal, window, scale,
                                 s);
    case 256:
      return MmaLauncher::run(bq, bk, bv, bo, bd, fl, fs, fa, gq, gk, gv, BH,
                              Sq, Skv, groups, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the floats of `scratch` that flash_attention_bwd_bf16 needs for this call
// (reads the card's SM count)
long long flash_attention_bwd_bf16_scratch(int hd, int BH, int Sq, int Skv,
                                           int groups) {
  if (sm_count() <= 0) return -1;
  return (long long)plan(hd, BH, Sq, Skv, groups).floats;
}

int flash_attention_bwd_bf16_ctas_per_sm(int hd) {
  switch (hd) {
    case 64: return WLauncher<64>::ctas_per_sm();
    case 80: return WLauncher<80>::ctas_per_sm();
    case 128: return WLauncher<128>::ctas_per_sm();
    case 256: return MmaLauncher::ctas_per_sm();
  }
  return -1;
}

// the main kernel's registers a thread at launch and (after setmaxnreg)
// in a consumer warpgroup, local memory a thread (spills), dynamic shared
// memory and CTAs an SM, into out[0..4]
int flash_attention_bwd_bf16_attrs(int hd, int* out) {
  switch (hd) {
    case 64: return WLauncher<64>::attrs(out);
    case 80: return WLauncher<80>::attrs(out);
    case 128: return WLauncher<128>::attrs(out);
    case 256: return MmaLauncher::attrs(out);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
