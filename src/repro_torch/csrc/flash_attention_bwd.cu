// Hand-written Hopper (sm_90a) kernels: the flash-attention backward.
//
// Replaces the backward that the JAX reference differentiates in place of a
// TPU kernel: jax.grad through src/repro/models/attention.py::
// chunked_attention (:97); the Pallas forward kernel
// (src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd) is
// forward-only and names "the standard flash backward" as its pair. Given
// q (BH, Sq, hd), k/v (BKV, Skv, hd) with BH = BKV * groups, the forward's
// out and dout (BH, Sq, hd) and the forward's row log-sum-exp lse (BH, Sq)
// (lse = m + log l of the scaled logits), it computes, in f32 on the CUDA
// cores:
//   delta_i = sum_d dout_id out_id
//   P_ij    = exp(s_ij scale - lse_i), 0 where the causal / window mask or
//             the tails hide (i, j), s = q k^T
//   dP      = dout v^T,  dS = P (dP - delta)
//   dv = P^T dout,  dk = scale dS^T q,  dq = scale dS k
// with the forward's masks (causal q_pos >= kv_pos, window q_pos - kv_pos <
// window) and GQA (query head bh reads kv head bh / groups, so dk and dv sum
// over the group).
//
// Bound on the card: operations. Five products over the unmasked pairs (S,
// dP, dv, dk, dq), 2 hd FLOP each: at stablelm-3b's training shape (BH 32,
// S 2048, hd 80, causal) 67.1 M pairs, 53.7 GFLOP, 0.80 ms at f32's 67
// TFLOP/s, against 2 x 21 MB of q, k, v, out, dout in and dq, dk, dv out
// (0.014 ms at 3.35 TB/s). The kernel does exactly those five products
// (over whole tiles): S and dP are computed once per tile pair.
//
// Design: two launches from one call.
//   delta — one warp per row, 16-byte loads, a fixed xor-shuffle tree; it
//           also zeroes the turn counters and the dq rows of query tiles
//           that no kv tile reaches.
//   main  — a persistent grid of at most the CTAs that fit on the card (one
//           an SM: 8 warps, up to 214 KB of shared memory). A CTA claims a work item, (kv head b, kv
//           tile j), from a counter, heavy items first (ascending j, all
//           heads at each j: under the causal mask kv tile 0 meets every
//           query tile), and keeps that tile's K and V in shared memory
//           while it walks, for each query head of b's group, the query
//           tiles that the forward's tile test pairs with j, from the last
//           down. Each query tile's q, dout, lse and delta are copied with
//           cp.async one tile ahead (two buffers), so the copy overlaps the
//           arithmetic. Per tile:
//     phase A: S^T and dP^T (keys x queries): a thread holds both at keys
//           ty + 16 a against queries tx + 16 c (4 x 4 at 64 x 64 tiles),
//           a warp 4 x 8 of those groups, so its 16-byte loads hit four and
//           eight distinct rows; then in registers P = exp2(s scale log2 e
//           - lse log2 e) (0 where masked) and dS = P (dP - delta), written
//           by query row (P, dS) and by key row (dS^T).
//     phase B: the three other products, dv += P^T dout and dk += dS^T q
//           (in registers across the item's tiles) and this tile's dq part
//           dS k, all C[r][c] += sum_t A[t][r] B[t][c] in one code path: a
//           thread tile is 8 rows x 4 columns (one 16-byte load of each
//           operand feeds 32 FFMA), each step's operands load while the
//           previous step's FFMAs run, and the tiles of all three products
//           are dealt to the threads in order, in rounds. At hd 80 that is
//           480 tiles in two rounds of 256 (15 of 16 lanes work, against
//           10 of 16 in the previous design's second column pass); hd 64
//           768 and hd 256 768 in three rounds (all), hd 128 640 in three
//           (5 of 6).
//   The dq part is added to dq in device memory (f32, in L2) in a fixed
//   order, so the result does not depend on scheduling: a turn counter per
//   (query head, query tile). The contributors of query tile i are kv tiles
//   j_lo(i) .. j_hi(i), and they take turns in ascending j: a CTA walks its
//   query tiles down from the last, so kv tiles claimed earlier reach a
//   query tile earlier. The first contributor stores its part, the others
//   read-add-write, the last one scales by `scale`. A thread with dq
//   entries reads the counter (relaxed, once a warp) before its dq product;
//   if the turn has come it copies the old values of its entries into
//   shared memory with cp.async while the product runs, else it spins after
//   the product and reads them from L2. After the next tile's first
//   barrier thread 0 fences (cumulative over the CTA's stores, which that
//   barrier ordered before it) and bumps the counter, so a CTA never waits
//   on a turn while it holds a bump. Progress is certain, not likely: items
//   are claimed in ascending j, so a CTA only ever waits on an item claimed
//   before its own, which a running CTA holds, and the chain of waits ends
//   at j_lo(i), whose turn is the first. The counter that hands out work
//   orders nothing numeric. The turns do cost time: the items of one j
//   start together, so each meets the one below it at their first query
//   tile and then trails it by about a tile, and its dq reads often find
//   the turn not yet come (PERF.md has the measured share).
// Every sum runs in a fixed order (no atomics in the arithmetic), so a rerun
// is bit-equal. Tiles (query rows x keys): 64 x 64 at hd 64 and 80, 32 x 64
// at hd 128, 32 x 32 at hd 256 (where the old dq is read from L2 directly:
// its staging does not fit). Shared-memory rows are padded (K, V, q, dout
// by 4 floats; P, dS by 4; dS^T by 8) so that the loads and stores of every
// phase are free of bank conflicts. Keys past Skv and rows past Sq are
// zero-filled and masked, so the lengths need not be tile multiples.
//
// Plain C interface (loaded with ctypes): contiguous f32 pointers, 16-byte
// aligned; head_dim 64, 80, 128 or 256; `scratch` holds BH * Sq + BH *
// ceil(Sq / 32) + 1 floats (delta, then the turn counters and the work
// counter). Returns cudaGetLastError() after the launches, or the first
// error. flash_attention_bwd_ctas_per_sm(hd) gives the main kernel's CTAs
// an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // both kernels: 8 warps
constexpr float kLog2e = 1.4426950408889634f;
// the dq adds and their turns; false only in a diagnostic variant
// (scripts/torch_kernel_variants.py), whose dq is then wrong
constexpr bool kDqAdds = true;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  return qp < Sq && kp < Skv && (!causal || qp >= kp) &&
         (!window || qp - kp < window);
}

// The forward's tile test, from both sides: the kv tiles [j_lo, j_hi] that
// query tile i meets, and the query tiles [i_lo, i_hi) that kv tile j meets.
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

template <int HD, int BQ, int BKV>
struct Cfg {
  static constexpr int HD4 = HD / 4;
  static constexpr int RS = HD + 4;          // K, V, q, dout rows
  static constexpr int PS = BKV + 4;         // P, dS rows (by query)
  static constexpr int TS = BQ + 8;          // dS^T rows (by key)
  // phase A: a 16 x 16 grid of threads; thread (ty, tx) holds S and dP at
  // keys ty + 16 a (a < AK) against queries tx + 16 c (c < AQ)
  static constexpr int AK = BKV / 16, AQ = BQ / 16;
  // phase B: a thread tile is 8 rows x 4 columns; the tiles of dV, dK and
  // dQ in that order, dealt to the threads in ROUNDS rounds
  static constexpr int DVT = BKV / 8 * HD4;   // dV's tiles (dK's the same)
  static constexpr int NT = (2 * BKV + BQ) / 8 * HD4;
  static constexpr int ROUNDS = (NT + kThreads - 1) / kThreads;
  static constexpr int QTILE = BQ * RS;
  // floats: K, V, q x 2, dout x 2, P, dS, dS^T, lse x 2, delta x 2, the
  // claimed item, then (where it fits) the staged old dq
  static constexpr int K_OFF = 0, V_OFF = BKV * RS, Q_OFF = 2 * BKV * RS;
  static constexpr int D_OFF = Q_OFF + 2 * QTILE;
  static constexpr int P_OFF = D_OFF + 2 * QTILE;
  static constexpr int S_OFF = P_OFF + BQ * PS;
  static constexpr int T_OFF = S_OFF + BQ * PS;
  static constexpr int L_OFF = T_OFF + BKV * TS;
  static constexpr int E_OFF = L_OFF + 2 * BQ;
  static constexpr int I_OFF = E_OFF + 2 * BQ;
  static constexpr int X_OFF = I_OFF + 4;
  static constexpr bool STAGE =
      sizeof(float) * (size_t)(X_OFF + BQ * HD) <= 232448;
  static constexpr size_t smem =
      sizeof(float) * (size_t)(X_OFF + (STAGE ? BQ * HD : 0));
  static_assert(BQ % 16 == 0 && BKV % 16 == 0, "tiles");
  // a warp that straddles two products runs one reduction length
  static_assert(BQ == BKV || DVT % 32 == 0, "warp-uniform reduction");
};

// ---- delta -----------------------------------------------------------------

// One warp per row (h, q): delta = rowsum(dout * out); the row of dq is
// zeroed when its query tile meets no kv tile. Threads below ncnt zero the
// counters.
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ out,
                 const float* __restrict__ dout, float* __restrict__ delta,
                 int* __restrict__ cnt, int ncnt, float* __restrict__ dq,
                 Tiles t, int rows, int hd) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid < ncnt) cnt[gid] = 0;
  const int row = gid / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                      // whole warps leave
  const float* o = out + (size_t)row * hd;
  const float* d = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int c = 4 * lane; c < hd; c += 128) {
    const float4 a = ld4(o + c), b = ld4(d + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
  const int i = (row % t.Sq) / t.BQ;
  if (t.j_lo(i) > t.j_hi(i))
    for (int c = 4 * lane; c < hd; c += 128)
      *reinterpret_cast<float4*>(dq + (size_t)row * hd + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- the main kernel ---------------------------------------------------------

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// acc[r][c] += sum_t A[t * as + r] B[t * bs + c], r < 8, c < 4; the next
// step's operands are loaded while this step's FFMAs run
template <int T>
__device__ __forceinline__ void mac(float (&acc)[8][4], const float* A,
                                    int as, const float* B, int bs) {
  float4 a[2][2], b[2];
  auto load = [&](int s, int t) {
    a[s][0] = ld4(A + t * as);
    a[s][1] = ld4(A + t * as + 4);
    b[s] = ld4(B + t * bs);
  };
  auto step = [&](int s) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float ar = r < 4 ? comp(a[s][0], r) : comp(a[s][1], r - 4);
      acc[r][0] = fmaf(ar, b[s].x, acc[r][0]);
      acc[r][1] = fmaf(ar, b[s].y, acc[r][1]);
      acc[r][2] = fmaf(ar, b[s].z, acc[r][2]);
      acc[r][3] = fmaf(ar, b[s].w, acc[r][3]);
    }
  };
  load(0, 0);
#pragma unroll 4
  for (int t = 0; t < T; t += 2) {
    load(1, t + 1);
    step(0);
    if (t + 2 < T) load(0, t + 2);
    step(1);
  }
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads, 1)
bwd_main_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv,
                int* __restrict__ cnt, int* __restrict__ work, Tiles tl,
                int n_kv_heads, int groups, float scale) {
  using C = Cfg<HD, BQ, BKV>;
  constexpr int HD4 = C::HD4, RS = C::RS, PS = C::PS, TS = C::TS;
  constexpr int AK = C::AK, AQ = C::AQ;
  constexpr int ROUNDS = C::ROUNDS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem + C::K_OFF;
  float* Vs = smem + C::V_OFF;
  float* Ps = smem + C::P_OFF;
  float* Ss = smem + C::S_OFF;
  float* St = smem + C::T_OFF;
  int* item_s = reinterpret_cast<int*>(smem + C::I_OFF);
  float* Xs = smem + C::X_OFF;           // staged old dq (BQ, HD)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // phase A: a warp is 4 key groups x 8 query groups
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  // phase B: this thread's tile of each round
  int prod[ROUNDS], r0s[ROUNDS], c0s[ROUNDS];
#pragma unroll
  for (int u = 0; u < ROUNDS; ++u) {
    const int tau = tid + kThreads * u;
    prod[u] = tau < C::DVT ? 0 : tau < 2 * C::DVT ? 1 : tau < C::NT ? 2 : 3;
    const int rel = tau - (prod[u] == 0 ? 0 : prod[u] == 1 ? C::DVT
                                                           : 2 * C::DVT);
    r0s[u] = (rel / HD4) * 8;
    c0s[u] = (rel % HD4) * 4;
  }
  const int Sq = tl.Sq, Skv = tl.Skv, nq = tl.nq;
  const int items = n_kv_heads * tl.nkv;

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

    const float* kb = k + (size_t)b * Skv * HD;
    const float* vb = v + (size_t)b * Skv * HD;
    for (int e = tid; e < BKV * HD4; e += kThreads) {
      const int r = e / HD4, c = e % HD4;
      const bool in = k0 + r < Skv;
      const size_t g = in ? (size_t)(k0 + r) * HD + 4 * c : 0;
      cp_async16(Ks + r * RS + 4 * c, kb + g, in);
      cp_async16(Vs + r * RS + 4 * c, vb + g, in);
    }
    // q, dout, lse and delta of tile n into buffer n & 1; tile n is query
    // tile ihi - 1 - n % ni of query head b * groups + n / ni
    auto load_tile = [&](int n) {
      const int h = b * groups + n / ni, q0 = (ihi - 1 - n % ni) * BQ;
      float* Qb = smem + C::Q_OFF + (n & 1) * C::QTILE;
      float* Db = smem + C::D_OFF + (n & 1) * C::QTILE;
      const float* qb = q + (size_t)h * Sq * HD;
      const float* db = dout + (size_t)h * Sq * HD;
      for (int e = tid; e < BQ * HD4; e += kThreads) {
        const int r = e / HD4, c = e % HD4;
        const bool in = q0 + r < Sq;
        const size_t g = in ? (size_t)(q0 + r) * HD + 4 * c : 0;
        cp_async16(Qb + r * RS + 4 * c, qb + g, in);
        cp_async16(Db + r * RS + 4 * c, db + g, in);
      }
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        const size_t g = in ? (size_t)h * Sq + q0 + tid : 0;
        cp_async4(smem + C::L_OFF + (n & 1) * BQ + tid, lse + g, in);
        cp_async4(smem + C::E_OFF + (n & 1) * BQ + tid, delta + g, in);
      }
    };
    if (ntiles > 0) load_tile(0);
    cp_async_commit();

    float acc[ROUNDS][8][4];
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.f;

    // the last tile's dq counter, bumped by thread 0 after a barrier
    int* pending = nullptr;
    for (int n = 0; n < ntiles; ++n) {
      cp_async_wait_all();
      __syncthreads();        // tile n landed; tile n - 1 fully consumed
      if (n + 1 < ntiles) load_tile(n + 1);
      cp_async_commit();

      const int g = n / ni, i = ihi - 1 - n % ni;
      const int h = b * groups + g, q0 = i * BQ;
      const float* Qb = smem + C::Q_OFF + (n & 1) * C::QTILE;
      const float* Db = smem + C::D_OFF + (n & 1) * C::QTILE;
      const float* Ls = smem + C::L_OFF + (n & 1) * BQ;
      const float* Es = smem + C::E_OFF + (n & 1) * BQ;
      // this CTA's turn at dq tile (h, i): after the kv tiles below j
      const int turn = j - tl.j_lo(i);
      const bool first = turn == 0, last = j == tl.j_hi(i);
      int* ctr = cnt + (size_t)h * nq + i;

      // phase A: S^T and dP^T, keys ty + 16 a against queries tx + 16 c;
      // then P and dS = P (dP - delta) in registers, written by query row
      // (P, dS) and by key row (dS^T)
      {
        float s[AK][AQ], dp[AK][AQ];
#pragma unroll
        for (int a = 0; a < AK; ++a)
#pragma unroll
          for (int c = 0; c < AQ; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
        for (int d = 0; d < HD; d += 4) {
          float4 kv[AK], vv[AK], qv[AQ], ov[AQ];
#pragma unroll
          for (int a = 0; a < AK; ++a) {
            kv[a] = ld4(Ks + (ty + 16 * a) * RS + d);
            vv[a] = ld4(Vs + (ty + 16 * a) * RS + d);
          }
#pragma unroll
          for (int c = 0; c < AQ; ++c) {
            qv[c] = ld4(Qb + (tx + 16 * c) * RS + d);
            ov[c] = ld4(Db + (tx + 16 * c) * RS + d);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int a = 0; a < AK; ++a)
#pragma unroll
              for (int c = 0; c < AQ; ++c) {
                s[a][c] = fmaf(comp(kv[a], e), comp(qv[c], e), s[a][c]);
                dp[a][c] = fmaf(comp(vv[a], e), comp(ov[c], e), dp[a][c]);
              }
        }
#pragma unroll
        for (int a = 0; a < AK; ++a) {
          const int kk = ty + 16 * a;
#pragma unroll
          for (int c = 0; c < AQ; ++c) {
            const int qq = tx + 16 * c;
            const bool ok =
                visible(q0 + qq, k0 + kk, Sq, Skv, tl.causal, tl.window);
            const float pv =
                ok ? exp2f(fmaf(s[a][c], scale * kLog2e, -Ls[qq] * kLog2e))
                   : 0.f;
            const float ds = pv * (dp[a][c] - Es[qq]);
            Ps[qq * PS + kk] = pv;
            Ss[qq * PS + kk] = ds;
            St[kk * TS + qq] = ds;
          }
        }
      }
      __syncthreads();        // P, dS, dS^T written; last tile's dq stored
      // the last tile's dq turn passes on: the barrier ordered every
      // thread's stores before thread 0's fence (cumulative), and the
      // bump waits on no turn of this tile
      if (kDqAdds && tid == 0 && pending) {
        __threadfence();
        atomicAdd(pending, 1);
      }
      pending = ctr;

      // phase B: dv += P^T dout, dk += dS^T q, dq part dS k
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int p = prod[u], r0 = r0s[u], c0 = c0s[u];
        if (p == 3) continue;                 // past the last tile
        float* xs = Xs + r0 * HD + c0;        // this thread's staged entries
        bool ready = true, staged = false;
        if (p == 2) {
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[u][r][c] = 0.f;
          // the turn is ours once the counter reaches it; then the old dq
          // of this thread's entries is copied while the product runs
          ready = first || !kDqAdds || ld_relaxed(ctr) == turn;
          staged = kDqAdds && C::STAGE && !first && ready;
          if (staged) {
            const float* src = dq + ((size_t)h * Sq + q0 + r0) * HD;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const bool in = q0 + r0 + r < Sq;
              cp_async16(xs + r * HD, in ? src + r * HD + c0 : dq, in);
            }
            cp_async_commit();
          }
        }
        const float* A = p == 0 ? Ps + r0 : p == 1 ? Ss + r0 : St + r0;
        const int as = p == 2 ? TS : PS;
        const float* B = (p == 0 ? Db : p == 1 ? Qb : Ks) + c0;
        if (BQ == BKV || p < 2)
          mac<BQ>(acc[u], A, as, B, RS);
        else
          mac<BKV>(acc[u], A, as, B, RS);
        if (p != 2 || !kDqAdds) continue;
        // dq rows q0 + r0 .. + 7: the first turn stores, the others add in
        // turn order, the last scales
        for (int spins = 0; !ready; ++spins) {
          // a wait this long means a broken order: fail, not hang
          if (spins > (1 << 24)) __trap();
          __nanosleep(64);
          ready = ld_relaxed(ctr) == turn;
        }
        if (staged) cp_async_wait_all();
        float* dqb = dq + ((size_t)h * Sq + q0 + r0) * HD + c0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (q0 + r0 + r >= Sq) continue;
          float4* ptr = reinterpret_cast<float4*>(dqb + r * HD);
          float4 o = make_float4(acc[u][r][0], acc[u][r][1], acc[u][r][2],
                                 acc[u][r][3]);
          if (!first) {
            const float4 old = staged ? ld4(xs + r * HD) : __ldcg(ptr);
            o = make_float4(old.x + o.x, old.y + o.y, old.z + o.z,
                            old.w + o.w);
          }
          if (last)
            o = make_float4(o.x * scale, o.y * scale, o.z * scale,
                            o.w * scale);
          __stcg(ptr, o);
        }
      }
    }
    cp_async_wait_all();      // K, V of an item with no query tile
    __syncthreads();          // every dq add stored; smem free
    if (kDqAdds && tid == 0 && pending) {
      __threadfence();
      atomicAdd(pending, 1);
    }
    if (tid == 0) *item_s = atomicAdd(work, 1);

    // dk, dv of keys k0 + r0 .. + 7 (dk scaled at the store)
    float* dkb = dk + (size_t)b * Skv * HD;
    float* dvb = dv + (size_t)b * Skv * HD;
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int p = prod[u], r0 = r0s[u];
      if (p > 1) continue;
      const float f = p == 0 ? 1.f : scale;
      float* base = p == 0 ? dvb : dkb;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int kp = k0 + r0 + r;
        if (kp >= Skv) continue;
        *reinterpret_cast<float4*>(base + (size_t)kp * HD + c0s[u]) =
            make_float4(acc[u][r][0] * f, acc[u][r][1] * f,
                        acc[u][r][2] * f, acc[u][r][3] * f);
      }
    }
    __syncthreads();          // the next item's claim is visible
    item = *item_s;
  }
}

template <int HD, int BQ, int BKV>
struct Launcher {
  using C = Cfg<HD, BQ, BKV>;
  // opt in and read the occupancy once per instantiation (thread-safe
  // static init), so a launch inside CUDA graph capture makes no attribute
  // call
  static int ctas_per_sm() {
    static const int occ = [] {
      auto kern = bwd_main_kernel<HD, BQ, BKV>;
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

  static int run(const float* q, const float* k, const float* v,
                 const float* out, const float* dout, const float* lse,
                 float* scratch, float* dq, float* dk, float* dv, int BH,
                 int Sq, int Skv, int groups, int causal, int window,
                 float scale, cudaStream_t stream) {
    const int occ = ctas_per_sm(), nsm = sms();
    if (occ <= 0 || nsm <= 0) return (int)cudaErrorInvalidConfiguration;
    Tiles t{Sq, Skv, BQ, BKV, causal, window, (Sq + BQ - 1) / BQ,
            (Skv + BKV - 1) / BKV};
    const int rows = BH * Sq;
    float* delta = scratch;
    int* cnt = reinterpret_cast<int*>(scratch + (size_t)rows);
    const int ncnt = BH * t.nq + 1;               // turns, then the work
    const long long threads =
        (long long)rows * 32 > ncnt ? (long long)rows * 32 : ncnt;
    bwd_delta_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(out, dout, delta, cnt, ncnt,
                                              dq, t, rows, HD);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int kv_heads = BH / groups;
    const int items = kv_heads * t.nkv;
    const int grid = items < occ * nsm ? items : occ * nsm;
    bwd_main_kernel<HD, BQ, BKV><<<grid, kThreads, C::smem, stream>>>(
        q, k, v, dout, lse, delta, dq, dk, dv, cnt, cnt + BH * t.nq, t,
        kv_heads, groups, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int flash_attention_bwd(int hd, const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* scratch, void* dq, void* dk, void* dv, int BH,
                        int Sq, int Skv, int groups, int causal, int window,
                        float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fo = (const float*)out,
              *fd = (const float*)dout, *fl = (const float*)lse;
  float *fs = (float*)scratch, *gq = (float*)dq, *gk = (float*)dk,
        *gv = (float*)dv;
  switch (hd) {
    case 64:
      return Launcher<64, 64, 64>::run(fq, fk, fv, fo, fd, fl, fs, gq, gk,
                                       gv, BH, Sq, Skv, groups, causal,
                                       window, scale, s);
    case 80:
      return Launcher<80, 64, 64>::run(fq, fk, fv, fo, fd, fl, fs, gq, gk,
                                       gv, BH, Sq, Skv, groups, causal,
                                       window, scale, s);
    case 128:
      return Launcher<128, 32, 64>::run(fq, fk, fv, fo, fd, fl, fs, gq, gk,
                                        gv, BH, Sq, Skv, groups, causal,
                                        window, scale, s);
    case 256:
      return Launcher<256, 32, 32>::run(fq, fk, fv, fo, fd, fl, fs, gq, gk,
                                        gv, BH, Sq, Skv, groups, causal,
                                        window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

int flash_attention_bwd_ctas_per_sm(int hd) {
  switch (hd) {
    case 64: return Launcher<64, 64, 64>::ctas_per_sm();
    case 80: return Launcher<80, 64, 64>::ctas_per_sm();
    case 128: return Launcher<128, 32, 64>::ctas_per_sm();
    case 256: return Launcher<256, 32, 32>::ctas_per_sm();
  }
  return -1;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
