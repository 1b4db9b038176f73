// Hand-written Hopper (sm_90a) kernels of the l1,inf projection engine.
//
// They replace the three Pallas TPU kernels of
// src/repro/kernels/l1inf/kernel.py and compute what those compute, and
// add a fourth: the engine's whole Newton loop in one persistent launch
// (the JAX engine runs that loop as a jax.lax.while_loop on the device,
// src/repro/kernels/l1inf/ops.py). The buffer is row-major (n, m): a
// column's rows are m floats apart, so every kernel reads a row segment of
// neighbouring columns with neighbouring threads.
//
// colstats   (replaces kernel.py::colstats)
//   Per-column sum and max of |Y|. Bound: bytes (one read of n*m floats).
//   A CTA owns 32 columns and reads them as 16-byte vectors (8 lanes a row,
//   32 row lanes). Tall buffers split the rows over a cluster of S <= 8
//   CTAs (S from n: 1 up to n = 1024), so fig2's 10000 x 1024 runs 256
//   CTAs instead of 32; rank 0 adds the ranks' partials through
//   distributed shared memory in rank order. No atomics, one launch, and
//   the maxima are exact whatever the order.
//
// mu_solve   (replaces kernel.py::mu_solve)
//   Per-column water level mu_j at removed mass theta: 26 bisection steps
//   on [0, colmax], 8 Michelot polish steps from below, then the exact
//   (k, S_k) payloads, in f32 (the plain version's arithmetic; only the
//   order of each sum differs). That is 36 compare-and-sum passes, so the
//   design question is where a column lives between passes: here, in
//   REGISTERS. A team of TL lanes owns one column and holds VPL of its
//   values per lane (TL = 8 for n <= 128, else a whole warp), staged in
//   once through shared memory so the global reads are row segments of
//   32 or 8 columns. Each pass is a lane-local sum and a __shfl_xor_sync
//   butterfly: fixed order (reruns are bit-equal), every lane ends with the
//   total, and no __syncthreads. A column too tall for one warp's
//   registers (n > 1280) is cut into row slabs over a cluster of S <= 8
//   CTAs; each pass then adds one cluster barrier, after which lanes r < S
//   read rank r's partial from distributed shared memory and a butterfly
//   adds them (double-buffered on the pass parity, so one barrier a pass).
//   Beyond 8 * 1280 rows the tile is streamed from global memory on every
//   pass (mu_solve_stream_kernel). The active-block count is read from
//   device memory; CTAs whose columns lie at or past nact_blocks * block_m
//   write the inactive defaults and read nothing (J-proportional work).
//   Bound: one read of the active prefix, or the f32 rate of 36 passes.
//
// newton_loop (the engine's loop: kernels/l1inf/ops.py::_engine, pass 2
//   to the end). One cooperative launch per projection, at a grid the
//   occupancy API says is resident; the loop, its counters and the cap-exit
//   re-evaluation are those of kernel.py::newton_loop_plain, and the host
//   never syncs. Bound: operations, the passes of every evaluation over its
//   prefix. A cold mu_solve a step spends 36 passes a column, so the design
//   is about passes and what surrounds them:
//   * Each cluster owns the column groups cl, cl + ncl, ... for the whole
//     loop and keeps, per owned column, its level mu, its count above k and
//     its max in shared memory (the grid is sized with room for them; a
//     buffer too wide for that raises). Theta only rises, so each level
//     only falls: from pass 3 on a column starts under the tangent at its
//     previous level, mu_prev - (theta - theta_prev) / k_prev (a lower
//     bound, removed(mu) being convex), less kWarmMargin * colmax for the
//     f32 rounding, and Michelot climbs to the fixed point in 2-5 passes
//     instead of 36. A column whose first step lowers its level, or that
//     has not settled after n_polish steps, takes mu_solve's cold passes
//     (26 bisections, the polish stopping at its first step that does not
//     raise the level, which leaves the result as it was).
//   * The teams of a warp (and the warps of a cluster) make their passes
//     together until the last of their columns settles, so every shuffle
//     and cluster barrier is taken by all.
//   * The groups whose tiles fit in the shared memory the grid leaves over
//     are staged once, at pass 2, and read from there after; the others
//     are staged again each evaluation, by 16-byte loads where m and A
//     allow.
//   * Each cluster adds its columns' S/k and 1/k per segment by a 32-lane
//     tree per group, and posts them with its last alive column (theta
//     only rises, so the groups past it are not visited again): one
//     grid.sync() a step, after which EVERY CTA adds the posted partials
//     in cluster order and applies Eq. (19) and theta = max(new, theta)
//     itself, and takes the max of the posted last columns for the prefix
//     count: all CTAs hold the same theta, so no second sync broadcasts it.
//
// clip_apply (replaces kernel.py::clip_apply)
//   X = sign(Y) * min(|Y|, mu_j) in Y's dtype (f32 or bf16), with mu
//   rounded to Y's dtype first. Bound: bytes (one read and one write of
//   Y). Columns on x (coalesced), rows strided over grid.y, mu_j kept in a
//   register per thread. In bf16 the f32 arithmetic is exact (the result
//   is +-|y|, +-mu or 0), so it is bit-equal to bf16 arithmetic.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// every entry point returns cudaGetLastError() (or the launch's own error)
// right after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // colstats, mu_solve, newton_loop
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;             // portable cluster size
constexpr int kSlabRows = 1280;            // rows one warp holds (40 a lane)
constexpr int kRegRows = kMaxCluster * kSlabRows;  // register-resident limit
constexpr float kPadTheta = 1e30f;         // core/l1inf.py::_PAD_THETA

// -------------------------------------------------------------------------
// reductions
// -------------------------------------------------------------------------

// Butterfly over aligned groups of L lanes: every lane of a group gets the
// bitwise same total (a + b == b + a), in a fixed tree order.
template <int L>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

template <int L>
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// -------------------------------------------------------------------------
// colstats
// -------------------------------------------------------------------------

constexpr int kStatCols = 32;              // 8 float4 lanes
constexpr int kStatRowLanes = kThreads / 8;

__device__ __forceinline__ float4 load4(const float* __restrict__ A, int r,
                                        int col, int m, int vec4) {
  const float* p = A + (size_t)r * m + col;
  if (vec4) {
    return col < m ? __ldg(reinterpret_cast<const float4*>(p))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(col < m ? __ldg(p) : 0.f, col + 1 < m ? __ldg(p + 1) : 0.f,
                     col + 2 < m ? __ldg(p + 2) : 0.f,
                     col + 3 < m ? __ldg(p + 3) : 0.f);
}

__global__ void __launch_bounds__(kThreads)
colstats_kernel(const float* __restrict__ A, float* __restrict__ colsum,
                float* __restrict__ colmax, int n, int m, int S, int slab,
                int vec4) {
  __shared__ float red_s[kStatRowLanes][kStatCols + 1];
  __shared__ float red_m[kStatRowLanes][kStatCols + 1];
  __shared__ float2 post[kStatCols];
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (blockIdx.x / S) * kStatCols;
  const int q = threadIdx.x & 7, rl = threadIdx.x >> 3;
  const int col = c0 + 4 * q;
  const int r0 = rank * slab, r1 = min(n, r0 + slab);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, mx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int r = r0 + rl; r < r1; r += kStatRowLanes) {
    const float4 x = load4(A, r, col, m, vec4);
    const float a[4] = {fabsf(x.x), fabsf(x.y), fabsf(x.z), fabsf(x.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += a[j];
      mx[j] = fmaxf(mx[j], a[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[rl][4 * q + j] = s[j];
    red_m[rl][4 * q + j] = mx[j];
  }
  __syncthreads();
  float ts = 0.f, tm = 0.f;
  const int t = threadIdx.x;
  if (t < kStatCols) {
    for (int g = 0; g < kStatRowLanes; ++g) {   // row lanes in order
      ts += red_s[g][t];
      tm = fmaxf(tm, red_m[g][t]);
    }
  }
  if (S == 1) {
    if (t < kStatCols && c0 + t < m) {
      colsum[c0 + t] = ts;
      colmax[c0 + t] = tm;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (t < kStatCols) post[t] = make_float2(ts, tm);
  cluster.sync();
  if (rank == 0 && t < kStatCols && c0 + t < m) {
    float2 tot = *cluster.map_shared_rank(&post[t], 0);
    for (int r = 1; r < S; ++r) {                 // ranks in order
      const float2 p = *cluster.map_shared_rank(&post[t], r);
      tot.x += p.x;
      tot.y = fmaxf(tot.y, p.y);
    }
    colsum[c0 + t] = tot.x;
    colmax[c0 + t] = tot.y;
  }
  cluster.sync();            // no CTA leaves while rank 0 reads its post
}

// -------------------------------------------------------------------------
// mu_solve: the register-resident body
// -------------------------------------------------------------------------

// A CTA of 8 warps owns kCols neighbouring columns; a team of TL lanes owns
// one column and holds rows rl, rl + TL, ... (VPL of them) of the CTA's
// row slab.
template <int VPL, int TL>
struct Tile {
  static constexpr int kCPW = 32 / TL;           // columns per warp
  static constexpr int kCols = kWarps * kCPW;    // columns per CTA
  static constexpr int kRows = VPL * TL;         // slab rows per CTA
  // row stride in the staging tile: conflict-free team reads
  static constexpr int kStride = kCols + (TL == 32 ? 1 : 4);
  static constexpr int kTileFloats = kRows * kStride;
  static_assert(kRows * kCols == VPL * kThreads, "one value a thread a step");
};

// Stage rows [r0, r1) of columns [c0, c0 + kCols) of |A| in shared memory
// (row segments of kCols floats per load instruction group); rows and
// columns outside the buffer read 0, which no pass counts (every threshold
// is >= 0). With vec4 (m a multiple of 4, A 16-byte aligned) each thread
// loads 16 bytes at a time: a quarter of the load instructions, four
// times the bytes in flight (what the Newton loop's reloads at paper
// Fig. 2's shapes wait on, PERF.md). The caller has made sure no thread
// still reads the tile.
template <int VPL, int TL>
__device__ __forceinline__ void stage_slab(const float* __restrict__ A, int m,
                                           int c0, int r0, int r1,
                                           float* tile, bool vec4 = false) {
  using T = Tile<VPL, TL>;
  if (vec4) {
    constexpr int Q = T::kCols / 4;               // 16-byte loads a row
#pragma unroll
    for (int it = 0; it < VPL / 4; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / Q, c = idx % Q * 4;
      const int row = r0 + r, col = c0 + c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < r1 && col < m) {
        x = __ldg(reinterpret_cast<const float4*>(A + (size_t)row * m + col));
      }
      float* t = tile + r * T::kStride + c;
      t[0] = fabsf(x.x);
      t[1] = fabsf(x.y);
      t[2] = fabsf(x.z);
      t[3] = fabsf(x.w);
    }
  } else {
#pragma unroll
    for (int it = 0; it < VPL; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / T::kCols, c = idx % T::kCols;
      const int row = r0 + r, col = c0 + c;
      float x = 0.f;
      if (row < r1 && col < m) x = fabsf(A[(size_t)row * m + col]);
      tile[r * T::kStride + c] = x;
    }
  }
  __syncthreads();
}

// Hand each lane its VPL values of a staged tile.
template <int VPL, int TL>
__device__ __forceinline__ void fetch_slab(const float* tile, float (&v)[VPL]) {
  using T = Tile<VPL, TL>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane / TL, rl = lane % TL;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[i] = tile[(rl + TL * i) * T::kStride + w * T::kCPW + sub];
  }
}

template <int VPL, int TL>
__device__ __forceinline__ void load_slab(const float* __restrict__ A, int m,
                                          int c0, int r0, int r1,
                                          float* tile, float (&v)[VPL]) {
  __syncthreads();              // the previous group is done with the tile
  stage_slab<VPL, TL>(A, m, c0, r0, r1, tile);
  fetch_slab<VPL, TL>(tile, v);
}

// Cluster mode (TL = 32, one column a warp): add this pass's two partials
// over the S ranks. Lane 0 posts the CTA's partials, one cluster barrier,
// lanes r < S read rank r's from distributed shared memory, an 8-lane
// butterfly combines them in a fixed order and lane 0's result goes to the
// whole warp. The post buffer alternates with the pass parity: a rank can
// only overwrite a parity after the next barrier, which every rank reaches
// after its reads of that parity. (Pushing the partials into every rank's
// slots behind per-warp mbarriers, with no cluster-wide barrier, measured
// slower on the H100: PERF.md.)
__device__ __forceinline__ void cluster_combine(float& a, float& b, bool b_max,
                                                int S, float2* post,
                                                unsigned& pass) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float2* slot = post + (pass & 1u) * kWarps + w;
  if (lane == 0) *slot = make_float2(a, b);
  cluster.sync();
  float2 p = make_float2(0.f, 0.f);
  if (lane < S) p = *cluster.map_shared_rank(slot, lane);
  const float ta = lanes_sum<8>(p.x);
  const float tb = b_max ? lanes_max<8>(p.y) : lanes_sum<8>(p.y);
  a = __shfl_sync(kFull, ta, 0);
  b = __shfl_sync(kFull, tb, 0);
  ++pass;
}

// Four independent chains per lane, joined in a fixed order.
template <int VPL>
__device__ __forceinline__ float removed_at(const float (&v)[VPL], float mid) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i & 3] += fmaxf(v[i] - mid, 0.f);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int VPL>
__device__ __forceinline__ void above(const float (&v)[VPL], float mu,
                                      float& cnt, float& sum) {
  float c[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const bool gt = v[i] > mu;
    c[i & 3] += gt ? 1.f : 0.f;
    s[i & 3] += gt ? v[i] : 0.f;
  }
  cnt = (c[0] + c[1]) + (c[2] + c[3]);
  sum = (s[0] + s[1]) + (s[2] + s[3]);
}

// Count and sum of a column's values above mu: team totals (cluster
// totals when S > 1), the same on every lane.
template <int VPL, int TL>
__device__ __forceinline__ void above_total(const float (&v)[VPL], float mu,
                                            int S, float2* post,
                                            unsigned& pass, float& cnt,
                                            float& sum) {
  above(v, mu, cnt, sum);
  cnt = lanes_sum<TL>(cnt);
  sum = lanes_sum<TL>(sum);
  if (S > 1) cluster_combine(cnt, sum, false, S, post, pass);
}

struct Solved {
  float mu, k, s;
  bool active;
};

// The 36 passes of one column at removed mass th (kernel.py's
// mu_solve_plain, pass for pass). Every lane of the team returns the same.
template <int VPL, int TL>
__device__ __forceinline__ Solved solve(const float (&v)[VPL], float th,
                                        int n_bisect, int n_polish, int S,
                                        float2* post, unsigned& pass) {
  float colsum, colmax;
  {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      s[i & 3] += v[i];
      mx = fmaxf(mx, v[i]);
    }
    colsum = lanes_sum<TL>((s[0] + s[1]) + (s[2] + s[3]));
    colmax = lanes_max<TL>(mx);
  }
  if (S > 1) cluster_combine(colsum, colmax, true, S, post, pass);
  const bool active = colsum > th;

  // bisection: removed(mu) = sum (y - mu)_+ is decreasing in mu
  float lo = 0.f, hi = colmax;
  for (int it = 0; it < n_bisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float removed = lanes_sum<TL>(removed_at(v, mid));
    if (S > 1) {
      float unused = 0.f;
      cluster_combine(removed, unused, false, S, post, pass);
    }
    const bool ge = removed >= th;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }

  // Michelot polish from below (monotone, finitely convergent)
  float mu = lo;
  for (int it = 0; it < n_polish; ++it) {
    float cnt, ssum;
    above_total<VPL, TL>(v, mu, S, post, pass, cnt, ssum);
    const float k = fmaxf(cnt, 1.f);
    mu = fmaxf((ssum - th) / k, mu);
  }
  mu = fmaxf(mu, 0.f);

  // exact payloads at the solved level
  float cnt, ssum;
  above_total<VPL, TL>(v, mu, S, post, pass, cnt, ssum);
  return Solved{mu, fmaxf(cnt, 1.f), ssum, active};
}

template <int VPL, int TL>
__host__ __device__ constexpr size_t body_smem_bytes() {
  return Tile<VPL, TL>::kTileFloats * sizeof(float) +
         2 * kWarps * sizeof(float2);
}

// Occupancy floors. mu_solve: 4 CTAs an SM (64 registers) up to 32 values
// a lane, 3 (85) for the cluster slabs' 40. The loop kernel carries more
// state: 2 CTAs an SM (128 registers) up to 32 values a lane, and 3 for the
// slabs' 40, which spills a little but triples its resident clusters.
template <int VPL>
constexpr int min_ctas() { return VPL <= 32 ? 4 : 3; }
template <int VPL>
constexpr int min_loop_ctas() { return VPL <= 32 ? 2 : 3; }

template <int VPL, int TL>
__global__ void __launch_bounds__(kThreads, min_ctas<VPL>())
mu_solve_kernel(const float* __restrict__ A, const float* __restrict__ theta,
                int theta_stride, const int* __restrict__ nact_blocks,
                int block_m, float* __restrict__ mu_out,
                float* __restrict__ k_out, float* __restrict__ s_out,
                bool* __restrict__ act_out, int n, int m, int n_bisect,
                int n_polish, int S, int slab) {
  using T = Tile<VPL, TL>;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float2* post = reinterpret_cast<float2*>(tile + T::kTileFloats);
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (blockIdx.x / S) * T::kCols;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane / TL, rl = lane % TL;
  const int col = c0 + w * T::kCPW + sub;
  const long long limit = (long long)nact_blocks[0] * block_m;
  const bool writer = rank == 0 && rl == 0 && col < m;

  if (c0 >= limit) {   // every column of the group lies past the prefix
    if (writer) {
      mu_out[col] = 0.f;
      k_out[col] = 1.f;
      s_out[col] = 0.f;
      act_out[col] = false;
    }
    return;            // the whole cluster shares c0, so leaves together
  }
  const float th = theta[(size_t)min(col, m - 1) * theta_stride];
  float v[VPL];
  const int r0 = rank * slab;
  load_slab<VPL, TL>(A, m, c0, r0, min(n, r0 + slab), tile, v);
  unsigned pass = 0;
  const Solved r = solve<VPL, TL>(v, th, n_bisect, n_polish, S, post, pass);
  if (writer) {
    const bool live = r.active && col < limit;
    mu_out[col] = live ? r.mu : 0.f;
    k_out[col] = live ? r.k : 1.f;
    s_out[col] = live ? r.s : 0.f;
    act_out[col] = live;
  }
  if (S > 1) cg::this_cluster().sync();   // keep post alive for the ranks
}

// -------------------------------------------------------------------------
// mu_solve beyond kRegRows rows: the tile streams from global memory on
// every pass (one CTA of 32 columns x 32 row groups).
// -------------------------------------------------------------------------

constexpr int kStreamCols = 32;
constexpr int kStreamGroups = 32;

// Sum two per-thread partials over the row groups of each column, in a
// fixed order; every thread of the column gets the same totals.
__device__ __forceinline__ void col_reduce2(float (*red)[kStreamGroups][kStreamCols],
                                           float& a, float& b, bool b_max) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  float ta = red[0][0][tx], tb = red[1][0][tx];
  for (int g = 1; g < kStreamGroups; ++g) {
    ta += red[0][g][tx];
    tb = b_max ? fmaxf(tb, red[1][g][tx]) : tb + red[1][g][tx];
  }
  __syncthreads();
  a = ta;
  b = tb;
}

__global__ void __launch_bounds__(kStreamCols * kStreamGroups)
mu_solve_stream_kernel(const float* __restrict__ A,
                       const float* __restrict__ theta, int theta_stride,
                       const int* __restrict__ nact_blocks, int block_m,
                       float* __restrict__ mu_out, float* __restrict__ k_out,
                       float* __restrict__ s_out, bool* __restrict__ act_out,
                       int n, int m, int n_bisect, int n_polish) {
  __shared__ float red[2][kStreamGroups][kStreamCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col0 = blockIdx.x * kStreamCols;
  const int col = col0 + tx;
  const long long limit = (long long)nact_blocks[0] * block_m;
  if (col0 >= limit) {
    if (ty == 0 && col < m) {
      mu_out[col] = 0.f;
      k_out[col] = 1.f;
      s_out[col] = 0.f;
      act_out[col] = false;
    }
    return;
  }
  const int c = min(col, m - 1);
  const float th = theta[(size_t)c * theta_stride];
  const float* src = A + c;
  float colsum = 0.f, colmax = 0.f;
  for (int r = ty; r < n; r += kStreamGroups) {
    const float v = fabsf(src[(size_t)r * m]);
    colsum += v;
    colmax = fmaxf(colmax, v);
  }
  col_reduce2(red, colsum, colmax, true);
  const bool active = colsum > th;
  float lo = 0.f, hi = colmax;
  for (int it = 0; it < n_bisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float removed = 0.f, unused = 0.f;
    for (int r = ty; r < n; r += kStreamGroups) {
      removed += fmaxf(fabsf(src[(size_t)r * m]) - mid, 0.f);
    }
    col_reduce2(red, removed, unused, false);
    const bool ge = removed >= th;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  float mu = lo, cnt = 0.f, ssum = 0.f;
  for (int it = 0; it <= n_polish; ++it) {   // n_polish steps, then payloads
    if (it == n_polish) mu = fmaxf(mu, 0.f);
    cnt = 0.f;
    ssum = 0.f;
    for (int r = ty; r < n; r += kStreamGroups) {
      const float v = fabsf(src[(size_t)r * m]);
      const bool gt = v > mu;
      cnt += gt ? 1.f : 0.f;
      ssum += gt ? v : 0.f;
    }
    col_reduce2(red, cnt, ssum, false);
    if (it < n_polish) mu = fmaxf((ssum - th) / fmaxf(cnt, 1.f), mu);
  }
  if (ty == 0 && col < m) {
    const bool live = active && col < limit;
    mu_out[col] = live ? mu : 0.f;
    k_out[col] = live ? fmaxf(cnt, 1.f) : 1.f;
    s_out[col] = live ? ssum : 0.f;
    act_out[col] = live;
  }
}

// -------------------------------------------------------------------------
// newton_loop: the engine's Newton loop in one cooperative launch
// -------------------------------------------------------------------------

constexpr float kWarmMargin = 1.f / 65536.f;   // kernel.py::WARM_MARGIN

struct LoopArgs {
  const float* A;          // (n, m) compacted |Y|
  const int* sids;         // (m,) compacted segment ids (G = padding)
  const float* colsum;     // (m,) compacted column sums (colstats)
  const float* t1;         // (G,) theta after pass 1
  const float* csafe;      // (G,) radii, 1 where <= 0
  const int* num_active;   // J: columns past it are dead for good
  float* mu;               // (m,) out: water levels, compacted order
  float* theta;            // (G,) out
  long long* stats;        // out: newton_iters, work_cols, active_cols
  float* partials;         // (2, clusters, 2G + 1) scratch
  int n, m, G, bm, n_bisect, n_polish, max_newton, shrink, S, slab;
  int own;                 // column groups a cluster owns, at most
  int resident;            // of them, those whose tile stays in shared memory
  int vec4;                // m % 4 == 0 and A 16-byte aligned
};

// Tiles: `resident` that stay, one more to stage the other groups in.
__host__ __device__ constexpr int loop_tiles(int own, int resident) {
  return resident + (own > resident ? 1 : 0);
}

template <int VPL, int TL>
__host__ __device__ constexpr size_t loop_smem_bytes(int G, int own,
                                                     int resident) {
  using T = Tile<VPL, TL>;
  return (size_t)loop_tiles(own, resident) * T::kTileFloats * sizeof(float) +
         2 * kWarps * sizeof(float2) + T::kCols * (sizeof(float2) + sizeof(int)) +
         3 * (size_t)own * T::kCols * sizeof(float) +
         5 * (size_t)G * sizeof(float) + 2 * sizeof(int);
}

// True on every lane of a solve when any of its columns asks for one more
// pass: a warp's teams make their passes together (S == 1), and so do the
// warps of a cluster's CTAs (S > 1: every rank holds the same totals, so
// each CTA reaches the same answer).
__device__ __forceinline__ bool any_team(bool x, int S) {
  return S > 1 ? __syncthreads_or(x) != 0 : __any_sync(kFull, x);
}

// Warp 0, after a group's solve: add its columns' (S/k, 1/k) into acc by
// segment, one segment at a time in the order of its first column, each by
// a 32-lane tree (a fixed order, so reruns are bit-equal). Returns the
// group's last alive column, -1 if none.
template <int NC>
__device__ __forceinline__ int group_sums(const float2* colres,
                                          const int* colseg, int c0,
                                          float* acc, int G, int lane) {
  const float2 r = lane < NC ? colres[lane] : make_float2(0.f, 0.f);
  const int sg = lane < NC ? colseg[lane] : -1;
  unsigned todo = __ballot_sync(kFull, sg >= 0);
  const int last = __reduce_max_sync(kFull, sg >= 0 ? c0 + lane : -1);
  while (todo) {
    const int seg = __shfl_sync(kFull, sg, __ffs((int)todo) - 1);
    const bool mine = sg == seg;
    const float x = lanes_sum<32>(mine ? r.x : 0.f);
    const float y = lanes_sum<32>(mine ? r.y : 0.f);
    if (lane == 0) {
      acc[seg] += x;
      acc[G + seg] += y;
    }
    todo &= ~__ballot_sync(kFull, mine);
  }
  return last;
}

template <int VPL, int TL>
__global__ void __launch_bounds__(kThreads, min_loop_ctas<VPL>())
newton_loop_kernel(const LoopArgs a) {
  using T = Tile<VPL, TL>;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);
  float2* post = reinterpret_cast<float2*>(
      tiles + (size_t)loop_tiles(a.own, a.resident) * T::kTileFloats);
  float2* colres = post + 2 * kWarps;             // this group's S/k, 1/k
  int* colseg = reinterpret_cast<int*>(colres + T::kCols);
  float* st_mu = reinterpret_cast<float*>(colseg + T::kCols);  // own groups'
  float* st_k = st_mu + a.own * T::kCols;         // levels, counts above
  float* st_max = st_k + a.own * T::kCols;        // and column maxima
  float* th = st_max + a.own * T::kCols;
  float* prev = th + a.G;
  float* cs = prev + a.G;
  float* acc = cs + a.G;                          // (2G) this CTA's sums
  int* posted = reinterpret_cast<int*>(acc + 2 * a.G);  // visit, last alive

  cg::grid_group grid = cg::this_grid();
  const int S = a.S;
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int cl = blockIdx.x / S, ncl = gridDim.x / S;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rl = lane % TL;
  const int j = w * T::kCPW + lane / TL;          // the team's column in a group
  const int ngroups = (a.m + T::kCols - 1) / T::kCols;
  const int nblocks = a.m / a.bm;
  const int r0 = rank * a.slab, r1 = min(a.n, r0 + a.slab);
  const int own = cl < ngroups ? (ngroups - 1 - cl) / ncl + 1 : 0;
  // this cluster's groups are cl + i * ncl; those with i < visit may hold
  // a column alive at theta (J bounds them at first)
  const int gJ = ((a.shrink ? *a.num_active : a.m) + T::kCols - 1) / T::kCols;
  int visit = gJ > cl ? (gJ - 1 - cl) / ncl + 1 : 0;
  for (int t = threadIdx.x; t < a.G; t += kThreads) {
    th[t] = a.t1[t];
    prev[t] = a.t1[t];
    cs[t] = a.csafe[t];
  }
  for (int c = visit * T::kCols + threadIdx.x; c < own * T::kCols;
       c += kThreads) {                            // never solved: level 0
    const int col = (cl + c / T::kCols * ncl) * T::kCols + c % T::kCols;
    if (rank == 0 && col < a.m) a.mu[col] = 0.f;
  }
  __syncthreads();
  unsigned pass = 0;

  // One Newton evaluation at th over the visited groups, pass 2 cold and
  // every later one warm; this cluster's per-segment sums of S/k and 1/k
  // and its last alive column go to partials[buf], and the count of
  // groups the next evaluation visits to posted[0].
  auto eval = [&](bool warm, int buf) {
    for (int t = threadIdx.x; t < 2 * a.G; t += kThreads) acc[t] = 0.f;
    int last = -1;
    for (int i = 0; i < visit; ++i) {
      const int c0 = (cl + i * ncl) * T::kCols;
      const int col = c0 + j, slot = i * T::kCols + j;
      const int sid = col < a.m ? a.sids[col] : a.G;
      const float thc = sid < a.G ? th[sid] : kPadTheta;
      const bool alive = sid < a.G && a.colsum[col] > thc;
      float* tile = tiles + (size_t)min(i, a.resident) * T::kTileFloats;
      float mu = 0.f, k = 1.f, s = 0.f, cmax = 0.f;
      // (also: the previous group is done with colres and the stage tile)
      if (__syncthreads_or(alive)) {
        if (!warm || i >= a.resident) {
          stage_slab<VPL, TL>(a.A, a.m, c0, r0, r1, tile, a.vec4 != 0);
        }
        float v[VPL];
        fetch_slab<VPL, TL>(tile, v);
        bool ok = false;
        if (warm) {
          // Michelot from below the tangent at the previous level (kernel.py
          // warm_levels); a first step that lowers the level, or a cap of
          // n_polish steps, sends the column to the cold solve
          if (alive) {
            cmax = st_max[slot];
            mu = fmaxf(st_mu[slot] - (thc - prev[sid]) / st_k[slot] -
                           cmax * kWarmMargin, 0.f);
          }
          bool done = !alive;
          for (int it = 0; it < a.n_polish && any_team(!done, S); ++it) {
            float c, sm;
            above_total<VPL, TL>(v, mu, S, post, pass, c, sm);
            const float kc = fmaxf(c, 1.f);
            const float nm = (sm - thc) / kc;
            if (!done && nm <= mu) {
              done = true;
              ok = it > 0 || nm == mu;
              k = kc;
              s = sm;
            } else if (!done) {
              mu = nm;
            }
          }
        }
        const bool cold = alive && !ok;
        if (any_team(cold, S)) {
          // mu_solve's passes (kernel.py _cold_levels), the polish ending
          // at its first step that does not raise the level
          if (!warm) {
            float mx = 0.f;
#pragma unroll
            for (int q = 0; q < VPL; ++q) mx = fmaxf(mx, v[q]);
            mx = lanes_max<TL>(mx);
            if (S > 1) {
              float unused = 0.f;
              cluster_combine(unused, mx, true, S, post, pass);
            }
            cmax = mx;
          }
          float lo = 0.f, hi = cmax;
          for (int it = 0; it < a.n_bisect; ++it) {
            const float mid = 0.5f * (lo + hi);
            float removed = lanes_sum<TL>(removed_at(v, mid));
            if (S > 1) {
              float unused = 0.f;
              cluster_combine(removed, unused, false, S, post, pass);
            }
            const bool ge = removed >= thc;
            lo = ge ? mid : lo;
            hi = ge ? hi : mid;
          }
          float mc = lo, kc = 1.f, sc = 0.f;
          bool done = !cold;
          for (int it = 0; it <= a.n_polish && any_team(!done, S); ++it) {
            float c, sm;
            above_total<VPL, TL>(v, mc, S, post, pass, c, sm);
            const float kk = fmaxf(c, 1.f);
            const float nm = (sm - thc) / kk;
            if (!done && (it == a.n_polish || nm <= mc)) {
              done = true;
              kc = kk;
              sc = sm;
            } else if (!done) {
              mc = nm;
            }
          }
          if (cold) {
            mu = mc;
            k = kc;
            s = sc;
          }
        }
        if (alive && rl == 0) {
          st_mu[slot] = mu;
          st_k[slot] = k;
          st_max[slot] = cmax;
        }
      }
      if (rank == 0 && rl == 0 && col < a.m) a.mu[col] = alive ? mu : 0.f;
      if (rl == 0) {
        colres[j] = alive ? make_float2(s / k, 1.f / k) : make_float2(0.f, 0.f);
        colseg[j] = alive ? sid : -1;
      }
      __syncthreads();
      if (w == 0) {
        last = max(last, group_sums<T::kCols>(colres, colseg, c0, acc, a.G,
                                              lane));
      }
    }
    __syncthreads();
    if (rank == 0) {
      float* dst = a.partials + ((size_t)buf * ncl + cl) * (2 * a.G + 1);
      for (int t = threadIdx.x; t < 2 * a.G; t += kThreads) {
        __stcg(dst + t, acc[t]);
      }
      if (threadIdx.x == 0) __stcg(dst + 2 * a.G, __int_as_float(last));
    }
    // theta only rises: the groups past the last alive column stay dead
    if (threadIdx.x == 0) {
      posted[0] = last < 0 ? 0 : (last / T::kCols - cl) / ncl + 1;
    }
  };

  // After grid.sync: every CTA adds the clusters' partials in the same
  // fixed order (a lane-strided sum and a 32-lane tree a segment, each
  // partial read once) and takes the Eq.-(19) step and theta = max(new,
  // theta), so all CTAs hold the same theta with no broadcast; the last
  // warp takes the max of the posted last alive columns into posted[1].
  // Returns any(theta > prev); with `step` false it only reads the max.
  auto update = [&](int buf, bool step) -> bool {
    const size_t stride = 2 * (size_t)a.G + 1;
    const float* base = a.partials + (size_t)buf * ncl * stride;
    for (int t = w; step && t < a.G; t += kWarps) {
      float sa = 0.f, sb = 0.f;
      for (int c = lane; c < ncl; c += 32) {
        sa += __ldcg(base + c * stride + t);
        sb += __ldcg(base + c * stride + a.G + t);
      }
      sa = lanes_sum<32>(sa);
      sb = lanes_sum<32>(sb);
      if (lane == 0) {
        const float nw = (sa - cs[t]) / fmaxf(sb, 1e-30f);
        prev[t] = th[t];
        th[t] = fmaxf(nw, th[t]);
      }
    }
    if (w == kWarps - 1) {
      int last = -1;
      for (int c = lane; c < ncl; c += 32) {
        last = max(last, __float_as_int(__ldcg(base + c * stride + 2 * a.G)));
      }
      last = __reduce_max_sync(kFull, last);
      if (lane == 0) posted[1] = last;
    }
    __syncthreads();
    visit = posted[0];
    if (!step) return false;
    int moved = 0;
    for (int t = threadIdx.x; t < a.G; t += kThreads) {
      moved |= th[t] > prev[t];
    }
    return __syncthreads_or(moved) != 0;
  };
  // blocks up to the last alive column (kernel.py::newton_loop_plain's
  // nact_of) at the theta of the evaluation just added
  auto nact = [&]() -> int {
    return a.shrink ? (posted[1] + a.bm) / a.bm : nblocks;
  };

  // pass 2 at t1, then the monotone ascent with mu carried
  long long work = (long long)nblocks * a.bm;
  int buf = 0;
  eval(false, buf);
  grid.sync();
  bool moved = update(buf, true);
  work += (long long)nact() * a.bm;
  buf ^= 1;
  int iters = 2;
  while (iters < a.max_newton && moved) {
    eval(true, buf);
    grid.sync();
    moved = update(buf, true);
    work += (long long)nact() * a.bm;
    buf ^= 1;
    ++iters;
  }
  // max_newton cap exit: mu lags theta by one iterate; re-evaluate
  if (moved) {
    eval(true, buf);
    grid.sync();
    update(buf, false);
  }
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < a.G; t += kThreads) a.theta[t] = th[t];
    if (threadIdx.x == 0) {
      a.stats[0] = iters;
      a.stats[1] = work;
      a.stats[2] = (long long)nact() * a.bm;
    }
  }
  if (S > 1) cg::this_cluster().sync();   // keep post alive for the ranks
}

// -------------------------------------------------------------------------
// plans and launches
// -------------------------------------------------------------------------

struct Plan {
  int vpl, tl, S, slab;
};

// Team width, values per lane, cluster size and slab rows for n rows.
Plan plan_for(int n) {
  if (n <= 128) {
    const int vpl = n <= 32 ? 4 : n <= 64 ? 8 : n <= 96 ? 12 : 16;
    return Plan{vpl, 8, 1, n};
  }
  const int S = n <= kSlabRows ? 1 : (n + kSlabRows - 1) / kSlabRows;
  const int slab = (n + S - 1) / S;
  const int per_lane = (slab + 31) / 32;
  const int vpl = per_lane <= 8 ? 8 : per_lane <= 16 ? 16
                : per_lane <= 24 ? 24 : per_lane <= 32 ? 32 : 40;
  return Plan{vpl, 32, S, slab};
}

int cols_per_cta(const Plan& p) { return kWarps * (32 / p.tl); }

using MuFn = void (*)(const float*, const float*, int, const int*, int,
                      float*, float*, float*, bool*, int, int, int, int, int,
                      int);
using LoopFn = void (*)(const LoopArgs);

#define L1INF_PLANS(X)                                              \
  X(4, 8) X(8, 8) X(12, 8) X(16, 8) X(8, 32) X(16, 32) X(24, 32)    \
  X(32, 32) X(40, 32)

MuFn mu_fn(const Plan& p, size_t* smem) {
#define X(V, L)                                                    \
  if (p.vpl == V && p.tl == L) {                                   \
    *smem = body_smem_bytes<V, L>();                               \
    return mu_solve_kernel<V, L>;                                  \
  }
  L1INF_PLANS(X)
#undef X
  return nullptr;
}

LoopFn loop_fn(const Plan& p, int G, int own, int resident, size_t* smem) {
#define X(V, L)                                                    \
  if (p.vpl == V && p.tl == L) {                                   \
    *smem = loop_smem_bytes<V, L>(G, own, resident);               \
    return newton_loop_kernel<V, L>;                               \
  }
  L1INF_PLANS(X)
#undef X
  return nullptr;
}
#undef L1INF_PLANS

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Raise a kernel's dynamic shared memory limit once it passes 48 KB.
template <typename Fn>
cudaError_t allow_smem(Fn fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A cudaLaunchKernelEx result: its own error, else the launch's last
// error (read either way, so a refused launch leaves none behind).
int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

struct LaunchCfg {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];

  LaunchCfg(int grid, size_t smem, cudaStream_t stream, int S, bool coop) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    int na = 0;
    if (S > 1) {
      attrs[na].id = cudaLaunchAttributeClusterDimension;
      attrs[na].val.clusterDim.x = S;
      attrs[na].val.clusterDim.y = 1;
      attrs[na].val.clusterDim.z = 1;
      ++na;
    }
    if (coop) {
      attrs[na].id = cudaLaunchAttributeCooperative;
      attrs[na].val.cooperative = 1;
      ++na;
    }
    cfg.attrs = attrs;
    cfg.numAttrs = na;
  }
};

// Resident clusters (CTAs when S = 1) of a cooperative loop launch with
// smem bytes of dynamic shared memory. The kernel may take all the
// card's opt-in limit leaves beside its static shared memory (set every
// time to the same value, never lowered, so a plan made for one shape
// stays launchable after another's).
cudaError_t resident_clusters(LoopFn fn, size_t smem, int S, int* value) {
  static int limit = 0;
  if (limit == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  const int dynamic = limit - (int)attr.sharedSizeBytes;
  if (smem > (size_t)dynamic) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dynamic);
  if (e != cudaSuccess) return e;
  if (S > 1) {
    LaunchCfg lc(S, smem, nullptr, S, false);
    return cudaOccupancyMaxActiveClusters(value, fn, &lc.cfg);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(value, fn, kThreads,
                                                    smem);
  *value *= sm_count();
  return e;
}

struct LoopPlan {
  int n, m, G;             // the shape it was made for
  LoopFn fn;
  size_t smem;
  int S, slab, ncl, own, resident;
};

// The loop kernel's launch for an (n, m) buffer of G segments, remembered
// per shape: the first call is eager, so a later one inside a CUDA-graph
// capture makes no occupancy query. The grid is the resident cluster count
// the occupancy API gives (at most one a column group) with room for the
// state of the groups a cluster owns; the shared memory that grid leaves
// over keeps as many of those groups' tiles resident as fit.
cudaError_t loop_plan(int n, int m, int G, LoopPlan* out) {
  static LoopPlan cache[32];
  static int used = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].n == n && cache[i].m == m && cache[i].G == G) {
      *out = cache[i];
      return cudaSuccess;
    }
  }
  const Plan p = plan_for(n);
  const int groups = (m + cols_per_cta(p) - 1) / cols_per_cta(p);
  LoopPlan lp{n, m, G, nullptr, 0, p.S, p.slab, 0, 1, 1};
  for (;;) {              // own only grows and the grid only shrinks
    lp.resident = lp.own == 1 ? 1 : 0;          // one tile
    lp.fn = loop_fn(p, G, lp.own, lp.resident, &lp.smem);
    int value = 0;
    const cudaError_t e = resident_clusters(lp.fn, lp.smem, p.S, &value);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    lp.ncl = std::min(groups, value);
    if (lp.ncl < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int need = (groups + lp.ncl - 1) / lp.ncl;
    if (need <= lp.own) break;
    lp.own = need;
  }
  for (int r = lp.resident + 1; r <= lp.own; ++r) {
    size_t smem = 0;
    const LoopFn fn = loop_fn(p, G, lp.own, r, &smem);
    int value = 0;
    if (resident_clusters(fn, smem, p.S, &value) != cudaSuccess ||
        std::min(groups, value) < lp.ncl) {
      cudaGetLastError();                        // a refused probe
      break;
    }
    lp.resident = r;
    lp.smem = smem;
  }
  if (used < 32) cache[used++] = lp;
  *out = lp;
  return cudaSuccess;
}

__device__ __forceinline__ float clip1(float y, float mu) {
  if (y != y) return y;                                  // NaN stays NaN
  const float s = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f);  // torch.sign
  return s * fminf(fabsf(y), mu);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kClipThreads = 256;

template <typename T>
__global__ void clip_apply_kernel(const T* __restrict__ Y,
                                  const float* __restrict__ mu,
                                  T* __restrict__ X, int n, int m) {
  const int col = blockIdx.x * kClipThreads + threadIdx.x;
  if (col >= m) return;
  const float mj = round_to(mu[col], Y);      // mu in Y's dtype first
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    const size_t i = (size_t)r * m + col;
    store(X + i, clip1(load(Y + i), mj));
  }
}

template <typename T>
int launch_clip(const T* Y, const float* mu, T* X, int n, int m,
                cudaStream_t stream) {
  const int gx = (m + kClipThreads - 1) / kClipThreads;
  int gy = 2048 / gx;                  // ~16 blocks per SM in all
  gy = gy < 1 ? 1 : (gy > n ? n : gy);
  gy = gy > 65535 ? 65535 : gy;
  clip_apply_kernel<T><<<dim3(gx, gy), kClipThreads, 0, stream>>>(Y, mu, X,
                                                                   n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int l1inf_colstats(const float* A, float* colsum, float* colmax, int n, int m,
                   int vec4, cudaStream_t stream) {
  const int S = n <= 1024 ? 1 : std::min(kMaxCluster, (n + 1023) / 1024);
  const int slab = (n + S - 1) / S;
  const int groups = (m + kStatCols - 1) / kStatCols;
  LaunchCfg lc(groups * S, 0, stream, S, false);
  const cudaError_t e = cudaLaunchKernelEx(&lc.cfg, colstats_kernel, A, colsum,
                                           colmax, n, m, S, slab, vec4);
  return launched(e);
}

int l1inf_mu_solve(const float* A, const float* theta, int theta_stride,
                   const int* nact_blocks, int block_m, float* mu, float* k,
                   float* s, bool* act, int n, int m, int n_bisect,
                   int n_polish, cudaStream_t stream) {
  if (n > kRegRows) {
    const dim3 block(kStreamCols, kStreamGroups);
    const dim3 grid((m + kStreamCols - 1) / kStreamCols);
    mu_solve_stream_kernel<<<grid, block, 0, stream>>>(
        A, theta, theta_stride, nact_blocks, block_m, mu, k, s, act, n, m,
        n_bisect, n_polish);
    return (int)cudaGetLastError();
  }
  const Plan p = plan_for(n);
  size_t smem = 0;
  const MuFn fn = mu_fn(p, &smem);
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return launched(e);
  const int groups = (m + cols_per_cta(p) - 1) / cols_per_cta(p);
  LaunchCfg lc(groups * p.S, smem, stream, p.S, false);
  e = cudaLaunchKernelEx(&lc.cfg, fn, A, theta, theta_stride, nact_blocks,
                         block_m, mu, k, s, act, n, m, n_bisect, n_polish,
                         p.S, p.slab);
  return launched(e);
}

// Rows up to which the loop kernel holds columns on chip (taller buffers
// run the loop on the host over the streaming mu_solve).
int l1inf_newton_loop_max_rows() { return kRegRows; }

// The loop kernel's grid in clusters (CTAs when S = 1) for an (n, m)
// buffer of G segments (loop_plan). Sizes the wrapper's scratch; a
// negative value is a CUDA error code.
int l1inf_newton_loop_clusters(int n, int m, int G) {
  if (n > kRegRows || G < 1) return -(int)cudaErrorInvalidValue;
  LoopPlan lp;
  const cudaError_t e = loop_plan(n, m, G, &lp);
  return e != cudaSuccess ? -(int)e : lp.ncl;
}

int l1inf_newton_loop(const float* A, const int* sids, const float* colsum,
                      const float* t1, const float* csafe,
                      const int* num_active, float* mu, float* theta,
                      long long* stats, float* partials, int n, int m, int G,
                      int bm, int n_bisect, int n_polish, int max_newton,
                      int shrink, cudaStream_t stream) {
  if (n > kRegRows || G < 1) return (int)cudaErrorInvalidValue;
  LoopPlan lp;
  const cudaError_t e = loop_plan(n, m, G, &lp);
  if (e != cudaSuccess) return (int)e;
  LoopArgs a{A, sids, colsum, t1, csafe, num_active, mu, theta, stats,
             partials, n, m, G, bm, n_bisect, n_polish, max_newton, shrink,
             lp.S, lp.slab, lp.own, lp.resident,
             (int)(m % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0)};
  LaunchCfg lc(lp.ncl * lp.S, lp.smem, stream, lp.S, true);
  return launched(cudaLaunchKernelEx(&lc.cfg, lp.fn, a));
}

int l1inf_clip_apply_f32(const float* Y, const float* mu, float* X, int n,
                         int m, cudaStream_t stream) {
  return launch_clip<float>(Y, mu, X, n, m, stream);
}

int l1inf_clip_apply_bf16(const void* Y, const float* mu, void* X, int n,
                          int m, cudaStream_t stream) {
  return launch_clip<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(Y), mu,
      static_cast<__nv_bfloat16*>(X), n, m, stream);
}

const char* l1inf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
