// Hand-written Hopper (sm_90a) kernels of the l1,inf projection engine.
//
// They replace the three Pallas TPU kernels of
// src/repro/kernels/l1inf/kernel.py and compute what those compute, but
// are laid out for the card: blocks run in parallel in no order, shared
// memory is at most 227 KB a block, and a warp wants 32 neighbouring
// addresses. The buffer is row-major (n, m): a column's rows are m floats
// apart, so every kernel puts NEIGHBOURING COLUMNS on neighbouring threads
// (threadIdx.x) and walks rows with threadIdx.y, which makes each row read
// of a block one coalesced 128-byte line.
//
// colstats   (replaces kernel.py::colstats)
//   Per-column sum and max of |Y|. Bound: bytes (one read of n*m floats,
//   8*m bytes written). A block owns 32 columns and loops over ALL rows
//   itself, so nothing is carried across blocks and no atomics are needed;
//   the row groups of a block meet in shared memory in a fixed order, so
//   the result is deterministic.
//
// mu_solve   (replaces kernel.py::mu_solve)
//   Per-column water level mu_j at removed mass theta (scalar or one per
//   column): the Pallas body's arithmetic in f32 — 26 bisection steps on
//   [0, colmax], 8 Michelot polish steps from below, then the exact
//   (k, S_k) payloads. That is 36 compare-and-sum passes over each active
//   column, so the bound is the f32 operation rate for short columns and
//   one read of the active prefix otherwise. The active-block count is
//   read from device memory (the host never syncs for it); a block whose
//   columns all lie at or past nact_blocks * block_m writes the inactive
//   defaults and reads nothing, which keeps the work J-proportional.
//   Large n: the Pallas kernel held a whole (n, 128) column tile in VMEM.
//   Here a block holds its (n, 32) tile in shared memory only while
//   n <= kTileRows (32 KB); a taller tile is STREAMED from global memory on
//   every pass instead of being spread over several blocks. Streaming
//   keeps one block per column group (so the per-step reductions stay
//   inside the block, with no grid-wide sync 36 times per solve), and the
//   repeated reads of one block's tile (n * 128 bytes; 1.28 MB at
//   n = 10000) hit L2, which holds 50 MB. Tall tiles get 32 row groups
//   (1024 threads) so each SM keeps more loads in flight.
//
// clip_apply (replaces kernel.py::clip_apply)
//   X = sign(Y) * min(|Y|, mu_j) in Y's dtype (f32 or bf16), with mu
//   rounded to Y's dtype first. Bound: bytes (one read and one write of
//   Y). Columns on x (coalesced), rows strided over grid.y, mu_j kept in a
//   register per thread. In bf16 the f32 arithmetic is exact (the result
//   is +-|y|, +-mu or 0), so it is bit-equal to bf16 arithmetic.
//
// Plain C interface (loaded with ctypes): pointers, sizes and the stream;
// every entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kCols = 32;          // columns per block (threadIdx.x)
constexpr int kTileRows = 256;     // mu_solve's shared tile: 256*32*4 = 32 KB
constexpr int kMaxGroups = 32;     // row groups per block (threadIdx.y)

int row_groups(int n) { return n <= kTileRows ? 8 : kMaxGroups; }

// Sum two per-thread partials over the row groups of each column, in a
// fixed order; every thread of the column gets the same totals.
__device__ __forceinline__ void col_sum2(float (*red)[kMaxGroups][kCols],
                                         float& a, float& b) {
  const int tx = threadIdx.x, ty = threadIdx.y, G = blockDim.y;
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  float ta = red[0][0][tx], tb = red[1][0][tx];
  for (int g = 1; g < G; ++g) {
    ta += red[0][g][tx];
    tb += red[1][g][tx];
  }
  __syncthreads();
  a = ta;
  b = tb;
}

// As col_sum2, but the second partial is reduced by max.
__device__ __forceinline__ void col_summax(float (*red)[kMaxGroups][kCols],
                                           float& s, float& mx) {
  const int tx = threadIdx.x, ty = threadIdx.y, G = blockDim.y;
  red[0][ty][tx] = s;
  red[1][ty][tx] = mx;
  __syncthreads();
  float ts = red[0][0][tx], tm = red[1][0][tx];
  for (int g = 1; g < G; ++g) {
    ts += red[0][g][tx];
    tm = fmaxf(tm, red[1][g][tx]);
  }
  __syncthreads();
  s = ts;
  mx = tm;
}

__global__ void __launch_bounds__(kCols * kMaxGroups)
colstats_kernel(const float* __restrict__ A, float* __restrict__ colsum,
                float* __restrict__ colmax, int n, int m) {
  __shared__ float red[2][kMaxGroups][kCols];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int c = min(col, m - 1);      // ragged edge: read a real column
  float s = 0.f, mx = 0.f;
  for (int r = threadIdx.y; r < n; r += blockDim.y) {
    const float v = fabsf(A[(size_t)r * m + c]);
    s += v;
    mx = fmaxf(mx, v);
  }
  col_summax(red, s, mx);
  if (threadIdx.y == 0 && col < m) {
    colsum[col] = s;
    colmax[col] = mx;
  }
}

__global__ void __launch_bounds__(kCols * kMaxGroups)
mu_solve_kernel(const float* __restrict__ A, const float* __restrict__ theta,
                int theta_stride, const int* __restrict__ nact_blocks,
                int block_m, float* __restrict__ mu_out,
                float* __restrict__ k_out, float* __restrict__ s_out,
                bool* __restrict__ act_out, int n, int m, int n_bisect,
                int n_polish) {
  __shared__ float tile[kTileRows * kCols];
  __shared__ float red[2][kMaxGroups][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y, G = blockDim.y;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + tx;
  const long long limit = (long long)nact_blocks[0] * block_m;

  if (col0 >= limit) {
    // every column of the block lies past the active prefix
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
  const float* src;
  size_t ld;
  if (n <= kTileRows) {
    for (int r = ty; r < n; r += G) {
      tile[r * kCols + tx] = A[(size_t)r * m + c];
    }
    __syncthreads();
    src = tile + tx;
    ld = kCols;
  } else {
    src = A + c;
    ld = (size_t)m;
  }

  // pass 0: colsum (activity) and colmax (bisection bracket)
  float colsum = 0.f, colmax = 0.f;
  for (int r = ty; r < n; r += G) {
    const float v = fabsf(src[r * ld]);
    colsum += v;
    colmax = fmaxf(colmax, v);
  }
  col_summax(red, colsum, colmax);
  const bool active = colsum > th;

  // bisection: removed(mu) = sum (y - mu)_+ is decreasing in mu
  float lo = 0.f, hi = colmax;
  for (int it = 0; it < n_bisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float removed = 0.f, unused = 0.f;
    for (int r = ty; r < n; r += G) {
      removed += fmaxf(fabsf(src[r * ld]) - mid, 0.f);
    }
    col_sum2(red, removed, unused);
    const bool ge = removed >= th;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }

  // Michelot polish from below (monotone, finitely convergent)
  float mu = lo;
  for (int it = 0; it < n_polish; ++it) {
    float cnt = 0.f, ssum = 0.f;
    for (int r = ty; r < n; r += G) {
      const float v = fabsf(src[r * ld]);
      const bool gt = v > mu;
      cnt += gt ? 1.f : 0.f;
      ssum += gt ? v : 0.f;
    }
    col_sum2(red, cnt, ssum);
    const float k = fmaxf(cnt, 1.f);
    mu = fmaxf((ssum - th) / k, mu);
  }
  mu = fmaxf(mu, 0.f);

  // exact payloads at the solved level
  float cnt = 0.f, ssum = 0.f;
  for (int r = ty; r < n; r += G) {
    const float v = fabsf(src[r * ld]);
    const bool gt = v > mu;
    cnt += gt ? 1.f : 0.f;
    ssum += gt ? v : 0.f;
  }
  col_sum2(red, cnt, ssum);

  if (ty == 0 && col < m) {
    const bool live = active && col < limit;
    mu_out[col] = live ? mu : 0.f;
    k_out[col] = live ? fmaxf(cnt, 1.f) : 1.f;
    s_out[col] = live ? ssum : 0.f;
    act_out[col] = live;
  }
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
                   cudaStream_t stream) {
  const dim3 block(kCols, row_groups(n));
  const dim3 grid((m + kCols - 1) / kCols);
  colstats_kernel<<<grid, block, 0, stream>>>(A, colsum, colmax, n, m);
  return (int)cudaGetLastError();
}

int l1inf_mu_solve(const float* A, const float* theta, int theta_stride,
                   const int* nact_blocks, int block_m, float* mu, float* k,
                   float* s, bool* act, int n, int m, int n_bisect,
                   int n_polish, cudaStream_t stream) {
  const dim3 block(kCols, row_groups(n));
  const dim3 grid((m + kCols - 1) / kCols);
  mu_solve_kernel<<<grid, block, 0, stream>>>(A, theta, theta_stride,
                                              nact_blocks, block_m, mu, k, s,
                                              act, n, m, n_bisect, n_polish);
  return (int)cudaGetLastError();
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
