// Hand-written Hopper (sm_90a) kernels of the fused Adam+projection step.
//
// They replace the two Pallas TPU kernels of
// src/repro/kernels/fused_step/kernel.py and compute what those compute:
//
// adam_colstats   (replaces kernel.py::adam_colstats, pass 1)
//   One read of (g, m, v, p[, mask]) per element: the Adam moments are
//   updated and written in the moment dtype, the updated value u is formed
//   from the STORED moments and rounded through p's dtype, and its
//   per-column statistics (sum |u| or sum u^2, and max |u|) are reduced.
//   u itself is never written. Bound: bytes (read g, m, v, p[, mask]; write
//   m, v and 8 bytes per column).
//
// adam_clip_apply (replaces kernel.py::adam_clip_apply, pass 2)
//   Recomputes u from the moments pass 1 stored (no moment update) and
//   writes sign(u) * min(|u|, mu_j) ("clip"; mu = 1e30 is the identity, 0 a
//   dead column) or u * mu_j ("scale"; identity 1.0), masked, in p's dtype.
//   Bound: bytes (read m, v, p[, mask] and mu; write x).
//
// Both passes compute u with ONE device function, adam_u, so pass 1's
// statistics describe exactly the matrix pass 2 writes (the recompute
// invariant of the reference's ref.py). Every operation of the update is
// an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn): nvcc would otherwise contract a*b+c into an FMA,
// and the kernel would drift from its plain PyTorch version, which rounds
// after every operation. The association order is the reference's:
// (lr_t * mhat) / (sqrt(vhat) + eps), then + (lr_t * wd) * p, then * mask,
// then p - step. The beta complements 1 - b1 and 1 - b2 arrive formed on
// the host in double and rounded once to f32, as the reference forms them.
// The step scalars [clip_scale, lr_t, b1c, b2c] stay on the device: the
// kernels read them from a (4,) f32 array, so no host sync is needed.
//
// Layouts. A leaf is an (L, R, Cc) row-major stack. "Canonical columns"
// are the Cc trailing columns (transpose = 0, reduce over rows) or the R
// rows (transpose = 1, reduce over the contiguous trailing dim: the SAE's
// enc1/w with axis 1).
//   * pass 1, transpose = 0: a block owns 32 neighbouring columns of one
//     matrix (threadIdx.x, coalesced) and loops over all rows with
//     threadIdx.y; row groups meet in shared memory in a fixed order.
//   * pass 1, transpose = 1: one warp per canonical column (a contiguous
//     row); lanes stride over it and meet in a fixed shuffle tree.
//   * pass 2: one warp per row of the (L * R, Cc) view and 256-column chunk
//     (grid.y), lanes striding over the contiguous dim; the row's mu is a
//     register when transpose = 1. The chunks keep a short, wide matrix
//     (1000 x 10000) from running on fewer blocks than the card has SMs.
//   The leading dim L is on the grid. Nothing is carried across blocks and
//   there are no atomics, so a rerun is bit-equal.
//
// Plain C interface (loaded with ctypes): pointers, sizes, scalars and the
// stream; dtype codes 0 = f32, 1 = bf16. Each entry point returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct AdamArgs {
  float b1, omb1, b2, omb2, eps, wd;
  int has_wd;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// round an f32 value through T (identity for f32)
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The update u (rounded through T) from STORED moments m_st, v_st.
template <typename T>
__device__ __forceinline__ float adam_u(float m_st, float v_st, float p,
                                        float mk, bool has_mask,
                                        float lr_t, float b1c, float b2c,
                                        const AdamArgs& a, const T* tag) {
  const float mhat = __fdiv_rn(m_st, b1c);
  const float vhat = __fdiv_rn(v_st, b2c);
  float step = __fdiv_rn(__fmul_rn(lr_t, mhat),
                         __fadd_rn(__fsqrt_rn(vhat), a.eps));
  if (a.has_wd) step = __fadd_rn(step, __fmul_rn(__fmul_rn(lr_t, a.wd), p));
  if (has_mask) step = __fmul_rn(step, mk);
  return rnd(__fsub_rn(p, step), tag);
}

// Pass 1 on one element: moments updated and stored, u returned.
template <typename T, typename M>
__device__ __forceinline__ float adam_step1(const T* g, const M* m,
                                            const M* v, const T* p,
                                            const T* mask, M* mo, M* vo,
                                            size_t i, float scale, float lr_t,
                                            float b1c, float b2c,
                                            const AdamArgs& a) {
  const float mk = mask ? ld(mask, i) : 1.f;
  float gv = rnd(__fmul_rn(ld(g, i), scale), g);   // (g * clip_scale) in T
  if (mask) gv = __fmul_rn(gv, mk);
  const float m_new = __fadd_rn(__fmul_rn(a.b1, ld(m, i)),
                                __fmul_rn(a.omb1, gv));
  const float v_new = __fadd_rn(__fmul_rn(a.b2, ld(v, i)),
                                __fmul_rn(__fmul_rn(a.omb2, gv), gv));
  st(mo, i, m_new);
  st(vo, i, v_new);
  const float m_st = rnd(m_new, m), v_st = rnd(v_new, m);
  return adam_u(m_st, v_st, ld(p, i), mk, mask != nullptr, lr_t, b1c, b2c,
                a, p);
}

constexpr int kCols = 32;         // pass 1, transpose = 0: columns a block
constexpr int kMaxGroups = 32;    // row groups (threadIdx.y)
constexpr int kWarps = 8;         // warps a block for the warp-per-row kernels
constexpr int kChunk = 256;       // pass 2: columns a warp writes (grid.y)

template <typename T, typename M, bool SQ>
__global__ void __launch_bounds__(kCols * kMaxGroups)
adam_colstats_cols_kernel(const T* __restrict__ g, const M* __restrict__ m,
                          const M* __restrict__ v, const T* __restrict__ p,
                          const T* __restrict__ mask, M* __restrict__ mo,
                          M* __restrict__ vo, float* __restrict__ colsum,
                          float* __restrict__ colmax,
                          const float* __restrict__ sc, AdamArgs a, int R,
                          int Cc) {
  __shared__ float red[2][kMaxGroups][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y, G = blockDim.y;
  const int col = blockIdx.x * kCols + tx;
  const size_t base = (size_t)blockIdx.y * R * Cc;
  const float scale = sc[0], lr_t = sc[1], b1c = sc[2], b2c = sc[3];
  float s = 0.f, mx = 0.f;
  if (col < Cc) {
    for (int r = ty; r < R; r += G) {
      const size_t i = base + (size_t)r * Cc + col;
      const float u = adam_step1(g, m, v, p, mask, mo, vo, i, scale, lr_t,
                                 b1c, b2c, a);
      const float au = fabsf(u);
      s = __fadd_rn(s, SQ ? __fmul_rn(au, au) : au);
      mx = fmaxf(mx, au);
    }
  }
  red[0][ty][tx] = s;
  red[1][ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && col < Cc) {
    for (int k = 1; k < G; ++k) {
      s = __fadd_rn(s, red[0][k][tx]);
      mx = fmaxf(mx, red[1][k][tx]);
    }
    colsum[(size_t)blockIdx.y * Cc + col] = s;
    colmax[(size_t)blockIdx.y * Cc + col] = mx;
  }
}

template <typename T, typename M, bool SQ>
__global__ void __launch_bounds__(32 * kWarps)
adam_colstats_rows_kernel(const T* __restrict__ g, const M* __restrict__ m,
                          const M* __restrict__ v, const T* __restrict__ p,
                          const T* __restrict__ mask, M* __restrict__ mo,
                          M* __restrict__ vo, float* __restrict__ colsum,
                          float* __restrict__ colmax,
                          const float* __restrict__ sc, AdamArgs a, int R,
                          int Cc) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;                       // whole warps leave together
  const size_t out = (size_t)blockIdx.y * R + row;
  const size_t base = out * Cc;
  const float scale = sc[0], lr_t = sc[1], b1c = sc[2], b2c = sc[3];
  float s = 0.f, mx = 0.f;
  for (int c = lane; c < Cc; c += 32) {
    const float u = adam_step1(g, m, v, p, mask, mo, vo, base + c, scale,
                               lr_t, b1c, b2c, a);
    const float au = fabsf(u);
    s = __fadd_rn(s, SQ ? __fmul_rn(au, au) : au);
    mx = fmaxf(mx, au);
  }
  for (int off = 16; off > 0; off >>= 1) {    // fixed shuffle tree
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    colsum[out] = s;
    colmax[out] = mx;
  }
}

template <typename T, typename M, bool SCALE>
__global__ void __launch_bounds__(32 * kWarps)
adam_clip_apply_kernel(const M* __restrict__ m, const M* __restrict__ v,
                       const T* __restrict__ p, const T* __restrict__ mask,
                       const float* __restrict__ mu, T* __restrict__ x,
                       const float* __restrict__ sc, AdamArgs a, int L, int R,
                       int Cc, int transpose) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);   // of L * R
  if (row >= L * R) return;
  const size_t base = (size_t)row * Cc;
  const float lr_t = sc[1], b1c = sc[2], b2c = sc[3];
  const float* mu_row = transpose ? mu + row : mu + (size_t)(row / R) * Cc;
  const float mu_t = transpose ? *mu_row : 0.f;
  const int c_end = min(Cc, ((int)blockIdx.y + 1) * kChunk);
  for (int c = blockIdx.y * kChunk + lane; c < c_end; c += 32) {
    const size_t i = base + c;
    const float mk = mask ? ld(mask, i) : 1.f;
    const float u = adam_u(ld(m, i), ld(v, i), ld(p, i), mk,
                           mask != nullptr, lr_t, b1c, b2c, a, p);
    const float mj = transpose ? mu_t : mu_row[c];
    float out;
    if (SCALE) {
      out = __fmul_rn(u, mj);
    } else {
      // sign(u) * min(|u|, mu): sign as (u > 0) - (u < 0), and a min that
      // keeps a NaN |u|, as torch.minimum does
      const float sgn = (float)(u > 0.f) - (float)(u < 0.f);
      const float au = fabsf(u);
      out = __fmul_rn(sgn, mj < au ? mj : au);
    }
    if (mask) out = __fmul_rn(out, mk);
    st(x, i, out);
  }
}

AdamArgs adam_args(float b1, float omb1, float b2, float omb2, float eps,
                   float wd) {
  AdamArgs a{b1, omb1, b2, omb2, eps, wd, wd != 0.f ? 1 : 0};
  return a;
}

template <typename T, typename M>
int launch_colstats(const void* g, const void* m, const void* v,
                    const void* p, const void* mask, void* mo, void* vo,
                    float* colsum, float* colmax, const float* sc,
                    AdamArgs a, int L, int R, int Cc, int transpose, int sq,
                    cudaStream_t stream) {
  const T *gt = (const T*)g, *pt = (const T*)p, *kt = (const T*)mask;
  const M *mt = (const M*)m, *vt = (const M*)v;
  M *mot = (M*)mo, *vot = (M*)vo;
  if (transpose) {
    const dim3 grid((R + kWarps - 1) / kWarps, L);
    if (sq)
      adam_colstats_rows_kernel<T, M, true><<<grid, 32 * kWarps, 0, stream>>>(
          gt, mt, vt, pt, kt, mot, vot, colsum, colmax, sc, a, R, Cc);
    else
      adam_colstats_rows_kernel<T, M, false><<<grid, 32 * kWarps, 0, stream>>>(
          gt, mt, vt, pt, kt, mot, vot, colsum, colmax, sc, a, R, Cc);
  } else {
    const dim3 block(kCols, R >= 256 ? kMaxGroups : 8);
    const dim3 grid((Cc + kCols - 1) / kCols, L);
    if (sq)
      adam_colstats_cols_kernel<T, M, true><<<grid, block, 0, stream>>>(
          gt, mt, vt, pt, kt, mot, vot, colsum, colmax, sc, a, R, Cc);
    else
      adam_colstats_cols_kernel<T, M, false><<<grid, block, 0, stream>>>(
          gt, mt, vt, pt, kt, mot, vot, colsum, colmax, sc, a, R, Cc);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename M>
int launch_clip(const void* m, const void* v, const void* p, const void* mask,
                const float* mu, void* x, const float* sc, AdamArgs a, int L,
                int R, int Cc, int transpose, int scale,
                cudaStream_t stream) {
  const M *mt = (const M*)m, *vt = (const M*)v;
  const T *pt = (const T*)p, *kt = (const T*)mask;
  T* xt = (T*)x;
  const dim3 grid((L * R + kWarps - 1) / kWarps, (Cc + kChunk - 1) / kChunk);
  if (scale)
    adam_clip_apply_kernel<T, M, true><<<grid, 32 * kWarps, 0, stream>>>(
        mt, vt, pt, kt, mu, xt, sc, a, L, R, Cc, transpose);
  else
    adam_clip_apply_kernel<T, M, false><<<grid, 32 * kWarps, 0, stream>>>(
        mt, vt, pt, kt, mu, xt, sc, a, L, R, Cc, transpose);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p_dtype / m_dtype: 0 = f32, 1 = bf16 (g and mask share p's dtype).
int fused_adam_colstats(int p_dtype, int m_dtype, const void* g,
                        const void* m, const void* v, const void* p,
                        const void* mask, void* mo, void* vo, float* colsum,
                        float* colmax, const float* sc, float b1, float omb1,
                        float b2, float omb2, float eps, float wd, int L,
                        int R, int Cc, int transpose, int sq,
                        cudaStream_t stream) {
  const AdamArgs a = adam_args(b1, omb1, b2, omb2, eps, wd);
  if (p_dtype == 0 && m_dtype == 0)
    return launch_colstats<float, float>(g, m, v, p, mask, mo, vo, colsum,
                                         colmax, sc, a, L, R, Cc, transpose,
                                         sq, stream);
  if (p_dtype == 1 && m_dtype == 0)
    return launch_colstats<__nv_bfloat16, float>(
        g, m, v, p, mask, mo, vo, colsum, colmax, sc, a, L, R, Cc, transpose,
        sq, stream);
  if (p_dtype == 0 && m_dtype == 1)
    return launch_colstats<float, __nv_bfloat16>(
        g, m, v, p, mask, mo, vo, colsum, colmax, sc, a, L, R, Cc, transpose,
        sq, stream);
  return launch_colstats<__nv_bfloat16, __nv_bfloat16>(
      g, m, v, p, mask, mo, vo, colsum, colmax, sc, a, L, R, Cc, transpose,
      sq, stream);
}

int fused_adam_clip_apply(int p_dtype, int m_dtype, const void* m,
                          const void* v, const void* p, const void* mask,
                          const float* mu, void* x, const float* sc, float b1,
                          float omb1, float b2, float omb2, float eps,
                          float wd, int L, int R, int Cc, int transpose,
                          int scale, cudaStream_t stream) {
  const AdamArgs a = adam_args(b1, omb1, b2, omb2, eps, wd);
  if (p_dtype == 0 && m_dtype == 0)
    return launch_clip<float, float>(m, v, p, mask, mu, x, sc, a, L, R, Cc,
                                     transpose, scale, stream);
  if (p_dtype == 1 && m_dtype == 0)
    return launch_clip<__nv_bfloat16, float>(m, v, p, mask, mu, x, sc, a, L,
                                             R, Cc, transpose, scale, stream);
  if (p_dtype == 0 && m_dtype == 1)
    return launch_clip<float, __nv_bfloat16>(m, v, p, mask, mu, x, sc, a, L,
                                             R, Cc, transpose, scale, stream);
  return launch_clip<__nv_bfloat16, __nv_bfloat16>(
      m, v, p, mask, mu, x, sc, a, L, R, Cc, transpose, scale, stream);
}

const char* fused_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
