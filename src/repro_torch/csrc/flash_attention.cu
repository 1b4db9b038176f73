// Hand-written Hopper (sm_90a) kernel: forward online-softmax attention.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd and
// computes what it computes:
//   q (BH, Sq, hd), k/v (BKV, Skv, hd) with BH = BKV * groups (GQA: query
//   head bh reads kv head bh / groups); s = (q . k) * hd^-1/2 in f32; causal
//   (q_pos >= kv_pos) and sliding-window (q_pos - kv_pos < window) masks;
//   masked logits -1e30 and their p forced to 0 after exp(s - m_new) (so a
//   row whose every key so far is masked sums nothing into l and acc);
//   running (m, l, acc) in f32 across KV tiles; out = acc / max(l, 1e-30)
//   in q's dtype.
//
// Bound on the card: operations. At hymba-1.5b's prefill (BH 50, S 2048,
// hd 64, causal, window 1024) the unmasked (q, k) pairs need 20.1 GFLOP
// (0.30 ms at 67 TFLOP/s f32) against 62.9 MB of q, k, v and out (0.019 ms
// at 3.35 TB/s). This first kernel runs on the CUDA cores in f32 (no
// wgmma, TMA or tensor cores yet), so it is far from the bf16 tensor-core
// bound; making it fast is later work.
//
// Design. One CTA of 256 threads per (bh, tile of 64 query rows) loops over
// the KV tiles in order; a tile that the causal or window mask empties
// entirely is skipped, with the Pallas kernel's tile test. The CTA keeps
// its query tile, one K and one V tile and the tile's probabilities in
// shared memory as f32 (rows padded by one float against bank conflicts).
// The threads form a 16 x 16 grid: thread (ty, tx) owns query rows
// ty + 16 i (i < 4), logits at key columns tx + 16 c and accumulator
// columns tx + 16 c, so the 16 threads of one row group are one half-warp
// and meet in a fixed xor-shuffle tree for the row max and row sum. Tiles
// are sized by head_dim (64 keys up to hd 128, 32 at hd 256) to stay under
// the 227 KB a block may use; above 48 KB the launch opts in with
// cudaFuncSetAttribute. Query rows and keys past Sq / Skv (tails that are
// not a multiple of the tile) are bounds-masked. Nothing is carried across
// blocks and nothing accumulates with atomics, so a rerun is bit-equal.
//
// Plain C interface (loaded with ctypes): pointers, sizes, flags, the
// scale and the stream; dtype code 0 = f32, 1 = bf16; head_dim 64, 80, 128
// or 256. Returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// reduce over the 16 lanes of a half-warp (lane bits 0..3), fixed order
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)BKV * (HD + 1) +
                          (size_t)BKV * HD + (size_t)kBQ * (BKV + 1));
}

template <typename T, int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Skv, int groups, int causal, int window, float scale) {
  constexpr int RQ = kBQ / 16;   // query rows per thread
  constexpr int CK = BKV / 16;   // logit columns per thread
  constexpr int CD = HD / 16;    // accumulator columns per thread
  constexpr int QS = HD + 1, KS = HD + 1, PS = BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + BKV * KS;
  float* Ps = Vs + BKV * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const T* qb = q + (size_t)bh * Sq * HD;
  const T* kb = k + (size_t)(bh / groups) * Skv * HD;
  const T* vb = v + (size_t)(bh / groups) * Skv * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    Qs[r * QS + c] = q0 + r < Sq ? ld(qb, (size_t)(q0 + r) * HD + c) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int nkv = (Skv + BKV - 1) / BKV;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BKV;
    // the Pallas kernel's tile test: skip tiles the masks empty entirely
    if (causal && k0 > q0 + kBQ - 1) break;
    if (window && q0 - (k0 + BKV - 1) >= window) continue;

    __syncthreads();                       // last tile's Ps / Vs reads done
    for (int e = tid; e < BKV * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Skv;
      const size_t g = (size_t)(k0 + r) * HD + c;
      Ks[r * KS + c] = in ? ld(kb, g) : 0.f;
      Vs[r * HD + c] = in ? ld(vb, g) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = Ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[CK];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = kp < Skv && (!causal || qp >= kp) &&
                (!window || qp - kp < window);
        s[i][c] = ok[c] ? s[i][c] * scale : kNeg;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PS + tx + 16 * c] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* ob = out + (size_t)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      st(ob, (size_t)qp * HD + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int HD, int BKV>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Skv, int groups, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD, BKV>;
  constexpr size_t smem = smem_bytes<HD, BKV>();
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, groups,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int BH, int Sq, int Skv, int groups, int causal,
                int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, BH, Sq, Skv, groups, causal,
                               window, scale, s);
    case 80:
      return launch<T, 80, 64>(q, k, v, out, BH, Sq, Skv, groups, causal,
                               window, scale, s);
    case 128:
      return launch<T, 128, 64>(q, k, v, out, BH, Sq, Skv, groups, causal,
                                window, scale, s);
    case 256:
      return launch<T, 256, 32>(q, k, v, out, BH, Sq, Skv, groups, causal,
                                window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_fwd(int dtype, int hd, const void* q, const void* k,
                        const void* v, void* out, int BH, int Sq, int Skv,
                        int groups, int causal, int window, float scale,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, BH, Sq, Skv, groups, causal,
                              window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, BH, Sq, Skv, groups,
                                      causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
