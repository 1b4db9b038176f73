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
// Bound on the card: operations. Five products over the unmasked pairs (S
// and dP recomputed, dv, dk, dq), 2 hd FLOP each: at stablelm-3b's training
// shape (BH 32, S 2048, hd 80, causal) 67.1 M pairs, 53.7 GFLOP, 0.80 ms at
// f32's 67 TFLOP/s, against 2 x 21 MB of q, k, v, out, dout in and dq, dk,
// dv out (0.014 ms at 3.35 TB/s).
//
// Design: three launches from one call, no atomics, every sum in a fixed
// order, so a rerun is bit-equal.
//   delta — one warp per row, 16-byte loads, a fixed xor-shuffle tree.
//   dkdv  — one CTA of 256 threads (16 x 16) per (kv head, BKV keys). K and
//           V stay in shared memory; the CTA loops over the group's query
//           heads and, for each, over the query tiles that the forward's
//           tile test leaves unmasked for these keys, in order. Per tile it
//           recomputes S^T and dP^T (thread (ty, tx) holds keys ty + 16 i
//           against query rows tx + 16 c), forms P^T and dS^T in shared
//           memory, and accumulates dv and dk in registers (keys ty + 16 i,
//           head-dim columns 4 (tx + 16 c) .. + 3). The sum over the GQA
//           group stays inside the CTA.
//   dq    — one CTA per (query head, BQ rows), heavy causal tiles first,
//           looping over the forward's kv range: S and dP recomputed, dS in
//           shared memory, dq accumulated in registers.
// Shared-memory rows are padded by four floats against bank conflicts and
// read in 16-byte vectors; tiles are 64 x 64 up to hd 128 and 32 x 32 at
// hd 256. A simple first design: no double buffering, one CTA an SM in
// dkdv. Keys past Skv and rows past Sq are zero-filled and masked, so the
// lengths need not be tile multiples.
//
// Plain C interface (loaded with ctypes): contiguous f32 pointers, 16-byte
// aligned; head_dim 64, 80, 128 or 256; delta is scratch of BH * Sq floats.
// Returns cudaGetLastError() after the launches, or the first error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16

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

template <int HD, int BQ, int BKV>
struct Tile {
  static constexpr int TX = 16;
  static constexpr int HD4 = HD / 4;               // 16-byte vectors a row
  static constexpr int C4 = (HD4 + TX - 1) / TX;   // of them a thread
  static constexpr int RS = HD + 4;                // q, dout, k, v rows
  static constexpr int PQ = BQ + 4;                // dkdv: P^T, dS^T rows
  static constexpr int PK = BKV + 4;               // dq: dS rows
  static constexpr size_t dkdv_smem =
      sizeof(float) * (2 * (size_t)BKV * RS + 2 * (size_t)BQ * RS +
                       2 * (size_t)BKV * PQ + 2 * (size_t)BQ);
  static constexpr size_t dq_smem =
      sizeof(float) * (2 * (size_t)BQ * RS + 2 * (size_t)BKV * RS +
                       (size_t)BQ * PK);
};

// ---- delta ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ out,
                 const float* __restrict__ dout, float* __restrict__ delta,
                 int rows, int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
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
}

// ---- dk, dv ----------------------------------------------------------------

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int groups,
                int causal, int window, float scale) {
  using T = Tile<HD, BQ, BKV>;
  constexpr int TX = T::TX, RK = BKV / 16, RQ = BQ / 16;
  constexpr int HD4 = T::HD4, C4 = T::C4, RS = T::RS, PQ = T::PQ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // (BKV, RS)
  float* Vs = Ks + BKV * RS;        // (BKV, RS)
  float* Qs = Vs + BKV * RS;        // (BQ, RS)
  float* Ds = Qs + BQ * RS;         // dout (BQ, RS)
  float* Pt = Ds + BQ * RS;         // P^T (BKV, PQ)
  float* St = Pt + BKV * PQ;        // dS^T (BKV, PQ)
  float* Ls = St + BKV * PQ;        // lse (BQ)
  float* Es = Ls + BQ;              // delta (BQ)

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y;         // kv head
  const float* kb = k + (size_t)b * Skv * HD;
  const float* vb = v + (size_t)b * Skv * HD;
  for (int e = tid; e < BKV * HD4; e += kThreads) {
    const int r = e / HD4, c = e % HD4;
    const bool in = k0 + r < Skv;
    const size_t g = in ? (size_t)(k0 + r) * HD + 4 * c : 0;
    cp_async16(Ks + r * RS + 4 * c, kb + g, in);
    cp_async16(Vs + r * RS + 4 * c, vb + g, in);
  }
  cp_async_commit();

  // the query tiles that the forward's tile test pairs with these keys
  const int nq = (Sq + BQ - 1) / BQ;
  const int i_begin = causal ? min(nq, k0 / BQ) : 0;
  const int i_end = window ? min(nq, (k0 + BKV + window - 2) / BQ + 1) : nq;

  float dK[RK][C4][4], dV[RK][C4][4];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dK[i][c][e] = dV[i][c][e] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int h = b * groups + g;
    const float* qb = q + (size_t)h * Sq * HD;
    const float* db = dout + (size_t)h * Sq * HD;
    const float* lb = lse + (size_t)h * Sq;
    const float* eb = delta + (size_t)h * Sq;
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * BQ;
      for (int e = tid; e < BQ * HD4; e += kThreads) {
        const int r = e / HD4, c = e % HD4;
        const bool in = q0 + r < Sq;
        const size_t gq = in ? (size_t)(q0 + r) * HD + 4 * c : 0;
        cp_async16(Qs + r * RS + 4 * c, qb + gq, in);
        cp_async16(Ds + r * RS + 4 * c, db + gq, in);
      }
      cp_async_commit();
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lb[q0 + r] : 0.f;
        Es[r] = in ? eb[q0 + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T and dP^T: keys ty + 16 i against query rows tx + 16 c
      float s[RK][RQ], dp[RK][RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < RQ; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[RK], vv[RK], qv[RQ], ov[RQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = ld4(Ks + (ty + 16 * i) * RS + d);
          vv[i] = ld4(Vs + (ty + 16 * i) * RS + d);
        }
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          qv[c] = ld4(Qs + (tx + TX * c) * RS + d);
          ov[c] = ld4(Ds + (tx + TX * c) * RS + d);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < RK; ++i)
#pragma unroll
            for (int c = 0; c < RQ; ++c) {
              s[i][c] = fmaf(comp(kv[i], e), comp(qv[c], e), s[i][c]);
              dp[i][c] = fmaf(comp(vv[i], e), comp(ov[c], e), dp[i][c]);
            }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kk = ty + 16 * i;
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          const int qq = tx + TX * c;
          const bool ok = visible(q0 + qq, k0 + kk, Sq, Skv, causal, window);
          const float p = ok ? expf(s[i][c] * scale - Ls[qq]) : 0.f;
          Pt[kk * PQ + qq] = p;
          St[kk * PQ + qq] = p * (dp[i][c] - Es[qq]);
        }
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T q (scaled at the store)
#pragma unroll 2
      for (int qq = 0; qq < BQ; qq += 4) {
        float4 pv[RK], sv[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = ld4(Pt + (ty + 16 * i) * PQ + qq);
          sv[i] = ld4(St + (ty + 16 * i) * PQ + qq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < C4; ++c) {
            const int col = 4 * (tx + TX * c);
            if (HD4 % TX != 0 && col >= HD) continue;
            const float4 o4 = ld4(Ds + (qq + e) * RS + col);
            const float4 q4 = ld4(Qs + (qq + e) * RS + col);
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              const float p = comp(pv[i], e), ds = comp(sv[i], e);
              dV[i][c][0] = fmaf(p, o4.x, dV[i][c][0]);
              dV[i][c][1] = fmaf(p, o4.y, dV[i][c][1]);
              dV[i][c][2] = fmaf(p, o4.z, dV[i][c][2]);
              dV[i][c][3] = fmaf(p, o4.w, dV[i][c][3]);
              dK[i][c][0] = fmaf(ds, q4.x, dK[i][c][0]);
              dK[i][c][1] = fmaf(ds, q4.y, dK[i][c][1]);
              dK[i][c][2] = fmaf(ds, q4.z, dK[i][c][2]);
              dK[i][c][3] = fmaf(ds, q4.w, dK[i][c][3]);
            }
          }
        }
      }
      __syncthreads();                 // Qs, Ds, Pt, St free again
    }
  }
  cp_async_wait_all();                 // K, V of a CTA with no query tile

  float* dkb = dk + (size_t)b * Skv * HD;
  float* dvb = dv + (size_t)b * Skv * HD;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Skv) continue;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int col = 4 * (tx + TX * c);
      if (HD4 % TX != 0 && col >= HD) continue;
      *reinterpret_cast<float4*>(dkb + (size_t)kp * HD + col) =
          make_float4(dK[i][c][0] * scale, dK[i][c][1] * scale,
                      dK[i][c][2] * scale, dK[i][c][3] * scale);
      *reinterpret_cast<float4*>(dvb + (size_t)kp * HD + col) =
          make_float4(dV[i][c][0], dV[i][c][1], dV[i][c][2], dV[i][c][3]);
    }
  }
}

// ---- dq --------------------------------------------------------------------

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Skv, int groups,
              int causal, int window, float scale) {
  using T = Tile<HD, BQ, BKV>;
  constexpr int TX = T::TX, RQ = BQ / 16, CK = BKV / 16;
  constexpr int HD4 = T::HD4, C4 = T::C4, RS = T::RS, PK = T::PK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // (BQ, RS)
  float* Ds = Qs + BQ * RS;         // dout (BQ, RS)
  float* Ks = Ds + BQ * RS;         // (BKV, RS)
  float* Vs = Ks + BKV * RS;        // (BKV, RS)
  float* Ss = Vs + BKV * RS;        // dS (BQ, PK)

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const float* qb = q + (size_t)h * Sq * HD;
  const float* db = dout + (size_t)h * Sq * HD;
  const float* kb = k + (size_t)(h / groups) * Skv * HD;
  const float* vb = v + (size_t)(h / groups) * Skv * HD;
  for (int e = tid; e < BQ * HD4; e += kThreads) {
    const int r = e / HD4, c = e % HD4;
    const bool in = q0 + r < Sq;
    const size_t g = in ? (size_t)(q0 + r) * HD + 4 * c : 0;
    cp_async16(Qs + r * RS + 4 * c, qb + g, in);
    cp_async16(Ds + r * RS + 4 * c, db + g, in);
  }
  cp_async_commit();
  float lr[RQ], er[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    lr[i] = qp < Sq ? lse[(size_t)h * Sq + qp] : 0.f;
    er[i] = qp < Sq ? delta[(size_t)h * Sq + qp] : 0.f;
  }

  // the forward's kv range for these rows
  const int nkv = (Skv + BKV - 1) / BKV;
  const int lo = q0 - window + 1;
  const int j_begin = window && lo > 0 ? lo / BKV : 0;
  const int j_end = causal ? min(nkv, (q0 + BQ - 1) / BKV + 1) : nkv;

  float dQ[RQ][C4][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dQ[i][c][e] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BKV;
    for (int e = tid; e < BKV * HD4; e += kThreads) {
      const int r = e / HD4, c = e % HD4;
      const bool in = k0 + r < Skv;
      const size_t g = in ? (size_t)(k0 + r) * HD + 4 * c : 0;
      cp_async16(Ks + r * RS + 4 * c, kb + g, in);
      cp_async16(Vs + r * RS + 4 * c, vb + g, in);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S and dP: query rows ty + 16 i against keys tx + 16 c
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = ld4(Qs + (ty + 16 * i) * RS + d);
        ov[i] = ld4(Ds + (ty + 16 * i) * RS + d);
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        kv[c] = ld4(Ks + (tx + TX * c) * RS + d);
        vv[c] = ld4(Vs + (tx + TX * c) * RS + d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            s[i][c] = fmaf(comp(qv[i], e), comp(kv[c], e), s[i][c]);
            dp[i][c] = fmaf(comp(ov[i], e), comp(vv[c], e), dp[i][c]);
          }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qq = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kk = tx + TX * c;
        const bool ok = visible(q0 + qq, k0 + kk, Sq, Skv, causal, window);
        const float p = ok ? expf(s[i][c] * scale - lr[i]) : 0.f;
        Ss[qq * PK + kk] = p * (dp[i][c] - er[i]);
      }
    }
    __syncthreads();

    // dq += dS k (scaled at the store)
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 sv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = ld4(Ss + (ty + 16 * i) * PK + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const int col = 4 * (tx + TX * c);
          if (HD4 % TX != 0 && col >= HD) continue;
          const float4 k4 = ld4(Ks + (kk + e) * RS + col);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float ds = comp(sv[i], e);
            dQ[i][c][0] = fmaf(ds, k4.x, dQ[i][c][0]);
            dQ[i][c][1] = fmaf(ds, k4.y, dQ[i][c][1]);
            dQ[i][c][2] = fmaf(ds, k4.z, dQ[i][c][2]);
            dQ[i][c][3] = fmaf(ds, k4.w, dQ[i][c][3]);
          }
        }
      }
    }
    __syncthreads();                   // Ks, Vs, Ss free again
  }
  cp_async_wait_all();                 // Q, dout of a CTA with no kv tile

  float* dqb = dq + (size_t)h * Sq * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int col = 4 * (tx + TX * c);
      if (HD4 % TX != 0 && col >= HD) continue;
      *reinterpret_cast<float4*>(dqb + (size_t)qp * HD + col) =
          make_float4(dQ[i][c][0] * scale, dQ[i][c][1] * scale,
                      dQ[i][c][2] * scale, dQ[i][c][3] * scale);
    }
  }
}

template <int HD, int BQ, int BKV>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int BH, int Sq, int Skv, int groups,
           int causal, int window, float scale, cudaStream_t stream) {
  using T = Tile<HD, BQ, BKV>;
  auto dkdv = bwd_dkdv_kernel<HD, BQ, BKV>;
  auto dqk = bwd_dq_kernel<HD, BQ, BKV>;
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::dkdv_smem);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::dq_smem);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  const int rows = BH * Sq;
  bwd_delta_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                     0, stream>>>(out, dout, delta, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((Skv + BKV - 1) / BKV, BH / groups);
  dkdv<<<g1, kThreads, T::dkdv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, groups, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((Sq + BQ - 1) / BQ, BH);
  dqk<<<g2, kThreads, T::dq_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, groups, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_bwd(int hd, const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv, int BH,
                        int Sq, int Skv, int groups, int causal, int window,
                        float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fo = (const float*)out,
              *fd = (const float*)dout, *fl = (const float*)lse;
  float *fe = (float*)delta, *gq = (float*)dq, *gk = (float*)dk,
        *gv = (float*)dv;
  switch (hd) {
    case 64:
      return launch<64, 64, 64>(fq, fk, fv, fo, fd, fl, fe, gq, gk, gv, BH,
                                Sq, Skv, groups, causal, window, scale, s);
    case 80:
      return launch<80, 64, 64>(fq, fk, fv, fo, fd, fl, fe, gq, gk, gv, BH,
                                Sq, Skv, groups, causal, window, scale, s);
    case 128:
      return launch<128, 64, 64>(fq, fk, fv, fo, fd, fl, fe, gq, gk, gv, BH,
                                 Sq, Skv, groups, causal, window, scale, s);
    case 256:
      return launch<256, 32, 32>(fq, fk, fv, fo, fd, fl, fe, gq, gk, gv, BH,
                                 Sq, Skv, groups, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
