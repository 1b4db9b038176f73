// Hand-written Hopper (sm_90a) kernels: forward online-softmax attention.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd and
// computes what it computes:
//   q (BH, Sq, hd), k/v (BKV, Skv, hd) with BH = BKV * groups (GQA: query
//   head bh reads kv head bh / groups); s = (q . k) * hd^-1/2 in f32; causal
//   (q_pos >= kv_pos) and sliding-window (q_pos - kv_pos < window) masks;
//   masked logits -1e30 and their p forced to 0 after the exp (so a row
//   whose every key so far is masked sums nothing into l and acc); running
//   (m, l, acc) in f32 across KV tiles; out = acc / max(l, 1e-30) in q's
//   dtype. A KV tile that the causal or window mask empties for every row
//   of a CTA (or of a warpgroup) is skipped, with the Pallas kernel's tile
//   test. Query rows past Sq are not stored and keys past Skv are masked,
//   so Sq and Skv need not be multiples of a tile. Nothing is carried
//   across blocks and nothing accumulates with atomics: a rerun is
//   bit-equal. Given a non-null lse pointer, either kernel also writes
//   each row's log-sum-exp of the scaled logits, lse = m + log max(l,
//   1e-30), f32 (BH, Sq), from the same m and l that produced out: the row
//   statistics that the backwards (flash_attention_bwd.cu in f32,
//   flash_attention_bwd_bf16.cu in bf16) recompute P from. The bf16 kernel
//   keeps m in log2 units (m2 = m log2 e) and writes m2 ln 2 + log max(l,
//   1e-30).
//
// Bound on the card: operations. At hymba-1.5b's prefill (BH 50, S 2048,
// hd 64, causal, window 1024) the unmasked (q, k) pairs need 20.1 GFLOP:
// 0.020 ms at the bf16 tensor cores' 989 TFLOP/s, 0.30 ms at f32's 67
// TFLOP/s on the CUDA cores, against 31.5 MB (bf16) or 62.9 MB (f32) of q,
// k, v and out (0.0094 / 0.019 ms at 3.35 TB/s).
//
// bf16: the tensor cores (flash_bf16_kernel). A CTA of three warpgroups
// covers 128 query rows: two consumer warpgroups of 64 rows each and a
// producer whose one thread loads with TMA (cp.async.bulk.tensor): Q once,
// then K and V tiles of 64 keys into a two-stage ring in shared memory,
// with a full mbarrier per tile and operand and an empty mbarrier per
// stage that the consumers' eight warps release. Tiles are 64 x 64 slabs
// in TMA's 128-byte swizzle, read by wgmma through matrix descriptors: S =
// Q K^T is wgmma m64n64k16 with Q and K both K-major from shared memory,
// the softmax runs on the f32 accumulator fragments in registers (a row
// lies on the four threads of a quad: its max and sum are two
// xor-shuffles, in a fixed order; p = 2^(s scale log2 e - m), one FFMA and
// one ex2.approx; a tile that every row sees whole is not masked, and a
// partial one is masked once into a bit per logit), P is rounded to bf16
// in registers and
// fed as wgmma's register operand for O += P V, with V from shared memory
// MN-major (the transpose bit), one m64n64k16 per 64 columns of head dim.
// O stays in f32 registers (128 a thread at hd 256). setmaxnreg moves
// registers from the producer to the consumers, within the CTA: at hd 64
// two CTAs share an SM (launched at 80 a thread, producer 24, consumers
// 104), which keeps four consumer warpgroups on it; above hd 64 one CTA
// (producer 40, consumers 232). The tensor maps
// are 3-D (hd, S, heads), so a tile that runs past the end of one head
// reads zeros, not the next head's rows. Every head dim runs wgmma: 64,
// 128 and 256 as 1, 2 and 4 slabs; 80 (160-byte rows, wider than the
// swizzle) as 128, two slabs whose columns 80-127 the TMA fills with
// zeros, which add nothing to S and are not stored.
//
// f32: the CUDA cores in full f32 (flash_f32_kernel; TF32 stays off, so
// the f32 model's card-against-CPU check keeps its precision). A CTA of
// 256 threads (a 16 x 16 grid) covers 16 * RQ query rows; thread (ty, tx)
// owns rows ty + 16 i (i < RQ), logits at keys tx + 16 c and output
// vectors at head-dim columns 4 (tx + 16 c) .. + 3. Shared memory is read
// in 16-byte vectors along the reduction dim (rows padded by four floats
// against bank conflicts), and the next tile's K and V are copied with
// cp.async while this tile computes (two stages). The 16 threads of one
// row group are one half-warp and meet in a fixed xor-shuffle tree for
// the row max and row sum. Tiles by head_dim (query rows x keys): 64 x 64
// at hd 64 and 80 (a thread
// holds 4 x 4 logits and 4 rows of 4 or 8 output columns), 128 x 32 at
// hd 128, 64 x 32 at hd 256, under the 227 KB a block may use. At hd 64
// the 64 x 64 tile takes 102 KB, so two CTAs share an SM; 128-row tiles
// (8 x 4 logits a thread) need 137 KB and one CTA an SM, and run slower
// on the H100 (PERF.md, scripts/torch_kernel_variants.py).
//
// Shared memory above 48 KB is opted into with cudaFuncSetAttribute once
// per instantiation, so launches inside CUDA graph capture make no
// attribute call; the tensor maps are encoded on the host at each call and
// passed by value as __grid_constant__ parameters (the driver's encoder is
// found through cudaGetDriverEntryPoint, so nothing links libcuda).
//
// Plain C interface (loaded with ctypes): pointers, sizes, flags, the
// scale and the stream; dtype code 0 = f32, 1 = bf16; head_dim 64, 80, 128
// or 256; lse is null or a (BH, Sq) f32 output; the bf16 path
// needs q, k, v 16-byte aligned. Returns
// cudaGetLastError() right after the launch, or the error that stopped
// it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // f32: 16 x 16
constexpr float kNeg = -1e30f;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The KV tiles [j_begin, j_end) of a CTA whose query rows are q0 ..
// q0 + BQ - 1: the Pallas kernel's tile test (a tile whose every key the
// causal or the window mask hides from all those rows is skipped), solved
// for its first and last tile.
template <int BQ, int BKV>
__device__ __forceinline__ void kv_range(int q0, int Skv, int causal,
                                         int window, int& j_begin,
                                         int& j_end) {
  const int nkv = (Skv + BKV - 1) / BKV;
  const int lo = q0 - window + 1;     // first key row q0 sees
  j_begin = window && lo > 0 ? lo / BKV : 0;
  j_end = causal ? min(nkv, (q0 + BQ - 1) / BKV + 1) : nkv;
}

// ---- f32: CUDA cores, full f32 ------------------------------------------

template <int HD, int RQ, int BKV>
struct F32Tile {
  static constexpr int TX = 16;             // threads along keys: a
                                            // half-warp meets per row
  static constexpr int TY = kThreads / TX;  // threads along query rows
  static constexpr int BQ = TY * RQ;        // query rows per CTA
  static constexpr int CK = BKV / TX;       // logit columns per thread
  static constexpr int HD4 = HD / 4;        // 16-byte vectors in a row
  static constexpr int C4 = (HD4 + TX - 1) / TX;  // output vectors a row
  static constexpr int QS = HD + 4, KS = HD + 4, VS = HD, PS = BKV + 4;
  static constexpr size_t smem = sizeof(float) *
      ((size_t)BQ * QS + 2 * (size_t)BKV * KS + 2 * (size_t)BKV * VS +
       (size_t)BQ * PS);
};

template <int HD, int RQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int groups,
                 int causal, int window, float scale) {
  using F = F32Tile<HD, RQ, BKV>;
  constexpr int TX = F::TX, TY = F::TY, BQ = F::BQ, CK = F::CK;
  constexpr int HD4 = F::HD4, C4 = F::C4;
  constexpr int QS = F::QS, KS = F::KS, VS = F::VS, PS = F::PS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // (BQ, HD+4)
  float* Ks = Qs + BQ * QS;           // 2 x (BKV, HD+4)
  float* Vs = Ks + 2 * BKV * KS;      // 2 x (BKV, HD)
  float* Ps = Vs + 2 * BKV * VS;      // (BQ, BKV+4)

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // causal: most tiles first
  const int bh = blockIdx.y;
  const float* qb = q + (size_t)bh * Sq * HD;
  const float* kb = k + (size_t)(bh / groups) * Skv * HD;
  const float* vb = v + (size_t)(bh / groups) * Skv * HD;

  for (int e = tid; e < BQ * HD4; e += kThreads) {
    const int r = e / HD4, c = e % HD4;
    const bool in = q0 + r < Sq;
    cp_async16(Qs + r * QS + 4 * c, in ? qb + (size_t)(q0 + r) * HD + 4 * c
                                       : qb, in);
  }
  int j_begin, j_end;
  kv_range<BQ, BKV>(q0, Skv, causal, window, j_begin, j_end);
  // K and V of tile j into stage st; keys past Skv are zero-filled
  auto load_kv = [&](int st, int j) {
    const int k0 = j * BKV;
    for (int e = tid; e < BKV * HD4; e += kThreads) {
      const int r = e / HD4, c = e % HD4;
      const bool in = k0 + r < Skv;
      const size_t g = in ? (size_t)(k0 + r) * HD + 4 * c : 0;
      cp_async16(Ks + (st * BKV + r) * KS + 4 * c, kb + g, in);
      cp_async16(Vs + (st * BKV + r) * VS + 4 * c, vb + g, in);
    }
  };
  if (j_begin < j_end) load_kv(0, j_begin);
  cp_async_commit();

  float m[RQ], l[RQ], acc[RQ][C4][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int st = (j - j_begin) & 1;
    const int k0 = j * BKV;
    if (j + 1 < j_end) {               // next tile's copy overlaps this one
      load_kv(st ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * BKV * KS;
    const float* Vt = Vs + st * BKV * VS;

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = ld4(Qs + (ty + TY * i) * QS + d);
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = ld4(Kt + (tx + TX * c) * KS + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < CK; ++c)
            s[i][c] = fmaf(comp(qv[i], e), comp(kv[c], e), s[i][c]);
    }

    // a tile that every row sees whole needs no mask
    const bool whole = k0 + BKV <= Skv &&
                       (!causal || k0 + BKV - 1 <= q0) &&
                       (!window || q0 + BQ - 1 - k0 < window);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + TY * i;
      bool ok[CK];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kp = k0 + tx + TX * c;
        ok[c] = whole || (kp < Skv && (!causal || qp >= kp) &&
                          (!window || qp - kp < window));
        s[i][c] = ok[c] ? s[i][c] * scale : kNeg;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        Ps[(ty + TY * i) * PS + tx + TX * c] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ld4(Ps + (ty + TY * i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const int col = 4 * (tx + TX * c);
          if (HD4 % TX != 0 && col >= HD) continue;
          const float4 vv = ld4(Vt + (kk + e) * VS + col);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = comp(pv[i], e);
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();                   // stage st and Ps are free again
  }
  cp_async_wait<0>();

  float* ob = out + (size_t)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + qp] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int col = 4 * (tx + TX * c);
      if (HD4 % TX != 0 && col >= HD) continue;
      *reinterpret_cast<float4*>(ob + (size_t)qp * HD + col) =
          make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                      acc[i][c][2] / den, acc[i][c][3] / den);
    }
  }
}

template <int HD, int RQ, int BKV>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int Sq, int Skv, int groups, int causal,
               int window, float scale, cudaStream_t stream) {
  auto kern = flash_f32_kernel<HD, RQ, BKV>;
  constexpr size_t smem = F32Tile<HD, RQ, BKV>::smem;
  constexpr int BQ = F32Tile<HD, RQ, BKV>::BQ;
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, Sq, Skv, groups, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores (wgmma), TMA, warp specialisation -----------------

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kBf16Threads = 128 * (kConsumers + 1);
constexpr int kBM = 64 * kConsumers;             // query rows per CTA
constexpr int kBN = 64;                          // keys per tile
constexpr int kStages = 2;
constexpr int kSlab = 64 * 64 * 2;               // one 64 x 64 bf16 slab
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HDP>
struct Bf16Smem {
  // CTAs an SM: two at hd 64, where a consumer thread fits in 104
  // registers (O 32, S 32, P 16), one above. A CTA's consumers can take
  // only what its own producer gives back: launched at 80 a thread,
  // 128 x (80 - 24) >= 256 x (104 - 80)
  static constexpr int kCtas = HDP == 64 ? 2 : 1;
  static constexpr int NS = HDP / 64;            // slabs per 64-row block
  static constexpr int Q = kConsumers * NS * kSlab;
  static constexpr int KV = kStages * NS * kSlab;
  // Q, K ring, V ring, seven mbarriers, slack to align to 1024 bytes
  static constexpr size_t bytes = (size_t)Q + 2 * KV + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
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

// wgmma matrix descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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
// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64),
// B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {    // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD: the head dim stored; HDP: the head dim the tiles cover (a multiple
// of 64; columns HD .. HDP-1 are zero-filled by the TMA)
template <int HD, int HDP>
__global__ void __launch_bounds__(kBf16Threads, Bf16Smem<HDP>::kCtas)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tmQ,
                  const __grid_constant__ CUtensorMap tmK,
                  const __grid_constant__ CUtensorMap tmV,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv, int groups,
                  int causal, int window, float scale_log2) {
  using L = Bf16Smem<HDP>;
  constexpr int NS = L::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;                            // [warpgroup][slab]
  uint8_t* sK = sQ + L::Q;                       // [stage][slab]
  uint8_t* sV = sK + L::KV;                      // [stage][slab]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + L::KV);
  uint64_t* barQ = bars;
  uint64_t* fullK = bars + 1;
  uint64_t* fullV = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // causal: most first
  const int bh = blockIdx.y;
  const int kvh = bh / groups;
  int j_begin, j_end;
  kv_range<kBM, kBN>(q0, Skv, causal, window, j_begin, j_end);
  const int ntiles = j_end - j_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullK + s, 1);
      mbar_init(fullV + s, 1);
      mbar_init(empty + s, 4 * kConsumers);      // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA copy ----
    if constexpr (L::kCtas == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(barQ, L::Q);
      for (int w = 0; w < kConsumers; ++w)
        for (int s = 0; s < NS; ++s)
          tma_load_3d(sQ + (w * NS + s) * kSlab, &tmQ, barQ, 64 * s,
                      q0 + 64 * w, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages, ph = (t / kStages) & 1;
        const int k0 = (j_begin + t) * kBN;
        mbar_wait(empty + st, ph ^ 1);           // round 0 passes at once
        mbar_expect_tx(fullK + st, NS * kSlab);
        for (int s = 0; s < NS; ++s)
          tma_load_3d(sK + (st * NS + s) * kSlab, &tmK, fullK + st, 64 * s,
                      k0, kvh);
        mbar_expect_tx(fullV + st, NS * kSlab);
        for (int s = 0; s < NS; ++s)
          tma_load_3d(sV + (st * NS + s) * kSlab, &tmV, fullV + st, 64 * s,
                      k0, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    if constexpr (L::kCtas == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32, t4 = lane % 4;
    const int wq0 = q0 + 64 * wg;                // the warpgroup's first row
    const int qr0 = wq0 + 16 * warp + lane / 4;  // this thread's two rows
    const int qr1 = qr0 + 8;
    const uint32_t aQ = smem_u32(sQ + wg * NS * kSlab);

    float o[NS][32];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's part

    mbar_wait(barQ, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages, ph = (t / kStages) & 1;
      const int k0 = (j_begin + t) * kBN;
      // the tile test for this warpgroup's 64 rows
      const bool skip = (causal && k0 > wq0 + 63) ||
                        (window && wq0 - (k0 + kBN - 1) >= window);
      const bool whole = k0 + kBN <= Skv &&
                         (!causal || k0 + kBN - 1 <= wq0) &&
                         (!window || wq0 + 63 - k0 < window);
      uint32_t pa[4][4];
      mbar_wait(fullK + st, ph);
      if (!skip) {
        float s[32];
        const uint32_t aK = smem_u32(sK + st * NS * kSlab);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
          wgmma_ss(s, desc_sw128(aQ + off, 16, 1024),
                   desc_sw128(aK + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);

        // s[i] holds row qr0 for (i & 2) == 0, else qr1, at key
        // k0 + 8 (i / 4) + 2 t4 + (i & 1). A tile that every row of the
        // warpgroup sees whole takes no mask; otherwise masked logits are
        // -1e30 and a bit per logit forces their p to 0.
        uint32_t vis = 0xffffffffu;
        if (!whole) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qp = (i & 2) ? qr1 : qr0;
            const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
            const bool ok = kp < Skv && (!causal || qp >= kp) &&
                            (!window || qp - kp < window);
            vis &= ok ? 0xffffffffu : ~(1u << i);
            s[i] = ok ? s[i] : kNeg;
          }
        }
        float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // running maxima in log2 units: p = 2^(s * scale * log2 e - m)
        const float n0 = fmaxf(m0, mx0 * scale_log2);
        const float n1 = fmaxf(m1, mx1 * scale_log2);
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool r1 = i & 2;
          float p = ex2(fmaf(s[i], scale_log2, r1 ? -n1 : -n0));
          if (!whole) p = (vis >> i) & 1u ? p : 0.f;
          s[i] = p;
          if (r1) rs1 += p; else rs0 += p;
        }
        const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
        l0 = l0 * c0 + rs0;
        l1 = l1 * c1 + rs1;
        m0 = n0;
        m1 = n1;
        // the previous P V group has retired (wait_group 0 below), so O
        // may be rescaled in registers
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[sl][4 * j] *= c0;
            o[sl][4 * j + 1] *= c0;
            o[sl][4 * j + 2] *= c1;
            o[sl][4 * j + 3] *= c1;
          }
        // P (rounded to bf16) as wgmma's A fragments, 16 keys each
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
      mbar_wait(fullV + st, ph);
      if (!skip) {
        const uint32_t aV = smem_u32(sV + st * NS * kSlab);
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) reg_fence(o[sl]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int sl = 0; sl < NS; ++sl)
            wgmma_rs(o[sl], pa[kk],
                     desc_sw128(aV + sl * kSlab + kk * 16 * 128, 16, 1024));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) reg_fence(o[sl]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);    // this warp is done
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    // lse from the m and l of the rows' four threads (equal after the
    // shuffles): one writes it
    if (lse != nullptr && t4 == 0) {
      if (qr0 < Sq) lse[(size_t)bh * Sq + qr0] = fmaf(m0, kLn2, logf(d0));
      if (qr1 < Sq) lse[(size_t)bh * Sq + qr1] = fmaf(m1, kLn2, logf(d1));
    }
    __nv_bfloat16* ob = out + (size_t)bh * Sq * HD;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * sl + 8 * j + 2 * t4;
        if (HD != HDP && col >= HD) continue;
        if (qr0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr0 * HD + col) =
              __floats2bfloat162_rn(o[sl][4 * j] / d0,
                                    o[sl][4 * j + 1] / d0);
        if (qr1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr1 * HD + col) =
              __floats2bfloat162_rn(o[sl][4 * j + 2] / d1,
                                    o[sl][4 * j + 3] / d1);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
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

template <int HD, int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int BH, int Sq, int Skv, int groups, int causal,
                int window, float scale, cudaStream_t stream) {
  auto kern = flash_bf16_kernel<HD, HDP>;
  constexpr size_t smem = Bf16Smem<HDP>::bytes;
  // opt in once per instantiation (thread-safe static init), so a launch
  // inside CUDA graph capture makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, q, HD, Sq, BH) ||
      !tensor_map(&tk, encode, k, HD, Skv, BH / groups) ||
      !tensor_map(&tv, encode, v, HD, Skv, BH / groups))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + kBM - 1) / kBM, BH);
  kern<<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, (float*)lse, Sq, Skv, groups, causal,
      window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_fwd(int dtype, int hd, const void* q, const void* k,
                        const void* v, void* out, void* lse, int BH, int Sq,
                        int Skv, int groups, int causal, int window,
                        float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (hd) {
      case 64:
        return launch_f32<64, 4, 64>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                     causal, window, scale, s);
      case 80:
        return launch_f32<80, 4, 64>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                     causal, window, scale, s);
      case 128:
        return launch_f32<128, 8, 32>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                      causal, window, scale, s);
      case 256:
        return launch_f32<256, 4, 32>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                      causal, window, scale, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64:
        return launch_bf16<64, 64>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                   causal, window, scale, s);
      case 80:
        return launch_bf16<80, 128>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                    causal, window, scale, s);
      case 128:
        return launch_bf16<128, 128>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                     causal, window, scale, s);
      case 256:
        return launch_bf16<256, 256>(q, k, v, out, lse, BH, Sq, Skv, groups,
                                     causal, window, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
