#!/usr/bin/env python3
"""Time variants of the port's kernels on the card.

    python3 scripts/torch_kernel_variants.py [--only NAME ...] [--src DIR]

Each variant is the committed ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_bwd_bf16.cu``,
``csrc/ssd.cu``, ``csrc/ssd_bwd.cu`` or ``csrc/l1inf.cu`` (or the same
file under ``--src``: the ``scalar_*`` variants apply to the first SSD
backward's ``ssd_bwd.cu``, whose chunk kernel read its operands as
scalars, and ``mma_flash_bwd_bf16_phase_clocks`` to the first bf16 flash
backward's, mma.sync at every head dim) with a few exact text
substitutions: another tiling or launch bound, or one part of the work cut
out to see what it costs (a "diagnostic" variant, whose output is wrong by
design and whose error is reported, not checked). Every variant is
compiled with the port's ``nvcc`` flags into ``build/variants/`` (all at
once, in parallel), loaded with ``ctypes`` through the same C interface as
the wrappers, run at the main path's shapes (hymba-1.5b's prefill for
flash in f32 and bf16; the backward at ``chip_smoke.BWD_SHAPES``,
stablelm-3b's training attention and hymba-1.5b's prefill, with the device
ms of its two launches from one traced call; the bf16 backward at
``chip_smoke.BWD_BF16_SHAPES``, stablelm-3b's and hymba-1.5b's training
attention, the same way; hymba-1.5b's and
mamba2-370m's shapes for SSD, and their training shapes for the SSD
backward (``chip_smoke.SSD_BWD_SHAPES`` with dt in [3, 20]); for the
l1,inf engine, colstats and mu_solve on ``chip_smoke.py`` phase 2's inputs
and the Newton loop on the engine's state after pass 1, at ``sae_enc1``,
``fig2_wide`` and ``fig2_tall``), compared with the plain version, and
timed as ``chip_smoke.time_ms`` times a kernel (a CUDA graph of
back-to-back calls between CUDA events, inputs L2-warm). SSD variants also
get one traced call, for the device ms of each of their launches;
``ssd_bwd_phase_clocks`` also reports its chunk kernel's clock64() cycles
per CTA in each phase, ``flash_bwd_bf16_phase_clocks`` the bf16 flash
backward's (BWD_BF16_PHASES; ``mma_flash_bwd_bf16_phase_clocks`` the same
phases of the first design, with ``--src`` on a tree that has it), and
``newton_loop_phase_clocks`` (with
``cold_loop_phase_clocks`` for the first loop kernel's source) the Newton
loop's, beside its L2-flushed time; the ``*_empty`` variants run the loop
with nothing solved for as many steps as the plain loop takes. Prints one JSON line per variant, then the card's
name and power limit. Needs one CUDA card; exits non-zero without one.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")

_F32_SCORES = ("    for (int d = 0; d < HD; d += 4) {\n"
               "      float4 qv[RQ], kv[CK];")
_F32_PV = "    for (int kk = 0; kk < BKV; kk += 4) {\n      float4 pv[RQ];"
_F32_TILE = "launch_f32<64, 4, 64>"
_SSD_X = ("  load_transposed<Q, P>(x + ((size_t)bh * S + t0) * P, xT);\n"
          "  load_rows<Q, N>(Cm")
_SSD_OB = ("__launch_bounds__(kThreads, N <= 32 ? 3 : 2)\n"
           "ssd_chunk_output_kernel")
_MU_BOUNDS = "constexpr int min_ctas() { return VPL <= 32 ? 4 : 3; }"
# the ranks' per-pass exchange: a post, a cluster barrier, the reads
_COMBINE = ("  if (lane == 0) *slot = make_float2(a, b);\n"
            "  cluster.sync();\n"
            "  float2 p = make_float2(0.f, 0.f);\n"
            "  if (lane < S) p = *cluster.map_shared_rank(slot, lane);\n")
_LOOP_BOUNDS = "constexpr int min_loop_ctas() { return VPL <= 32 ? 2 : 3; }"
_STAT_S = ("const int S = n <= 1024 ? 1 : std::min(kMaxCluster, "
           "(n + 1023) / 1024);")
# the backward's phase A product loop, phase B's (all three products) and
# the point where the next tile's copy is issued
_BWD_A = ("        for (int d = 0; d < HD; d += 4) {\n"
          "          float4 kv[AK], vv[AK], qv[AQ], ov[AQ];")
_BWD_B = "  for (int t = 0; t < T; t += 2) {"
_BWD_NEXT = "      if (n + 1 < ntiles) load_tile(n + 1);\n      cp_async_commit();\n"
_DQ_PARTIALS = [
    ("constexpr bool kDqAdds = true;", "constexpr bool kDqAdds = false;"),
    ("                int n_kv_heads, int groups, float scale) {",
     "                int n_kv_heads, int groups, float scale,\n"
     "                float* __restrict__ part) {"),
    ("        if (p != 2 || !kDqAdds) continue;",
     "        if (p == 2) {\n"
     "          float* pb = part + (((size_t)h * nq + i) * tl.nkv\n"
     "                              + (j - tl.j_lo(i))) * (BQ * HD) + r0 * HD;\n"
     "          for (int r = 0; r < 8; ++r)\n"
     "            __stcg(reinterpret_cast<float4*>(pb + r * HD + c0),\n"
     "                   make_float4(acc[u][r][0], acc[u][r][1], acc[u][r][2],\n"
     "                               acc[u][r][3]));\n"
     "        }\n"
     "        if (p != 2 || !kDqAdds) continue;"),
    ("template <int HD, int BQ, int BKV>\nstruct Launcher {",
     "template <int HD, int BQ>\n"
     "__global__ void bwd_reduce_kernel(const float* __restrict__ part,\n"
     "                                  float* __restrict__ dq, Tiles t, int BH,\n"
     "                                  float scale) {\n"
     "  const long long g = (long long)blockIdx.x * 256 + threadIdx.x;\n"
     "  if (g >= (long long)BH * t.Sq * (HD / 4)) return;\n"
     "  const int c4 = g % (HD / 4);\n"
     "  const long long row = g / (HD / 4);\n"
     "  const int q = row % t.Sq, h = row / t.Sq, i = q / BQ;\n"
     "  const int n = t.j_hi(i) - t.j_lo(i) + 1;\n"
     "  const float* pb = part + ((size_t)h * t.nq + i) * t.nkv * (BQ * HD)\n"
     "                    + (q % BQ) * HD + 4 * c4;\n"
     "  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);\n"
     "  for (int sl = 0; sl < n; ++sl) {\n"
     "    const float4 v = __ldcs(reinterpret_cast<const float4*>(\n"
     "        pb + (size_t)sl * BQ * HD));\n"
     "    a = sl == 0 ? v : make_float4(a.x + v.x, a.y + v.y, a.z + v.z,\n"
     "                                  a.w + v.w);\n"
     "  }\n"
     "  reinterpret_cast<float4*>(dq)[g] =\n"
     "      make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);\n"
     "}\n\n"
     "template <int HD, int BQ, int BKV>\nstruct Launcher {\n"
     "  static float* partbuf(size_t need) {\n"
     "    static float* p = nullptr;\n"
     "    static size_t have = 0;\n"
     "    if (need > have) {\n"
     "      if (p) cudaFree(p);\n"
     "      if (cudaMalloc(&p, need * sizeof(float)) != cudaSuccess) return nullptr;\n"
     "      have = need;\n"
     "    }\n"
     "    return p;\n"
     "  }"),
    ("        kv_heads, groups, scale);\n    return (int)cudaGetLastError();",
     "        kv_heads, groups, scale, part);\n"
     "    err = cudaGetLastError();\n"
     "    if (err != cudaSuccess) return (int)err;\n"
     "    const long long tot = (long long)BH * Sq * (HD / 4);\n"
     "    bwd_reduce_kernel<HD, BQ><<<(unsigned)((tot + 255) / 256), 256, 0,\n"
     "                                stream>>>(part, dq, t, BH, scale);\n"
     "    return (int)cudaGetLastError();"),
    ("    const int kv_heads = BH / groups;",
     "    float* part = partbuf((size_t)BH * t.nq * t.nkv * BQ * HD);\n"
     "    if (!part) return (int)cudaErrorMemoryAllocation;\n"
     "    const int kv_heads = BH / groups;"),
]
# the first SSD backward's chunk kernel (scalar shared-memory loads): the
# loops of its serial phases (the
# suffix sums, ddaL, dcoef, phase E's one thread) and its product calls
_SCALAR_SERIAL = [
    ("  for (int j = tid; j < Q; j += kThreads) {\n    float run = 0.f;",
     "  for (int j = Q + tid; j < Q; j += kThreads) {\n    float run = 0.f;"),
    ("  for (int t = tid; t < Q; t += kThreads) {\n    float s = 0.f;",
     "  for (int t = Q + tid; t < Q; t += kThreads) {\n    float s = 0.f;"),
    ("  for (int j = tid; j < Q; j += kThreads) {\n    float s = 0.f;",
     "  for (int j = Q + tid; j < Q; j += kThreads) {\n    float s = 0.f;"),
    ("  if (tid == 0) {\n    float hsum", "  if (false) {\n    float hsum")]
_SCALAR_PRODUCTS = {
    "dM": "mm<Q, Q, P>(",
    "V": "mm<Q, P, N>(",
    "MTdy": "mm<Q, P, Q>(",
    "dB": "mm<Q, N, Q>([&](int j, int i) { return dGs",
    "xdh": "mm<Q, N, P>([&](int j, int p)",
    "dC": "mm<Q, N, Q>([&](int i, int j) { return dGs",
    "dyh": "mm<Q, N, P>([&](int i, int p)"}
# the SSD backward: the loop heads of its chunk kernel's products (Q 64)
# and of the state walk's, its serial phases, the head-sum launch
_BWD_PRODUCTS = {
    "dM": "    for (int p = 0; p < P; p += 4) {\n      const float4 a0",
    "V": "      for (int n = 0; n < NS; n += 4) {\n        float4 hv[4], bv[4];",
    "dB": "          for (int i = 16 * q; i < 16 * q + 16; i += 4) {\n"
          "            float4 cv[TN];",
    "xdh": "        for (int p = 0; p < P; p += 4) {\n          float4 xv[4];",
    "dC": "          for (int j = 16 * q; j < 16 * q + 16; j += 4) {\n"
          "            float4 gv[4];",
    "dyh": "        for (int p = 0; p < P; p += 4) {\n          float4 yv[4];",
    "MTdy": "      for (int i = 16 * q; i < 16 * q + 16; i += 4) {\n"
            "        float4 mv[4];",
    "state": "  for (int i = 0; i < Q; ++i) {\n    const float4 cv"}


def _cut(head):
    """The loop at ``head`` run zero times: its start set to its end."""
    start = head.split("= ")[1].split(";")[0]
    end = head.split("< ")[1].split(";")[0]
    return head.replace(f"= {start};", f"= {end};", 1)


_BWD_SERIAL = [
    ("  const bool zcol = tid < NSEG * Q;", "  const bool zcol = false;"),
    ("for (int j = 16 * s; j < min(16 * s + 16, t); ++j)",
     "for (int j = t; j < t; ++j)"),
    ("      for (int p = 16 * s; p < 16 * s + 16; ++p)",
     "      for (int p = 0; p < 0; ++p)"),
    ("  if (warp == 0) warp_scan<Q, true>(dcumE, dda, lane);\n"
     "  if (warp == 1) warp_scan<Q, false>(kc, kc, lane);",
     "  if (false) warp_scan<Q, true>(dcumE, dda, lane);\n"
     "  if (false) warp_scan<Q, false>(kc, kc, lane);")]
# the chunk kernel's product step loops (pragma, head): as committed
# (unrolled), and rolled in the ssd_bwd_rolled variant
_STEP_LOOPS = [
    ("#pragma unroll 2\n",
     "    for (int p = 0; p < P; p += 4) {\n      const float4 a0"),
    ("", "      for (int n = 0; n < NS; n += 4) {\n        float4 hv[4], bv[4];"),
    ("#pragma unroll\n", "          for (int i = 16 * q; i < 16 * q + 16; i += 4) {\n"
                        "            float4 cv[TN];"),
    ("#pragma unroll 4\n",
     "        for (int p = 0; p < P; p += 4) {\n          float4 xv[4];"),
    ("#pragma unroll\n", "          for (int j = 16 * q; j < 16 * q + 16; j += 4) {\n"
                        "            float4 gv[4];"),
    ("#pragma unroll 4\n",
     "        for (int p = 0; p < P; p += 4) {\n          float4 yv[4];"),
    ("#pragma unroll\n", "      for (int i = 16 * q; i < 16 * q + 16; i += 4) {\n"
                        "        float4 mv[4];")]
_ROLLED = [(pragma + head, "#pragma unroll 1\n" + head)
           for pragma, head in _STEP_LOOPS]
# thread 0 of each chunk-kernel CTA stamps clock64() at its phase bounds
# (after the first loads; phase 1's product, its epilogue; phase 2; the
# slices; v's stores, the dx product, its stores; the block sums, dcoef,
# the end) and adds the gaps to a device array; the variant's
# ssd_bwd_phase_clocks reads the sums (then zeroes them)
_STAMP = "  if (tid == 0) stamp_[{k}] = clock64();\n"
_NSTAMP = 13
_PHASES = [
    ("  const float* gb = G + ((size_t)bg * nc + ch) * Q * Q;\n",
     "  const float* gb = G + ((size_t)bg * nc + ch) * Q * Q;\n"
     f"  long long stamp_[{_NSTAMP}];\n" + _STAMP.format(k=0)),
    ("    __syncthreads();\n    float acc[10] = {};\n",
     "    __syncthreads();\n" + _STAMP.format(k=1) + "    float acc[10] = {};\n"),
    ("#pragma unroll\n    for (int o = 0; o < 10; ++o)\n      put_dm(",
     _STAMP.format(k=2) + "#pragma unroll\n    for (int o = 0; o < 10; ++o)\n      put_dm("),
    ("  __syncthreads();\n\n  // phase 2:",
     "  __syncthreads();\n" + _STAMP.format(k=3) + "\n  // phase 2:"),
    ("  __syncthreads();                  // Z is dead: the slices take its place\n",
     "  __syncthreads();\n" + _STAMP.format(k=4)),
    ("  __syncthreads();                  // the last slice is read: v takes R\n",
     "  __syncthreads();\n" + _STAMP.format(k=5)),
    ("    // M^T dy: i in segment q feeds the columns j = tx + 16 c, c <= q\n",
     _STAMP.format(k=6) + "    // M^T dy: i in segment q feeds the columns j = tx + 16 c, c <= q\n"),
    ("#pragma unroll\n    for (int c = 0; c < 4; ++c) {\n      const int j = tx + 16 * c;\n"
     "      float o[4];",
     _STAMP.format(k=7) + "#pragma unroll\n    for (int c = 0; c < 4; ++c) {\n"
     "      const int j = tx + 16 * c;\n      float o[4];"),
    ("  // the sum of dy * x: each thread's entries",
     _STAMP.format(k=8) + "  // the sum of dy * x: each thread's entries"),
    ("    wred[8 + warp] = ddsum;\n  }\n  __syncthreads();\n",
     "    wred[8 + warp] = ddsum;\n  }\n  __syncthreads();\n" + _STAMP.format(k=9)),
    ("    dcumE[i] = __fmul_rn(ec[i], dcacc[i]);\n  __syncthreads();\n",
     "    dcumE[i] = __fmul_rn(ec[i], dcacc[i]);\n  __syncthreads();\n"
     + _STAMP.format(k=10)),
    ("      o[0] = dap;\n      o[1] = dd8;\n    }\n  }\n}\n",
     "      o[0] = dap;\n      o[1] = dd8;\n    }\n  }\n" + _STAMP.format(k=11)
     + f"  if (tid == 0)\n    for (int k = 0; k < {_NSTAMP - 2}; ++k)\n"
     "      atomicAdd(&g_phase_clocks[k], "
     "(unsigned long long)(stamp_[k + 1] - stamp_[k]));\n}\n"),
    ("namespace {\n\nconstexpr int kThreads = 256;",
     f"__device__ unsigned long long g_phase_clocks[{_NSTAMP - 2}];\n"
     "namespace {\n\nconstexpr int kThreads = 256;"),
    ("const char* ssd_bwd_error_string(int code) {",
     "int ssd_bwd_phase_clocks(unsigned long long* out) {\n"
     "  cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));\n"
     f"  static const unsigned long long zero[{_NSTAMP - 2}] = {{}};\n"
     "  cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));\n"
     "  return (int)cudaGetLastError();\n}\n\n"
     "const char* ssd_bwd_error_string(int code) {")]
# The Newton loop kernel's phases: thread 0 of each CTA stamps clock64() at
# the end of each phase and adds the gap to a per-CTA sum in shared memory
# (phase_mark); at the kernel's end the sums go to a device array with the
# CTA count (phase_mark(-2)), which the variant's l1inf_phase_clocks reads
# (then zeroes). Phases: the column load, the colmax (and colsum) pass,
# the bisection, the polish, the payloads, the column sums and the posting,
# the wait at grid.sync(), update, the alive-prefix count (in the
# committed kernel: each group's alive test) and the warm Michelot steps.
LOOP_PHASES = ("load", "stats", "bisect", "polish", "payloads", "colsums",
               "grid_sync", "update", "nact", "warm")
_NPH = len(LOOP_PHASES)
_PHASE_MARK = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n\n"
     f"__device__ unsigned long long g_phase_clocks[{_NPH + 1}];\n\n"
     "__device__ __forceinline__ void phase_mark(int k) {\n"
     "  __shared__ long long last_;\n"
     f"  __shared__ unsigned long long acc_[{_NPH}];\n"
     "  if (threadIdx.x != 0) return;\n"
     "  const long long now = clock64();\n"
     f"  if (k == -1) for (int j = 0; j < {_NPH}; ++j) acc_[j] = 0;\n"
     "  if (k == -2) {\n"
     f"    for (int j = 0; j < {_NPH}; ++j) atomicAdd(&g_phase_clocks[j], acc_[j]);\n"
     f"    atomicAdd(&g_phase_clocks[{_NPH}], 1ull);\n"
     "    return;\n  }\n"
     "  if (k >= 0) acc_[k] += (unsigned long long)(now - last_);\n"
     "  last_ = clock64();\n}\n"),
    ("const char* l1inf_error_string(int code) {",
     "int l1inf_phase_clocks(unsigned long long* out) {\n"
     "  cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));\n"
     f"  static const unsigned long long zero[{_NPH + 1}] = {{}};\n"
     "  cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));\n"
     "  return (int)cudaGetLastError();\n}\n\n"
     "const char* l1inf_error_string(int code) {")]
# the first loop kernel (every Newton step a cold 36-pass mu_solve over
# columns reloaded from global memory, every CTA rescanning the alive
# prefix): apply to its l1inf.cu with --src
_COLD_LOOP_MARKS = _PHASE_MARK + [
    ("  __syncthreads();\n  unsigned pass = 0;\n\n",
     "  __syncthreads();\n  unsigned pass = 0;\n  phase_mark(-1);\n\n"),
    ("    bound = last + 1;\n    return",
     "    bound = last + 1;\n    phase_mark(8);\n    return"),
    ("      load_slab<VPL, TL>(a.A, a.m, c0, r0, r1, tile, v);\n",
     "      load_slab<VPL, TL>(a.A, a.m, c0, r0, r1, tile, v);\n"
     "      phase_mark(0);\n"),
    ("  const bool active = colsum > th;\n",
     "  const bool active = colsum > th;\n  phase_mark(1);\n"),
    ("  // Michelot polish from below", "  phase_mark(2);\n"
     "  // Michelot polish from below"),
    ("  mu = fmaxf(mu, 0.f);\n\n  // exact payloads",
     "  phase_mark(3);\n  mu = fmaxf(mu, 0.f);\n\n  // exact payloads"),
    ("  return Solved{mu, fmaxf(cnt, 1.f), ssum, active};",
     "  phase_mark(4);\n  return Solved{mu, fmaxf(cnt, 1.f), ssum, active};"),
    ("        // the next load_slab's first barrier orders colres's reuse\n",
     "        phase_mark(5);\n"),
    ("          __stcg(dst + t, acc[t]);\n        }\n      }\n",
     "          __stcg(dst + t, acc[t]);\n        }\n      }\n"
     "      phase_mark(5);\n"),
    ("  grid.sync();\n  bool moved = update(buf);\n",
     "  grid.sync();\n  phase_mark(6);\n  bool moved = update(buf);\n"
     "  phase_mark(7);\n"),
    ("    grid.sync();\n    moved = update(buf);\n",
     "    grid.sync();\n    phase_mark(6);\n    moved = update(buf);\n"
     "    phase_mark(7);\n"),
    ("      a.stats[2] = (long long)nfinal * a.bm;\n    }\n  }\n",
     "      a.stats[2] = (long long)nfinal * a.bm;\n    }\n  }\n"
     "  phase_mark(-2);\n")]
# the committed loop kernel (warm steps, the polish ending at its first
# step that does not raise the level, so its payloads are that step's)
_LOOP_MARKS = _PHASE_MARK + [
    ("  __syncthreads();\n  unsigned pass = 0;\n\n",
     "  __syncthreads();\n  unsigned pass = 0;\n  phase_mark(-1);\n\n"),
    ("      if (__syncthreads_or(alive)) {\n",
     "      const bool any_alive = __syncthreads_or(alive);\n"
     "      phase_mark(8);\n      if (any_alive) {\n"),
    ("        fetch_slab<VPL, TL>(tile, v);\n",
     "        fetch_slab<VPL, TL>(tile, v);\n        phase_mark(0);\n"),
    ("        const bool cold = alive && !ok;\n",
     "        phase_mark(9);\n        const bool cold = alive && !ok;\n"),
    ("            cmax = mx;\n          }\n",
     "            cmax = mx;\n          }\n          phase_mark(1);\n"),
    ("          float mc = lo, kc = 1.f, sc = 0.f;\n",
     "          phase_mark(2);\n          float mc = lo, kc = 1.f, sc = 0.f;\n"),
    ("          if (cold) {\n            mu = mc;\n",
     "          phase_mark(3);\n          if (cold) {\n            mu = mc;\n"),
    ("                                              lane));\n      }\n",
     "                                              lane));\n      }\n"
     "      phase_mark(5);\n"),
    ("      posted[0] = last < 0 ? 0 : (last / T::kCols - cl) / ncl + 1;\n"
     "    }\n",
     "      posted[0] = last < 0 ? 0 : (last / T::kCols - cl) / ncl + 1;\n"
     "    }\n    phase_mark(5);\n"),
    ("  grid.sync();\n  bool moved = update(buf, true);\n",
     "  grid.sync();\n  phase_mark(6);\n  bool moved = update(buf, true);\n"
     "  phase_mark(7);\n"),
    ("    grid.sync();\n    moved = update(buf, true);\n",
     "    grid.sync();\n    phase_mark(6);\n    moved = update(buf, true);\n"
     "    phase_mark(7);\n"),
    ("      a.stats[2] = (long long)nact() * a.bm;\n    }\n  }\n",
     "      a.stats[2] = (long long)nact() * a.bm;\n    }\n  }\n"
     "  phase_mark(-2);\n")]
# staging a group's tile: the Newton loop with the scalar loads mu_solve
# keeps (its 16-byte loads off), and the same as 4-byte cp.async copies
# with |.| taken when the lanes fetch their values
_VEC4 = "(int)(m % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0)};"
_SCALAR_LOADS = [(_VEC4, "0};")]
_STAGE = ("      float x = 0.f;\n"
          "      if (row < r1 && col < m) x = fabsf(A[(size_t)row * m + col]);\n"
          "      tile[r * T::kStride + c] = x;\n")
_STAGE_CP = _SCALAR_LOADS + [
    (_STAGE, "      const bool in = row < r1 && col < m;\n"
     "      const unsigned dst = (unsigned)__cvta_generic_to_shared(\n"
     "          tile + r * T::kStride + c);\n"
     "      asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4, %2;\\n\"\n"
     "                   :: \"r\"(dst), \"l\"(A + (in ? (size_t)row * m + col : 0)),\n"
     "                   \"r\"(in ? 4 : 0));\n"),
    ("    }\n  }\n  __syncthreads();\n}\n",
     "    }\n    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "  }\n  __syncthreads();\n}\n"),
    ("    v[i] = tile[(rl + TL * i) * T::kStride + w * T::kCPW + sub];",
     "    v[i] = fabsf(tile[(rl + TL * i) * T::kStride + w * T::kCPW + sub]);")]
# the same grid and grid.sync() count with no solve: no group is visited
# and every step "moves", so the loop runs to max_newton (the runner passes
# the plain loop's Newton count)
_LOOP_EMPTY = [
    ("    for (int i = 0; i < visit; ++i) {",
     "    for (int i = visit; i < visit; ++i) {"),
    ("    return __syncthreads_or(moved) != 0;",
     "    return __syncthreads_or(moved) >= 0;")]
# the same grid and grid.sync() count with no work: no column is solved,
# the prefix scan is cut and every step "moves", so the loop runs to
# max_newton (the runner passes the committed kernel's Newton count)
_COLD_LOOP_EMPTY = [
    ("    for (int g = cl; g < ngroups; g += ncl) {",
     "    for (int g = ngroups; g < ngroups; g += ncl) {"),
    ("    for (int c = threadIdx.x; c < bound; c += kThreads) {",
     "    for (int c = bound; c < bound; c += kThreads) {"),
    ("    return __syncthreads_or(moved) != 0;",
     "    return __syncthreads_or(moved) >= 0;")]

# the bf16 flash backward's phase clocks: consumer thread 0 of each CTA
# adds the clock64() gap since its last stamp to phase k (BWD_BF16_PHASES:
# 0 items (claim, K and V, dk / dv stores), 1 the wait for a tile's loads,
# 2 S^T and dP^T, 3 P and dS on the fragments, 4 dv and dk, 5 dS^T to
# shared memory and the barrier, 6 dq's product, 7 the wait for dq's turn,
# 8 its read-add-write); the dv / dk products are waited for before the dS
# stores, so that their time is their own. The variant's
# flash_attention_bwd_bf16_clocks reads the sums and the CTA count (then
# zeroes them)
BWD_BF16_PHASES = ("items", "loads", "s_dp", "p_ds", "dv_dk", "ds_smem",
                   "dq", "dq_turn_wait", "dq_add")
_CLOCK_DEFS = (
    f"constexpr int kClockPhases = {len(BWD_BF16_PHASES)};\n"
    "__device__ unsigned long long g_bwd_clocks[kClockPhases + 1];\n"
    "#define CLOCK_START() unsigned long long clk_[kClockPhases] = {}; "
    "long long clk_last_ = clock64()\n"
    "#define CLOCK(k) if (threadIdx.x == 0) { const long long now_ = "
    "clock64(); clk_[k] += (unsigned long long)(now_ - clk_last_); "
    "clk_last_ = now_; }\n"
    "#define CLOCK_END() if (threadIdx.x == 0) { for (int k_ = 0; k_ < "
    "kClockPhases; ++k_) atomicAdd(&g_bwd_clocks[k_], clk_[k_]); "
    "atomicAdd(&g_bwd_clocks[kClockPhases], 1ull); }\n")
_CLOCK_READ = (
    "const char* flash_attention_bwd_bf16_error_string(int code) {",
    "int flash_attention_bwd_bf16_clocks(unsigned long long* out) {\n"
    "  cudaMemcpyFromSymbol(out, g_bwd_clocks, sizeof(g_bwd_clocks));\n"
    "  static const unsigned long long zero[kClockPhases + 1] = {};\n"
    "  cudaMemcpyToSymbol(g_bwd_clocks, zero, sizeof(zero));\n"
    "  return (int)cudaGetLastError();\n}\n\n"
    "const char* flash_attention_bwd_bf16_error_string(int code) {")
_BWD_BF16_CLOCKS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + _CLOCK_DEFS),
    ("\n  for (int ic = 0;; ++ic) {\n",
     "\n  CLOCK_START();\n  for (int ic = 0;; ++ic) {\n"),
    ("    mbar_wait(fullKV, ic & 1);\n",
     "    mbar_wait(fullKV, ic & 1);\n    CLOCK(0);\n"),
    ("      mbar_wait(fullT + st, (tc >> 1) & 1);\n",
     "      mbar_wait(fullT + st, (tc >> 1) & 1);\n      CLOCK(1);\n"),
    ("      if (kPipe && pctr) fetch();  // the last tile's old sums\n",
     "      if (kPipe && pctr) {\n        CLOCK(2);\n        fetch();\n"
     "        CLOCK(7);\n      }\n"),
    ("      reg_fence(s);\n      reg_fence(dp);\n",
     "      reg_fence(s);\n      reg_fence(dp);\n      CLOCK(2);\n"),
    ("      if (kPipe && pctr) finish();  // the last tile's add\n",
     "      CLOCK(3);\n      if (kPipe && pctr) {\n        finish();\n"
     "        CLOCK(8);\n      }\n"),
    ("      wgmma_commit();\n\n      // 4. dS^T",
     "      wgmma_commit();\n      wgmma_wait0();\n      CLOCK(4);\n\n"
     "      // 4. dS^T"),
    ("      consumers_sync();            // dS^T of both strips written\n",
     "      consumers_sync();            // dS^T of both strips written\n"
     "      CLOCK(5);\n"),
    ("      reg_fence(dqa);\n      reg_fence(dqr);\n",
     "      reg_fence(dqa);\n      reg_fence(dqr);\n      CLOCK(6);\n"),
    ("        fetch();\n        finish();\n",
     "        fetch();\n        CLOCK(7);\n        finish();\n"
     "        CLOCK(8);\n"),
    ("      fetch();\n      finish();\n    }\n",
     "      fetch();\n      CLOCK(7);\n      finish();\n      CLOCK(8);\n"
     "    }\n"),
    ("  if (lane == 0) mbar_arrive(added + (bc & 1));\n}\n",
     "  if (lane == 0) mbar_arrive(added + (bc & 1));\n  CLOCK(0);\n"
     "  CLOCK_END();\n}\n"),
    _CLOCK_READ]
# the same phases stamped into the first (mma.sync) design's source
# (run with --src on a tree that has it): thread 0 of each
# CTA; its phase A is S^T / dP^T (2) and P / dS with their shared-memory
# stores (3), its barrier and bump 5, phase B dv / dk (4), then dq
_MMA_CLOCKS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + _CLOCK_DEFS),
    ("  if (tid == 0) *item_s = atomicAdd(work, 1);\n  __syncthreads();\n"
     "  int item = *item_s;\n",
     "  CLOCK_START();\n"
     "  if (tid == 0) *item_s = atomicAdd(work, 1);\n  __syncthreads();\n"
     "  int item = *item_s;\n"),
    ("    for (int n = 0; n < ntiles; ++n) {\n      cp_async_wait_all();",
     "    CLOCK(0);\n"
     "    for (int n = 0; n < ntiles; ++n) {\n      cp_async_wait_all();"),
    ("      if (n + 1 < ntiles) load_tile(n + 1);\n      cp_async_commit();\n",
     "      if (n + 1 < ntiles) load_tile(n + 1);\n      cp_async_commit();\n"
     "      CLOCK(1);\n"),
    ("        // element e of n8 tile t: key 16 ka + g8",
     "        CLOCK(2);\n        // element e of n8 tile t: key 16 ka + g8"),
    ("      __syncthreads();        // P^T, dS^T written; last tile's dq stored",
     "      CLOCK(3);\n"
     "      __syncthreads();        // P^T, dS^T written; last tile's dq stored"),
    ("      pending = ctr;\n", "      pending = ctr;\n      CLOCK(5);\n"),
    ("      // this tile's dq part dS k: queries",
     "      CLOCK(4);\n      // this tile's dq part dS k: queries"),
    ("      // dq rows: the first turn stores, the others add in turn order, the",
     "      CLOCK(6);\n"
     "      // dq rows: the first turn stores, the others add in turn order, the"),
    ("        __syncwarp();\n      }\n#pragma unroll\n"
     "      for (int half = 0; half < 2; ++half) {\n"
     "        const int qp = q0 + 16 * qb + g8 + 8 * half;",
     "        __syncwarp();\n      }\n      CLOCK(7);\n#pragma unroll\n"
     "      for (int half = 0; half < 2; ++half) {\n"
     "        const int qp = q0 + 16 * qb + g8 + 8 * half;"),
    ("            __stcg(acc, o);\n        }\n      }\n    }\n"
     "    cp_async_wait_all();",
     "            __stcg(acc, o);\n        }\n      }\n      CLOCK(8);\n    }\n"
     "    cp_async_wait_all();"),
    ("    __syncthreads();          // the next item's claim is visible\n"
     "    item = *item_s;\n  }\n}\n",
     "    __syncthreads();          // the next item's claim is visible\n"
     "    item = *item_s;\n  }\n  CLOCK(0);\n  CLOCK_END();\n}\n"),
    _CLOCK_READ]
# name -> (source, diagnostic, [(old, new), ...])
VARIANTS = {
    "l1inf": ("l1inf.cu", False, []),
    "l1inf_ctas_unbounded": ("l1inf.cu", False, [
        (_MU_BOUNDS, "constexpr int min_ctas() { return 1; }"),
        (_LOOP_BOUNDS, "constexpr int min_loop_ctas() { return 1; }")]),
    "mu_solve_no_cluster_exchange": ("l1inf.cu", True, [
        (_COMBINE, "  float2 p = make_float2(a, b);\n")]),
    "mu_solve_no_bisect_shuffles": ("l1inf.cu", True, [
        ("\n    float removed = lanes_sum<TL>(removed_at(v, mid));",
         "\n    float removed = removed_at(v, mid);")]),
    "colstats_one_cta": ("l1inf.cu", False, [(_STAT_S, "const int S = 1;")]),
    "newton_loop_2_ctas": ("l1inf.cu", False, [
        (_LOOP_BOUNDS, "constexpr int min_loop_ctas() { return 2; }")]),
    "newton_loop_3_ctas": ("l1inf.cu", False, [
        (_LOOP_BOUNDS, "constexpr int min_loop_ctas() { return 3; }")]),
    "newton_loop_phase_clocks": ("l1inf.cu", False, _LOOP_MARKS),
    "newton_loop_scalar_loads": ("l1inf.cu", False, _SCALAR_LOADS),
    "stage_cp_async": ("l1inf.cu", False, _STAGE_CP),
    "newton_loop_empty": ("l1inf.cu", True, _LOOP_EMPTY),
    "cold_loop_phase_clocks": ("l1inf.cu", False, _COLD_LOOP_MARKS),
    "cold_loop_empty": ("l1inf.cu", True, _COLD_LOOP_EMPTY),
    "flash": ("flash_attention.cu", False, []),
    "flash_f32_tile_128x64": ("flash_attention.cu", False, [
        (_F32_TILE, "launch_f32<64, 8, 64>")]),
    "flash_f32_no_scores": ("flash_attention.cu", True, [
        (_F32_SCORES, _F32_SCORES.replace("d = 0", "d = HD"))]),
    "flash_f32_no_pv": ("flash_attention.cu", True, [
        (_F32_PV, _F32_PV.replace("kk = 0", "kk = BKV"))]),
    "flash_f32_no_products": ("flash_attention.cu", True, [
        (_F32_SCORES, _F32_SCORES.replace("d = 0", "d = HD")),
        (_F32_PV, _F32_PV.replace("kk = 0", "kk = BKV"))]),
    "flash_f32_no_exp": ("flash_attention.cu", True, [
        ("ok[c] ? expf(s[i][c] - m_new) : 0.f;",
         "ok[c] ? (s[i][c] - m_new) : 0.f;")]),
    "flash_bf16_one_cta": ("flash_attention.cu", False, [
        ("static constexpr int kCtas = HDP == 64 ? 2 : 1;",
         "static constexpr int kCtas = 1;")]),
    "flash_bf16_no_qk": ("flash_attention.cu", True, [
        ("          wgmma_ss(s, desc_sw128",
         "          if (0) wgmma_ss(s, desc_sw128")]),
    "flash_bf16_no_pv": ("flash_attention.cu", True, [
        ("            wgmma_rs(o[sl], pa[kk],",
         "            if (0) wgmma_rs(o[sl], pa[kk],")]),
    "flash_bf16_no_exp": ("flash_attention.cu", True, [
        ("float p = ex2(fmaf(", "float p = (fmaf(")]),
    "flash_bwd": ("flash_attention_bwd.cu", False, []),
    # a diagnostic: no dq read-add-writes and no turn waits (dq wrong)
    "flash_bwd_no_dq_adds": ("flash_attention_bwd.cu", True, [
        ("constexpr bool kDqAdds = true;", "constexpr bool kDqAdds = false;")]),
    "flash_bwd_no_exp": ("flash_attention_bwd.cu", True, [
        ("ok ? exp2f(fmaf(s[a][c], scale * kLog2e, -Ls[qq] * kLog2e))",
         "ok ? (fmaf(s[a][c], scale * kLog2e, -Ls[qq] * kLog2e))")]),
    # each tile's copy waited for before its arithmetic, as one buffer would
    "flash_bwd_single_buffered": ("flash_attention_bwd.cu", False, [
        (_BWD_NEXT, _BWD_NEXT + "      cp_async_wait_all();\n")]),
    "flash_bwd_no_phase_a": ("flash_attention_bwd.cu", True, [
        (_BWD_A, _BWD_A.replace("d = 0", "d = HD"))]),
    "flash_bwd_no_phase_b": ("flash_attention_bwd.cu", True, [
        (_BWD_B, _BWD_B.replace("t = 0", "t = T"))]),
    "flash_bwd_a_unroll_4": ("flash_attention_bwd.cu", False, [
        ("#pragma unroll 2\n" + _BWD_A, "#pragma unroll 4\n" + _BWD_A)]),
    "flash_bwd_mac_unroll_2": ("flash_attention_bwd.cu", False, [
        ("#pragma unroll 4\n" + _BWD_B, "#pragma unroll 2\n" + _BWD_B)]),
    # the old dq read straight from L2 after the dq part, not staged
    "flash_bwd_no_dq_staging": ("flash_attention_bwd.cu", False, [
        ("static constexpr bool STAGE =",
         "static constexpr bool STAGE = false &&")]),
    # diagnostics of the dq turns: no waits (a turn not yet come is not
    # waited for), no fence before the bump (both can give a wrong dq)
    "flash_bwd_no_turn_waits": ("flash_attention_bwd.cu", True, [
        ("        for (int spins = 0; !ready; ++spins) {",
         "        for (int spins = 0; false; ++spins) {")]),
    "flash_bwd_no_fence": ("flash_attention_bwd.cu", True, [
        ("      if (kDqAdds && tid == 0 && pending) {\n        __threadfence();",
         "      if (kDqAdds && tid == 0 && pending) {")]),
    # the other dq route: each kv tile's dq part stored to its own slot of
    # a scratch buffer (allocated by the launcher here), no turns, and a
    # second pass that sums the slots in ascending kv tile and scales
    "flash_bwd_dq_partials": ("flash_attention_bwd.cu", False, _DQ_PARTIALS),
    # the bf16 backward as it stands (the source under --src), with its
    # phase clocks, and the first (mma.sync) design's phase clocks (run
    # with --src on a tree that has it)
    "flash_bwd_bf16": ("flash_attention_bwd_bf16.cu", False, []),
    "flash_bwd_bf16_phase_clocks": ("flash_attention_bwd_bf16.cu", False,
                                    _BWD_BF16_CLOCKS),
    "mma_flash_bwd_bf16_phase_clocks": ("flash_attention_bwd_bf16.cu", False,
                                        _MMA_CLOCKS),
    # the first SSD backward (run with --src on a tree that has it): cuts
    # of its chunk kernel's serial phases and of each of its products
    "scalar_ssd_bwd": ("ssd_bwd.cu", False, []),
    "scalar_ssd_bwd_no_serial": ("ssd_bwd.cu", True, _SCALAR_SERIAL),
    "scalar_ssd_bwd_no_products": ("ssd_bwd.cu", True, [
        ("  for (int k = 0; k < K; ++k) {", "  for (int k = K; k < K; ++k) {")]),
    **{f"scalar_ssd_bwd_no_{cut}": ("ssd_bwd.cu", True, [
        (call, "if (0) " + call)]) for cut, call in _SCALAR_PRODUCTS.items()},
    # the redesigned SSD backward: cuts of its serial phases, of each
    # product and of all of them, of the head-sum launch, and its chunk
    # kernel held to one CTA an SM (its shared memory request doubled)
    "ssd_bwd": ("ssd_bwd.cu", False, []),
    "ssd_bwd_no_serial": ("ssd_bwd.cu", True, _BWD_SERIAL),
    "ssd_bwd_no_products": ("ssd_bwd.cu", True, [
        (h, _cut(h)) for h in _BWD_PRODUCTS.values()]),
    **{f"ssd_bwd_no_{cut}": ("ssd_bwd.cu", True, [(h, _cut(h))])
       for cut, h in _BWD_PRODUCTS.items()},
    "ssd_bwd_no_sum": ("ssd_bwd.cu", True, [
        ("    ssd_bwd_sum_kernel<<<", "    if (0) ssd_bwd_sum_kernel<<<")]),
    # diagnostics of the chunk kernel's other work: no exp in the decay
    # tile, no global reads of x and dy, none of the slices, no stores of
    # dx, dB and dC
    "ssd_bwd_no_decay_exp": ("ssd_bwd.cu", True, [
        ("    const float L = expf(__fsub_rn(cum[i], cum[j]));",
         "    const float L = __fsub_rn(cum[i], cum[j]);")]),
    "ssd_bwd_no_xdy_reads": ("ssd_bwd.cu", True, [
        ("  load_rows<Q, P, XS>(x + row0 * P, P, xs);\n"
         "  load_rows<Q, P, XS>(dy + row0 * P, P, dys);\n", "")]),
    "ssd_bwd_no_slice_reads": ("ssd_bwd.cu", True, [
        ("  fetch(0);\n", ""),
        ("    if (sl + 1 < NSL) fetch(sl + 1);\n", "")]),
    "ssd_bwd_no_stores": ("ssd_bwd.cu", True, [
        ("            dBp[(row0 + j) * N + n0 + np + 8 * m] =",
         "            if (0) dBp[(row0 + j) * N + n0 + np + 8 * m] ="),
        ("            dCp[(row0 + i) * N + n0 + np + 8 * m] =",
         "            if (0) dCp[(row0 + i) * N + n0 + np + 8 * m] ="),
        ("      *reinterpret_cast<float4*>(dx + (row0 + j) * P + 4 * ty) =",
         "      if (0) *reinterpret_cast<float4*>(dx + (row0 + j) * P + 4 * ty) =")]),
    # the chunk kernel's product loops rolled over their steps (a smaller
    # body of code)
    "ssd_bwd_rolled": ("ssd_bwd.cu", False, _ROLLED),
    "ssd_bwd_phase_clocks": ("ssd_bwd.cu", False, _PHASES),
    "ssd_bwd_chunk_1_cta": ("ssd_bwd.cu", False, [
        ("  static constexpr size_t smem2 = ChunkSmem<Q, N>::bytes;",
         "  static constexpr size_t smem2 = 2 * ChunkSmem<Q, N>::bytes;")]),
    "ssd": ("ssd.cu", False, []),
    "ssd_output_2_ctas": ("ssd.cu", False, [
        (_SSD_OB, _SSD_OB.replace("N <= 32 ? 3 : 2", "2"))]),
    "ssd_output_4_ctas": ("ssd.cu", False, [
        (_SSD_OB, _SSD_OB.replace("N <= 32 ? 3 : 2", "N <= 32 ? 4 : 2"))]),
    "ssd_output_no_x": ("ssd.cu", True, [
        (_SSD_X, "  load_rows<Q, N>(Cm")]),
    "ssd_output_no_intra": ("ssd.cu", True, [
        ("    int j = 0;\n    for (; j < 2 * ty + 2; j += 4) {",
         "    int j = Q;\n    for (; j < 2 * ty + 2; j += 4) {")]),
    "ssd_output_no_inter": ("ssd.cu", True, [
        ("    for (int n = 0; n < N; n += 4) {\n      float4 cv[RQ], hv[CP];",
         "    for (int n = N; n < N; n += 4) {\n      float4 cv[RQ], hv[CP];")]),
    "ssd_output_no_g": ("ssd.cu", True, [
        ("        g[r][c] = gb[row(r) * Q + tx + 16 * c];",
         "        g[r][c] = 0.f;")]),
    "ssd_output_no_exp": ("ssd.cu", True, [
        ("? __fmul_rn(__fmul_rn(g[r][c], expf(__fsub_rn(cum[i], cum[j]))),",
         "? __fmul_rn(__fmul_rn(g[r][c], __fsub_rn(cum[i], cum[j])),")]),
    "ssd_state_no_x": ("ssd.cu", True, [
        ("  load_transposed<Q, P>(x + ((size_t)bh * S + t0) * P, xT);\n"
         "  load_transposed<Q, N>(Bb, wT);",
         "  load_transposed<Q, N>(Bb, wT);")]),
    "ssd_state_no_upd": ("ssd.cu", True, [
        ("    for (int j = 0; j < Q; j += 4) {\n      float4 xv[RP], bv",
         "    for (int j = Q; j < Q; j += 4) {\n      float4 xv[RP], bv")]),
}


def build(names, nvcc, flags, csrc=CSRC):
    """Write and compile every variant at once, each from its source under
    ``csrc``; {name: library path}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name in names:
        src, _, subs = VARIANTS[name]
        text = open(os.path.join(csrc, src)).read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = cu[:-3] + ".so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", csrc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{text.decode()}")
        libs[name] = lib
    return libs


def flash_runs(torch, CS, FA, lib, dev):
    """(dtype name, max |err| vs plain, ms) at hymba-1.5b's prefill."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [I, I, P, P, P, P, P] + [I] * 6 + [
        ctypes.c_float, P]
    name, B, H, KV, S, hd, causal, window = CS.ATTN_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
        q = torch.randn((B * H, S, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B * KV, S, hd), generator=g, device=dev).to(dt)
        out = torch.empty_like(q)
        # the stream is read at each call: timing captures on a side stream
        fn = lambda: lib.flash_attention_fwd(
            code, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None, B * H, S, S, H // KV, int(causal),
            window, hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("flash variant: launch failed")
        plain = FA.flash_attention_fwd_plain(q, k, v, groups=H // KV,
                                             causal=causal, window=window)
        err = float((out.float() - plain.float()).abs().max())
        rows.append((str(dt).split(".")[-1], err, CS.time_ms(torch, fn)))
    return rows


def bwd_runs(torch, CS, FA, lib, dev):
    """{shape: row} at chip_smoke.BWD_SHAPES: max |err| / scale of dq, dk,
    dv against the plain version, ms, and the device ms of each launch."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = [I] + [P] * 10 + [I] * 6 + [
        ctypes.c_float, P]
    g = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for name, B, H, KV, S, hd, causal, window in CS.BWD_SHAPES:
        kw = dict(groups=H // KV, causal=causal, window=window)
        q = torch.randn((B * H, S, hd), generator=g, device=dev)
        k = torch.randn((B * KV, S, hd), generator=g, device=dev)
        v = torch.randn((B * KV, S, hd), generator=g, device=dev)
        dout = torch.randn((B * H, S, hd), generator=g, device=dev)
        out, lse = FA.flash_attention_fwd_plain(q, k, v, return_lse=True,
                                                **kw)
        scratch = torch.empty((B * H * S + B * H * (-(-S // 32)) + 1,),
                              device=dev)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        fn = lambda: lib.flash_attention_bwd(
            hd, *(t.data_ptr() for t in (q, k, v, out, dout, lse, scratch,
                                         *grads)),
            B * H, S, S, H // KV, int(causal), window, hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("flash_bwd variant: launch failed")
        want = FA.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads, want))
        trace = CS._profile(torch, fn)
        launches = {r["name"].split("::")[-1].split("<")[0].split("(")[0]:
                    r["device_ms"] for r in trace["top_device"]
                    if "bwd_" in r["name"]}
        rows[name] = {"ms": CS.time_ms(torch, fn),
                      "max_err_over_scale_vs_plain": err,
                      "launch_device_ms": launches}
        del q, k, v, dout, out, lse, scratch, grads, want
        torch.cuda.empty_cache()
    return rows


def bwd_bf16_runs(torch, CS, FA, lib, dev):
    """{shape: row} at chip_smoke.BWD_BF16_SHAPES (stablelm-3b's and
    hymba-1.5b's training attention) in bf16, on the forward kernel's out
    and lse: max |err| / scale of dq, dk, dv against the plain version at
    the kernel's tiles, ms, the device ms of each launch and, for a
    ``*_phase_clocks`` variant, one call's clock64() cycles a CTA in each
    phase (BWD_BF16_PHASES) and the CTAs that stamped them."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_bf16.argtypes = [I] + [P] * 11 + [I] * 6 + [
        ctypes.c_float, P]
    g = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for name, B, H, KV, S, hd, causal, window in CS.BWD_BF16_SHAPES:
        kw = dict(groups=H // KV, causal=causal, window=window)
        q, k, v, dout = (torch.randn(s, generator=g, device=dev).bfloat16()
                         for s in ((B * H, S, hd), (B * KV, S, hd),
                                   (B * KV, S, hd), (B * H, S, hd)))
        out, lse = FA._fwd_kernel(q, k, v, H // KV, causal, window, True)
        if hasattr(lib, "flash_attention_bwd_bf16_scratch"):
            lib.flash_attention_bwd_bf16_scratch.argtypes = [I] * 5
            lib.flash_attention_bwd_bf16_scratch.restype = ctypes.c_longlong
            n = lib.flash_attention_bwd_bf16_scratch(hd, B * H, S, S, H // KV)
        else:           # the first design's layout
            n = B * H * S + B * H * (-(-S // 32)) + 1
        scratch = torch.empty((n,), device=dev)
        dqacc = torch.empty(q.shape, device=dev)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        fn = lambda: lib.flash_attention_bwd_bf16(
            hd, *(t.data_ptr() for t in (q, k, v, out, dout, lse, scratch,
                                         dqacc, *grads)),
            B * H, S, S, H // KV, int(causal), window, hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("flash_bwd_bf16 variant: launch failed")
        want = FA.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        err = {gname: float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
               for gname, a, b in zip(("dq", "dk", "dv"), grads, want)}
        trace = CS._profile(torch, fn)
        launches = {r["name"].split("::")[-1].split("<")[0].split("(")[0]:
                    r["device_ms"] for r in trace["top_device"]
                    if "bwd_" in r["name"]}
        rows[name] = {"ms": CS.time_ms(torch, fn),
                      "max_err_over_scale_vs_plain": err,
                      "launch_device_ms": launches}
        if hasattr(lib, "flash_attention_bwd_bf16_clocks"):
            clocks = (ctypes.c_ulonglong * (len(BWD_BF16_PHASES) + 1))()
            lib.flash_attention_bwd_bf16_clocks(clocks)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            lib.flash_attention_bwd_bf16_clocks(clocks)
            ctas = max(int(clocks[len(BWD_BF16_PHASES)]), 1)
            rows[name]["phase_clocks_per_cta"] = {
                ph: clocks[i] / ctas for i, ph in enumerate(BWD_BF16_PHASES)}
            rows[name]["clock_ctas"] = ctas
        del q, k, v, dout, out, lse, scratch, dqacc, grads, want
        torch.cuda.empty_cache()
    return rows


def ssd_runs(torch, CS, SK, lib, dev):
    """(shape, bit-equal to plain, ms, device ms per launch)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd.argtypes = [I] + [P] * 12 + [I] * 6 + [P]
    g = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, BG, groups, S, Pd, N, Q, (lo, hi), _ in CS.SSD_SHAPES[:2]:
        BH, nc = BG * groups, S // Q
        x = torch.randn((BH, S, Pd), generator=g, device=dev)
        dt = torch.rand((BH, S), generator=g, device=dev) * (hi - lo) + lo
        a = -torch.exp(torch.rand((BH,), generator=g, device=dev) - 0.5)
        d = torch.ones((BH,), device=dev)
        Bm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        Cm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        f32 = dict(device=dev)
        y, st = torch.empty_like(x), torch.empty((BH, Pd, N), **f32)
        scratch = (torch.empty((BH, nc, Pd, N), **f32),
                   torch.empty((BH, nc), **f32), torch.empty((BH, S), **f32),
                   torch.empty((BG, nc, Q, Q), **f32))
        fn = lambda: lib.ssd_fwd(
            0, x.data_ptr(), dt.data_ptr(), a.data_ptr(), d.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), st.data_ptr(),
            *(t.data_ptr() for t in scratch), BH, S, Pd, N, Q, groups,
            torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("ssd variant: launch failed")
        yp, stp = SK.ssd_fwd_plain(x, dt, a, d, Bm, Cm, chunk=Q,
                                   groups=groups)
        same = torch.equal(y, yp) and torch.equal(st, stp)
        trace = CS._profile(torch, fn)
        launches = {r["name"].split("::")[-1].split("<")[0].split("(")[0]:
                    r["device_ms"] for r in trace["top_device"]
                    if "ssd_" in r["name"]}
        rows.append((name, same, CS.time_ms(torch, fn), launches))
    return rows


def ssd_bwd_runs(torch, CS, SK, lib, dev):
    """{shape: row} at hymba-1.5b's and mamba2-370m's training shapes
    (chip_smoke.SSD_BWD_SHAPES with dt in [3, 20]) on the forward kernels'
    saved state: each gradient's max |err| over its scale against the
    plain version, ms, and the device ms of each launch."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_bwd.argtypes = [P] * 21 + [I] * 6 + [P]
    g = torch.Generator(device=dev).manual_seed(14)
    rows = {}
    for name, BG, groups, S, Pd, N, Q, (lo, hi) in CS.SSD_BWD_SHAPES[::2]:
        BH, nc = BG * groups, S // Q
        x = torch.randn((BH, S, Pd), generator=g, device=dev)
        dt = torch.rand((BH, S), generator=g, device=dev) * (hi - lo) + lo
        a = -torch.exp(torch.rand((BH,), generator=g, device=dev) - 0.5)
        d = torch.ones((BH,), device=dev)
        Bm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        Cm = torch.randn((BG, S, N), generator=g, device=dev) * 2
        dy = torch.randn((BH, S, Pd), generator=g, device=dev)
        args = (x, dt, a, d, Bm, Cm)
        hst, cum, G = SK._fwd_kernel(*args, Q, groups)[2]
        f32 = dict(device=dev)
        out = [torch.empty_like(x), torch.empty_like(dt),
               torch.empty((BH,), **f32), torch.empty((BH,), **f32),
               torch.empty_like(Bm), torch.empty_like(Cm)]
        scratch = [torch.empty((BH, nc, Pd, N), **f32),
                   torch.empty((BH, S, N), **f32),
                   torch.empty((BH, S, N), **f32),
                   torch.empty((BH, nc, 2), **f32)]
        fn = lambda: lib.ssd_bwd(
            *(t.data_ptr() for t in (x, dt, a, d, Bm, Cm, dy)), None,
            *(t.data_ptr() for t in (cum, G, hst, *out, *scratch)),
            BH, S, Pd, N, Q, groups, torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("ssd_bwd variant: launch failed")
        want = SK.ssd_bwd_plain(*args, dy, None, (hst, cum, G), chunk=Q,
                                groups=groups)
        err = {k: float((u - w).abs().max() / w.abs().max())
               for k, u, w in zip(("dx", "ddt", "da", "dd", "dB", "dC"),
                                  out, want)}
        trace = CS._profile(torch, fn)
        launches = {r["name"].split("::")[-1].split("<")[0].split("(")[0]:
                    r["device_ms"] for r in trace["top_device"]
                    if "ssd_bwd" in r["name"]}
        rows[name] = {"ms": CS.time_ms(torch, fn),
                      "max_err_over_scale_vs_plain": err,
                      "launch_device_ms": launches}
        if hasattr(lib, "ssd_bwd_phase_clocks"):
            clocks = (ctypes.c_ulonglong * (_NSTAMP - 2))()
            lib.ssd_bwd_phase_clocks(clocks)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            lib.ssd_bwd_phase_clocks(clocks)
            rows[name]["phase_clocks_per_cta"] = [c / (BH * nc)
                                                  for c in clocks]
        del x, dt, dy, hst, cum, G, out, scratch, want
        torch.cuda.empty_cache()
    return rows


def l1inf_runs(torch, CS, K, O, lib, dev, empty=False):
    """{shape: row} for colstats, mu_solve and the Newton loop: the inputs
    of chip_smoke.py phase 2 (a vector theta, two thirds of the blocks
    active) and the engine's state after pass 1 of phase 3's projection.
    The loop is timed L2-warm and flushed; a variant with
    ``l1inf_phase_clocks`` also reports one launch's clock64() cycles a CTA
    in each of ``LOOP_PHASES``. ``empty``: the loop runs max_newton = the
    plain loop's Newton count (an empty-loop variant steps until then)."""
    import numpy as np
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.l1inf_colstats.argtypes = [P, P, P, I, I, I, P]
    lib.l1inf_mu_solve.argtypes = [P, P, I, P, I, P, P, P, P, I, I, I, I, P]
    lib.l1inf_newton_loop.argtypes = [P] * 10 + [I] * 8 + [P]
    lib.l1inf_newton_loop_clusters.argtypes = [I, I, I]
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    flush = lambda: flush_buf.fill_(1.0)          # 256 MB through L2
    rows = {}
    for name, (n, m_pad) in CS.SHAPES.items():
        m, C = {"sae_enc1": (10000, 0.2), "fig2_wide": (10000, 1.0),
                "fig2_tall": (1000, 1.0)}[name]
        Y = torch.zeros((n, m_pad), device=dev)
        Y[:, :m] = (torch.randn((n, m), generator=g, device=dev) / n ** 0.5
                    if name == "sae_enc1"
                    else torch.rand((n, m), generator=g, device=dev))
        A = Y.abs()
        stream = lambda: torch.cuda.current_stream().cuda_stream
        s, mx = torch.empty(m_pad, device=dev), torch.empty(m_pad, device=dev)
        cs = lambda: lib.l1inf_colstats(A.data_ptr(), s.data_ptr(),
                                        mx.data_ptr(), n, m_pad, 1, stream())
        s2, m2 = K.colstats_plain(A)
        theta = (s2 * torch.from_numpy(rng.uniform(
            0.05, 1.2, size=m_pad).astype(np.float32)).to(dev)).contiguous()
        nact = torch.tensor([(m_pad // 128) * 2 // 3], dtype=torch.int32,
                            device=dev)
        out = [torch.empty(m_pad, device=dev) for _ in range(3)] + [
            torch.empty(m_pad, dtype=torch.bool, device=dev)]
        ms = lambda: lib.l1inf_mu_solve(
            A.data_ptr(), theta.data_ptr(), 1, nact.data_ptr(), 128,
            *(t.data_ptr() for t in out), n, m_pad, 26, 8, stream())
        if cs() != 0 or ms() != 0:
            raise SystemExit("l1inf variant: launch failed")
        want = K.mu_solve_plain(A, theta, block_m=128, nact=nact)
        row = {"colstats_ms": CS.time_ms(torch, cs),
               "colstats_max_exact": bool(torch.equal(mx, m2)),
               "mu_solve_ms": CS.time_ms(torch, ms),
               "mu_solve_active_equal": bool(torch.equal(out[3], want[3])),
               "mu_solve_max_err_over_colmax": float(
                   ((out[0] - want[0]).abs() / m2.clamp(min=1e-30)).max())}
        Yc = Y[:, :m].contiguous()
        Ypad, bm = O._padded(Yc, 0)
        sids = (torch.arange(Ypad.shape[1], device=dev) >= m).to(torch.int32)
        li = O._loop_inputs(Ypad, sids, torch.full((1,), C, device=dev), 1,
                            None, bm=bm, n_bisect=26, n_polish=8,
                            shrink=True)
        mp = Ypad.shape[1]
        mu, th = torch.empty(mp, device=dev), torch.empty(1, device=dev)
        st = torch.empty(3, dtype=torch.int64, device=dev)
        clusters = lib.l1inf_newton_loop_clusters(n, mp, 1)
        part = torch.empty(2 * clusters * 3, device=dev)   # 2 x (2G + 1)
        plain = K.newton_loop_plain(
            li["A"], li["sids"], li["colsum"], li["t1"], li["Csafe"],
            li["num_active"], num_segments=1, block_m=bm)
        cap = int(plain[2]) if empty else 32
        loop = lambda: lib.l1inf_newton_loop(
            *(li[k].data_ptr() for k in ("A", "sids", "colsum", "t1",
                                         "Csafe", "num_active")),
            mu.data_ptr(), th.data_ptr(), st.data_ptr(), part.data_ptr(),
            n, mp, 1, bm, 26, 8, cap, 1, stream())
        if loop() != 0:
            raise SystemExit("l1inf variant: loop launch failed")
        row.update({"newton_loop_ms": CS.time_ms(torch, loop),
                    "newton_loop_ms_flushed": CS.time_cold_ms(torch, loop,
                                                              flush),
                    "newton_loop_clusters": clusters,
                    "newton_iters": int(st[0]),
                    "newton_iters_plain": int(plain[2]),
                    "theta_err": float((th - plain[0]).abs().max())})
        if hasattr(lib, "l1inf_phase_clocks"):
            clocks = (ctypes.c_ulonglong * (_NPH + 1))()
            torch.cuda.synchronize()
            lib.l1inf_phase_clocks(clocks)
            loop()
            torch.cuda.synchronize()
            lib.l1inf_phase_clocks(clocks)
            ctas = max(clocks[_NPH], 1)
            row["loop_phase_cycles_per_cta"] = {
                k: clocks[i] / ctas for i, k in enumerate(LOOP_PHASES)}
            row["loop_ctas"] = clocks[_NPH]
        rows[name] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS),
                    help="variants to run (default: all)")
    ap.add_argument("--src", default=CSRC,
                    help="the csrc directory the variants are made from "
                         "(default: this tree's); the scalar_* variants "
                         "apply to the first SSD backward's csrc")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.l1inf import kernel as K
    from repro_torch.kernels.l1inf import ops as O
    from repro_torch.kernels.ssd import kernel as SK
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    names = args.only or list(VARIANTS)
    # a name given twice is built once and run twice (in turns)
    libs = build(list(dict.fromkeys(names)), _build._nvcc(),
                 _build.NVCC_FLAGS, args.src)
    for name in names:
        src, diagnostic, subs = VARIANTS[name]
        lib = ctypes.CDLL(libs[name])
        line = {"variant": name,
                "source": os.path.join(os.path.relpath(args.src, ROOT), src),
                "diagnostic": diagnostic,
                "substitutions": [new for _, new in subs]}
        if src == "flash_attention.cu":
            for dname, err, ms in flash_runs(torch, CS, FA, lib, dev):
                line[dname] = {"ms": ms, "max_abs_err_vs_plain": err}
        elif src == "flash_attention_bwd.cu":
            line.update(bwd_runs(torch, CS, FA, lib, dev))
        elif src == "flash_attention_bwd_bf16.cu":
            line.update(bwd_bf16_runs(torch, CS, FA, lib, dev))
        elif src == "ssd_bwd.cu":
            line.update(ssd_bwd_runs(torch, CS, SK, lib, dev))
        elif src == "l1inf.cu":
            line.update(l1inf_runs(torch, CS, K, O, lib, dev,
                                   empty=name.endswith("_empty")))
        else:
            for shape, same, ms, launches in ssd_runs(torch, CS, SK, lib,
                                                      dev):
                line[shape] = {"ms": ms, "bit_equal_to_plain": same,
                               "launch_device_ms": launches}
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
