#!/usr/bin/env python3
"""Time variants of the port's kernels on the card.

    python3 scripts/torch_kernel_variants.py [--only NAME ...]

Each variant is the committed ``csrc/flash_attention.cu``, ``csrc/ssd.cu``
or ``csrc/l1inf.cu`` with a few exact text substitutions: another tiling
or launch bound, or one
part of the work cut out to see what it costs (a "diagnostic" variant,
whose output is wrong by design and whose error is reported, not checked).
Every variant is compiled with the port's ``nvcc`` flags into
``build/variants/`` (all at once, in parallel), loaded with ``ctypes``
through the same C interface as the wrappers, run at the main path's
shapes (hymba-1.5b's prefill for flash in f32 and bf16; hymba-1.5b's and
mamba2-370m's shapes for SSD; for the l1,inf engine, colstats and mu_solve
on ``chip_smoke.py`` phase 2's inputs and the Newton loop on the engine's
state after pass 1, at ``sae_enc1``, ``fig2_wide`` and ``fig2_tall``),
compared with the plain version, and timed
as ``chip_smoke.time_ms`` times a kernel (a CUDA graph of back-to-back
calls between CUDA events, inputs L2-warm). SSD variants also get one
traced call, for the device ms of each of their three launches. Prints one
JSON line per variant, then the card's name and power limit. Needs one
CUDA card; exits non-zero without one.
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
# name -> (source, diagnostic, [(old, new), ...])
VARIANTS = {
    "l1inf": ("l1inf.cu", False, []),
    "l1inf_ctas_unbounded": ("l1inf.cu", False, [
        (_MU_BOUNDS, "constexpr int min_ctas() { return 1; }"),
        (_LOOP_BOUNDS, "constexpr int min_loop_ctas() { return 1; }")]),
    "mu_solve_no_cluster_exchange": ("l1inf.cu", True, [
        (_COMBINE, "  float2 p = make_float2(a, b);\n")]),
    "mu_solve_no_bisect_shuffles": ("l1inf.cu", True, [
        ("    float removed = lanes_sum<TL>(removed_at(v, mid));",
         "    float removed = removed_at(v, mid);")]),
    "colstats_one_cta": ("l1inf.cu", False, [(_STAT_S, "const int S = 1;")]),
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
    "ssd": ("ssd.cu", False, []),
    "ssd_output_2_ctas": ("ssd.cu", False, [
        (_SSD_OB, _SSD_OB.replace("N <= 32 ? 3 : 2", "2"))]),
    "ssd_output_4_ctas": ("ssd.cu", False, [
        (_SSD_OB, _SSD_OB.replace("N <= 32 ? 3 : 2", "N <= 32 ? 4 : 2"))]),
    "ssd_output_no_x": ("ssd.cu", True, [
        (_SSD_X, "  load_rows<Q, N>(Cm")]),
    "ssd_output_no_intra": ("ssd.cu", True, [
        ("  int j = 0;\n  for (; j < 2 * ty + 2; j += 4) {",
         "  int j = Q;\n  for (; j < 2 * ty + 2; j += 4) {")]),
    "ssd_output_no_inter": ("ssd.cu", True, [
        ("  for (int n = 0; n < N; n += 4) {\n    float4 cv[RQ], hv[CP];",
         "  for (int n = N; n < N; n += 4) {\n    float4 cv[RQ], hv[CP];")]),
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


def build(names, nvcc, flags):
    """Write and compile every variant at once; {name: library path}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name in names:
        src, _, subs = VARIANTS[name]
        text = open(os.path.join(CSRC, src)).read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: text not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = cu[:-3] + ".so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", CSRC, "-o", lib, cu],
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
    lib.flash_attention_fwd.argtypes = [I, I, P, P, P, P] + [I] * 6 + [
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
            out.data_ptr(), B * H, S, S, H // KV, int(causal), window,
            hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if fn() != 0:
            raise SystemExit("flash variant: launch failed")
        plain = FA.flash_attention_fwd_plain(q, k, v, groups=H // KV,
                                             causal=causal, window=window)
        err = float((out.float() - plain.float()).abs().max())
        rows.append((str(dt).split(".")[-1], err, CS.time_ms(torch, fn)))
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


def l1inf_runs(torch, CS, K, O, lib, dev):
    """{shape: row} for colstats, mu_solve and the Newton loop: the inputs
    of chip_smoke.py phase 2 (a vector theta, two thirds of the blocks
    active) and the engine's state after pass 1 of phase 3's projection."""
    import numpy as np
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.l1inf_colstats.argtypes = [P, P, P, I, I, I, P]
    lib.l1inf_mu_solve.argtypes = [P, P, I, P, I, P, P, P, P, I, I, I, I, P]
    lib.l1inf_newton_loop.argtypes = [P] * 10 + [I] * 8 + [P]
    lib.l1inf_newton_loop_clusters.argtypes = [I, I, I]
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
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
        part = torch.empty(4 * clusters, device=dev)
        loop = lambda: lib.l1inf_newton_loop(
            *(li[k].data_ptr() for k in ("A", "sids", "colsum", "t1",
                                         "Csafe", "num_active")),
            mu.data_ptr(), th.data_ptr(), st.data_ptr(), part.data_ptr(),
            n, mp, 1, bm, 26, 8, 32, 1, stream())
        if loop() != 0:
            raise SystemExit("l1inf variant: loop launch failed")
        plain = K.newton_loop_plain(
            li["A"], li["sids"], li["colsum"], li["t1"], li["Csafe"],
            li["num_active"], num_segments=1, block_m=bm)
        row.update({"newton_loop_ms": CS.time_ms(torch, loop),
                    "newton_loop_clusters": clusters,
                    "newton_iters": int(st[0]),
                    "newton_iters_plain": int(plain[2]),
                    "theta_err": float((th - plain[0]).abs().max())})
        rows[name] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS),
                    help="variants to run (default: all)")
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
    libs = build(names, _build._nvcc(), _build.NVCC_FLAGS)
    for name in names:
        src, diagnostic, subs = VARIANTS[name]
        lib = ctypes.CDLL(libs[name])
        line = {"variant": name, "source": f"src/repro_torch/csrc/{src}",
                "diagnostic": diagnostic,
                "substitutions": [new for _, new in subs]}
        if src == "flash_attention.cu":
            for dname, err, ms in flash_runs(torch, CS, FA, lib, dev):
                line[dname] = {"ms": ms, "max_abs_err_vs_plain": err}
        elif src == "l1inf.cu":
            line.update(l1inf_runs(torch, CS, K, O, lib, dev))
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
