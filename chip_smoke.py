#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Every phase prints one JSON line; any failed check or error exits non-zero
and prints no result. Phases:

  1. build   — ``nvidia-smi`` name and power limit, then ``nvcc`` builds the
               kernels from ``src/repro_torch/csrc`` (time, ptxas summary).
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               padded buffers the engine hands it: the SAE's canonical
               packed ``enc1/w`` (96 x 10112) and paper Fig. 2's 1000 x 10000
               and 10000 x 1000 (padded to 1000 x 10112 and 10000 x 1024).
               colstats: sums to rtol 1e-5, maxes exact; mu_solve with a
               vector theta and a partial active-block count: active sets
               equal, mu to atol 1e-5 * colmax; clip_apply: bit-equal in f32
               and bf16. Device times (a CUDA graph of back-to-back calls
               between CUDA events, warm L2) of kernel, plain version and,
               for clip_apply, ``torch.clamp`` as a yardstick.
  3. project — ``project_l1inf_kernel`` against ``project_l1inf_newton`` at
               those shapes (atol 3e-4 * scale, rtol 3e-3; a rerun must be
               bit-equal), with launches and wall times per projection, and
               the Newton against the sort-based oracle on a small input.
  4. train   — the main path: 20 projected SAE steps at the paper's full
               synthetic width (10000 features, 96 hidden, batch 128; spec
               enc1/w l1inf radius 0.2 axis 1) through
               ``ProjectionEngine(solver="kernel").projected_update``, with
               every kernel's launch count read just around them; then the
               same 20 steps under ``solver="newton"`` (final params to
               atol 3e-4 * scale).
  5. train_sae — ``train_sae`` as the JAX package runs it (``"fused"``, so
               Newton for plain l1,inf), 2 epochs of each descent.
  6. the ``kernels`` line, the ``nvidia-smi`` line, and the result line.

TF32 is off for matmuls and cuDNN, so float32 products are full float32.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SHAPES = {"sae_enc1": (96, 10112), "fig2_wide": (1000, 10112),
          "fig2_tall": (10000, 1024)}
SOURCE = "src/repro_torch/csrc/l1inf.cu"
REPLACES = {"colstats": "src/repro/kernels/l1inf/kernel.py:58",
            "mu_solve": "src/repro/kernels/l1inf/kernel.py:136",
            "clip_apply": "src/repro/kernels/l1inf/kernel.py:198"}
FAILURES = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", flush=True)
    return bool(ok)


def time_ms(torch, fn, budget_ms=100.0):
    """Mean device time of one fn() call in ms. fn is captured back to back
    into a CUDA graph, which is replayed once between two CUDA events, so
    the host's launch overhead stays out of the number; inputs stay warm in
    L2. fn must not synchronise."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
        start.record(side)
        fn()
        end.record(side)
    end.synchronize()
    torch.cuda.current_stream().wait_stream(side)
    reps = int(min(200, max(10, budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn, reps=5):
    """Mean wall time of fn() in ms, host clock, synchronised: for calls
    that synchronise themselves (the projection's host Newton loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def bits_equal(torch, a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import _build
    from repro_torch.core import (ProjectionEngine, ProjectionSpec,
                                  project_l1inf_newton, sparsity_report)
    from repro_torch.kernels.l1inf import kernel as K
    from repro_torch.kernels.l1inf import ref
    from repro_torch.kernels.l1inf.ops import project_l1inf_kernel
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.sae import (SAEConfig, SAETrainConfig,
                                 make_classification, projected_step,
                                 sae_init, train_sae, train_test_split)
    from repro_torch._tree import flatten_with_path, leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = str(path) + ".log"
        if os.path.exists(log):
            ptxas += [l.strip() for l in open(log) if "Used" in l
                      or "spill" in l]
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": build_s,
          "libraries": sorted(libs), "ptxas": ptxas})

    # -- 2. each kernel against its plain version --------------------------
    rng = np.random.default_rng(0)
    cfg = SAEConfig(n_features=10000, n_hidden=96, n_classes=2)
    params0 = sae_init(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    enc1 = torch.zeros(SHAPES["sae_enc1"], device=dev)
    enc1[:, :cfg.n_features] = params0["enc1"]["w"].T
    inputs = {"sae_enc1": enc1}
    for name in ("fig2_wide", "fig2_tall"):
        n, m_pad = SHAPES[name]
        m = 10000 if name == "fig2_wide" else 1000
        Y = np.zeros((n, m_pad), np.float32)
        Y[:, :m] = rng.uniform(0, 1, size=(n, m))
        inputs[name] = torch.from_numpy(Y).to(dev)

    bm = 128
    errs = {k: 0.0 for k in REPLACES}
    timing = {}
    for name, Y in inputs.items():
        n, m = Y.shape
        A = Y.abs()
        s1, m1 = K.colstats(A)
        s2, m2 = K.colstats_plain(A)
        rel = float(((s1 - s2).abs() / s2.clamp(min=1e-30)).max())
        check(rel <= 1e-5, f"colstats sum {name}: rel err {rel}")
        check(torch.equal(m1, m2), f"colstats max {name}: not exact")
        errs["colstats"] = max(errs["colstats"],
                               float((s1 - s2).abs().max()))

        u = torch.from_numpy(rng.uniform(0.05, 1.2, size=m).astype(
            np.float32)).to(dev)
        theta = (s2 * u).contiguous()
        nact = torch.tensor([(m // bm) * 2 // 3], dtype=torch.int32,
                            device=dev)
        r1 = K.mu_solve(A, theta, block_m=bm, nact_blocks=nact)
        r2 = K.mu_solve_plain(A, theta, block_m=bm, nact=nact)
        check(torch.equal(r1[3], r2[3]), f"mu_solve active set {name}")
        dmu = (r1[0] - r2[0]).abs()
        check(bool((dmu <= 1e-5 * m2).all()),
              f"mu_solve mu {name}: max err {float(dmu.max())}")
        errs["mu_solve"] = max(errs["mu_solve"], float(dmu.max()))

        mu = torch.from_numpy(rng.uniform(0, 1, size=m).astype(
            np.float32)).to(dev) * m2
        for dt in (torch.float32, torch.bfloat16):
            Yd = Y.to(dt)
            x1, x2 = K.clip_apply(Yd, mu), K.clip_apply_plain(Yd, mu)
            check(bits_equal(torch, x1, x2), f"clip_apply {name} {dt}")
            errs["clip_apply"] = max(errs["clip_apply"], float(
                (x1.float() - x2.float()).abs().max()))

        P = min(int(nact) * bm, m)
        mu_lo = mu[None, :]
        t = {
            "colstats": (time_ms(torch, lambda: K.colstats(A)),
                         time_ms(torch, lambda: K.colstats_plain(A)), None,
                         (n * m * 4 + 2 * m * 4) / HBM_BYTES_PER_S * 1e3,
                         "bytes"),
            "mu_solve": (time_ms(torch, lambda: K.mu_solve(
                A, theta, block_m=bm, nact_blocks=nact)),
                time_ms(torch, lambda: K.mu_solve_plain(
                    A, theta, block_m=bm, nact=nact)), None)
            + max(((n * P * 4 + P * 4 + m * 13) / HBM_BYTES_PER_S * 1e3,
                   "bytes"),
                  (36 * 2 * n * P / F32_OPS_PER_S * 1e3, "operations")),
            "clip_apply": (time_ms(torch, lambda: K.clip_apply(Y, mu)),
                           time_ms(torch, lambda: K.clip_apply_plain(Y, mu)),
                           time_ms(torch, lambda: torch.clamp(
                               Y, -mu_lo, mu_lo)),
                           (2 * n * m * 4 + m * 4) / HBM_BYTES_PER_S * 1e3,
                           "bytes"),
        }
        timing[name] = t
        emit({"phase": "kernels", "shape": name, "n": n, "m": m,
              "mu_solve_prefix_cols": P,
              "colstats_sum_rel_err": rel,
              "mu_solve_max_abs_err": float(dmu.max()),
              "ms": {k: {"kernel": v[0], "plain": v[1], "library": v[2],
                         "bound": v[3], "bound_by": v[4]}
                     for k, v in t.items()}})

    # -- 3. the projection at those shapes -----------------------------------
    for name, (Y, C) in {"sae_enc1": (enc1[:, :cfg.n_features], 0.2),
                         "fig2_wide": (inputs["fig2_wide"][:, :10000], 1.0),
                         "fig2_tall": (inputs["fig2_tall"][:, :1000], 1.0),
                         }.items():
        Y = Y.contiguous()
        K.reset_launch_counts()
        X1, st = project_l1inf_kernel(Y, C, return_stats=True)
        per_projection = K.launch_counts()
        check(bits_equal(torch, X1, project_l1inf_kernel(Y, C)),
              f"project {name}: kernel engine not the same on a rerun")
        X2 = project_l1inf_newton(Y, C)
        scale = max(float(Y.abs().max()), 1.0)
        err = float((X1 - X2).abs().max())
        ok = torch.allclose(X1, X2, atol=3e-4 * scale, rtol=3e-3)
        check(ok, f"project {name}: kernel vs newton max err {err}")
        colsp = float(((X1 == 0).all(dim=0)).float().mean() * 100)
        emit({"phase": "project", "shape": name, "n": Y.shape[0],
              "m": Y.shape[1], "C": C, "max_abs_err": err,
              "newton_iters": st["newton_iters"],
              "work_cols": int(st["work_cols"]),
              "full_cols": st["full_cols"], "colsp_pct": colsp,
              "launches": per_projection,
              "kernel_wall_ms": wall_ms(
                  torch, lambda: project_l1inf_kernel(Y, C)),
              "newton_wall_ms": wall_ms(
                  torch, lambda: project_l1inf_newton(Y, C))})
    Ys = torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32)).to(
        dev)
    Cs = float(0.2 * Ys.abs().amax(dim=0).sum())
    err = float((project_l1inf_newton(Ys, Cs)
                 - ref.project_l1inf_ref(Ys, Cs)).abs().max())
    check(err <= 3e-4 * max(float(Ys.abs().max()), 1.0),
          f"newton vs sort oracle (64 x 300): {err}")
    emit({"phase": "project", "shape": "small_vs_oracle", "n": 64, "m": 300,
          "max_abs_err": err})

    # -- 4. the main path: projected SAE steps through the kernels -----------
    X, y, _ = make_classification(n_samples=1000, n_features=10000,
                                  n_informative=64, seed=0)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.2, seed=0)
    Xd = torch.from_numpy(Xtr).to(dev)
    yd = torch.from_numpy(ytr).to(dev)
    spec = ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.2,
                          axis=1)
    acfg = AdamConfig(lr=1e-3)
    order = np.concatenate([np.random.default_rng(0).permutation(len(Xtr))
                            for _ in range(4)])
    batches = [torch.from_numpy(order[i * 128:(i + 1) * 128]).to(dev)
               for i in range(20)]
    ones = tree_map(torch.ones_like, params0)

    def run(solver):
        engine = ProjectionEngine((spec,), solver=solver)
        params, opt = params0, adam_init(params0, acfg)
        state = engine.init_state(params0)
        times, losses = [], []
        for idx in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, state, loss, _ = projected_step(
                params, opt, state, Xd[idx], yd[idx], ones, cfg=cfg,
                acfg=acfg, engine=engine)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
        return params, times, losses

    K.reset_launch_counts()
    p_kernel, t_kernel, l_kernel = run("kernel")
    launches = K.launch_counts()
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
    p_newton, t_newton, l_newton = run("newton")
    scale = max(max(float(p.abs().max()) for p in leaves(p_newton)), 1.0)
    errs_leaf = {k: float((a - b).abs().max()) for (k, a), (_, b) in zip(
        flatten_with_path(p_kernel), flatten_with_path(p_newton))}
    err = max(errs_leaf.values())
    check(err <= 3e-4 * scale, f"20 kernel steps vs newton: max err {err}")
    live_k = (p_kernel["enc1"]["w"] != 0).any(dim=1)
    live_n = (p_newton["enc1"]["w"] != 0).any(dim=1)
    check(all(np.isfinite(l_kernel)), "non-finite loss")
    emit({"phase": "train", "steps": 20, "batch": 128,
          "n_features": cfg.n_features, "n_hidden": cfg.n_hidden,
          "launches": launches, "loss_first": l_kernel[0],
          "loss_last": l_kernel[-1], "loss_last_newton": l_newton[-1],
          "colsp_pct": sparsity_report(p_kernel, (spec,))["enc1/w"],
          "max_abs_err_vs_newton": err, "scale": scale,
          "max_abs_err_by_leaf": errs_leaf,
          "support_cols_differing": int((live_k != live_n).sum()),
          "step_ms_kernel_first": t_kernel[0],
          "step_ms_kernel_mean_rest": float(np.mean(t_kernel[1:])),
          "step_ms_newton_mean_rest": float(np.mean(t_newton[1:]))})

    # -- 5. train_sae as the JAX package runs it -----------------------------
    t = time.perf_counter()
    res = train_sae(Xtr, ytr, Xte, yte, cfg,
                    SAETrainConfig(epochs=2, projection=spec, seed=0),
                    device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    finite = all(bool(torch.isfinite(p).all()) for p in leaves(res.params))
    check(finite, "train_sae: non-finite params")
    check(res.params["enc1"]["w"].shape == (10000, 96), "train_sae shape")
    check(0 < len(res.selected) < cfg.n_features,
          f"train_sae selected {len(res.selected)} features")
    emit({"phase": "train_sae", "epochs_per_descent": 2,
          "test_accuracy": res.test_accuracy,
          "selected_features": int(len(res.selected)),
          "column_sparsity_pct": res.column_sparsity, "seconds": sec,
          "history": res.history})

    # -- 6. result -------------------------------------------------------------
    if FAILURES:
        print(json.dumps({"failures": FAILURES}), file=sys.stderr)
        return 1
    sae = timing["sae_enc1"]
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": sae[k][0], "plain_ms": sae[k][1],
         "bound_ms": sae[k][3], "bound_by": sae[k][4],
         "library_ms": sae[k][2]} for k in REPLACES]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
