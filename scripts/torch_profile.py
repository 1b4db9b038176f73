#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's projected SAE step, on the card.

    python3 scripts/torch_profile.py [--norm l1inf|l12]
                                     [--solver kernel|fused]
                                     [--steps 5] [--out FILE]

Runs the paper's full-width synthetic SAE (10000 features, 96 hidden, batch
128; spec enc1/w, max axis 1) for a few warm-up steps, then traces
``--steps`` steps with ``torch.profiler`` (CPU + CUDA), once with
``--solver`` and once with ``solver="newton"``, and then the projection
alone: ``project_l1inf_kernel`` on the SAE's packed (96, 10000) encoder for
``--norm l1inf``, the engine's Newton ``apply`` on the SAE's params
otherwise. Two modes: ``--norm l1inf --solver kernel`` (the default) and
``--norm l12 --solver fused``, this port's fused Adam+projection step; the
radius of each is ``chip_smoke.RADIUS``'s (0.2 and paper Table 1's eta of
10), so the profile runs the configuration the smoke run checks. For each
it prints one
JSON line: host wall time per step (synchronised), device time per step
(the sum of the traced device activities; one stream, so they do not
overlap), the device's idle share in the traced window, the untraced wall
time per step, the port's CUDA kernels' device time and launches per step,
and the top device consumers. ``--out`` writes the full per-op tables.
Needs one CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

# trace-name fragments of the port's kernels (csrc/*.cu, anonymous namespace)
KERNELS = {"colstats": "::colstats_kernel", "mu_solve": "::mu_solve_kernel",
           "newton_loop": "::newton_loop_kernel",
           "clip_apply": "::clip_apply_kernel",
           "adam_colstats": "::adam_colstats_",
           "adam_clip_apply": "::adam_clip_apply_kernel"}
# --norm -> the solver it is profiled with
MODES = {"l1inf": "kernel", "l12": "fused"}


def _dev_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _trace(torch, fn, steps):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    from torch.autograd import DeviceType
    # device-side activities only (kernels, copies): a CPU op's own entry
    # repeats the device time of the kernels it launched
    rows = [(e.key, e.count, _dev_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    dev_ms = sum(r[2] for r in rows) / 1e3 / steps
    ours = {}
    for name, frag in KERNELS.items():
        hit = [r for r in rows if frag in r[0]]
        if hit:
            ours[name] = {
                "device_ms_per_step": sum(r[2] for r in hit) / 1e3 / steps,
                "launches_per_step": sum(r[1] for r in hit) / steps}
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
            "device_idle_share": max(0.0, 1.0 - dev_ms / wall_ms),
            "our_kernels": ours,
            "top_device": [{"name": r[0][:90], "calls_per_step": r[1] / steps,
                            "device_ms_per_step": r[2] / 1e3 / steps}
                           for r in rows[:8]]}, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--norm", default="l1inf", choices=tuple(MODES))
    ap.add_argument("--solver", default=None,
                    choices=tuple(MODES.values()))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.solver not in (None, MODES[args.norm]):
        ap.error(f"--norm {args.norm} is profiled with --solver "
                 f"{MODES[args.norm]}")
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(root, "src"), root]
    from chip_smoke import RADIUS
    from repro_torch.core import ProjectionEngine, ProjectionSpec
    from repro_torch.kernels.l1inf.ops import project_l1inf_kernel
    from repro_torch.optim import AdamConfig, adam_init
    from repro_torch.sae import (SAEConfig, make_classification,
                                 projected_step, sae_init)
    from repro_torch._tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = SAEConfig(n_features=10000, n_hidden=96, n_classes=2)
    X, y, _ = make_classification(n_samples=1000, n_features=10000,
                                  n_informative=64, seed=0)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    radius = RADIUS[args.norm]
    spec = ProjectionSpec(pattern=r"enc1/w", norm=args.norm, radius=radius,
                          axis=1)
    acfg = AdamConfig(lr=1e-3)
    params0 = sae_init(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
    ones = tree_map(torch.ones_like, params0)
    order = np.random.default_rng(0).permutation(1000)
    out, tables = {"norm": args.norm, "radius": radius}, {}

    for solver in (MODES[args.norm], "newton"):
        engine = ProjectionEngine((spec,), solver=solver)
        st = {"p": params0, "o": adam_init(params0, acfg),
              "s": engine.init_state(params0), "i": 0}

        def step():
            idx = torch.from_numpy(
                order[(st["i"] * 128) % 872:][:128]).to(dev)
            st["i"] += 1
            st["p"], st["o"], st["s"], _, _ = projected_step(
                st["p"], st["o"], st["s"], Xd[idx], yd[idx], ones, cfg=cfg,
                acfg=acfg, engine=engine)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t) * 1e3 / args.steps
        res, rows = _trace(torch, step, args.steps)
        res["wall_ms_per_step_untraced"] = untraced
        out[f"step_{solver}"] = res
        tables[f"step_{solver}"] = rows
        print(json.dumps({"trace": f"step_{solver}", "norm": args.norm,
                          **res}), flush=True)

    if args.norm == "l1inf":
        Y = params0["enc1"]["w"].T.contiguous()
        name, proj = "project_sae_enc1", lambda: project_l1inf_kernel(
            Y, radius)
    else:          # the Newton step's projection alone, on the SAE's params
        engine = ProjectionEngine((spec,))
        name, proj = f"project_{args.norm}_newton", lambda: engine.apply(
            params0)
    proj()
    res, rows = _trace(torch, proj, args.steps)
    out[name], tables[name] = res, rows
    print(json.dumps({"trace": name, **res}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": torch.cuda.get_device_name(0),
                       "summary": out,
                       "tables": {k: [list(r) for r in v]
                                  for k, v in tables.items()}}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
