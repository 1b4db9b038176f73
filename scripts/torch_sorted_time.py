#!/usr/bin/env python3
"""Time ``project_l1inf_sorted`` and the kernel engine at paper Fig. 2's
shapes and hold them to the same tree's ``project_l1inf_newton``.

    python3 scripts/torch_sorted_time.py [--src DIR] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that an unpacked older tree can be timed
beside this one in the same call. Inputs: U(0, 1) 1000 x 10000 and
10000 x 1000 at C = 1, drawn with numpy (``chip_smoke.py`` phase 3's
draw) and with ``torch.rand`` (seed 0). One JSON line per (shape, draw):
the median wall ms of one sorted, one kernel-engine
(``project_l1inf_kernel``, its kernels built from that tree) and one
Newton projection (each call synchronized, after two warm calls) and
their max |. - Newton|; then the card's name and power limit as
``nvidia-smi`` gives them. Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"fig2_wide": (1000, 10000), "fig2_tall": (10000, 1000)}
C = 1.0


def wall_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sorted_time: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.l1inf import (project_l1inf_newton,
                                        project_l1inf_sorted)
    from repro_torch.kernels.l1inf.ops import project_l1inf_kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    draws = {}
    for name, shape in SHAPES.items():
        draws[(name, "numpy")] = torch.from_numpy(
            rng.uniform(0, 1, size=shape).astype(np.float32)).to(dev)
        draws[(name, "torch_rand")] = torch.rand(
            shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
    for (name, draw), Y in draws.items():
        Xs = project_l1inf_sorted(Y, C)
        Xk = project_l1inf_kernel(Y, C)
        Xn = project_l1inf_newton(Y, C)
        print(json.dumps({
            "src": args.src, "shape": name, "draw": draw, "C": C,
            "sorted_ms": wall_ms(
                torch, lambda: project_l1inf_sorted(Y, C), args.reps),
            "kernel_ms": wall_ms(
                torch, lambda: project_l1inf_kernel(Y, C), args.reps),
            "newton_ms": wall_ms(
                torch, lambda: project_l1inf_newton(Y, C), args.reps),
            "sorted_max_abs_diff_vs_newton": float(
                (Xs - Xn).abs().max()),
            "kernel_max_abs_diff_vs_newton": float(
                (Xk - Xn).abs().max())}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
