#!/usr/bin/env python3
"""How far the CPU side of ``chip_smoke.py`` phase 7c's block check moves
with the CPU's settings.

    python3 scripts/torch_blockcheck_cpu_probe.py [--only NAME ...]
        [--arch stablelm-3b] [--kind global]

Runs ``models.blockcheck.block_backward_check`` for one full-width f32
block (by default phase 7c's stablelm-3b ``global`` block, seq 2048, its
seed and perturbation) once under each CPU setting in ``SETTINGS``: the
card's two backwards are the same in every run, so what moves between the
lines is the CPU reference. Each setting changes one thing: the intra-op
thread count, oneDNN off, ``torch.set_float32_matmul_precision``, or
oneDNN's fp32 matmul precision. Prints one JSON line per setting (each
leaf's max |card - CPU|, its noise floor, the CPU gradient's scale, and
the worst share of twice the floor), then the CPU's capability, threads
and the environment variables that steer its math libraries. Run it again
under ``ATEN_CPU_CAPABILITY=avx2`` for the other vector unit. Needs one
CUDA card.
"""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> what it changes for the CPU side
SETTINGS = {
    "default": {},
    "threads_1": {"threads": 1},
    "threads_4": {"threads": 4},
    "threads_7": {"threads": 7},
    "mkldnn_off": {"mkldnn": False},
    "matmul_precision_high": {"precision": "high"},
    "matmul_precision_medium": {"precision": "medium"},
    "mkldnn_matmul_tf32": {"mkldnn_matmul": "tf32"},
    "mkldnn_matmul_bf16": {"mkldnn_matmul": "bf16"},
}
ENV_PREFIXES = ("OMP_", "MKL_", "ONEDNN_", "DNNL_", "ATEN_", "KMP_",
                "TORCH_")


@contextlib.contextmanager
def cpu_setting(torch, threads=None, mkldnn=None, precision=None,
                mkldnn_matmul=None):
    """Apply one setting for the block and restore it after (each knob
    through its own API: the legacy matmul precision and oneDNN's
    fp32_precision may not be read once both were set)."""
    mm = torch.backends.mkldnn.matmul if mkldnn_matmul else None
    old = (torch.get_num_threads(),
           torch.get_float32_matmul_precision() if precision else None,
           mm.fp32_precision if mm else None)
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if precision:
            torch.set_float32_matmul_precision(precision)
        if mm:
            mm.fp32_precision = mkldnn_matmul
        with torch.backends.mkldnn.flags(
                enabled=torch.backends.mkldnn.enabled if mkldnn is None
                else mkldnn):
            yield
    finally:
        torch.set_num_threads(old[0])
        if precision:
            torch.set_float32_matmul_precision(old[1])
        if mm:
            mm.fp32_precision = old[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(SETTINGS))
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--kind", default="global")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_blockcheck_cpu_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import BLOCK_SEQ, PERTURB
    from repro_torch import configs as C
    from repro_torch.models.blockcheck import (FLOOR_FACTOR,
                                               block_backward_check)
    cfg = C.get_config(args.arch)
    for name in args.only or list(SETTINGS):
        if "mkldnn_matmul" in SETTINGS[name] and not hasattr(getattr(
                torch.backends.mkldnn, "matmul", None), "fp32_precision"):
            print(json.dumps({"setting": name, "unavailable": True}),
                  flush=True)
            continue
        with cpu_setting(torch, **SETTINGS[name]):
            rep = block_backward_check(cfg, args.kind, "cuda",
                                       seq=BLOCK_SEQ, perturb=PERTURB)
        leaves = rep["leaves"]
        print(json.dumps({
            "setting": name, "arch": args.arch, "kind": args.kind,
            "ok": rep["ok"], "failed": rep["failed"],
            "worst_over_floor": max(r["over_floor"]
                                    for r in leaves.values()),
            "floor_factor": FLOOR_FACTOR, "leaves": leaves}), flush=True)
    print(json.dumps({
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "cpu_threads": torch.get_num_threads(),
        "torch": torch.__version__,
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(ENV_PREFIXES)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
