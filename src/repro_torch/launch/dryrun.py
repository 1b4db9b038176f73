"""The multi-pod dry-run (port of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell on the production meshes on ``meta`` tensors,
with nothing allocated, and record each cell's memory per device, its
counts and its roofline terms at the H100's constants.

The reference lowers and compiles each cell for 256 or 512 forced host
devices and parses the HLO. The port has no compiler: it runs the cell's
step once (``launch.steps.lower_cell``) as rank 0 of a fake process group
of 256 or 512 ranks (``torch.distributed``'s "fake" backend: collectives
return at once, moving nothing), on meta tensors, under
``roofline.counter.Counter``, and ``roofline.analysis.analyze`` turns the
counts into the roofline. The dry-run initialises the fake group itself
and tears it down, so run it as its own process (a group the process
already holds would be in the way).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma_7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all            # every runnable cell
  python -m repro_torch.launch.dryrun --list           # show the cell matrix

One JSON per cell is written to experiments/dryrun_torch/<cell>.json;
failures are recorded with the exception text (they are bugs: the sweep
continues, and exits 1 if any cell failed).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback

from ..configs import ARCH_IDS, get_config
from ..models.zoo import SHAPES, build, cell_supported
from ..roofline.analysis import (HBM_BYTES, active_params, analyze,
                                 model_flops_for)
from .mesh import make_production_mesh
from .steps import lower_cell

__all__ = ["OUT_DIR", "run_cell", "cell_list", "fake_group", "main"]

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the ``with`` block (destroyed after it)."""
    import torch.distributed as dist
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mem_dict(cell) -> dict:
    """The reference's memory keys where they mean something here, from
    the live-bytes peak: arguments (rank 0's pieces of params, moments,
    theta state, batch or cache; beside them the sum of those pieces' own
    bytes, which the arguments' storages must equal), outputs that are
    not arguments, temp (the peak less the arguments: what the step holds
    at its peak beyond them), total (the peak) and whether it fits one
    card's 80 GB."""
    c = cell.counts
    out = {"argument_size_in_bytes": int(c.argument_bytes),
           "argument_pieces_bytes": int(cell.pieces_bytes),
           "output_size_in_bytes": int(cell.output_bytes),
           "temp_size_in_bytes": int(c.peak_bytes - c.argument_bytes),
           "total_bytes_per_device": int(c.peak_bytes)}
    out["fits_80gb"] = out["total_bytes_per_device"] <= HBM_BYTES
    return out


def run_cell(arch: str, shape: str, mesh_kind: str,
             extra_rules: dict | None = None,
             config_overrides: dict | None = None,
             tag: str = "") -> dict:
    """Trace one cell on its production mesh (a fake group of 256 or 512
    ranks, set up and torn down here; bf16 params, f32 moments, as the
    reference's) and return its record."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    multi_pod = mesh_kind == "multipod"
    n_chips = 512 if multi_pod else 256
    model = build(cfg)
    with fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        cell = lower_cell(model, shape, mesh, multi_pod,
                          extra_rules=extra_rules)
        t_trace = time.time() - t0
    n_total = model.n_params()
    n_active = active_params(cfg, n_total)
    rf = analyze(arch, shape, mesh_kind, n_chips, cell.counts,
                 model_flops_for(cfg, shape, n_total, n_active),
                 memory_analysis=_mem_dict(cell))
    rec = rf.to_json()
    rec.update({"status": "ok", "kind": cell.kind, "tag": tag,
                "n_params_total": n_total, "n_params_active": n_active,
                "trace_s": round(t_trace, 1)})
    return rec


def cell_list():
    """(arch, shape, mesh, runnable, why) for every cell, the reference's
    order."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            for mesh_kind in ("pod", "multipod"):
                cells.append((arch, shape, mesh_kind, ok, why))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of logical-rule overrides (perf sweeps)")
    ap.add_argument("--config-overrides", default=None,
                    help="JSON dict of ArchConfig field overrides")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, mesh_kind, ok, why in cell_list():
            print(f"{arch:22s} {shape:12s} {mesh_kind:9s} "
                  f"{'RUN' if ok else 'SKIP: ' + why}")
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    extra = json.loads(args.rules) if args.rules else None
    cfg_over = (json.loads(args.config_overrides)
                if args.config_overrides else None)
    todo = ([(args.arch, args.shape, args.mesh)] if not args.all else
            [(a, s, m) for a, s, m, _, _ in cell_list()])
    n_fail = 0
    for arch, shape, mesh_kind in todo:
        name = f"{arch}__{shape}__{mesh_kind}"
        if args.tag != "baseline":
            name += f"__{args.tag}"
        print(f"=== {name} ===", flush=True)
        try:
            rec = run_cell(arch, shape, mesh_kind, extra_rules=extra,
                           config_overrides=cfg_over, tag=args.tag)
        except Exception as e:  # a failure here is a bug; record, go on
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "failed", "error": f"{type(e).__name__}: {e}",
                   "tag": args.tag}
            n_fail += 1
        (OUT_DIR / f"{name}.json").write_text(
            json.dumps(rec, indent=1, default=str))
        print(json.dumps({k: rec.get(k) for k in
                          ("status", "dominant", "compute_s", "memory_s",
                           "collective_s", "roofline_fraction", "trace_s")},
                         default=str), flush=True)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
