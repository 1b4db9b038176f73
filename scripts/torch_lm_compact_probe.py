#!/usr/bin/env python3
"""How far hymba-1.5b's logits move under f32 rounding noise once its
projection specs are applied, by depth and by spec — the noise floor that
``chip_smoke.py``'s lm_compact phase compares its compact forward with.

    python3 scripts/torch_lm_compact_probe.py

Builds hymba-1.5b at full width with ``chip_smoke.lm_compact_params``
(phase 10's params: seed 6, one U(0, 1) factor per hidden unit of w1),
then for each variant — no projection, both specs (``mlp/w1`` and ``ssm/wx``,
radius 32, through the kernel engine), ``mlp/w1`` only, ``ssm/wx`` only —
and each depth (the first L layers of the stack), one f32 forward of a
(1, 2048) batch, the same forward with every weight multiplied by
(1 + 1e-6 N(0, 1)) (chip_smoke's PERTURB), and, where the specs compact
w1, the compact forward: prints max |diff| over the true vocab and the
logits' scale as JSON lines. Needs one CUDA card.
"""
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (1, 2, 4, 8, 16, 32)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_compact_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import PERTURB, lm_compact_params
    from repro_torch import configs as C
    from repro_torch._tree import tree_map
    from repro_torch.core import ProjectionEngine
    from repro_torch.models import zoo as Z
    from repro_torch.serve import compact_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, params = lm_compact_params(torch, Z, C, dev)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    V = cfg.vocab
    specs = {s: tuple(dataclasses.replace(cfg.projection_specs[0],
                                          pattern=p) for p in pats)
             for s, pats in (("both", (r"blocks/.*/(mlp/w1|ssm/wx)$",)),
                             ("mlp_w1", (r"blocks/.*/mlp/w1$",)),
                             ("ssm_wx", (r"blocks/.*/ssm/wx$",)))}
    variants = {"none": (params, None)}
    for name, sp in specs.items():
        dense, _ = ProjectionEngine(sp, solver="kernel").apply(params)
        cm = compact_model(dense, sp) if name != "ssm_wx" else None
        variants[name] = (dense, cm)
    for name, (dense, cm) in variants.items():
        for L in DEPTHS:
            dcfg = dataclasses.replace(cfg, n_layers=L)
            model = Z.build(dcfg)
            cut = lambda p: {**p, "blocks": tree_map(lambda a: a[:L],
                                                     p["blocks"])}
            dp = cut(dense)
            g = torch.Generator(device=dev).manual_seed(8)
            pert = tree_map(lambda a: a * (1 + PERTURB * torch.randn(
                a.shape, generator=g, device=dev))
                if a.is_floating_point() else a, dp)
            with torch.no_grad():
                ref = model.forward(dp, {"tokens": tokens})[0][..., :V]
                moved = model.forward(pert, {"tokens": tokens})[0][..., :V]
                line = {"variant": name, "depth": L,
                        "scale": float(ref.abs().max()),
                        "noise_floor": float((moved - ref).abs().max())}
                if cm is not None:
                    out = model.forward(cut(cm.params), {"tokens": tokens})
                    line["compact_vs_dense"] = float(
                        (out[0][..., :V] - ref).abs().max())
            print(json.dumps(line), flush=True)
            del pert, ref, moved
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
