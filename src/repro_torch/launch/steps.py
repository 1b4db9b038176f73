"""Production step builders (port of ``repro.launch.steps``, one device).

``build_train_step``  — loss + gradients + the engine's projected-update
                        core (Adam + the l1,inf family projections,
                        warm-started: the theta state threads through the
                        step's signature), ``(params, opt, proj_state,
                        batch) -> (loss, metrics, params, opt,
                        proj_state)``; ``metrics`` carries the step's
                        Newton evaluations beyond the 2-evaluation floor.
``build_prefill_step``— the full forward, last-token logits.
``build_decode_step`` — one-token serve step against a cache.

On the card a step runs every kernel of its path: the flash-attention and
SSD kernels forward and backward (bf16 or f32, the params' dtype), and,
under the engine's ``solver="fused"``, the fused Adam+projection kernels
for plans that stream their statistics at ``every_k == 1`` and the Newton
for the rest. Params may be bf16 with f32 Adam moments
(``AdamConfig(moment_dtype=torch.float32)``), the reference's production
setting (``lower_cell``); gradients take the params' dtype, as JAX's do.

The train step updates ``params`` and ``opt`` in place (the reference's
jitted step donates them), so callers keep only the returned trees. Its
``every_k`` gates run on the host: it reads the optimizer count once a
step, and a plan off its step is not solved.

``projection_engine_for`` takes a mesh (``launch.mesh``): on more than one
rank it gives the mesh-resident ``solver="fused_sharded"``. The step
builders' ``mesh``, ``rules_for_cell`` and ``lower_cell`` wait for the
sharding rules and the FSDP/TP steps (ROADMAP.md queue A item 8b) and
raise NotImplementedError. ``rules`` name mesh axes and change nothing
without a mesh, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._tree import tree_map
from ..core import ProjectionEngine
from ..models.zoo import Model
from ..optim import AdamConfig
from ..train.loop import _grad_tree

__all__ = ["projection_engine_for", "build_train_step", "build_prefill_step",
           "build_decode_step", "rules_for_cell", "lower_cell"]

_NO_MESH = ("sharding rules and the FSDP/TP steps are not ported to "
            "repro_torch yet (ROADMAP.md queue A item 8b)")


def _one_device(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(f"{what}: mesh {mesh!r}: {_NO_MESH}")


def rules_for_cell(cfg, shape_name: str, multi_pod: bool) -> dict:
    """The per-cell sharding rules: they need a mesh (NotImplementedError)."""
    raise NotImplementedError(f"rules_for_cell: {_NO_MESH}")


def lower_cell(*args, **kwargs):
    """The dry-run lowering over a mesh (NotImplementedError)."""
    raise NotImplementedError(f"lower_cell: {_NO_MESH}")


def projection_engine_for(cfg, mesh=None,
                          with_projection: bool = True) -> ProjectionEngine:
    """The production engine policy: the fused two-pass step wherever it
    exists. On a mesh of more than one rank that is
    ``solver="fused_sharded"``: the fused passes on each rank's column
    block, one (2, num_segments) all-reduce per Newton evaluation, and the
    mesh-resident Newton of ``solver="sharded"`` for plans the fused step
    cannot take. With no mesh, or one rank, it is ``solver="fused"`` with
    the single-buffer Newton as the fallback."""
    specs = cfg.projection_specs if with_projection else ()
    if mesh is not None and mesh.size() > 1:
        return ProjectionEngine(specs, solver="fused_sharded", mesh=mesh)
    return ProjectionEngine(specs, solver="fused")


def _extra_evals(stats: Dict[str, Any], device) -> torch.Tensor:
    """Eq.-(19) evaluations beyond the 2-evaluation bootstrap floor, the
    largest over the plans solved this step (0 when none was)."""
    if not stats:
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.stack([torch.as_tensor(v, device=device).to(torch.int32) - 2
                        for v in stats.values()]).max()


def build_train_step(model: Model, mesh=None, rules: Optional[dict] = None,
                     acfg: AdamConfig = AdamConfig(),
                     with_projection: bool = True):
    """The production train step: ``train_step(params, opt_state,
    proj_state, batch) -> (loss, metrics, params, opt_state, proj_state)``
    with ``metrics["proj_newton_extra_evals"]`` beside the loss's own
    metrics. ``params`` and ``opt_state`` are updated in place."""
    _one_device(mesh, "build_train_step")
    engine = projection_engine_for(model.cfg, None, with_projection)

    def train_step(params, opt_state, proj_state, batch):
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_tree(params, grads)
        loss, metrics = model.loss(leaves, batch)
        loss.backward()
        del leaves
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            new_params, new_opt, new_proj, stats = engine.projected_update(
                grads, opt_state, params, acfg, state=proj_state,
                with_stats=True, count=int(opt_state.count) + 1,
                inplace=True)
        metrics["proj_newton_extra_evals"] = _extra_evals(stats, loss.device)
        return loss, metrics, new_params, new_opt, new_proj

    return train_step


def build_prefill_step(model: Model, mesh=None,
                       rules: Optional[dict] = None):
    """``prefill_step(params, batch) -> logits (B, V)`` of the last token."""
    _one_device(mesh, "build_prefill_step")

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits[:, -1, :]

    return prefill_step


def build_decode_step(model: Model, mesh=None,
                      rules: Optional[dict] = None):
    """``serve_step(params, cache, tokens, pos) -> (logits (B, V), new
    cache)``; the cache passed in is left as it was."""
    _one_device(mesh, "build_decode_step")

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = model.decode(params, cache, tokens, pos)
        return logits[:, -1, :], new_cache

    return serve_step
