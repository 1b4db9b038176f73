"""Training runner (port of ``repro.train.loop``): the production loop with
every fault-tolerance feature wired in (checkpoint/restart, straggler
watchdog, deterministic data, projection constraints, microbatch gradient
accumulation).

``train`` runs on the card unless given ``device=`` (the tests pass
"cpu"). On the card every full-sequence attention of the step goes through
the flash-attention kernels, forward and backward, and the projection
through the engine's solver (``proj_solver="kernel"``: the l1,inf
kernels), and every SSD scan of an ``ssm`` or ``hybrid`` block through
the SSD kernels, forward and backward (``SSDFunction``). On the CPU the
same step runs the kernels' plain versions.

The step owns its state as the reference's jitted step owns its donated
buffers: the backward accumulates into one f32 gradient tree in place, and
the Adam update writes the params and moments in place (``inplace`` of
``ProjectionEngine.projected_update``), so a full-size step holds params,
gradients and moments once each (and a projected leaf twice, briefly).
``mesh`` and ``rules`` are accepted for the reference's signature and must
be None until the sharding rules and the FSDP/TP step are ported
(ROADMAP.md queue A item 8b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map
from ..checkpoint import AsyncCheckpointer, latest_step, restore_tree
from ..core import ProjectionEngine, sparsity_report
from ..data.pipeline import LMBatcher
from ..dist.watchdog import StepWatchdog
from ..models.zoo import Model
from ..optim import AdamConfig, adam_init

__all__ = ["TrainConfig", "build_accum_step", "lr_at", "train"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    microbatches: int = 1          # gradient accumulation
    lr: float = 3e-4
    warmup: int = 20
    with_projection: bool = True
    proj_solver: str = "fused"     # engine solver; "fused" = two-pass step
                                   # where the family supports it, Newton
                                   # elsewhere ("kernel": the l1,inf kernels)
    seed: int = 0


def _no_mesh(mesh, rules):
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "mesh / rules: sharding rules and the FSDP/TP train step are "
            "not ported to repro_torch yet (ROADMAP.md queue A item 8b)")


def _grad_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``p``'s storage whose gradient accumulates into ``g``
    in place (autograd adds into a ``.grad`` that is already set)."""
    leaf = p.detach().requires_grad_()
    leaf.grad = g
    return leaf


def _grad_tree(params: Dict[str, Any], grads: Dict[str, Any]):
    """The tree the backward differentiates. Each stacked block leaf (the
    decoder's and an encoder's) is handed over as one leaf a layer (``models.transformer._layer`` takes
    either): indexing a stacked leaf under autograd would build a
    full-size zero gradient for every layer."""
    return {k: tree_map(
        (lambda p, g: [_grad_leaf(p[i], g[i]) for i in range(p.shape[0])])
        if k in ("blocks", "enc_blocks") else _grad_leaf, v, grads[k])
        for k, v in params.items()}


def build_accum_step(model: Model, acfg: AdamConfig, tcfg: TrainConfig,
                     mesh=None, rules=None, engine: ProjectionEngine = None):
    """The train step ``step(params, opt_state, proj_state, batch, lr,
    count=None) -> (params, opt_state, proj_state, loss)``: the gradients
    of ``tcfg.microbatches`` microbatches (consecutive row blocks of the
    batch) summed in microbatch order in f32 and divided by their number,
    then the shared ``ProjectionEngine.projected_update`` step core (Adam +
    packed warm-started projection + every_k gate). ``count`` is the new
    optimizer count on the host, when the caller tracks it (``train``
    does): the every_k gates then skip the solves off their step. The
    step's Adam update writes into the tensors of ``params`` and
    ``opt_state``, so the caller uses the returned trees only; params are
    f32.
    """
    _no_mesh(mesh, rules)
    cfg = model.cfg
    if engine is None:
        engine = ProjectionEngine(
            cfg.projection_specs if tcfg.with_projection else (),
            solver=tcfg.proj_solver)
    n = tcfg.microbatches

    def step(params, opt_state, proj_state, batch, lr, count=None):
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_tree(params, grads)
        rows = next(iter(batch.values())).shape[0] // n
        loss = None
        for j in range(n):
            mb = {key: x[j * rows:(j + 1) * rows] for key, x in batch.items()}
            l, _ = model.loss(leaves, mb)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
        del leaves
        if n > 1:
            tree_map(lambda g: g.div_(n), grads)
            loss = loss / n
        with torch.no_grad():
            params, opt_state, proj_state = engine.projected_update(
                grads, opt_state, params, acfg, lr=lr, state=proj_state,
                count=count, inplace=True)
        return params, opt_state, proj_state, loss

    return step


def lr_at(tcfg: TrainConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(tcfg.warmup, 1))
    return tcfg.lr * warm


def train(model: Model, batcher: LMBatcher, tcfg: TrainConfig,
          mesh=None, rules=None, resume: bool = True,
          on_step: Optional[Callable[[int, float, float], None]] = None,
          device=None) -> Dict[str, Any]:
    """Run the loop on ``device`` (the card when None; raises when CUDA is
    missing); auto-resumes from the latest checkpoint in ``tcfg.ckpt_dir``
    if present. Params start from ``model.init`` with a
    ``torch.Generator(device)`` seeded by ``tcfg.seed``; batches go to the
    device as int64.

    >>> out = train(build(cfg), LMBatcher(SyntheticLM(cfg.vocab), 2, 16),
    ...             TrainConfig(steps=4), device="cpu")
    """
    _no_mesh(mesh, rules)
    dev = resolve_device(device)
    acfg = AdamConfig(lr=tcfg.lr)
    params = model.init(torch.Generator(device=dev).manual_seed(tcfg.seed),
                        device=dev)
    opt_state = adam_init(params, acfg)
    start_step = 0

    engine = ProjectionEngine(
        model.cfg.projection_specs if tcfg.with_projection else (),
        solver=tcfg.proj_solver)
    proj_state = engine.init_state(params)

    ckpt = None
    if tcfg.ckpt_dir:
        ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        if resume and latest_step(tcfg.ckpt_dir) is not None:
            # the projection theta state rides in the checkpoint so a resume
            # stays warm-started; pre-engine checkpoints lack it — fall back
            # to a cold Newton start rather than refusing the restore
            try:
                state = {"params": params, "opt": opt_state,
                         "proj": proj_state}
                state, start_step = restore_tree(state, tcfg.ckpt_dir)
                proj_state = state["proj"]
            except KeyError:
                state = {"params": params, "opt": opt_state}
                state, start_step = restore_tree(state, tcfg.ckpt_dir)
                print("[train] checkpoint has no projection state; "
                      "cold-starting Newton")
            params, opt_state = state["params"], state["opt"]
            del state
            print(f"[train] resumed from step {start_step}")

    step_fn = build_accum_step(model, acfg, tcfg, engine=engine)
    watchdog = StepWatchdog(on_straggler=lambda s, dt, ew: print(
        f"[watchdog] straggler step {s}: {dt:.3f}s vs EWMA {ew:.3f}s"))

    count = int(opt_state.count)        # tracked on the host from here
    losses = []
    step_metrics = []   # per-step watchdog snapshots (dist/watchdog.py)
    for step in range(start_step, tcfg.steps):
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev, torch.int64)
                 for k, v in batcher.get(step).items()}
        watchdog.start()
        count += 1
        params, opt_state, proj_state, loss = step_fn(
            params, opt_state, proj_state, batch, lr_at(tcfg, step),
            count=count)
        loss_f = float(loss)            # waits for the step
        dt = watchdog.stop(step)
        step_metrics.append(watchdog.metrics())
        losses.append(loss_f)
        if on_step:
            on_step(step, loss_f, dt)
        if step % tcfg.log_every == 0:
            print(f"[train] step {step:5d} loss {loss_f:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if ckpt and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save({"params": params, "opt": opt_state,
                       "proj": proj_state}, step + 1)
    if ckpt:
        ckpt.save({"params": params, "opt": opt_state, "proj": proj_state},
                  tcfg.steps)
        ckpt.wait()

    report = {}
    if model.cfg.projection_specs:
        report = sparsity_report(params, model.cfg.projection_specs)
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "proj_state": proj_state, "sparsity": report,
            "straggler_events": watchdog.events,
            "step_metrics": step_metrics,
            "watchdog": watchdog.metrics()}
