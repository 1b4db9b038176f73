"""Projected training of the supervised autoencoder — the paper's Algorithm 3
(port of ``repro.sae.train``).

Double descent (Frankle-Carbin style, as adapted by the paper):
  descent 1: projected Adam (projection applied after every update);
  mask:      M0 = surviving column support of the constrained weight;
  rewind:    weights back to their initial values, masked by M0;
  descent 2: retrain with gradients masked by M0 (zero columns stay frozen),
             projection kept active.

As in the JAX package, ``train_sae`` builds its engine with
``solver="fused"``; no ported family streams its statistics, so the plain
l1,inf constraint runs the packed Newton. ``projected_step`` is the one
training step (forward, autograd backward, ``projected_update``) and takes
any engine, e.g. ``solver="kernel"`` to run the projection on the CUDA
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._tree import leaves, tree_map, unflatten_like
from ..core import (ProjectionEngine, ProjectionSpec, column_masks,
                    family_for_norm, sparsity_report)
from ..optim import AdamConfig, adam_init
from .model import SAEConfig, accuracy, sae_init, sae_loss

__all__ = ["SAETrainConfig", "SAEResult", "projected_step", "train_sae"]


@dataclasses.dataclass(frozen=True)
class SAETrainConfig:
    epochs: int = 30
    batch_size: int = 128
    lr: float = 1e-3
    seed: int = 0
    double_descent: bool = True
    projection: Optional[ProjectionSpec] = None   # None => unconstrained


@dataclasses.dataclass
class SAEResult:
    params: dict
    test_accuracy: float
    column_sparsity: float     # % of feature columns of enc1/w fully zero
    selected: np.ndarray       # indices of surviving features
    history: list
    # per-epoch surviving-column fraction J/m of the constrained leaves
    compaction_history: list = dataclasses.field(default_factory=list)
    compaction_ratio: float = 1.0


def projected_step(params: Dict[str, Any], opt_state, proj_state, x, y,
                   mask, *, cfg: SAEConfig, acfg: AdamConfig,
                   engine: ProjectionEngine):
    """One training step: SAE forward, autograd backward, then the engine's
    ``projected_update`` (Adam with the mask, packed warm-started
    projection, mask freeze). Returns (params, opt_state, proj_state,
    loss, aux) with detached tensors."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = sae_loss(live, x, y, cfg)
    grads = unflatten_like(params, list(torch.autograd.grad(
        loss, leaves(live))))
    with torch.no_grad():
        params, opt_state, proj_state = engine.projected_update(
            grads, opt_state, tree_map(torch.Tensor.detach, params), acfg,
            mask=mask, state=proj_state)
    return (params, opt_state, proj_state, loss.detach(),
            {k: v.detach() for k, v in aux.items()})


def _make_step(cfg: SAEConfig, tcfg: SAETrainConfig, acfg: AdamConfig):
    specs = (tcfg.projection,) if tcfg.projection else ()
    # "fused" routes every plan as the JAX trainer does (Newton for plain
    # l1,inf — see the module docstring)
    engine = ProjectionEngine(specs, solver="fused")

    def step(params, opt_state, proj_state, x, y, mask):
        return projected_step(params, opt_state, proj_state, x, y, mask,
                              cfg=cfg, acfg=acfg, engine=engine)

    return step, engine


def _compaction_ratio(params, specs) -> float:
    """Mean surviving-column fraction J/m of the constrained leaves."""
    rep = sparsity_report(params, specs)
    if not rep:
        return 1.0
    return float(np.mean([1.0 - v / 100.0 for v in rep.values()]))


def _run_descent(params, step_fn, engine, X, y, tcfg, mask, rng, specs=()):
    acfg = AdamConfig(lr=tcfg.lr)
    opt_state = adam_init(params, acfg)
    proj_state = engine.init_state(params)
    n = X.shape[0]
    history, compaction = [], []
    for _ in range(tcfg.epochs):
        perm = rng.permutation(n)
        for s in range(0, n, tcfg.batch_size):
            idx = torch.as_tensor(perm[s:s + tcfg.batch_size],
                                  device=X.device)
            params, opt_state, proj_state, loss, _ = step_fn(
                params, opt_state, proj_state, X[idx], y[idx], mask)
        history.append(float(loss))
        compaction.append(_compaction_ratio(params, specs))
    return params, history, compaction


def train_sae(X_train: np.ndarray, y_train: np.ndarray,
              X_test: np.ndarray, y_test: np.ndarray,
              cfg: SAEConfig, tcfg: SAETrainConfig, *,
              params0: Optional[Dict[str, Any]] = None,
              device: Optional[str] = None) -> SAEResult:
    """Algorithm 3 end to end on numpy data.

    ``params0``: optional starting parameters (a tree of tensors, e.g.
    carried from the JAX package with ``convert.params_from_numpy``); by
    default ``sae_init`` draws them from a generator seeded with
    ``tcfg.seed``. ``device``: where to train (the card when None; raises
    if CUDA is missing). Batches are drawn from
    ``np.random.default_rng(tcfg.seed)`` as in the JAX package.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(tcfg.seed)
    X_train = torch.as_tensor(np.asarray(X_train, np.float32), device=dev)
    y_train_t = torch.as_tensor(np.asarray(y_train), dtype=torch.int64,
                                device=dev)

    if params0 is None:
        gen = torch.Generator().manual_seed(tcfg.seed)
        params0 = sae_init(cfg, generator=gen, device=dev)
    else:
        params0 = tree_map(lambda p: p.detach().to(dev), params0)
    ones_mask = tree_map(torch.ones_like, params0)
    acfg = AdamConfig(lr=tcfg.lr)

    # masked variant (Eq. 20): descent 1 uses the TRUE projection to find
    # the support; descent 2 keeps only the frozen mask, magnitudes
    # unbounded
    fam = (family_for_norm(tcfg.projection.norm)
           if tcfg.projection is not None else None)
    masked_mode = fam is not None and fam.name == "l1inf_masked"
    if masked_mode:
        tcfg1 = dataclasses.replace(tcfg, projection=dataclasses.replace(
            tcfg.projection, norm="l1inf"))
    else:
        tcfg1 = tcfg
    step_fn, step_engine = _make_step(cfg, tcfg1, acfg)

    eval_specs = (tcfg1.projection,) if tcfg1.projection else ()

    # ---- descent 1: projected training --------------------------------
    params, hist1, comp1 = _run_descent(params0, step_fn, step_engine,
                                        X_train, y_train_t, tcfg, ones_mask,
                                        rng, specs=eval_specs)
    history = [("descent1", hist1)]
    compaction_history = [("descent1", comp1)]

    # ---- double descent: mask, rewind, retrain -------------------------
    if tcfg.projection and tcfg.double_descent:
        specs = (tcfg1.projection,)
        masks = column_masks(params, specs)
        rewound = tree_map(lambda p0, m: p0 * m, params0, masks)
        if masked_mode:  # retrain mask-only, no clipping
            step_fn, step_engine = _make_step(
                cfg, dataclasses.replace(tcfg, projection=None), acfg)
        params, hist2, comp2 = _run_descent(rewound, step_fn, step_engine,
                                            X_train, y_train_t, tcfg, masks,
                                            rng, specs=eval_specs)
        history.append(("descent2", hist2))
        compaction_history.append(("descent2", comp2))

    with torch.no_grad():
        test_acc = float(accuracy(
            params, torch.as_tensor(np.asarray(X_test, np.float32),
                                    device=dev),
            torch.as_tensor(np.asarray(y_test), dtype=torch.int64,
                            device=dev)))
    w1 = params["enc1"]["w"].detach().cpu().numpy()
    live = np.any(w1 != 0, axis=1)
    colsp = 100.0 * (1.0 - live.mean())
    return SAEResult(params=params, test_accuracy=test_acc,
                     column_sparsity=float(colsp),
                     selected=np.nonzero(live)[0], history=history,
                     compaction_history=compaction_history,
                     compaction_ratio=_compaction_ratio(params, eval_specs))
