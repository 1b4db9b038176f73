"""Adam/AdamW on nested-dict parameter trees (port of
``repro.optim.adam``).

fp32 moment math regardless of the parameter dtype, moments stored in
``moment_dtype``, decoupled weight decay, global-norm clipping, bias
correction and masked updates (Algorithm 3's support freeze). The update
is factored into scalar helpers (``adam_scalars``, ``clip_scale``) and a
per-leaf update (``adam_leaf_update``), as in the JAX package.

Mask semantics: ``mask`` zeroes the WHOLE step of masked-out entries — the
gradient before the moment update AND the decoupled weight-decay term —
so a frozen entry is bit-identical across steps for any weight decay.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .._tree import leaves, tree_map, unflatten_like

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update",
           "adam_scalars", "adam_leaf_update", "global_norm",
           "clip_by_global_norm", "clip_scale"]


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32


class AdamState(NamedTuple):
    count: torch.Tensor      # 0-d int32 on the parameters' device
    mu: Any
    nu: Any


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32)."""
    ls = leaves(tree)
    total = 0
    for l in ls:
        total = total + torch.sum(torch.square(l.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(tree: Any, max_norm: float) -> torch.Tensor:
    """The global-norm clipping multiplier min(1, max_norm / ||g||)."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Any:
    """``tree`` scaled by ``clip_scale(tree, max_norm)``; each leaf is
    multiplied in the promoted dtype (f32 for bf16 leaves, as JAX does)
    and returned in its own.

    >>> grads = clip_by_global_norm(grads, 1.0)
    """
    scale = clip_scale(tree, max_norm)
    return tree_map(lambda g: (g.to(torch.promote_types(g.dtype, scale.dtype))
                               * scale).to(g.dtype), tree)


def adam_init(params: Any, cfg: AdamConfig = AdamConfig()) -> AdamState:
    """Zero moments in ``cfg.moment_dtype`` on each leaf's device; the
    count lives on the first leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adam_scalars(cfg: AdamConfig, count: torch.Tensor, lr=None):
    """(lr_t, b1c, b2c) at the POST-increment count: ``lr`` overrides
    ``cfg.lr``; b1c/b2c are the bias-correction denominators 1 - b^t."""
    lr_t = cfg.lr if lr is None else lr
    t = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=t.device), t)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=t.device), t)
    return lr_t, b1c, b2c


def adam_leaf_update(g, m, v, p, cfg: AdamConfig, lr_t, b1c, b2c, *,
                     mask=None, scale=None):
    """One leaf of the Adam update: (p_new, m_new, v_new).

    f32 math; moments stored in ``cfg.moment_dtype``; ``scale`` is the
    global-norm clip multiplier, applied as ``(g * scale).to(g.dtype)``;
    ``mask`` zeroes the gradient AND the whole step (decay included).
    """
    if scale is not None:
        g = (g * scale).to(g.dtype)
    if mask is not None:
        g = g * mask.to(g.dtype)
    g32 = g.to(torch.float32)
    m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
    mhat = m_new / b1c
    vhat = v_new / b2c
    step = lr_t * mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        step = step + lr_t * cfg.weight_decay * p.to(torch.float32)
    if mask is not None:
        step = step * mask.to(torch.float32)
    return ((p.to(torch.float32) - step).to(p.dtype),
            m_new.to(cfg.moment_dtype), v_new.to(cfg.moment_dtype))


def adam_update(grads: Any, state: AdamState, params: Any,
                cfg: AdamConfig = AdamConfig(), lr=None, mask: Any = None,
                inplace: bool = False):
    """Returns (new_params, new_state). ``lr`` overrides ``cfg.lr``;
    ``mask`` (same tree, {0,1}) freezes masked-out entries.

    ``inplace`` writes the new params and moments into the tensors of
    ``params`` and ``state`` (returned, with a new count), one slice of a
    stacked leaf's leading dim at a time: the step then holds one layer's
    temporaries beside the state, where the functional update holds a
    second copy of the params and moments. The train loop donates its
    state so (JAX's ``donate_argnums``); the values are bit-equal to the
    functional update's.
    """
    count = state.count + 1
    lr_t, b1c, b2c = adam_scalars(cfg, count, lr)
    scale = (clip_scale(grads, cfg.clip_norm)
             if cfg.clip_norm is not None else None)
    p_l, g_l = leaves(params), leaves(grads)
    m_l, v_l = leaves(state.mu), leaves(state.nu)
    mk_l = leaves(mask) if mask is not None else [None] * len(p_l)
    if inplace:
        for p, g, m, v, mk in zip(p_l, g_l, m_l, v_l, mk_l):
            for i in (range(p.shape[0]) if p.ndim > 2 else (...,)):
                out = adam_leaf_update(g[i], m[i], v[i], p[i], cfg, lr_t, b1c,
                                       b2c, mask=None if mk is None else mk[i],
                                       scale=scale)
                for dst, src in zip((p[i], m[i], v[i]), out):
                    dst.copy_(src)
        return params, AdamState(count=count, mu=state.mu, nu=state.nu)
    out = [adam_leaf_update(g, m, v, p, cfg, lr_t, b1c, b2c, mask=mk,
                            scale=scale)
           for p, g, m, v, mk in zip(p_l, g_l, m_l, v_l, mk_l)]
    new_p = unflatten_like(params, [o[0] for o in out])
    new_m = unflatten_like(params, [o[1] for o in out])
    new_v = unflatten_like(params, [o[2] for o in out])
    return new_p, AdamState(count=count, mu=new_m, nu=new_v)
