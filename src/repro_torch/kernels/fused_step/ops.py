"""The fused Adam+projection passes at the leaf level (port of
``repro.kernels.fused_step.ops``).

One projected train step over a constrained leaf is ``fused_adam_colstats``
(pass 1: moments out, per-column |u| statistics out, u never written), the
O(num_segments) segmented Newton on those statistics (``core.engine``) and
``fused_adam_clip_apply`` (pass 2: u recomputed from the stored moments,
clipped or scaled, written): two passes over the leaf's memory.

Both take the leaf in its own layout (rank >= 2, leading dims stacked) and
hand the kernels its contiguous (L, R, C) view; the CUDA kernels take any
shape, so nothing is padded. Dispatch is by the tensor's device alone
(``kernel.py``): the plain versions on the CPU, the kernels on the card.
The step scalars (lr_t, b1c, b2c) come from ``optim.adam.adam_scalars``
and ``scale`` from ``optim.adam.clip_scale``, so the fused and unfused
paths share one definition of the update; they may be device tensors and
stay on the device.
"""
from __future__ import annotations

import torch

from . import kernel as _k

__all__ = ["fused_adam_colstats", "fused_adam_clip_apply"]


def _view3(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape((-1,) + tuple(x.shape[-2:])) if x.ndim > 2 else x[None]
    return x.contiguous()


def _scalars(scale, lr_t, b1c, b2c, device) -> torch.Tensor:
    """(4,) f32 [clip_scale, lr_t, b1c, b2c] on ``device``, built from
    Python floats (filled on the device) or device tensors, with no copy
    from the host and so no host sync."""
    def f(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.stack([f(1.0 if scale is None else scale), f(lr_t), f(b1c),
                        f(b2c)])


def _mask3(mask, p3):
    return None if mask is None else _view3(mask).to(p3.dtype)


def fused_adam_colstats(g, m, v, p, *, cfg, lr_t, b1c, b2c, scale=None,
                        mask=None, transpose: bool = False,
                        stat: str = "abs"):
    """Pass 1 of the fused step: Adam moments + Newton column statistics.

    ``g``/``m``/``v``/``p``: gradient, moments (in ``cfg.moment_dtype``) and
    param leaf (rank >= 2, leading dims stacked; g in p's dtype); ``cfg``:
    AdamConfig; ``lr_t``/``b1c``/``b2c``: the step scalars; ``scale``:
    optional global-norm clip multiplier; ``mask``: optional {0,1} leaf
    (zeroes the grads and the whole step); ``transpose``: the spec's max
    axis is the trailing dim (canonical columns are then the
    second-to-last dim); ``stat``: "abs" (sum |u|) or "sq" (sum u^2).
    Returns ``(m_new, v_new, colsum, colmax)``: moments with the leaf's
    shape, statistics f32 (lead, m) of the never-written |u|.

    >>> mn, vn, cs, cm = fused_adam_colstats(g, m, v, p, cfg=acfg,
    ...     lr_t=1e-3, b1c=b1c, b2c=b2c, transpose=True)
    """
    if stat not in ("abs", "sq"):
        raise ValueError(f"unknown stat {stat!r} (abs | sq)")
    if m.dtype != cfg.moment_dtype or v.dtype != cfg.moment_dtype:
        raise TypeError(f"moments are {m.dtype}/{v.dtype}, the config "
                        f"stores {cfg.moment_dtype}")
    shape = p.shape
    p3 = _view3(p)
    m_new, v_new, colsum, colmax = _k.adam_colstats(
        _scalars(scale, lr_t, b1c, b2c, p.device), _view3(g), _view3(m),
        _view3(v), p3, _mask3(mask, p3), b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        wd=cfg.weight_decay, transpose=transpose, stat=stat)
    return m_new.reshape(shape), v_new.reshape(shape), colsum, colmax


def fused_adam_clip_apply(m, v, p, mu, *, cfg, lr_t, b1c, b2c, mask=None,
                          transpose: bool = False, mode: str = "clip"):
    """Pass 2 of the fused step: recompute the update, clip, write params.

    ``m``/``v``: the moments pass 1 just wrote; ``p``: the ORIGINAL
    (pre-step) params; ``mu``: (lead, m) f32 per-column level with the
    engine's gating folded in (clip: 1e30 = identity, 0 = dead column;
    scale: a multiplier, identity 1.0). Returns the projected params in
    the leaf's shape and dtype — the only param write of the step.

    >>> p_new = fused_adam_clip_apply(mn, vn, p, mu, cfg=acfg,
    ...     lr_t=1e-3, b1c=b1c, b2c=b2c)
    """
    if mode not in ("clip", "scale"):
        raise ValueError(f"unknown mode {mode!r} (clip | scale)")
    p3 = _view3(p)
    mu = torch.as_tensor(mu, dtype=torch.float32,
                         device=p.device).contiguous()
    x = _k.adam_clip_apply(
        _scalars(None, lr_t, b1c, b2c, p.device), _view3(m), _view3(v), p3,
        mu, _mask3(mask, p3), b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        wd=cfg.weight_decay, transpose=transpose, mode=mode)
    return x.reshape(p.shape)
