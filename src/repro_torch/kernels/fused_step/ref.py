"""Reference twins of the fused optimizer+projection passes (port of
``repro.kernels.fused_step.ref``): the oracles the kernels and their plain
versions are held against.

Two invariants every implementation keeps:

1. **Moment-consistent recompute.** Pass 1 stores the new moments in
   ``cfg.moment_dtype`` and derives the updated value u from the STORED
   (cast) moments; pass 2 recomputes u from those same stored moments, so
   the two passes agree bit for bit on u — pass 1's statistics describe
   exactly the matrix pass 2 clips. With f32 moments u also matches the
   unfused ``adam_update`` bit for bit; with bf16 moments the fused step
   quantizes the moments before the step.

2. **Param-dtype rounding before statistics.** u is rounded through the
   param dtype before the |.| statistics and before the clip, as in the
   unfused path, where the packer reads the already-written params.

The update formula mirrors ``optim.adam.adam_leaf_update``.
"""
from __future__ import annotations

import torch

__all__ = ["adam_colstats_ref", "adam_clip_apply_ref"]


def _view3(x: torch.Tensor) -> torch.Tensor:
    """Leaf -> (lead, R, C) view (lead = stacked matrices)."""
    return x.reshape((-1,) + tuple(x.shape[-2:])) if x.ndim > 2 else x[None]


def _u_from_moments(m_st, v_st, p, cfg, lr_t, b1c, b2c, mask):
    """Updated value u in the PARAM dtype from the stored moments."""
    mhat = m_st.to(torch.float32) / b1c
    vhat = v_st.to(torch.float32) / b2c
    step = lr_t * mhat / (torch.sqrt(vhat) + cfg.eps)
    if cfg.weight_decay:
        step = step + lr_t * cfg.weight_decay * p.to(torch.float32)
    if mask is not None:
        step = step * mask.to(torch.float32)
    return (p.to(torch.float32) - step).to(p.dtype)


def adam_colstats_ref(g, m, v, p, *, cfg, lr_t, b1c, b2c, scale=None,
                      mask=None, transpose=False, stat="abs"):
    """Pass 1: Adam moments + per-column (sum, max) of |u|, u never stored.

    Returns (m_new, v_new, colsum, colmax): moments in ``cfg.moment_dtype``
    with the leaf's shape, statistics f32 (lead, m) over the canonical
    columns (the trailing dim, or the second-to-last when ``transpose``).
    ``stat="sq"`` accumulates sum u^2 instead of sum |u|.

    >>> mn, vn, cs, cm = adam_colstats_ref(g, m, v, p, cfg=acfg, lr_t=1e-3,
    ...                                    b1c=b1c, b2c=b2c)
    """
    shape = p.shape
    g3, m3, v3, p3 = _view3(g), _view3(m), _view3(v), _view3(p)
    mk3 = None if mask is None else _view3(mask)
    if scale is not None:
        g3 = (g3 * scale).to(g3.dtype)
    if mk3 is not None:
        g3 = g3 * mk3.to(g3.dtype)
    g32 = g3.to(torch.float32)
    m_new = cfg.b1 * m3.to(torch.float32) + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v3.to(torch.float32) + (1 - cfg.b2) * g32 * g32
    m_st = m_new.to(cfg.moment_dtype)
    v_st = v_new.to(cfg.moment_dtype)
    u = _u_from_moments(m_st, v_st, p3, cfg, lr_t, b1c, b2c, mk3)
    a = u.to(torch.float32).abs()
    red = 2 if transpose else 1
    colsum = (a * a if stat == "sq" else a).sum(dim=red)
    colmax = a.amax(dim=red)
    return m_st.reshape(shape), v_st.reshape(shape), colsum, colmax


def adam_clip_apply_ref(m_st, v_st, p, mu, *, cfg, lr_t, b1c, b2c,
                        mask=None, transpose=False, mode="clip"):
    """Pass 2: recompute u from the stored moments, clip at mu, write.

    ``mu``: (lead, m) f32 per-column level (1e30 = identity, 0 = dead
    column for ``mode="clip"``; a multiplier with identity 1.0 for
    ``mode="scale"``). Returns the params in the leaf's shape and dtype.

    >>> x = adam_clip_apply_ref(mn, vn, p, mu, cfg=acfg, lr_t=1e-3,
    ...                         b1c=b1c, b2c=b2c)
    """
    shape = p.shape
    m3, v3, p3 = _view3(m_st), _view3(v_st), _view3(p)
    mk3 = None if mask is None else _view3(mask)
    uf = _u_from_moments(m3, v3, p3, cfg, lr_t, b1c, b2c, mk3).to(
        torch.float32)
    mu_b = mu[:, :, None] if transpose else mu[:, None, :]
    if mode == "scale":
        x = uf * mu_b
    else:
        x = torch.sign(uf) * torch.minimum(uf.abs(), mu_b)
    if mk3 is not None:
        x = x * mk3.to(torch.float32)
    return x.to(p.dtype).reshape(shape)
