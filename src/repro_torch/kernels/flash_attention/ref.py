"""Dense-softmax oracle for the flash attention kernel."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  groups: int = 1, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BKV, Skv, hd), BH = BKV * groups."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    k = k.repeat_interleave(groups, dim=0)
    v = v.repeat_interleave(groups, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * hd ** -0.5
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask[None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None], p, torch.zeros((), device=q.device))
    out = torch.einsum("bqk,bkh->bqh", p, v.float())
    return out.to(q.dtype)
