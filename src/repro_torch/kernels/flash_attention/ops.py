"""Model-shaped GQA flash attention.

Accepts the model-layer layout (B, S, H, hd) / (B, S, KV, hd), folds batch x
heads into the kernel's leading dim and calls ``flash_attention_fwd``: the
CUDA kernel for tensors on the card, its plain version on the CPU.

A v head dim below q/k's (MLA: q/k 192, v 128) is zero-padded up to q/k's
before the call and the output sliced back after it. The kernels keep
their contract (v shaped like k) and the scale stays q/k's ``hd ** -0.5``,
as the reference's ``chunked_attention`` takes it from q. The padding is
plain autograd (``F.pad``, then a slice), so the backward kernel sees the
padded v, the padded columns of dv come back zero and the pad's own
gradient drops them. The cost is the padded columns' share of the p @ v
product and of v's and out's bytes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import flash_attention_fwd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, hd_v) with
    hd_v <= hd -> (B, Sq, H, hd_v). ``block_q`` / ``block_kv`` set the
    plain version's tiles only."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    hd_v = v.shape[-1]
    if hd_v > hd:
        raise ValueError(f"flash_attention: v head dim {hd_v} > q/k head "
                         f"dim {hd}")
    if hd_v < hd:
        v = F.pad(v, (0, hd - hd_v))
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    out = flash_attention_fwd(qf, kf, vf, groups=H // KV, causal=causal,
                              window=window, block_q=block_q,
                              block_kv=block_kv)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)[..., :hd_v]
