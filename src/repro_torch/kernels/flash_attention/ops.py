"""Model-shaped GQA flash attention.

Accepts the model-layer layout (B, S, H, hd) / (B, S, KV, hd), folds batch x
heads into the kernel's leading dim and calls ``flash_attention_fwd``: the
CUDA kernel for tensors on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_fwd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd).
    ``block_q`` / ``block_kv`` set the plain version's tiles only."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, Skv, hd).contiguous()
    out = flash_attention_fwd(qf, kf, vf, groups=H // KV, causal=causal,
                              window=window, block_q=block_q,
                              block_kv=block_kv)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)
