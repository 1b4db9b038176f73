"""Model-shaped SSD.

Accepts the ``models/ssm.py`` tensor layout: x (B, S, H, P), dt (B, S, H),
A_log/D (H,), B/C (B, S, N) (one group per batch row), folds batch x heads
into the kernel's leading dim and calls ``ssd_fwd``: the CUDA kernels for
tensors on the card, their plain versions on the CPU. Under grad the call
goes through ``SSDFunction``, so the gradient reaches x, dt, B and C, and
A_log and D through the torch ops that form a and d; the final state is
discarded, and its gradient counts as zero.
"""
from __future__ import annotations

import torch

from .kernel import ssd_fwd

__all__ = ["ssd_attention"]


def ssd_attention(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  D: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                  chunk: int = 64, tile_bf16: bool = False) -> torch.Tensor:
    """x: (B, S, H, P); dt: (B, S, H); A_log/D: (H,); Bm/Cm: (B, S, N).
    Returns y (B, S, H, P) in x's dtype (the final state is discarded).
    ``tile_bf16``: the bf16-tile kernels (``ssd_fwd``)."""
    Bb, S, H, P = x.shape
    xf = x.transpose(1, 2).reshape(Bb * H, S, P).contiguous()
    dtf = dt.transpose(1, 2).reshape(Bb * H, S).contiguous()
    a = (-torch.exp(A_log.float())).repeat(Bb)
    d = D.float().repeat(Bb)
    y, _ = ssd_fwd(xf, dtf, a, d, Bm.contiguous(), Cm.contiguous(),
                   chunk=chunk, groups=H, tile_bf16=tile_bf16)
    return y.reshape(Bb, H, S, P).transpose(1, 2)
