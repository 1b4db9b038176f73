"""Oracle for the SSD kernel: the naive sequential recurrence.

    h_t = exp(a dt_t) h_{t-1} + dt_t x_t B_t^T      (h in R^{P x N})
    y_t = h_t C_t + D x_t
"""
from __future__ import annotations

import torch

__all__ = ["ssd_ref"]


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            d: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            groups: int = 1):
    """x: (BH, S, P); dt: (BH, S); a/d: (BH,); B/C: (BG, S, N).
    Returns (y (BH, S, P) in x's dtype, final state (BH, P, N) f32)."""
    BH, S, P = x.shape
    N = B.shape[-1]
    Bf = B.repeat_interleave(groups, dim=0).float()
    Cf = C.repeat_interleave(groups, dim=0).float()
    xf, dtf = x.float(), dt.float()
    af, df = a.float()[:, None, None], d.float()[:, None]
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t, None, None]
        h = torch.exp(af * dtt) * h + dtt * (xf[:, t, :, None]
                                             * Bf[:, t, None, :])
        ys.append((h @ Cf[:, t, :, None])[..., 0] + df * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h
