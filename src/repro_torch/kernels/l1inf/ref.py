"""Sort-based oracle for the l1,inf kernel suite (port of
``repro.kernels.l1inf.ref``).

Self-contained reference semantics for each kernel: per-column (sum, max)
of |Y|, the exact per-column water level by sorting, the clip, and the full
projection. The kernels' plain versions (``kernel.py``) repeat the
kernels' own arithmetic (bisection + polish); this module is what both are
held against.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["colstats_ref", "mu_solve_ref", "clip_apply_ref",
           "project_l1inf_segmented_ref", "project_l1inf_ref"]


def colstats_ref(Y: torch.Tensor):
    A = Y.to(torch.float32).abs()
    return A.sum(dim=0), A.amax(dim=0)


def mu_solve_ref(Yabs: torch.Tensor, theta):
    """Exact per-column water level for removed mass theta (sort-based).

    Returns (mu, k, S_k, active): for active columns (colsum > theta),
    sum_i (y - mu)_+ = theta with k = |{y > mu}| and S_k the top-k sum.
    Inactive columns report mu = 0, k = 1, S_k = 0.
    """
    A = Yabs.to(torch.float32).abs()
    n, _ = A.shape
    theta = torch.as_tensor(theta, dtype=torch.float32, device=A.device)
    Z = -torch.sort(-A, dim=0).values
    S = torch.cumsum(Z, dim=0)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=A.device)[:, None]
    valid = Z * k > (S - theta)
    kj = torch.clamp(valid.to(torch.int64).sum(dim=0), 1, n)
    S_k = torch.gather(S, 0, (kj - 1)[None, :])[0]
    kf = kj.to(torch.float32)
    mu = (S_k - theta) / kf
    active = S[n - 1] > theta
    mu = torch.where(active, torch.clamp(mu, min=0.0), torch.zeros_like(mu))
    kf = torch.where(active, kf, torch.ones_like(kf))
    S_k = torch.where(active, S_k, torch.zeros_like(S_k))
    return mu, kf, S_k, active


def clip_apply_ref(Y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return (torch.sign(Y) * torch.minimum(Y.abs(), mu[None, :].to(Y.dtype))
            ).to(Y.dtype)


def project_l1inf_segmented_ref(Y, seg_ids, C_seg, num_segments: int):
    """Packed multi-ball oracle: a per-segment loop over the plain
    projection; padding columns (seg_ids == num_segments) pass through.
    Python loop — test oracle only. Returns a numpy array."""
    Y = np.asarray(Y, np.float32)
    seg_ids = np.asarray(seg_ids)
    C_seg = np.asarray(C_seg, np.float32)
    X = Y.copy()
    for g in range(num_segments):
        cols = np.nonzero(seg_ids == g)[0]
        if cols.size == 0:
            continue
        Xg = project_l1inf_ref(torch.from_numpy(np.ascontiguousarray(
            Y[:, cols])), float(C_seg[g]))
        X[:, cols] = Xg.numpy()
    return X


def project_l1inf_ref(Y: torch.Tensor, C) -> torch.Tensor:
    """Full exact projection oracle (per-column sort + scalar Newton)."""
    A = Y.to(torch.float32).abs()
    _, m = A.shape
    C = torch.as_tensor(C, dtype=torch.float32, device=A.device)
    _, colmax = colstats_ref(Y)
    inside = colmax.sum() <= C
    theta = torch.clamp((colmax.sum() - C) / m, min=0.0)
    for _ in range(64):      # monotone Newton, finite convergence; 64 caps it
        _, kf, S_k, active = mu_solve_ref(A, theta)
        zero = torch.zeros_like(kf)
        Aa = torch.where(active, S_k / kf, zero).sum()
        Ba = torch.where(active, 1.0 / kf, zero).sum()
        theta = torch.maximum((Aa - C) / torch.clamp(Ba, min=1e-30), theta)
    mu, _, _, _ = mu_solve_ref(A, theta)
    X = clip_apply_ref(Y, mu)
    X = torch.where(inside, Y, X)
    return torch.where(C > 0, X, torch.zeros_like(X))
