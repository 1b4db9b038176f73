"""The comparison norms of the SAE experiments and the Moreau-dual prox
(port of ``repro.core.norms``).

  * l1 ball on the flattened matrix            (paper's `l1` column)
  * l1,2 / group-lasso ball (sum of column l2) (paper's `l2,1` column)
  * prox of the l_inf,1 norm via Moreau + the l1,inf projection (Eq. 16)
"""
from __future__ import annotations

import torch

from .l1inf import project_l1inf_newton
from .simplex import project_l1_ball, simplex_threshold

__all__ = [
    "project_l1_ball",
    "project_l12_ball",
    "prox_linf1",
    "linf1_norm",
    "l12_norm",
]


def l12_norm(Y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """sum_j ||y_j||_2 (column l2 norms summed; group-lasso norm)."""
    return torch.sqrt((Y * Y).sum(dim=axis)).sum()


def linf1_norm(Y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """max_j sum_i |Y_ij| — the dual of the l1,inf norm (Eq. 14)."""
    return Y.abs().sum(dim=axis).max()


def project_l12_ball(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """Projection onto {X : sum_j ||x_j||_2 <= C} (group-lasso ball).

    Column norms are projected onto the l1 ball; columns are rescaled.
    """
    dt = torch.promote_types(Y.dtype, torch.float32)
    Yf = Y.to(dt)
    C = torch.as_tensor(C, dtype=dt, device=Y.device)
    nu = torch.sqrt((Yf * Yf).sum(dim=axis))
    inside = nu.sum() <= C
    tau = simplex_threshold(nu, C, dim=0)
    nu_new = torch.clamp(nu - tau, min=0.0)
    zero = torch.zeros((), dtype=dt, device=Y.device)
    scale = torch.where(nu > 0, nu_new / torch.clamp(
        nu, min=torch.finfo(dt).tiny), zero)
    X = Yf * scale.unsqueeze(axis)
    X = torch.where(inside, Yf, X)
    X = torch.where(C > 0, X, torch.zeros_like(X))
    return X.to(Y.dtype)


def prox_linf1(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """prox_{C ||.||_inf,1}(Y) = Y - P_{B_{1,inf}^C}(Y)  (Moreau, Eq. 16)."""
    return Y - project_l1inf_newton(Y, C, axis=axis)
