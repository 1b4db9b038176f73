"""Weighted l1,inf ball projection (port of ``repro.core.weighted``).

    B_w = { X : sum_j w_j * max_i |X_ij| <= C },   w_j > 0.

Column j is zeroed iff ||y_j||_1 <= theta * w_j, otherwise clipped at mu_j
with removal mass sum_i (|y_ij| - mu_j)_+ = theta * w_j; theta solves
g(theta) = sum_j w_j * mu_j(theta * w_j) = C, convex decreasing and
piecewise linear, so the monotone Newton applies with

    theta' = ( sum_A w_j S_{k_j}/k_j - C ) / ( sum_A w_j^2/k_j ).

It runs no kernel: the family has no streaming statistics hook and no
kernel solver, so every engine solver takes the packed Newton for it.
"""
from __future__ import annotations

import torch

from .._device import taken
from .l1inf import _post, _prep, _sorted_stats, _theta_state

__all__ = ["project_l1inf_weighted", "l1inf_weighted_norm"]


def l1inf_weighted_norm(Y: torch.Tensor, w: torch.Tensor,
                        axis: int = 0) -> torch.Tensor:
    """sum_j w_j max_i |Y_ij| (``axis`` is the max axis)."""
    return (w * Y.abs().amax(dim=axis)).sum()


class _WeightedSegOps:
    """Segmented-Newton hooks of the weighted family: column j sees the
    threshold theta * w_j, and the Eq.-(19) tangent carries w_j
    (numerator) and w_j^2 (denominator). ``w`` is the packed per-column
    weight vector (1.0 on padding lanes)."""
    uses_weights = True

    @staticmethod
    def prepare(A, w=None):
        if w is None:
            w = torch.ones((A.shape[1],), dtype=A.dtype, device=A.device)
        Z, S, b = _sorted_stats(A)
        return {"S": S, "b": b, "w": w, "colmax": Z[0], "colsum": S[-1]}

    @staticmethod
    def stats(aux, th_col):
        w = aux["w"]
        tw = th_col * w
        k, S_k, active = _theta_state(aux["S"], aux["b"], tw)
        mu = torch.clamp((S_k - tw) / k, min=0.0)
        return w * S_k / k, w * w / k, active, mu

    @staticmethod
    def stats0(aux):
        return aux["w"] * aux["colmax"], aux["w"] * aux["w"]

    @staticmethod
    def colnorm(aux):
        return aux["w"] * aux["colmax"]

    @staticmethod
    def death(aux):
        # column j dies once theta * w_j >= ||y_j||_1
        return aux["colsum"] / aux["w"]

    @staticmethod
    def finalize(Ydt, A, mu):
        return torch.sign(Ydt) * torch.minimum(A, mu[None, :])


def project_l1inf_weighted(Y: torch.Tensor, w, C, axis: int = 0,
                           max_iter: int = 48) -> torch.Tensor:
    """Exact projection onto B_w (w > 0 per column; ``axis`` = max axis).

    >>> X = project_l1inf_weighted(Y, torch.ones(Y.shape[1]), 1.0)
    """
    Yt, transpose, dt = _prep(Y, axis)
    dev = Yt.device
    A = Yt.abs()
    m = A.shape[1]
    w = torch.as_tensor(w, dtype=dt, device=dev).reshape(m)
    C = torch.as_tensor(C, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    Z, S, b = _sorted_stats(A)
    inside = (w * Z[0]).sum() <= C
    # Newton from below: theta_0 from the all-active k = 1 segment
    theta0 = torch.clamp(((w * S[0]).sum() - C)
                         / torch.clamp((w * w).sum(), min=1e-30), min=0.0)

    def step(theta):
        k, S_k, active = _theta_state(S, b, theta * w)
        Aa = torch.where(active, w * S_k / k, zero).sum()
        Ba = torch.where(active, w * w / k, zero).sum()
        return (Aa - C) / torch.clamp(Ba, min=torch.finfo(dt).tiny)

    i, theta, prev = 1, step(theta0), theta0
    while i < max_iter and taken(theta > prev):
        i, theta, prev = i + 1, step(theta), theta

    k, S_k, active = _theta_state(S, b, theta * w)
    mu = torch.where(active, torch.clamp((S_k - theta * w) / k, min=0.0),
                     zero)
    X = torch.sign(Yt) * torch.minimum(A, mu[None, :])
    X = torch.where(inside, Yt, X)
    X = torch.where(C > 0, X, torch.zeros_like(X))
    return _post(X, Y, transpose)
