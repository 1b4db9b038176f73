"""Projections onto the simplex and the l1 ball — port of
``repro.core.simplex``.

These are the building blocks of the paper's l1,inf machinery (every column
sub-problem is a simplex projection) and the l1 comparison method of the SAE
experiments. The torch functions run on any device; their 1-D scans go
through ``cumsum_in_order``, so reruns on the card are bit-equal. The
``*_np`` functions are numpy references (float64, host).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import on_card

__all__ = ["project_simplex_sort", "project_l1_ball",
           "project_weighted_l1_ball", "simplex_threshold",
           "project_simplex_michelot_np", "project_simplex_condat_np",
           "cumsum_in_order"]


def _blocked_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor as the rows of a (B, L) view
    (L about sqrt(n)) plus each row's carry: a scan along the last dim of
    a 2-D tensor and a scan along dim 0 of a (B, 2) tensor, both of which
    torch runs in a fixed order on either device."""
    n = v.numel()
    L = math.isqrt(n - 1) + 1
    B = -(-n // L)
    rows = torch.cumsum(F.pad(v, (0, B * L - n)).view(B, L), dim=1)
    tot = rows[:, -1]
    carry = torch.cumsum(torch.stack([tot, torch.zeros_like(tot)], dim=1),
                         dim=0)[:, 0]
    return (rows + F.pad(carry[:-1], (1, 0))[:, None]).reshape(-1)[:n]


def cumsum_in_order(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``torch.cumsum(x, dim)``, the same from run to run on either device.

    On a CUDA tensor whose scan covers every element (a 1-D scan), torch
    hands ``cumsum`` to CUB's decoupled look-back scan, whose float sums
    depend on which tiles finish first, so reruns differ in the last bits
    (paper Fig. 2's 10^7-element scans do). That case runs as
    ``_blocked_cumsum``, accumulated in float64 as torch's CPU scan
    accumulates f32, each prefix rounded to x's dtype. Every other scan is
    torch's own, which already runs in a fixed order.
    """
    if (not on_card(x) or not x.is_floating_point() or x.numel() < 2
            or x.numel() != x.shape[dim]):
        return torch.cumsum(x, dim=dim)
    v = x.reshape(-1).to(torch.float64)
    return _blocked_cumsum(v).to(x.dtype).reshape(x.shape)


def simplex_threshold(y: torch.Tensor, radius, axis: int = -1
                      ) -> torch.Tensor:
    """Water level tau with sum(max(y - tau, 0)) == radius along ``axis``.

    Sort-based O(n log n): tau = (cumsum_k - radius) / k for the largest
    valid k. Assumes ``sum(max(y, 0)) >= radius`` (callers handle the
    interior case).
    """
    u = torch.flip(torch.sort(y, dim=axis).values, dims=(axis,))  # descending
    css = cumsum_in_order(u, dim=axis)
    n = y.shape[axis]
    shape = [1] * y.ndim
    shape[axis] = n
    k = torch.arange(1, n + 1, dtype=y.dtype, device=y.device).reshape(shape)
    valid = u * k > (css - radius)
    rho = torch.clamp(valid.sum(dim=axis, keepdim=True) - 1, 0, n - 1)
    css_rho = torch.gather(css, axis, rho)
    tau = (css_rho - radius) / (rho.to(y.dtype) + 1.0)
    return tau.squeeze(axis)


def project_l1_ball(y: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Euclidean projection of (flattened) ``y`` onto the l1 ball of
    ``radius``; returns a tensor of ``y``'s shape and dtype.

    >>> project_l1_ball(torch.tensor([3.0, -1.0]), 1.0)
    tensor([ 1., -0.])
    """
    radius = torch.as_tensor(radius, dtype=y.dtype, device=y.device)
    flat = y.abs().reshape(-1)
    inside = flat.sum() <= radius
    tau = simplex_threshold(flat, radius, axis=0)
    proj = torch.sign(y) * torch.clamp(y.abs() - tau, min=0.0)
    return torch.where(inside, y, proj)


def project_simplex_sort(y: torch.Tensor, radius=1.0,
                         axis: int = -1) -> torch.Tensor:
    """Euclidean projection of y onto the solid simplex
    {x >= 0 : sum(x) <= radius} along ``axis``.

    If y is already inside (y >= 0 elementwise and sum <= radius) returns y.

    >>> project_simplex_sort(torch.tensor([2.0, 0.0]), 1.0)
    tensor([1., 0.])
    """
    radius = torch.as_tensor(radius, dtype=y.dtype, device=y.device)
    tau = simplex_threshold(y, radius, axis=axis)
    proj = torch.clamp(y - tau.unsqueeze(axis), min=0.0)
    inside = (y >= 0).all(dim=axis) & (y.sum(dim=axis) <= radius)
    return torch.where(inside.unsqueeze(axis), y, proj)


def project_weighted_l1_ball(y: torch.Tensor, w, radius=1.0
                             ) -> torch.Tensor:
    """Projection onto {x : sum_i w_i |x_i| <= radius}, w > 0 (Perez et al.
    2022).

    KKT: x_i = sign(y_i) max(|y_i| - tau w_i, 0) with
    tau = (sum_{i in A} w_i|y_i| - radius) / sum_{i in A} w_i^2 over the
    active set, found by sorting |y_i|/w_i descending (a stable sort, as
    ``jnp.argsort`` is).

    >>> project_weighted_l1_ball(torch.tensor([3.0, -1.0]), torch.ones(2))
    tensor([ 1., -0.])
    """
    w = torch.as_tensor(w, dtype=y.dtype, device=y.device)
    wb = torch.broadcast_to(w, y.shape)
    a = y.abs().reshape(-1)
    ww = wb.reshape(-1)
    inside = (ww * a).sum() <= radius
    r = a / ww
    order = torch.argsort(-r, stable=True)
    cwa = cumsum_in_order((ww * a)[order])
    cw2 = cumsum_in_order((ww * ww)[order])
    taus = (cwa - radius) / cw2
    valid = r[order] > taus
    rho = torch.clamp(valid.sum() - 1, 0, a.shape[0] - 1)
    tau = torch.clamp(taus[rho], min=0.0)
    proj = torch.sign(y) * torch.clamp(y.abs() - tau * wb, min=0.0)
    return torch.where(inside, y, proj)


# ----------------------------------------------------------------------------
# Numpy reference algorithms (for benchmarks and cross-checks)
# ----------------------------------------------------------------------------

def project_simplex_michelot_np(y: np.ndarray, radius: float = 1.0
                                ) -> np.ndarray:
    """Michelot's iterative active-set algorithm (numpy, exact)."""
    y = np.asarray(y, dtype=np.float64)
    if y.min() >= 0 and y.sum() <= radius:
        return y.copy()
    v = y.copy()
    rho = (v.sum() - radius) / v.size
    while True:
        v2 = v[v > rho]
        if v2.size == v.size:
            break
        v = v2
        if v.size == 0:
            rho = 0.0
            break
        rho = (v.sum() - radius) / v.size
    return np.maximum(y - rho, 0.0)


def project_simplex_condat_np(y: np.ndarray, radius: float = 1.0
                              ) -> np.ndarray:
    """Condat (2016) fast projection (numpy, exact). As in the JAX package,
    it runs the sorted method: Condat's pointer-heavy scan is slow in
    Python, and the sorted method is exact."""
    y = np.asarray(y, dtype=np.float64)
    if y.min() >= 0 and y.sum() <= radius:
        return y.copy()
    u = np.sort(y)[::-1]
    css = np.cumsum(u)
    k = np.arange(1, y.size + 1)
    valid = u * k > (css - radius)
    rho = np.nonzero(valid)[0][-1]
    tau = (css[rho] - radius) / (rho + 1.0)
    return np.maximum(y - tau, 0.0)
