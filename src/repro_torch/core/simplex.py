"""Projection onto the l1 ball (the per-leaf ``norm="l1"`` spec).

Port of the part of ``repro.core.simplex`` that ``core.constraints`` needs:
the sort-based simplex water level and the l1-ball projection built on it.
"""
from __future__ import annotations

import torch

__all__ = ["simplex_threshold", "project_l1_ball"]


def simplex_threshold(y: torch.Tensor, radius, dim: int = -1) -> torch.Tensor:
    """Water level tau with sum(max(y - tau, 0)) == radius along ``dim``.

    Sort-based O(n log n): tau = (cumsum_k - radius) / k for the largest
    valid k. Assumes ``sum(max(y, 0)) >= radius`` (callers handle the
    interior case).
    """
    u = torch.flip(torch.sort(y, dim=dim).values, dims=(dim,))  # descending
    css = torch.cumsum(u, dim=dim)
    n = y.shape[dim]
    shape = [1] * y.ndim
    shape[dim] = n
    k = torch.arange(1, n + 1, dtype=y.dtype, device=y.device).reshape(shape)
    valid = u * k > (css - radius)
    rho = torch.clamp(valid.sum(dim=dim, keepdim=True) - 1, 0, n - 1)
    css_rho = torch.gather(css, dim, rho)
    tau = (css_rho - radius) / (rho.to(y.dtype) + 1.0)
    return tau.squeeze(dim)


def project_l1_ball(y: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Euclidean projection of (flattened) ``y`` onto the l1 ball of
    ``radius``; returns a tensor of ``y``'s shape and dtype.

    >>> project_l1_ball(torch.tensor([3.0, -1.0]), 1.0)
    tensor([ 1., -0.])
    """
    radius = torch.as_tensor(radius, dtype=y.dtype, device=y.device)
    flat = y.abs().reshape(-1)
    inside = flat.sum() <= radius
    tau = simplex_threshold(flat, radius, dim=0)
    proj = torch.sign(y) * torch.clamp(y.abs() - tau, min=0.0)
    return torch.where(inside, y, proj)
