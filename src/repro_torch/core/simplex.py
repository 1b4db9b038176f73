"""Projection onto the l1 ball (the per-leaf ``norm="l1"`` spec).

Port of the part of ``repro.core.simplex`` that ``core.constraints`` needs:
the sort-based simplex water level and the l1-ball projection built on it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["simplex_threshold", "project_l1_ball", "cumsum_in_order"]


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
    if (not x.is_cuda or not x.is_floating_point() or x.numel() < 2
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
