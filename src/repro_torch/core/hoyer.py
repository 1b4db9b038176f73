"""Hoyer l1/l2 sparseness-ratio projection (Thom & Palm, arXiv:1303.5259)
— port of ``repro.core.hoyer``.

The Hoyer sparseness of a nonzero y in R^n is

    sigma(y) = (sqrt(n) - ||y||_1 / ||y||_2) / (sqrt(n) - 1)   in [0, 1],

and sigma(y) >= s is ||y||_1 <= k ||y||_2 with k = sqrt(n) - s (sqrt(n) - 1).
The projection keeps each column's energy L2, targets L1 = k L2 and puts
|y| on the sphere-simplex intersection {z >= 0 : sum z = L1, ||z|| = L2},
signs restored; feasible and zero columns pass through.

  * ``project_hoyer``     — Hoyer's alternating projection, batched over
    columns, a host loop of at most n + 2 rounds (one sync each);
  * ``project_hoyer_ref`` — the exact sorted closed form.

Per-leaf only: there is no shared per-segment threshold and the row count
enters the constraint, so zero-row packing would change it. The family
registers with ``seg_ops=None``.
"""
from __future__ import annotations

import math

import torch

from .._device import taken
from .l1inf import _post, _prep

__all__ = [
    "hoyer_sparseness",
    "project_hoyer",
    "project_hoyer_ref",
]

_FEAS_RTOL = 1e-6   # relative slack on the l1 <= k l2 feasibility test


def hoyer_sparseness(Y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-column Hoyer sparseness in [0, 1] along ``axis``; zero columns
    and n = 1 columns count as maximally sparse (1).

    >>> sig = hoyer_sparseness(Y)        # (m,), 1 = one-hot columns
    """
    dt = torch.promote_types(Y.dtype, torch.float32)
    Yf = Y.to(dt)
    n = Yf.shape[axis]
    l1 = Yf.abs().sum(dim=axis)
    l2 = torch.sqrt((Yf * Yf).sum(dim=axis))
    if n == 1:
        return torch.ones_like(l1)
    rn = torch.sqrt(torch.tensor(float(n), dtype=dt, device=Y.device))
    sig = (rn - l1 / torch.clamp(l2, min=torch.finfo(dt).tiny)) / (rn - 1.0)
    return torch.where(l2 > 0, sig, torch.ones_like(sig))


def _hoyer_targets(b, s, n):
    """(feasible mask, L1 target, L2 target, k) for the |.| columns b."""
    dt, dev = b.dtype, b.device
    l1 = b.sum(dim=0)
    l2 = torch.sqrt((b * b).sum(dim=0))
    rn = torch.sqrt(torch.tensor(float(n), dtype=dt, device=dev))
    s = torch.as_tensor(s, dtype=dt, device=dev)
    k = torch.minimum(torch.clamp(rn - s * (rn - 1.0), min=1.0), rn)
    feas = (l1 <= k * l2 * (1.0 + _FEAS_RTOL)) | (l2 == 0)
    return feas, k * l2, l2, k


def _alternating_cols(b, L1, L2, n):
    """Hoyer's alternating projection on every column of the nonnegative
    (n, m) ``b`` at once; returns z >= 0 with sum z = L1, ||z|| = L2."""
    dt = b.dtype
    tiny = torch.finfo(dt).tiny
    zero = torch.zeros((), dtype=dt, device=b.device)
    z = b + ((L1 - b.sum(dim=0)) / n)[None, :]
    active = torch.ones(b.shape, dtype=torch.bool, device=b.device)
    done = torch.zeros((b.shape[1],), dtype=torch.bool, device=b.device)
    i = 0
    while i < n + 2 and taken(~done.all()):
        p = active.to(dt).sum(dim=0)
        mid = torch.where(active, (L1 / torch.clamp(p, min=1.0))[None, :],
                          zero)
        d = z - mid
        A = (d * d).sum(dim=0)
        B = (mid * d).sum(dim=0)
        Cq = (mid * mid).sum(dim=0) - L2 * L2
        disc = torch.clamp(B * B - A * Cq, min=0.0)
        alpha = (-B + torch.sqrt(disc)) / torch.clamp(A, min=tiny)
        zs = mid + alpha[None, :] * d        # on the sphere AND the plane
        colneg = ((zs < 0) & active).any(dim=0)
        # zero the negatives, fix them, re-project onto the hyperplane
        act2 = active & (zs >= 0)
        zc = torch.clamp(zs, min=0.0)
        p2 = act2.to(dt).sum(dim=0)
        corr = (L1 - zc.sum(dim=0)) / torch.clamp(p2, min=1.0)
        zn = torch.where(act2, zc + corr[None, :], zero)
        upd = torch.logical_not(done)
        z = torch.where(upd[None, :],
                        torch.where(colneg[None, :], zn, zs), z)
        active = torch.where(upd[None, :],
                             torch.where(colneg[None, :], act2, active),
                             active)
        done = done | (upd & torch.logical_not(colneg))
        i += 1
    return torch.clamp(z, min=0.0)


def project_hoyer(Y: torch.Tensor, s, axis: int = 0) -> torch.Tensor:
    """Project each column of Y to Hoyer sparseness >= s, keeping each
    column's l2 energy and signs; feasible and zero columns are untouched.

    >>> X = project_hoyer(Y, 0.9)        # every column now >= 0.9 sparse
    """
    Yt, transpose, dt = _prep(Y, axis)
    n = Yt.shape[0]
    b = Yt.abs()
    feas, L1, L2, _ = _hoyer_targets(b, s, n)
    X = torch.sign(Yt) * _alternating_cols(b, L1, L2, n)
    X = torch.where(feas[None, :], Yt, X)
    return _post(X, Y, transpose)


def project_hoyer_ref(Y: torch.Tensor, s, axis: int = 0) -> torch.Tensor:
    """Exact closed-form reference of ``project_hoyer``: on each sorted
    column scan every active-set size p (z = c1 b + c2 on the top p),
    keep the feasible candidates and take the one nearest |y|.

    >>> X = project_hoyer_ref(Y, 0.9)
    """
    Yt, transpose, dt = _prep(Y, axis)
    dev = Yt.device
    n = Yt.shape[0]
    tiny = torch.finfo(dt).tiny
    b = Yt.abs()
    feas, L1, L2, k = _hoyer_targets(b, s, n)

    order = torch.argsort(-b, dim=0, stable=True)
    bs = torch.gather(b, 0, order)                  # descending per column
    inv = torch.argsort(order, dim=0)
    S = torch.cumsum(bs, dim=0)                     # S_p at row p-1
    Q = torch.cumsum(bs * bs, dim=0)
    p = torch.arange(1, n + 1, dtype=dt, device=dev)[:, None]

    num = (L2 * L2)[None, :] - (L1 * L1)[None, :] / p
    var = Q - S * S / p
    c1 = torch.sqrt(torch.clamp(num, min=0.0) / torch.clamp(var, min=tiny))
    c2 = (L1[None, :] - c1 * S) / p
    z_small = c1 * bs + c2                          # candidate's smallest
    ok = (num >= 0.0) & (var > tiny) & (z_small > 0.0)

    dist = ((c1 - 1.0) ** 2 * Q + 2.0 * (c1 - 1.0) * c2 * S
            + p * c2 * c2 + (Q[-1][None, :] - Q))
    cost = torch.where(ok, dist, torch.full_like(dist, math.inf))
    pbest = torch.argmin(cost, dim=0)               # (m,) row = p - 1
    c1b = torch.gather(c1, 0, pbest[None, :])
    c2b = torch.gather(c2, 0, pbest[None, :])
    rows = torch.arange(n, device=dev)[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    zs = torch.where(rows <= pbest[None, :],
                     torch.clamp(c1b * bs + c2b, min=0.0), zero)

    # degenerate fallback (every active entry tied: var == 0 for all p):
    # spread L1 equally over ceil(k^2) entries
    has = ok.any(dim=0)
    p0 = torch.clamp(torch.ceil(k * k), 1.0, float(n))
    zs_fb = torch.where(rows < p0, (L1 / p0)[None, :], zero)
    zs = torch.where(has[None, :], zs, zs_fb)

    z = torch.gather(zs, 0, inv)
    X = torch.sign(Yt) * z
    X = torch.where(feas[None, :], Yt, X)
    return _post(X, Y, transpose)
