"""Bi-level l1,inf projection (Barlaud, Perez, Marmorat, arXiv:2407.16293)
— port of ``repro.core.bilevel``.

The bi-level operator targets the same constraint set as the paper's exact
projection — the ball {X : ||X||_{1,inf} <= C} — with a two-level
composition that is cheaper and empirically sparser:

  level 1 (columns -> maxima):  u_j = max_i |Y_ij|
  level 2 (outer l1 ball):      v   = P_{B_1(C)}(u)        (simplex thresh)
  inner  (per-column l_inf):    X_ij = sign(Y_ij) min(|Y_ij|, v_j)

Level 2 is a soft threshold v_j = (u_j - theta)_+ with theta solving
sum_j (u_j - theta)_+ = C: the paper's Eq. (19) restricted to k = 1, so
the monotone Newton of ``core.l1inf`` applies with per-column statistics
a_j = u_j, b_j = 1, active_j <=> u_j >= theta, mu_j = (u_j - theta)_+.
The iteration state is the (m,) maxima vector: one max sweep, O(m) Newton
steps on the host (one device sync each), one clip sweep.

Warm start: as ``project_l1inf_newton`` — any ``theta0 >= 0`` is repaired
by the bootstrap step.
"""
from __future__ import annotations

from typing import Optional

import torch

from .l1inf import _post, _prep, l1inf_norm
from .simplex import simplex_threshold

__all__ = [
    "bilevel_norm",
    "project_bilevel",
    "project_bilevel_stats",
    "project_bilevel_ref",
]

# the bi-level operator's feasible set is the plain l1,inf ball
bilevel_norm = l1inf_norm


class _BilevelSegOps:
    """Segmented-Newton hooks of the bi-level family (the ``_PlainSegOps``
    contract of ``core.l1inf``): Eq.-(19) statistics pinned at k = 1.

    Active convention: NOT (u < theta), so a column exactly at the
    threshold stays in the tangent with mu = 0. ``from_colstats`` builds
    the aux from the column maxima a streaming sweep emits, which is what
    qualifies the family for the fused optimizer+projection step.
    """
    uses_weights = False

    @staticmethod
    def prepare(A, w=None):
        return {"u": A.amax(dim=0)}

    @staticmethod
    def from_colstats(colsum, colmax, w=None):
        return {"u": colmax}

    @staticmethod
    def stats(aux, th_col):
        u = aux["u"]
        active = torch.logical_not(u < th_col)
        mu = torch.clamp(u - th_col, min=0.0)
        return u, torch.ones_like(u), active, mu

    @staticmethod
    def stats0(aux):
        return aux["u"], torch.ones_like(aux["u"])

    @staticmethod
    def colnorm(aux):
        return aux["u"]

    @staticmethod
    def death(aux):
        # a column dies as soon as theta passes its maximum
        return aux["u"]

    @staticmethod
    def finalize(Ydt, A, mu):
        return torch.sign(Ydt) * torch.minimum(A, mu[None, :])


def _k1_newton(u: torch.Tensor, C: torch.Tensor, theta0, max_iter: int):
    """Monotone Newton for sum_j (u_j - theta)_+ = C on a nonnegative (m,)
    vector (the bi-level maxima or the l1,2 energies).

    Same structure as ``core.l1inf._newton_solve`` (cold bound, bootstrap
    repair, monotone ascent, carried mu, cap-exit re-eval), so theta
    threads between the per-matrix and the packed forms. Returns
    (mu (m,) before gating, theta_out, iters, inside).
    """
    dt, dev = u.dtype, u.device
    m = u.shape[0]
    norm = u.sum()
    tiny = torch.finfo(dt).tiny
    zero = torch.zeros((), dtype=dt, device=dev)
    Csafe = torch.where(C > 0, C, torch.ones_like(C))
    cold = torch.clamp((norm - Csafe) / m, min=0.0)
    if theta0 is None:
        start = cold
    else:
        t0 = torch.as_tensor(theta0, dtype=dt, device=dev)
        start = torch.maximum(torch.clamp(t0, min=0.0), cold)

    def eval_step(th):
        active = torch.logical_not(u < th)
        Aa = torch.where(active, u, zero).sum()
        Ba = active.to(dt).sum()
        new = (Aa - Csafe) / torch.clamp(Ba, min=tiny)
        mu = torch.where(active, torch.clamp(u - th, min=0.0), zero)
        return new, mu

    t1 = torch.maximum(eval_step(start)[0], cold)
    t2, mu = eval_step(t1)
    theta, prev = torch.maximum(t2, t1), t1
    iters = 2
    while iters < max_iter and bool(theta > prev):
        new, mu = eval_step(theta)
        iters, theta, prev = iters + 1, torch.maximum(new, theta), theta
    if bool(theta > prev):
        mu = eval_step(theta)[1]

    inside = norm <= C
    umax = torch.clamp(u.max(), min=0.0) if m else zero
    theta_out = torch.where(C > 0, torch.where(inside, zero, theta), umax)
    return mu, theta_out, iters, inside


def _gate(X, Yt, C, inside):
    X = torch.where(inside, Yt, X)
    return torch.where(C > 0, X, torch.zeros_like(X))


def _bilevel_impl(Yt, C, theta0, max_iter):
    A = Yt.abs()
    mu, theta, iters, inside = _k1_newton(A.amax(dim=0), C, theta0,
                                          max_iter)
    X = torch.sign(Yt) * torch.minimum(A, mu[None, :])
    return _gate(X, Yt, C, inside), theta, iters


def project_bilevel(Y: torch.Tensor, C, axis: int = 0, max_iter: int = 32,
                    *, theta0: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Bi-level l1,inf projection of Y (max over ``axis``) at radius C.

    Inside the ball the operator is the identity; C <= 0 maps to zero.

    >>> X = project_bilevel(Y, 1.0)
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, _, _ = _bilevel_impl(Yt, C, theta0, max_iter)
    return _post(X, Y, transpose)


def project_bilevel_stats(Y: torch.Tensor, C, axis: int = 0,
                          max_iter: int = 32, *,
                          theta0: Optional[torch.Tensor] = None):
    """Like ``project_bilevel`` but returns (X, {"theta", "iters"}).

    >>> X, st = project_bilevel_stats(Y, 1.0)
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, theta, iters = _bilevel_impl(Yt, C, theta0, max_iter)
    return _post(X, Y, transpose), {"theta": theta, "iters": iters}


def project_bilevel_ref(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """Sort-based reference of the bi-level operator: simplex-threshold the
    column-max vector, then clip (tests and benchmarks).

    >>> X = project_bilevel_ref(Y, 1.0)
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    A = Yt.abs()
    u = A.amax(dim=0)
    inside = u.sum() <= C
    Csafe = torch.where(C > 0, C, torch.ones_like(C))
    tau = torch.clamp(simplex_threshold(u, Csafe, axis=0), min=0.0)
    v = torch.clamp(u - tau, min=0.0)
    X = torch.sign(Yt) * torch.minimum(A, v[None, :])
    return _post(_gate(X, Yt, C, inside), Y, transpose)
