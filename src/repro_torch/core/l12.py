"""l1,2 (group-lasso) ball as a registered constraint family (port of
``repro.core.l12``).

The ball {X : sum_j ||x_j||_2 <= C} factors through per-column energies
the way the bi-level family factors through column maxima:

  level 1 (columns -> energies):  nu_j = ||y_j||_2
  level 2 (outer l1 ball):        v    = P_{B_1(C)}(nu)     (simplex thresh)
  inner  (per-column rescale):    x_j  = y_j * v_j / nu_j

so the k = 1 monotone Newton of ``core.bilevel`` solves it on the (m,)
energy vector, and ``finalize`` scales columns by mu_j / nu_j instead of
clipping at mu_j. ``norms.project_l12_ball`` (sort-based) is its reference.

Fusable: the aux is the square root of a streaming per-column sum, so
``_L12SegOps`` has ``from_colstats`` with ``colstats_stat = "sq"`` (pass 1
of the fused step accumulates sum u^2) and ``fused_mode = "scale"`` (pass
2 multiplies by a per-column factor; identity sentinel 1.0).
"""
from __future__ import annotations

from typing import Optional

import torch

from .bilevel import _gate, _k1_newton
from .l1inf import _post, _prep

__all__ = [
    "project_l12_newton",
    "project_l12_stats",
]


def _scale_of(nu: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-column multiplier mu_j / nu_j; zero-energy columns stay zero."""
    tiny = torch.finfo(nu.dtype).tiny
    return torch.where(nu > 0, mu / torch.clamp(nu, min=tiny),
                       torch.zeros((), dtype=nu.dtype, device=nu.device))


class _L12SegOps:
    """Segmented-Newton hooks of the l1,2 family on per-column energies:
    ``_BilevelSegOps`` with nu = ||y_j||_2 in place of the column maxima
    and a scaling ``finalize``. ``colstats_stat`` and ``fused_mode`` steer
    the fused step's two passes; ``fused_scale`` turns (aux, mu) into the
    pass-2 multiplier."""
    uses_weights = False
    colstats_stat = "sq"      # pass-1 colsum accumulates sum u^2
    fused_mode = "scale"      # pass-2 multiplies by a factor

    @staticmethod
    def prepare(A, w=None):
        # A = |Y|, so sum A^2 = sum Y^2: the column energies
        return {"nu": torch.sqrt((A * A).sum(dim=0))}

    @staticmethod
    def from_colstats(colsum, colmax, w=None):
        # under colstats_stat="sq" the colsum slot is sum_i u_ij^2
        return {"nu": torch.sqrt(colsum)}

    @staticmethod
    def stats(aux, th_col):
        nu = aux["nu"]
        active = torch.logical_not(nu < th_col)
        mu = torch.clamp(nu - th_col, min=0.0)
        return nu, torch.ones_like(nu), active, mu

    @staticmethod
    def stats0(aux):
        return aux["nu"], torch.ones_like(aux["nu"])

    @staticmethod
    def colnorm(aux):
        return aux["nu"]

    @staticmethod
    def death(aux):
        # a column dies as soon as theta passes its energy
        return aux["nu"]

    @staticmethod
    def finalize(Ydt, A, mu):
        nu = torch.sqrt((A * A).sum(dim=0))
        return Ydt * _scale_of(nu, mu)[None, :]

    @staticmethod
    def fused_scale(aux, mu):
        return _scale_of(aux["nu"], mu)


def _l12_impl(Yt, C, theta0, max_iter):
    nu = torch.sqrt((Yt * Yt).sum(dim=0))
    mu, theta, iters, inside = _k1_newton(nu, C, theta0, max_iter)
    X = Yt * _scale_of(nu, mu)[None, :]
    return _gate(X, Yt, C, inside), theta, iters


def project_l12_newton(Y: torch.Tensor, C, axis: int = 0,
                       max_iter: int = 32, *,
                       theta0: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Newton-form l1,2 projection of Y (column l2 over ``axis``) at
    radius C: one energy sweep, a monotone Newton on the (m,) energies,
    one scale sweep. Identity inside the ball; C <= 0 maps to zero.

    >>> X = project_l12_newton(Y, 1.0)      # sum_j ||x_j||_2 <= 1
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, _, _ = _l12_impl(Yt, C, theta0, max_iter)
    return _post(X, Y, transpose)


def project_l12_stats(Y: torch.Tensor, C, axis: int = 0, max_iter: int = 32,
                      *, theta0: Optional[torch.Tensor] = None):
    """Like ``project_l12_newton`` but returns (X, {"theta", "iters"}).

    >>> X, st = project_l12_stats(Y, 1.0)   # st["theta"] warm-starts a re-solve
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, theta, iters = _l12_impl(Yt, C, theta0, max_iter)
    return _post(X, Y, transpose), {"theta": theta, "iters": iters}
