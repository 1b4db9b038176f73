"""Masked l1,inf projection, paper Eq. 20 (port of ``repro.core.masked``).

Keeps the original magnitudes but zeroes exactly the support removed by the
real projection: X = Y if inside the ball, else Y * sign(P(|Y|)). Only whole
dominated columns (mu_j = 0) are zeroed; surviving entries are NOT clipped.
Both entry points share one Newton solve, so the mask and the projection
never disagree on ties.
"""
from __future__ import annotations

import torch

from .l1inf import (_PlainSegOps, _post, _prep, l1inf_norm,
                    project_l1inf_newton_stats)

__all__ = ["project_l1inf_masked", "l1inf_column_mask"]


class _MaskedSegOps(_PlainSegOps):
    """Segmented-Newton hooks of the masked family: the plain family's
    Eq.-(19) statistics (same theta, same support), but surviving columns
    stay UNCLIPPED — finalize multiplies by the column-survival
    indicator."""

    @staticmethod
    def finalize(Ydt, A, mu):
        return Ydt * (mu > 0.0)[None, :]


def _masked_solve(Y: torch.Tensor, C, axis: int):
    """One Newton solve -> (X_masked, alive) with X_masked in Y's layout."""
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    P, _ = project_l1inf_newton_stats(Yt.abs(), C, axis=0)
    alive = (P > 0).any(dim=0)
    inside = l1inf_norm(Yt, axis=0) <= C
    X = torch.where(inside, Yt, Yt * alive[None, :])
    return _post(X, Y, transpose), alive


def l1inf_column_mask(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """Boolean per-column mask: True for columns surviving P_{B_{1,inf}^C}.

    >>> alive = l1inf_column_mask(Y, 1.0)
    """
    return _masked_solve(Y, C, axis)[1]


def project_l1inf_masked(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """Masked projection P^M (Eq. 20).

    >>> X = project_l1inf_masked(Y, 1.0)
    """
    return _masked_solve(Y, C, axis)[0]
