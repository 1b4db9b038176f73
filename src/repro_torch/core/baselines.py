"""CPU baselines the paper compares against (numpy, exact).

  * Quattoni et al. 2009  — materialized total order: build all nm
    breakpoints, one global sort, linear walk. O(nm log nm) always.
  * Bejar et al. 2021     — "fastest l1,inf prox in the West": column
    pre-elimination preprocess + naive iterated projection.
  * Chu et al. 2020-class — semismooth Newton on theta (per-column presort +
    finitely-convergent monotone Newton; same iteration class).

All return the exact projection; they differ in complexity profile (paper
Figs. 1-3). The port's own copy of ``repro.core.baselines``: numpy in,
numpy out, float64 on the host.
"""
from __future__ import annotations

import numpy as np

from .heap import project_l1inf_naive

__all__ = [
    "project_l1inf_quattoni",
    "project_l1inf_bejar",
    "project_l1inf_newton_np",
]


def _prep(Y, C):
    A = np.abs(np.asarray(Y, dtype=np.float64))
    norm = A.max(axis=0).sum() if A.size else 0.0
    return A, norm


def _sorted_stats(A):
    n, m = A.shape
    Z = -np.sort(-A, axis=0)
    S = np.cumsum(Z, axis=0)
    k = np.arange(1, n, dtype=np.float64)[:, None]
    b = np.concatenate([S[: n - 1] - k * Z[1:], S[n - 1 : n]], axis=0)
    return Z, S, b


def _finalize(Y, A, S, b, theta):
    n, m = A.shape
    idx = (b < theta).sum(axis=0)
    active = idx < n
    k = np.clip(idx + 1, 1, n).astype(np.float64)
    S_k = S[np.clip(idx, 0, n - 1), np.arange(m)]
    mu = np.where(active, np.maximum((S_k - theta) / k, 0.0), 0.0)
    X = np.sign(Y) * np.minimum(A, mu[None, :])
    return X.astype(np.asarray(Y).dtype, copy=False)


def project_l1inf_quattoni(Y: np.ndarray, C: float) -> np.ndarray:
    """Materialized total order (Quattoni-class): full global sort of all nm
    breakpoints + prefix scan + segment selection."""
    Y = np.asarray(Y)
    A, norm = _prep(Y, C)
    if C <= 0:
        return np.zeros_like(Y)
    if norm <= C:
        return Y.copy()
    n, m = A.shape
    Z, S, b = _sorted_stats(A)

    k = np.arange(1, n, dtype=np.float64)[:, None]
    dA = np.concatenate([S[1:] / (k + 1) - S[: n - 1] / k,
                         -(S[n - 1 : n] / n)], axis=0).ravel()
    dB = np.concatenate([np.broadcast_to(1.0 / (k + 1) - 1.0 / k, (n - 1, m)),
                         np.full((1, m), -1.0 / n)], axis=0).ravel()
    bf = b.ravel()
    order = np.argsort(bf, kind="stable")
    b_sorted = bf[order]
    A_state = np.concatenate([[S[0].sum()], S[0].sum() + np.cumsum(dA[order])])
    B_state = np.concatenate([[float(m)], float(m) + np.cumsum(dB[order])])
    lo = np.concatenate([[0.0], b_sorted])
    hi = np.concatenate([b_sorted, [np.inf]])
    with np.errstate(divide="ignore", invalid="ignore"):
        theta_t = (A_state - C) / B_state
    valid = (B_state > 0) & (theta_t > lo - 1e-12) & (theta_t <= hi + 1e-12)
    t = int(np.argmax(valid))
    theta = max(theta_t[t], 0.0)
    return _finalize(Y, A, S, b, theta)


def project_l1inf_bejar(Y: np.ndarray, C: float) -> np.ndarray:
    """Bejar et al.: O(nm + m log m) column pre-elimination, then the naive
    iterated projection on the surviving columns."""
    Y = np.asarray(Y)
    A, norm = _prep(Y, C)
    if C <= 0:
        return np.zeros_like(Y)
    if norm <= C:
        return Y.copy()
    n, m = A.shape
    colsums = A.sum(axis=0)
    colmax = A.max(axis=0)

    # Pre-elimination: a column j is provably zeroed if ||y_j||_1 <= theta_lb.
    # Lower-bound theta by Eq. (19) with every column at k = n over columns
    # sorted by decreasing colsum (Bejar's preprocess, vectorized):
    order = np.argsort(-colsums, kind="stable")
    cs = colsums[order]
    css = np.cumsum(cs)
    r = np.arange(1, m + 1, dtype=np.float64)
    # candidate theta using the top-r columns fully active at k=n:
    cand = (css / n - C) / (r / n)
    # keep columns whose colsum exceeds the best (largest) valid lower bound
    theta_lb = 0.0
    for i in range(m):
        if cand[i] <= cs[i]:
            theta_lb = cand[i]
    keep = colsums > max(theta_lb, 0.0)
    if not keep.any():
        keep = colsums >= colsums.max()
    sub = project_l1inf_naive(Y[:, keep], C)
    X = np.zeros_like(np.asarray(Y))
    X[:, keep] = sub
    return X


def project_l1inf_newton_np(Y: np.ndarray, C: float, max_iter: int = 128
                            ) -> np.ndarray:
    """Semismooth Newton on theta (Chu et al. 2020 class), numpy."""
    Y = np.asarray(Y)
    A, norm = _prep(Y, C)
    if C <= 0:
        return np.zeros_like(Y)
    if norm <= C:
        return Y.copy()
    n, m = A.shape
    Z, S, b = _sorted_stats(A)
    cols = np.arange(m)
    theta = max((S[0].sum() - C) / m, 0.0)
    for _ in range(max_iter):
        idx = (b < theta).sum(axis=0)
        active = idx < n
        k = np.clip(idx + 1, 1, n).astype(np.float64)
        S_k = S[np.clip(idx, 0, n - 1), cols]
        Aa = (S_k[active] / k[active]).sum()
        Ba = (1.0 / k[active]).sum()
        new_theta = (Aa - C) / Ba
        if new_theta <= theta:
            break
        theta = new_theta
    return _finalize(Y, A, S, b, theta)
