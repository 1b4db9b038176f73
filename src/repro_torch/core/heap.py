"""The paper's Algorithm 2 (inverse total order with lazy heaps) and
Algorithm 1 (naive iterated l1) as host oracles — the port's own copy of
``repro.core.heap``, which ``repro_torch`` may not import.

Kept in the paper's native sequential form (numpy + heapq), float64
throughout: numpy in, numpy out (a CPU tensor is read through
``np.asarray``). Complexity O(nm + T log(nm)) where T is the number of
breakpoints *above* theta* — at high sparsity theta* is large, T ~ 0, and
the cost collapses to the O(nm) column-sum pass. Columns that end up
zeroed are never heapified (the paper's "columns elimination by design").

The vectorized torch solvers live in ``core.l1inf``; these functions are
the exact answers they are held to (tests, ``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = ["project_l1inf_heap", "project_l1inf_naive", "theta_l1inf_heap"]


def _check_and_absorb(Y: np.ndarray, C: float):
    """Common preamble: |Y|, inside-ball check, degenerate radii."""
    A = np.abs(np.asarray(Y, dtype=np.float64))
    if A.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    norm = A.max(axis=0).sum() if A.size else 0.0
    return A, norm


def theta_l1inf_heap(Y: np.ndarray, C: float) -> float:
    """theta* via the reverse total-order walk (Algorithm 2). 0 if inside."""
    A, norm = _check_and_absorb(Y, C)
    if norm <= C:
        return 0.0
    return _walk_theta(A, float(C))


def project_l1inf_heap(Y: np.ndarray, C: float) -> np.ndarray:
    """Faithful Algorithm 2: exact projection onto the l1,inf ball.

    Walks the global breakpoint total order in *decreasing* theta using one
    lazy global heap (keyed on each column's next breakpoint) and one lazy
    min-heap per activated column, maintaining the Eq.-(19) sums (A, B)
    incrementally. Fires as soon as the candidate theta falls inside the
    current segment.
    """
    Y = np.asarray(Y)
    A, norm = _check_and_absorb(Y, C)
    if C <= 0:
        return np.zeros_like(Y)
    if norm <= C:
        return Y.copy()
    n, m = A.shape

    theta, k_arr, S_arr, entered = _walk_state(A, float(C))
    # water levels: entered columns use their segment (k, S_k); others are dead
    mu = np.zeros(m)
    act = entered & (S_arr - theta > 0)
    mu[act] = (S_arr[act] - theta) / k_arr[act]
    X = np.sign(Y) * np.minimum(A, mu[None, :])
    return X.astype(Y.dtype, copy=False)


def _walk_theta(A: np.ndarray, C: float) -> float:
    return _walk_state(A, C)[0]


def _walk_state(A: np.ndarray, C: float):
    """Core reverse walk. Returns (theta, k, S_k, entered) per column."""
    n, m = A.shape
    colsums = A.sum(axis=0)

    # global max-heap over columns keyed by the next (largest unseen)
    # breakpoint; entry breakpoint of column j is its death b_n = ||y_j||_1.
    H = [(-colsums[j], j) for j in range(m)]
    heapq.heapify(H)

    k_arr = np.zeros(m, dtype=np.int64)     # current active count (0: not entered)
    S_arr = colsums.copy()                   # S_k for the current k
    col_heaps: dict[int, list] = {}
    A_sum = 0.0                              # sum_j S_kj / k_j  over entered
    B_sum = 0.0                              # sum_j 1 / k_j     over entered

    theta = None
    while H:
        negb, j = H[0]
        b = -negb
        if B_sum > 0.0:
            cand = (A_sum - C) / B_sum
            if cand >= b:                    # theta* in [b, prev_b)
                theta = cand
                break
        heapq.heappop(H)
        if k_arr[j] == 0:
            # entry: column activates with k = n; lazy heapify (min-heap so
            # pops yield z_n, z_{n-1}, ... exactly in breakpoint order)
            k_arr[j] = n
            h = A[:, j].tolist()
            heapq.heapify(h)
            col_heaps[j] = h
            A_sum += S_arr[j] / n
            B_sum += 1.0 / n
        else:
            # transition k -> k-1: drop z_k (the smallest of the top-k)
            k = k_arr[j]
            z = heapq.heappop(col_heaps[j])
            A_sum -= S_arr[j] / k
            B_sum -= 1.0 / k
            S_arr[j] -= z
            k_arr[j] = k - 1
            if k - 1 >= 1:
                A_sum += S_arr[j] / (k - 1)
                B_sum += 1.0 / (k - 1)
        k = k_arr[j]
        if k >= 1:
            z_top = col_heaps[j][0]
            b_next = S_arr[j] - k * z_top    # b_{k-1} = S_k - k z_k
            heapq.heappush(H, (-b_next, j))
    if theta is None:
        theta = (A_sum - C) / B_sum if B_sum > 0 else 0.0
    entered = k_arr >= 1
    return theta, k_arr, S_arr, entered


# -----------------------------------------------------------------------------
# Algorithm 1 (naive iterated l1 projection, as in Bejar et al. / the paper)
# -----------------------------------------------------------------------------

def project_l1inf_naive(Y: np.ndarray, C: float, max_iter: int = 10_000
                        ) -> np.ndarray:
    """Algorithm 1: iterate theta updates from full per-column simplex
    projections until theta stabilizes. Exact but O(n^2 m P) worst case."""
    Y = np.asarray(Y)
    A, norm = _check_and_absorb(Y, C)
    if C <= 0:
        return np.zeros_like(Y)
    if norm <= C:
        return Y.copy()
    n, m = A.shape

    Z = -np.sort(-A, axis=0)
    S = np.cumsum(Z, axis=0)
    active = np.ones(m, dtype=bool)
    theta = (Z[0].sum() - C) / m
    for _ in range(max_iter):
        # drop dominated columns (Prop. 3)
        active &= S[-1] > theta
        if not active.any():
            break
        # per-column active counts at the current theta (Prop. 2 gathering)
        k = np.zeros(m, dtype=np.int64)
        Ssel = np.zeros(m)
        for j in np.nonzero(active)[0]:
            # largest k with z_k > (S_k - theta)/k  (simplex active set)
            kk = np.arange(1, n + 1)
            valid = Z[:, j] * kk > (S[:, j] - theta)
            kj = int(np.nonzero(valid)[0][-1]) + 1
            k[j] = kj
            Ssel[j] = S[kj - 1, j]
        num = (Ssel[active] / k[active]).sum() - C
        den = (1.0 / k[active]).sum()
        new_theta = num / den
        if new_theta <= theta * (1 + 1e-15):
            theta = new_theta
            break
        theta = new_theta
    mu = np.zeros(m)
    for j in np.nonzero(active)[0]:
        kk = np.arange(1, n + 1)
        valid = Z[:, j] * kk > (S[:, j] - theta)
        idx = np.nonzero(valid)[0]
        if idx.size == 0:
            continue
        kj = idx[-1] + 1
        mu[j] = max(0.0, (S[kj - 1, j] - theta) / kj)
    X = np.sign(Y) * np.minimum(A, mu[None, :])
    return X.astype(Y.dtype, copy=False)
