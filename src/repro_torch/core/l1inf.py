"""Projection onto the l1,inf ball — PyTorch port of ``repro.core.l1inf``.

Paper: Perez, Condat, Barlaud, "Near-Linear Time Projection onto the l1,inf
Ball; Application to Sparse Autoencoders" (2023).

For Y in R^{n x m} (max over the n rows of each column):

    ||Y||_{1,inf} = sum_j max_i |Y_ij|.

The projection factorizes through a scalar threshold theta >= 0: column j
is zeroed iff ||y_j||_1 <= theta, otherwise clipped at mu_j where
sum_i (|y_ij| - mu_j)_+ = theta, and theta solves sum_j mu_j(theta) = C.
With per-column descending sort z and prefix sums S_k, the breakpoints are
b_k = S_k - k z_{k+1} (k < n) and b_n = S_n (column death); on each segment
Eq. (19) gives theta = (sum_A S_{k_j}/k_j - C) / (sum_A 1/k_j).

Implementations (same names and contracts as the JAX package):

  * ``project_l1inf_sorted`` — global sort of all nm breakpoints + prefix
    scan of the slope payloads, then a short Newton polish;
  * ``project_l1inf_newton`` — per-column sort once, then the monotone
    semismooth Newton on theta (the production path);
  * ``project_l1inf_segmented`` — many balls in one packed (n, M) buffer,
    one theta per segment, Eq. (19) as segment sums.

The Newton loops run on the host, one device sync per step (``any(theta >
prev)``), with the JAX package's stopping rule kept exactly: ascend while
any segment moves, stop at ``max_iter``, and re-evaluate the water level
once on a cap exit, so ``iters`` matches the reference.

Warm start (``theta0=``): any value >= 0 is safe; an overshooting guess is
repaired by the first unclamped Eq.-(19) step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .simplex import cumsum_in_order

__all__ = [
    "l1inf_norm",
    "project_l1inf",
    "project_l1inf_sorted",
    "project_l1inf_newton",
    "project_l1inf_newton_stats",
    "project_l1inf_segmented",
    "theta_l1inf",
    "column_support",
    "active_compaction",
    "support_indices",
    "compact_columns",
]

# Sentinel theta assigned to padding columns (dummy segment) in packed
# buffers: far above any real breakpoint, so they are never active.
_PAD_THETA = 1e30


def l1inf_norm(Y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """||Y||_{1,inf}: sum over columns of the max |.| within each column.

    ``axis`` is the *max* axis (paper convention: axis=0).
    """
    return Y.abs().amax(dim=axis).sum()


def column_support(X: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Boolean per-column support (True where the column is not all-zero)."""
    return (X != 0).any(dim=axis)


def active_compaction(active: torch.Tensor,
                      key: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation packing the True columns of ``active`` first.

    Returns (perm, num_active): ``x[:, perm]`` holds the surviving columns
    in its leading ``num_active`` slots and ``out[perm] = packed`` is the
    exact scatter-back. With ``key``, the active prefix is ordered by
    ascending key (the kernel engine passes theta - colsum, so column deaths
    peel off the END of the prefix). The sort is stable, as ``jnp.argsort``
    is, so ties keep their column order and the work counters match.
    """
    if key is None:
        key = torch.zeros(active.shape, dtype=torch.float32,
                          device=active.device)
    sort_key = torch.where(active, key.to(torch.float32),
                           torch.full_like(key, float("inf"),
                                           dtype=torch.float32))
    perm = torch.argsort(sort_key, stable=True)
    return perm, active.to(torch.int32).sum()


def support_indices(support) -> np.ndarray:
    """Host-side column-gather indices from a boolean support vector.

    ``support``: bool (m,) tensor or array. Returns int32 (J,) numpy
    indices of the True entries, ascending.

    >>> support_indices(np.array([True, False, True]))   # -> [0, 2]
    """
    if isinstance(support, torch.Tensor):
        support = support.detach().cpu().numpy()
    return np.nonzero(np.asarray(support))[0].astype(np.int32)


def compact_columns(x: torch.Tensor, idx, axis: int = -1) -> torch.Tensor:
    """Gather the surviving columns ``idx`` of ``x`` along ``axis`` (values
    untouched, so the gather is exact).

    >>> compact_columns(torch.ones(4, 8), np.array([1, 5]), axis=1).shape
    torch.Size([4, 2])
    """
    index = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                            device=x.device)
    return torch.index_select(x, axis, index)


# -----------------------------------------------------------------------------
# shared pieces
# -----------------------------------------------------------------------------

def _segment_summer(seg_ids: torch.Tensor, num_segments: int):
    """``vals -> (num_segments,)`` per-segment sums for fixed ``seg_ids``,
    the same from run to run on either device. On the card ``index_add_``
    accumulates with atomics in no fixed order (and the sorting
    ``index_put_(accumulate=True)`` sums each segment serially), so CUDA
    tensors reduce a (num_segments, M) one-hot-masked copy along its rows,
    which torch does in a fixed order; on the CPU ``index_add_`` sums in
    column order. The masked copy costs num_segments * M per call: cheap
    for the few segments of today's plans, a segmented-reduction kernel
    once plans carry many stacked layers."""
    if seg_ids.is_cuda:
        onehot = seg_ids[None, :] == torch.arange(
            num_segments, dtype=seg_ids.dtype, device=seg_ids.device)[:, None]
        return lambda vals: torch.where(onehot, vals[None, :],
                                        vals.new_zeros(())).sum(dim=1)
    return lambda vals: torch.zeros(
        (num_segments,), dtype=vals.dtype, device=vals.device).index_add_(
            0, seg_ids, vals)


def _segment_max(vals: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.full((num_segments,), float("-inf"), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg_ids.to(torch.int64), vals, "amax")


def _sorted_stats(A: torch.Tensor):
    """Per-column descending sort Z, prefix sums S (S[k-1] = S_k), and the
    (n, m) breakpoint matrix b (non-decreasing along rows; last row death).
    """
    n = A.shape[0]
    Z = -torch.sort(-A, dim=0).values
    S = cumsum_in_order(Z, dim=0)
    k = torch.arange(1, n, dtype=A.dtype, device=A.device)[:, None]
    b_trans = S[: n - 1] - k * Z[1:]
    b_death = S[n - 1: n]
    return Z, S, torch.cat([b_trans, b_death], dim=0)


def _theta_state(S: torch.Tensor, b: torch.Tensor, theta: torch.Tensor):
    """Per-column (k, S_k, active) at threshold ``theta`` (scalar or (m,)):
    k in [1, n] the active count, S_k its prefix sum, active False where
    the column is dominated (theta >= S_n)."""
    n = S.shape[0]
    idx = (b < theta).sum(dim=0)
    active = idx < n
    k = torch.clamp(idx + 1, 1, n)
    S_k = torch.gather(S, 0, (k - 1)[None, :])[0]
    return k.to(S.dtype), S_k, active


def _eq19_step(S, b, Csafe, theta):
    """One Eq.-(19) evaluation at scalar ``theta``: the tangent-line root of
    g and the per-column water level mu(theta)."""
    k, S_k, active = _theta_state(S, b, theta)
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    Aa = torch.where(active, S_k / k, zero).sum()
    Ba = torch.where(active, 1.0 / k, zero).sum()
    new = (Aa - Csafe) / torch.clamp(Ba, min=torch.finfo(S.dtype).tiny)
    mu = torch.where(active, torch.clamp((S_k - theta) / k, min=0.0), zero)
    return new, mu


def _newton_solve(S, b, Csafe, theta_start, max_iter: int):
    """Warm-start-safe monotone Newton for g(theta) = Csafe. Returns
    (theta, mu, n_eq19_evals); the stopping rule is the JAX package's."""
    t1, _ = _eq19_step(S, b, Csafe, theta_start)
    t1 = torch.clamp(t1, min=0.0)
    t2, mu = _eq19_step(S, b, Csafe, t1)
    th, prev = torch.maximum(t2, t1), t1
    i = 2
    while i < max_iter and bool(th > prev):
        new, mu = _eq19_step(S, b, Csafe, th)
        i, th, prev = i + 1, torch.maximum(new, th), th
    # a max_iter cap exit leaves mu one iterate behind theta: re-evaluate
    if bool(th > prev):
        mu = _eq19_step(S, b, Csafe, th)[1]
    return th, mu, i


def _prep(Y: torch.Tensor, axis: int):
    if Y.ndim != 2:
        raise ValueError(f"project_l1inf expects a 2-D matrix, got "
                         f"{tuple(Y.shape)}")
    if axis not in (0, 1, -1, -2):
        raise ValueError("axis must index one of the two matrix dims")
    transpose = axis in (1, -1)
    Yt = Y.T if transpose else Y
    dt = torch.promote_types(Y.dtype, torch.float32)
    return Yt.to(dt), transpose, dt


def _post(X, Y, transpose):
    X = X.T if transpose else X
    return X.to(Y.dtype).contiguous()


# -----------------------------------------------------------------------------
# exact vectorized total order
# -----------------------------------------------------------------------------

def project_l1inf_sorted(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """Exact projection of Y onto {X : ||X||_{1,inf} <= C}.

    Global sort of all breakpoints + prefix scan of the (dA, dB) slope
    payloads selects the unique segment holding theta; a 4-step Newton
    polish removes fp boundary wobble. ``axis`` is the max axis.
    """
    Yt, transpose, dt = _prep(Y, axis)
    dev = Yt.device
    C = torch.as_tensor(C, dtype=dt, device=dev)
    A = Yt.abs()
    n, m = A.shape
    Z, S, b = _sorted_stats(A)

    k = torch.arange(1, n, dtype=dt, device=dev)[:, None]
    dA_trans = S[1:] / (k + 1) - S[: n - 1] / k
    dB_trans = (1.0 / (k + 1) - 1.0 / k).expand(n - 1, m)
    dA_death = -(S[n - 1: n] / n)
    dB_death = torch.full((1, m), -1.0 / n, dtype=dt, device=dev)
    dA = torch.cat([dA_trans, dA_death], dim=0).reshape(-1)
    dB = torch.cat([dB_trans, dB_death], dim=0).reshape(-1)
    bf = b.reshape(-1)

    order = torch.argsort(bf, stable=True)
    b_sorted = bf[order]
    A0 = S[0].sum()
    B0 = torch.tensor(float(m), dtype=dt, device=dev)
    A_state = torch.cat([A0[None], A0 + cumsum_in_order(dA[order])])
    B_state = torch.cat([B0[None], B0 + cumsum_in_order(dB[order])])

    lo = torch.cat([torch.zeros((1,), dtype=dt, device=dev), b_sorted])
    hi = torch.cat([b_sorted,
                    torch.full((1,), float("inf"), dtype=dt, device=dev)])
    safeB = torch.clamp(B_state, min=torch.finfo(dt).tiny)
    theta_t = (A_state - C) / safeB
    big = torch.clamp(b_sorted.abs().max(), min=1.0) if b_sorted.numel() \
        else torch.ones((), dtype=dt, device=dev)
    eps = torch.finfo(dt).eps * big
    valid = (B_state > 0) & (theta_t > lo - eps) & (theta_t <= hi + eps)
    t = torch.argmax(valid.to(torch.int32))            # first valid segment
    theta = torch.clamp(theta_t[t], min=0.0)

    Csafe = torch.where(C > 0, C, torch.ones_like(C))
    _, mu, _ = _newton_solve(S, b, Csafe, theta, max_iter=4)

    X = torch.sign(Yt) * torch.minimum(A, mu[None, :])
    inside = Z[0].sum() <= C
    X = torch.where(inside, Yt, X)
    X = torch.where(C > 0, X, torch.zeros_like(X))
    return _post(X, Y, transpose)


# -----------------------------------------------------------------------------
# semismooth Newton (production path)
# -----------------------------------------------------------------------------

def _project_newton_impl(Yt, C, dt, theta0, max_iter):
    """Shared Newton body. Returns (X, theta_out, iters)."""
    A = Yt.abs()
    n, m = A.shape
    Z, S, b = _sorted_stats(A)
    colmax = Z[0]
    colsum = S[n - 1]
    norm = colmax.sum()

    Csafe = torch.where(C > 0, C, torch.ones_like(C))
    cold = torch.clamp((norm - Csafe) / m, min=0.0)
    if theta0 is None:
        start = cold
    else:
        t0 = torch.as_tensor(theta0, dtype=dt, device=A.device)
        start = torch.maximum(torch.clamp(t0, min=0.0), cold)

    theta, mu, iters = _newton_solve(S, b, Csafe, start, max_iter)

    X = torch.sign(Yt) * torch.minimum(A, mu[None, :])
    inside = norm <= C
    X = torch.where(inside, Yt, X)
    X = torch.where(C > 0, X, torch.zeros_like(X))
    # C <= 0 removes every column: the norm-removal threshold max_j ||y_j||_1
    theta_out = torch.where(
        C > 0, torch.where(inside, torch.zeros_like(theta), theta),
        torch.clamp(colsum.max(), min=0.0))
    return X, theta_out, iters


def project_l1inf_newton(Y: torch.Tensor, C, axis: int = 0,
                         max_iter: int = 32, *,
                         theta0: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Exact projection via monotone semismooth Newton on theta.

    One per-column sort + cumsum, then <= ~15 Newton steps (1-2 with a good
    ``theta0``), each a compare-and-sum over the breakpoint matrix; mu is
    carried through the loop.
    """
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, _, _ = _project_newton_impl(Yt, C, dt, theta0, max_iter)
    return _post(X, Y, transpose)


def project_l1inf_newton_stats(Y: torch.Tensor, C, axis: int = 0,
                               max_iter: int = 32, *,
                               theta0: Optional[torch.Tensor] = None):
    """Like ``project_l1inf_newton`` but returns (X, stats) with
    stats = {"theta": theta*, "iters": #Eq.-(19) evaluations (int)}."""
    Yt, transpose, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    X, theta, iters = _project_newton_impl(Yt, C, dt, theta0, max_iter)
    return _post(X, Y, transpose), {"theta": theta, "iters": iters}


# -----------------------------------------------------------------------------
# segmented Newton: many independent balls in one packed buffer
# -----------------------------------------------------------------------------

class _PlainSegOps:
    """Per-column statistics of the PLAIN l1,inf family for the segmented
    Newton — the ``seg_ops`` contract of ``core.families``:

      prepare(A, w)       -> aux (per-column sort/prefix state; ``w`` the
                             per-column weights of weight-aware families)
      stats(aux, th_col)  -> (a, b, active, mu): Eq.-(19) numerator and
                             denominator contributions, the active flag and
                             the water level at th_col
      stats0(aux)         -> (a, b) at theta = 0 (cold start)
      colnorm(aux)        -> per-column contribution to the norm
      death(aux)          -> per-column theta at which the column dies
      finalize(Ydt, A, mu)-> projected output before inside/zero gating

    Optional: ``from_colstats(colsum, colmax, w)`` -> aux from streamed
    per-column statistics, which qualifies a family for the fused
    optimizer+projection step (``core.engine``). The plain family has no
    such hook: its aux needs sorted prefix sums, which no streaming sweep
    can emit.
    """
    @staticmethod
    def prepare(A, w=None):
        Z, S, b = _sorted_stats(A)
        return {"S": S, "b": b, "colmax": Z[0], "colsum": S[-1]}

    @staticmethod
    def stats(aux, th_col):
        k, S_k, active = _theta_state(aux["S"], aux["b"], th_col)
        mu = torch.clamp((S_k - th_col) / k, min=0.0)
        return S_k / k, 1.0 / k, active, mu

    @staticmethod
    def stats0(aux):
        return aux["colmax"], torch.ones_like(aux["colmax"])

    @staticmethod
    def colnorm(aux):
        return aux["colmax"]

    @staticmethod
    def death(aux):
        return aux["colsum"]

    @staticmethod
    def finalize(Ydt, A, mu):
        return torch.sign(Ydt) * torch.minimum(A, mu[None, :])


def _segmented_newton(aux, seg_ids: torch.Tensor, C_seg, num_segments: int,
                      theta0: Optional[torch.Tensor], max_iter: int,
                      *, ops, dt=torch.float32):
    """Segmented Newton on PREPARED per-column statistics.

    Returns (mu (M,), theta_out (G,), iters, inside_seg (G,), zero_seg (G,))
    — mu is the water level at theta* before inside/zero gating.
    """
    G = int(num_segments)
    dev = seg_ids.device
    C_seg = torch.as_tensor(C_seg, dtype=dt, device=dev)
    tiny = torch.finfo(dt).tiny
    zero = torch.zeros((), dtype=dt, device=dev)

    valid = seg_ids < G
    summer = _segment_summer(seg_ids, G + 1)

    def sum_seg(v):
        return summer(v)[:G]

    a0, b0 = ops.stats0(aux)
    norm_seg = sum_seg(torch.where(valid, ops.colnorm(aux), zero))
    num0 = sum_seg(torch.where(valid, a0, zero))
    den0 = sum_seg(torch.where(valid, b0, zero))

    Csafe = torch.where(C_seg > 0, C_seg, torch.ones_like(C_seg))
    cold = torch.clamp((num0 - Csafe) / torch.clamp(den0, min=1.0), min=0.0)
    if theta0 is None:
        start = cold
    else:
        t0 = torch.as_tensor(theta0, dtype=dt, device=dev)
        start = torch.maximum(torch.clamp(t0, min=0.0), cold)

    pad = torch.full((1,), _PAD_THETA, dtype=dt, device=dev)
    col_seg = torch.clamp(seg_ids, max=G)

    def eval_step(th_seg):
        th_col = torch.cat([th_seg, pad])[col_seg]
        a, b_, active, mu = ops.stats(aux, th_col)
        active = active & valid
        new = ((sum_seg(torch.where(active, a, zero)) - Csafe)
               / torch.clamp(sum_seg(torch.where(active, b_, zero)),
                             min=tiny))
        return new, torch.where(active, mu, zero)

    # the host twin of the kernel engine's loop in kernels/l1inf/ops.py:
    # bootstrap clamped to the cold bound, monotone ascent, carried mu,
    # cap-exit re-eval
    t1 = torch.maximum(eval_step(start)[0], cold)
    t2, mu = eval_step(t1)
    theta, prev = torch.maximum(t2, t1), t1
    iters = 2
    while iters < max_iter and bool((theta > prev).any()):
        new, mu = eval_step(theta)
        iters, theta, prev = iters + 1, torch.maximum(new, theta), theta
    if bool((theta > prev).any()):
        mu = eval_step(theta)[1]

    inside_seg = norm_seg <= C_seg
    zero_seg = C_seg <= 0
    seg_max = _segment_max(torch.where(valid, ops.death(aux), zero),
                           seg_ids, G + 1)[:G]
    theta_out = torch.where(zero_seg, seg_max,
                            torch.where(inside_seg, zero, theta))
    return mu, theta_out, iters, inside_seg, zero_seg


def _segmented_solve(Y: torch.Tensor, seg_ids, C_seg, num_segments: int,
                     theta0: Optional[torch.Tensor], max_iter: int,
                     ops=None, w_col: Optional[torch.Tensor] = None):
    """Single-buffer segmented Newton solve, family-parametric through
    ``ops`` (default: plain l1,inf); ``w_col`` (M,) carries the per-column
    weights of weight-aware families. Returns (X, theta_seg, iters)."""
    if Y.ndim != 2:
        raise ValueError("packed buffer must be 2-D")
    if ops is None:
        ops = _PlainSegOps
    dt = torch.promote_types(Y.dtype, torch.float32)
    dev = Y.device
    Ydt = Y.to(dt)
    A = Ydt.abs()
    G = int(num_segments)
    seg_ids = torch.as_tensor(seg_ids, dtype=torch.int32, device=dev)
    if w_col is not None:
        w_col = torch.as_tensor(w_col, dtype=dt, device=dev)

    aux = ops.prepare(A, w_col)
    mu, theta_out, iters, inside_seg, zero_seg = _segmented_newton(
        aux, seg_ids, C_seg, G, theta0, max_iter, ops=ops, dt=dt)

    X = ops.finalize(Ydt, A, mu)
    col_seg = torch.clamp(seg_ids, max=G)
    inside_col = torch.cat([inside_seg, inside_seg.new_ones(1)])[col_seg]
    zero_col = torch.cat([zero_seg, zero_seg.new_zeros(1)])[col_seg]
    X = torch.where(inside_col[None, :], Ydt, X)
    X = torch.where(zero_col[None, :], torch.zeros_like(X), X)
    return X.to(Y.dtype), theta_out, iters


def project_l1inf_segmented(Y: torch.Tensor, seg_ids, C_seg, *,
                            num_segments: int,
                            theta0: Optional[torch.Tensor] = None,
                            max_iter: int = 32):
    """Project each column group of a packed (n, M) buffer onto its own
    ball.

    ``seg_ids`` (M,) int maps column -> segment in [0, num_segments);
    ``seg_ids == num_segments`` marks lane padding (never active, returned
    unchanged). ``C_seg`` (num_segments,) holds the radii; ``theta0``
    (num_segments,) warm-starts every segment. The max axis is 0.

    Returns (X, theta_seg, iters), iters the Eq.-(19) evaluation count.
    """
    return _segmented_solve(Y, seg_ids, C_seg, num_segments, theta0,
                            max_iter)


def theta_l1inf(Y: torch.Tensor, C, axis: int = 0) -> torch.Tensor:
    """The optimal threshold theta* (0 if Y is already inside the ball;
    max_j ||y_j||_1 for C <= 0)."""
    Yt, _, dt = _prep(Y, axis)
    C = torch.as_tensor(C, dtype=dt, device=Yt.device)
    _, theta, _ = _project_newton_impl(Yt, C, dt, None, 32)
    return theta


def project_l1inf(Y: torch.Tensor, C, axis: int = 0,
                  method: str = "newton") -> torch.Tensor:
    """Dispatcher. method in {"newton", "sorted"}."""
    if method == "newton":
        return project_l1inf_newton(Y, C, axis=axis)
    if method == "sorted":
        return project_l1inf_sorted(Y, C, axis=axis)
    raise ValueError(f"unknown method {method!r}")
