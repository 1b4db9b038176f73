"""The sparsity-adaptive l1,inf projection engine on the hand-written
kernels (port of ``repro.kernels.l1inf.ops``).

Engine shape (DESIGN.md §3):

  * outer monotone Newton on theta, warm-startable via ``theta0=`` (any
    value >= 0; an overshooting guess is repaired by the first unclamped
    Eq.-(19) step). The loop runs on the host with one device sync per
    step (the ``any(theta > prev)`` test); everything else stays on the
    device;
  * active-column shrinking — after the first full ``mu_solve`` pass the
    surviving columns are compacted into the leading slots, ordered by
    descending death margin, and every later Newton step solves only the
    still-alive prefix of ``ceil(J / block_m)`` column blocks. The prefix
    count is computed on the device and handed to ``mu_solve`` as a device
    tensor, which its kernel reads itself. ``mu`` is carried through the
    loop and scattered back through the permutation before ``clip_apply``;
  * packed multi-ball (``project_l1inf_kernel_segmented``) — one packed
    (n, M) buffer with a per-column segment id, one ``mu_solve`` launch per
    Newton step for every segment.

The kernels dispatch on the buffer's device (``kernel.py``): on a CPU
tensor the whole engine runs through their plain versions, which is how
the tests hold it against the JAX engine in interpret mode, counters
included; on a CUDA tensor every step launches the kernels.

``return_stats=True`` exposes the counters ``newton_iters``,
``num_active``, ``active_cols_per_step``, ``work_cols`` (columns swept
across all ``mu_solve`` launches) and ``full_cols``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.l1inf import (_PAD_THETA, _segment_max, _segment_summer,
                           active_compaction)
from .kernel import clip_apply, colstats, mu_solve

__all__ = ["project_l1inf_kernel", "project_l1inf_kernel_segmented"]

# Columns per engine block (the nact_blocks granularity). The Pallas engine
# sized it to fit a VMEM budget; the CUDA mu_solve streams tall columns, so
# one value serves every n. Tests pin it to the JAX engine's choice.
_DEFAULT_BLOCK_M = 128


def _pad_to(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    n, m = x.shape
    pn, pm = (-n) % mult0, (-m) % mult1
    if pn or pm:
        x = F.pad(x, (0, pm, 0, pn))
    return x.contiguous()


def _padded(Y: torch.Tensor, block_m: int):
    Ypad = _pad_to(Y, 8, 128)
    bm = block_m or _DEFAULT_BLOCK_M
    if Ypad.shape[1] % bm:
        Ypad = _pad_to(Ypad, 8, bm)
    return Ypad, bm


def _engine(Ypad, seg_ids, C_seg, num_segments, theta0, *, bm, n_bisect,
            n_polish, max_newton, shrink):
    """Shared sparsity-adaptive Newton engine over a padded (n_pad, m_pad)
    buffer whose columns map to ``num_segments`` balls (plus the dummy
    padding segment ``num_segments``).

    Returns (mu_full, theta_seg, norm_seg, colsum, stats); mu_full and
    colsum are in the ORIGINAL column order.

    NOTE: the loop structure (bootstrap, monotone ascent, carried mu,
    cap-exit re-eval) is the kernel twin of core/l1inf.py's
    _segmented_newton — keep structural fixes in sync.
    """
    _, m_pad = Ypad.shape
    dev = Ypad.device
    G = int(num_segments)
    nblocks = m_pad // bm
    f32, i32 = torch.float32, torch.int32
    Aabs = Ypad.to(f32).abs()
    seg_ids = torch.as_tensor(seg_ids, dtype=i32, device=dev)
    C_seg = torch.as_tensor(C_seg, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    colsum, colmax = colstats(Aabs)
    valid = seg_ids < G
    sum_cols = _segment_summer(seg_ids, G + 1)
    norm_seg = sum_cols(torch.where(valid, colmax, zero))[:G]
    m_seg = sum_cols(valid.to(f32))[:G]

    Csafe = torch.where(C_seg > 0, C_seg, torch.ones_like(C_seg))
    cold = torch.clamp((norm_seg - Csafe) / torch.clamp(m_seg, min=1.0),
                       min=0.0)
    if theta0 is None:
        start = cold
    else:
        t0 = torch.as_tensor(theta0, dtype=f32, device=dev)
        start = torch.maximum(torch.clamp(t0, min=0.0), cold)

    pad = torch.full((1,), _PAD_THETA, dtype=f32, device=dev)

    def theta_cols(th_seg, sids):
        return torch.cat([th_seg, pad])[torch.clamp(sids, max=G)]

    def eval_step(th_seg, A, sids, sum_seg, nact_blocks):
        """One mu_solve launch + the segmented Eq.-(19) update at th_seg."""
        mu, k, S, act = mu_solve(A, theta_cols(th_seg, sids), block_m=bm,
                                 n_bisect=n_bisect, n_polish=n_polish,
                                 nact_blocks=nact_blocks)
        act = act & (sids < G)
        Aa = sum_seg(torch.where(act, S / k, zero))[:G]
        Ba = sum_seg(torch.where(act, 1.0 / k, zero))[:G]
        return (Aa - Csafe) / torch.clamp(Ba, min=1e-30), mu

    all_blocks = torch.tensor(nblocks, dtype=i32, device=dev)

    # pass 1: full sweep. The repair clamps to the COLD bound, not 0: cold
    # <= theta* always and cold > 0 outside the ball, which keeps theta off
    # the degenerate theta = 0 level where the payloads carry no slope.
    t1 = torch.maximum(
        eval_step(start, Aabs, seg_ids, sum_cols, all_blocks)[0], cold)

    # active-column shrinking: theta only rises from t1, so a column with
    # colsum <= theta_cols(t1) is dead for good. Survivors go first, by
    # descending death margin, so deaths peel off the END of the prefix.
    if shrink:
        tc1 = theta_cols(t1, seg_ids)
        act1 = (colsum > tc1) & valid
        perm, J = active_compaction(act1, key=tc1 - colsum)
        Ap = Aabs.index_select(1, perm)
        sids_p = seg_ids[perm]
        sum_p = _segment_summer(sids_p, G + 1)
        colsum_p = colsum[perm]
        iota = torch.arange(m_pad, dtype=i32, device=dev)

        def nact_of(th_seg):
            alive = (colsum_p > theta_cols(th_seg, sids_p)) & (sids_p < G)
            last = torch.where(alive, iota, -1).max()
            return ((last + 1) + bm - 1) // bm
    else:
        perm = torch.arange(m_pad, dtype=torch.int64, device=dev)
        J = torch.tensor(m_pad, dtype=i32, device=dev)
        Ap, sids_p, sum_p = Aabs, seg_ids, sum_cols

        def nact_of(th_seg):
            return all_blocks

    # pass 2 + the monotone loop on the packed prefix, mu carried
    nact1 = nact_of(t1)
    t2, mu_p = eval_step(t1, Ap, sids_p, sum_p, nact1)
    theta, prev = torch.maximum(t2, t1), t1
    work = nblocks * bm + nact1 * bm
    iters = 2
    while iters < max_newton and bool((theta > prev).any()):
        nact = nact_of(theta)
        new, mu_p = eval_step(theta, Ap, sids_p, sum_p, nact)
        iters, theta, prev = iters + 1, torch.maximum(new, theta), theta
        work = work + nact * bm
    # max_newton cap exit: mu lags theta by one iterate; re-evaluate
    if bool((theta > prev).any()):
        mu_p = eval_step(theta, Ap, sids_p, sum_p, nact_of(theta))[1]

    # scatter back: perm is a bijection, so this is exact
    mu_full = torch.zeros((m_pad,), dtype=f32, device=dev)
    mu_full[perm] = mu_p
    stats = {
        "newton_iters": iters,
        "num_active": J,
        "active_cols_per_step": nact_of(theta) * bm,
        "work_cols": work,
        "full_cols": m_pad,
    }
    return mu_full, theta, norm_seg, colsum, stats


def project_l1inf_kernel(Y: torch.Tensor, C, *, theta0=None,
                         block_m: int = 0, n_bisect: int = 26,
                         n_polish: int = 8, max_newton: int = 32,
                         shrink: bool = True, return_stats: bool = False):
    """Exact projection of Y (n, m; max over axis 0) onto the l1,inf ball.

    Sort-free sparsity-adaptive engine: outer monotone Newton on theta
    (Eq. 19, warm-startable via ``theta0``), inner per-column bisection +
    polish in ``mu_solve``, active-column shrinking after the first pass.
    Y is f32 or bf16; the result has Y's dtype and device. With
    ``return_stats=True`` returns (X, stats): the five counters plus
    ``theta``.
    """
    if Y.ndim != 2:
        raise ValueError("expected 2-D input")
    n, m = Y.shape
    dev = Y.device
    C = torch.as_tensor(C, dtype=torch.float32, device=dev)
    Ypad, bm = _padded(Y, block_m)
    m_pad = Ypad.shape[1]
    seg_ids = (torch.arange(m_pad, device=dev) >= m).to(torch.int32)
    th0 = None if theta0 is None else torch.as_tensor(
        theta0, dtype=torch.float32, device=dev).reshape(1)

    mu_full, theta, norm_seg, colsum, stats = _engine(
        Ypad, seg_ids, C.reshape(1), 1, th0, bm=bm, n_bisect=n_bisect,
        n_polish=n_polish, max_newton=max_newton, shrink=shrink)

    X = clip_apply(Ypad, mu_full)[:n, :m]
    inside = norm_seg[0] <= C
    X = torch.where(inside, Y, X)
    X = torch.where(C > 0, X, torch.zeros_like(X)).to(Y.dtype)
    if not return_stats:
        return X
    stats = dict(stats)
    stats["theta"] = torch.where(
        C > 0, torch.where(inside, torch.zeros_like(theta[0]), theta[0]),
        torch.clamp(colsum.max(), min=0.0))
    return X, stats


def project_l1inf_kernel_segmented(Y: torch.Tensor, seg_ids, C_seg, *,
                                   num_segments: int, theta0=None,
                                   block_m: int = 0, n_bisect: int = 26,
                                   n_polish: int = 8, max_newton: int = 32,
                                   shrink: bool = True,
                                   return_stats: bool = False):
    """Packed multi-ball projection: one engine run, one ``mu_solve``
    launch per Newton step, for EVERY segment of a packed (n, M) buffer.

    ``seg_ids`` (M,) int maps column -> ball in [0, num_segments); the
    value ``num_segments`` marks lane padding (returned unchanged).
    ``C_seg`` (num_segments,) radii; ``theta0`` (num_segments,) warm
    start. Returns (X, theta_seg) or (X, theta_seg, stats).
    """
    if Y.ndim != 2:
        raise ValueError("expected a packed 2-D buffer")
    n, m = Y.shape
    dev = Y.device
    G = int(num_segments)
    C_seg = torch.as_tensor(C_seg, dtype=torch.float32, device=dev)
    Ypad, bm = _padded(Y, block_m)
    m_pad = Ypad.shape[1]
    sids = torch.full((m_pad,), G, dtype=torch.int32, device=dev)
    sids[:m] = torch.as_tensor(seg_ids, dtype=torch.int32, device=dev)
    th0 = None if theta0 is None else torch.as_tensor(
        theta0, dtype=torch.float32, device=dev)

    mu_full, theta, norm_seg, colsum, stats = _engine(
        Ypad, sids, C_seg, G, th0, bm=bm, n_bisect=n_bisect,
        n_polish=n_polish, max_newton=max_newton, shrink=shrink)

    Xpad = clip_apply(Ypad, mu_full)
    inside_seg = norm_seg <= C_seg
    zero_seg = C_seg <= 0
    col_seg = torch.clamp(sids, max=G)
    inside_col = torch.cat([inside_seg, inside_seg.new_ones(1)])[col_seg]
    zero_col = torch.cat([zero_seg, zero_seg.new_zeros(1)])[col_seg]
    Xpad = torch.where(inside_col[None, :], Ypad, Xpad)
    Xpad = torch.where(zero_col[None, :], torch.zeros_like(Xpad), Xpad)
    X = Xpad[:n, :m].to(Y.dtype)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    seg_max = _segment_max(torch.where(sids < G, colsum, zero), sids,
                           G + 1)[:G]
    theta_out = torch.where(zero_seg, seg_max,
                            torch.where(inside_seg, zero, theta))
    if not return_stats:
        return X, theta_out
    return X, theta_out, stats
