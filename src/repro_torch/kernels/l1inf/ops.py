"""The sparsity-adaptive l1,inf projection engine on the hand-written
kernels (port of ``repro.kernels.l1inf.ops``).

Engine shape (DESIGN.md §3):

  * outer monotone Newton on theta, warm-startable via ``theta0=`` (any
    value >= 0; an overshooting guess is repaired by the first unclamped
    Eq.-(19) step). On the card the loop from pass 2 on is ONE persistent
    launch (``kernel.newton_loop``) and the projection never syncs the
    host; on the CPU it is the host loop over the plain ``mu_solve``, with
    one ``any(theta > prev)`` test per step;
  * active-column shrinking — after the first full ``mu_solve`` pass the
    surviving columns are compacted into the leading slots, ordered by
    descending death margin, and every later Newton step solves only the
    still-alive prefix of ``ceil(J / block_m)`` column blocks. The prefix
    count is computed on the device and handed to ``mu_solve`` as a device
    tensor, which its kernel reads itself. ``mu`` is carried through the
    loop and scattered back through the permutation before ``clip_apply``;
  * packed multi-ball (``project_l1inf_kernel_segmented``) — one packed
    (n, M) buffer with a per-column segment id, one ``mu_solve`` per
    Newton step for every segment;
  * the bi-level family's packed solve
    (``project_bilevel_kernel_segmented``) — one ``colstats`` sweep, the
    k = 1 Newton on the (M,) column maxima, one ``clip_apply``: two passes
    over the buffer and no ``mu_solve``.

The kernels dispatch on the buffer's device (``kernel.py``): on a CPU
tensor the whole engine runs through their plain versions, which is how
the tests hold it against the JAX engine in interpret mode, counters
included; on a CUDA tensor every step launches the kernels.

``return_stats=True`` exposes the counters ``newton_iters``,
``num_active``, ``active_cols_per_step``, ``work_cols`` (columns swept
across all ``mu_solve`` evaluations) and ``full_cols``; all but
``full_cols`` are 0-d tensors on the buffer's device, as the JAX engine
returns arrays (convert them once, after the projection).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.bilevel import _BilevelSegOps
from ...core.l1inf import (_PAD_THETA, _segment_max, _segment_summer,
                           _segmented_newton, active_compaction)
from .kernel import clip_apply, colstats, eq19_step, mu_solve, newton_loop

__all__ = ["project_l1inf_kernel", "project_l1inf_kernel_segmented",
           "project_bilevel_kernel_segmented"]

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


def _f32(x, dev) -> torch.Tensor:
    """x as f32 on dev; a Python number is filled in on the device, so the
    card sees no host-to-device copy (and no sync)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=dev)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _padded(Y: torch.Tensor, block_m: int):
    Ypad = _pad_to(Y, 8, 128)
    bm = block_m or _DEFAULT_BLOCK_M
    if Ypad.shape[1] % bm:
        Ypad = _pad_to(Ypad, 8, bm)
    return Ypad, bm


def _loop_inputs(Ypad, seg_ids, C_seg, num_segments, theta0, *, bm,
                 n_bisect, n_polish, shrink):
    """The engine up to its Newton loop: colstats, the cold or warm start,
    pass 1 (a full ``mu_solve`` sweep) and the active-column compaction.
    Returns a dict with the loop's inputs (``A``, ``sids``, ``colsum``,
    ``t1``, ``Csafe``, ``num_active``, compacted) and what the engine
    needs afterwards (``perm``, ``norm_seg``, ``colsum_full``)."""
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
    all_blocks = torch.full((), nblocks, dtype=i32, device=dev)

    def solve(A, th_cols, nact):
        return mu_solve(A, th_cols, block_m=bm, n_bisect=n_bisect,
                        n_polish=n_polish, nact_blocks=nact)

    # pass 1: full sweep. The repair clamps to the COLD bound, not 0: cold
    # <= theta* always and cold > 0 outside the ball, which keeps theta off
    # the degenerate theta = 0 level where the payloads carry no slope.
    t1 = torch.maximum(eq19_step(solve, Aabs, start, seg_ids, sum_cols,
                                 Csafe, G, all_blocks)[0], cold)

    # active-column shrinking: theta only rises from t1, so a column with
    # colsum <= theta_cols(t1) is dead for good. Survivors go first, by
    # descending death margin, so deaths peel off the END of the prefix.
    if shrink:
        tc1 = torch.cat([t1, pad])[torch.clamp(seg_ids, max=G)]
        act1 = (colsum > tc1) & valid
        perm, J = active_compaction(act1, key=tc1 - colsum)
        Ap = Aabs.index_select(1, perm)
        sids_p = seg_ids[perm]
        colsum_p = colsum[perm]
    else:
        perm = torch.arange(m_pad, dtype=torch.int64, device=dev)
        J = all_blocks * bm
        Ap, sids_p, colsum_p = Aabs, seg_ids, colsum
    return {"A": Ap, "sids": sids_p, "colsum": colsum_p, "t1": t1,
            "Csafe": Csafe, "num_active": J.to(i32), "perm": perm,
            "norm_seg": norm_seg, "colsum_full": colsum}


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
    m_pad = Ypad.shape[1]
    G = int(num_segments)
    li = _loop_inputs(Ypad, seg_ids, C_seg, G, theta0, bm=bm,
                      n_bisect=n_bisect, n_polish=n_polish, shrink=shrink)

    # pass 2 + the monotone loop on the packed prefix, mu carried: one
    # persistent launch on the card, the host loop on the CPU
    theta, mu_p, iters, work, active_cols = newton_loop(
        li["A"], li["sids"], li["colsum"], li["t1"], li["Csafe"],
        li["num_active"], num_segments=G, block_m=bm, shrink=shrink,
        n_bisect=n_bisect, n_polish=n_polish, max_newton=max_newton)

    # scatter back: perm is a bijection, so this is exact
    mu_full = torch.zeros((m_pad,), dtype=torch.float32, device=Ypad.device)
    mu_full[li["perm"]] = mu_p
    stats = {
        "newton_iters": iters,
        "num_active": li["num_active"],
        "active_cols_per_step": active_cols,
        "work_cols": work,
        "full_cols": m_pad,
    }
    return mu_full, theta, li["norm_seg"], li["colsum_full"], stats


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
    C = _f32(C, dev)
    Ypad, bm = _padded(Y, block_m)
    m_pad = Ypad.shape[1]
    seg_ids = (torch.arange(m_pad, device=dev) >= m).to(torch.int32)
    th0 = None if theta0 is None else _f32(theta0, dev).reshape(1)

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


def _gate_segments(Ypad, Xpad, sids, G, inside_seg, zero_seg):
    """Segments already inside their ball keep Y, segments of radius <= 0
    go to zero; padding columns (segment id G) keep Y."""
    col_seg = torch.clamp(sids, max=G)
    inside_col = torch.cat([inside_seg, inside_seg.new_ones(1)])[col_seg]
    zero_col = torch.cat([zero_seg, zero_seg.new_zeros(1)])[col_seg]
    Xpad = torch.where(inside_col[None, :], Ypad, Xpad)
    return torch.where(zero_col[None, :], torch.zeros_like(Xpad), Xpad)


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

    inside_seg = norm_seg <= C_seg
    zero_seg = C_seg <= 0
    Xpad = _gate_segments(Ypad, clip_apply(Ypad, mu_full), sids, G,
                          inside_seg, zero_seg)
    X = Xpad[:n, :m].to(Y.dtype)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    seg_max = _segment_max(torch.where(sids < G, colsum, zero), sids,
                           G + 1)[:G]
    theta_out = torch.where(zero_seg, seg_max,
                            torch.where(inside_seg, zero, theta))
    if not return_stats:
        return X, theta_out
    return X, theta_out, stats


def project_bilevel_kernel_segmented(Y: torch.Tensor, seg_ids, C_seg, *,
                                     num_segments: int, theta0=None,
                                     block_m: int = 0, max_newton: int = 32,
                                     return_stats: bool = False):
    """Packed multi-ball BI-LEVEL projection (arXiv:2407.16293) on the
    kernels, with the contract of ``project_l1inf_kernel_segmented``.

    The bi-level Newton state is the (M,) column-max vector of ONE
    ``colstats`` sweep; each Newton step is an O(M) segment sum on the
    host loop (one sync), and the only other launch is the final
    ``clip_apply``. Returns (X, theta_seg) or (X, theta_seg, stats) with
    ``newton_iters`` and the two-sweep ``work_cols`` / ``full_cols``.
    """
    if Y.ndim != 2:
        raise ValueError("expected a packed 2-D buffer")
    n, m = Y.shape
    dev = Y.device
    G = int(num_segments)
    f32 = torch.float32
    C_seg = torch.as_tensor(C_seg, dtype=f32, device=dev)
    Ypad, _ = _padded(Y, block_m)
    m_pad = Ypad.shape[1]
    sids = torch.full((m_pad,), G, dtype=torch.int32, device=dev)
    sids[:m] = torch.as_tensor(seg_ids, dtype=torch.int32, device=dev)
    colsum, colmax = colstats(Ypad.to(f32).abs())
    # the family's own segmented Newton on the streamed maxima, as the
    # fused step runs it; padding columns carry segment id G
    mu, theta_out, iters, inside_seg, zero_seg = _segmented_newton(
        _BilevelSegOps.from_colstats(colsum, colmax), sids, C_seg, G,
        theta0, max_newton, ops=_BilevelSegOps)
    Xpad = _gate_segments(Ypad, clip_apply(Ypad, mu), sids, G, inside_seg,
                          zero_seg)
    X = Xpad[:n, :m].to(Y.dtype)
    if not return_stats:
        return X, theta_out
    return X, theta_out, {"newton_iters": iters, "work_cols": 2 * m_pad,
                          "full_cols": m_pad}
