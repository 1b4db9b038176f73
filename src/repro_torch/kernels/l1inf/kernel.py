"""The l1,inf projection engine's three kernels: wrappers and plain versions.

Each kernel is hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/l1inf.cu`` (its source note says which Pallas
kernel of ``repro/kernels/l1inf/kernel.py`` it replaces, what bounds it on
the card and how its layout answers that). Beside each wrapper sits a
plain PyTorch version that repeats the kernel's arithmetic:

  * ``colstats``   — per-column (sum, max) of |Y|;
  * ``mu_solve``   — per-column water level mu_j at removed mass theta by
                     26 bisection steps + 8 Michelot polish steps, with the
                     exact (k, S_k) payloads and the ``nact_blocks`` prefix
                     predicate (NOT the sort: that stays in ``ref.py``);
  * ``clip_apply`` — X = sign(Y) * min(|Y|, mu_j) in Y's dtype;
  * ``newton_loop`` — the engine's monotone Newton on theta from pass 2 to
                     the end (carried mu, the alive-prefix count, the work
                     counter, the cap-exit re-evaluation) in ONE persistent
                     launch; pass 2 solves cold as ``mu_solve`` does, every
                     later step starts each column from its previous level
                     (``warm_levels``). Its plain version is the host loop
                     over the same solves.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (building it at first use), a
meta tensor (the dry-run's) takes the kernel's shape rule: its outputs
are empty meta tensors and the launch is recorded, with its cost, in the
active ``roofline.counter.Counter`` (no launch count moves); any other
device raises. Each ``*_cost`` gives a kernel's (operations, bytes) from
its shapes: each input byte read once, each output byte written once.
Each wrapper checks device, dtype, shape and contiguity first, allocates
its outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports an error, and adds one to
its launch count (``launch_counts``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ... import _build
from ..._device import is_meta, kernel_side, taken
from ...roofline.counter import record_kernel
from ...core.l1inf import _PAD_THETA, _segment_summer

__all__ = ["colstats", "mu_solve", "clip_apply", "newton_loop",
           "colstats_plain", "mu_solve_plain", "clip_apply_plain",
           "newton_loop_plain", "warm_levels", "eq19_step", "launch_counts",
           "reset_launch_counts", "colstats_cost", "mu_solve_cost",
           "clip_apply_cost", "newton_loop_cost", "NEWTON_LOOP_MAX_ROWS"]

# The tallest buffer the cooperative Newton keeps in registers: 8 cluster
# CTAs of 1280 rows (kRegRows = kMaxCluster * kSlabRows in csrc/l1inf.cu,
# whose l1inf_newton_loop_max_rows() returns it).
NEWTON_LOOP_MAX_ROWS = 8 * 1280

_LAUNCHES: Dict[str, int] = {"colstats": 0, "mu_solve": 0, "clip_apply": 0,
                             "newton_loop": 0}
_LIB: Optional[ctypes.CDLL] = None


def launch_counts() -> Dict[str, int]:
    """Snapshot {kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("l1inf")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.l1inf_colstats.argtypes = [P, P, P, I, I, I, P]
        lib.l1inf_mu_solve.argtypes = [P, P, I, P, I, P, P, P, P, I, I, I,
                                       I, P]
        lib.l1inf_newton_loop.argtypes = [P] * 10 + [I] * 8 + [P]
        lib.l1inf_newton_loop_max_rows.argtypes = []
        lib.l1inf_newton_loop_clusters.argtypes = [I, I, I]
        lib.l1inf_clip_apply_f32.argtypes = [P, P, P, I, I, P]
        lib.l1inf_clip_apply_bf16.argtypes = [P, P, P, I, I, P]
        for fn in (lib.l1inf_colstats, lib.l1inf_mu_solve,
                   lib.l1inf_newton_loop, lib.l1inf_newton_loop_max_rows,
                   lib.l1inf_newton_loop_clusters,
                   lib.l1inf_clip_apply_f32, lib.l1inf_clip_apply_bf16):
            fn.restype = I
        lib.l1inf_error_string.argtypes = [I]
        lib.l1inf_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().l1inf_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    _LAUNCHES[name] += 1



def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_matrix(name: str, x: torch.Tensor, dtypes) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name}: expected an (n, m) matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(one of {tuple(dtypes)})")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous (row-major)")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def _check_vector(name: str, v: torch.Tensor, m: int, like: torch.Tensor,
                  dtype) -> None:
    if v.device != like.device:
        raise ValueError(f"{name}: tensors on {v.device} and {like.device}")
    if v.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {v.dtype}")
    if v.numel() != m or not v.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({m},) vector, got "
                         f"{tuple(v.shape)}")


# -----------------------------------------------------------------------------
# colstats
# -----------------------------------------------------------------------------

def colstats_cost(n: int, m: int):
    """(operations, bytes) of ``colstats`` on an (n, m) f32 matrix: |.|,
    a sum and a max an element; Y read, two (m,) f32 written."""
    return 3 * n * m, 4 * n * m + 2 * 4 * m


def colstats_plain(Y: torch.Tensor):
    """Plain version of ``colstats``: (sum |Y|, max |Y|) per column, f32."""
    A = Y.to(torch.float32).abs()
    return A.sum(dim=0), A.amax(dim=0)


def colstats(Y: torch.Tensor):
    """Per-column (sum, max) of |Y| for an (n, m) f32 row-major matrix.

    Returns two (m,) f32 tensors on Y's device. CUDA: one launch of
    ``l1inf_colstats`` (16-byte loads when m is a multiple of 4 and Y is
    16-byte aligned); CPU: ``colstats_plain``.
    """
    _check_matrix("colstats", Y, (torch.float32,))
    if not kernel_side(Y, "colstats"):
        return colstats_plain(Y)
    n, m = Y.shape
    colsum = torch.empty((m,), dtype=torch.float32, device=Y.device)
    colmax = torch.empty((m,), dtype=torch.float32, device=Y.device)
    if is_meta(Y):
        record_kernel("colstats", colstats_cost(n, m))
        return colsum, colmax
    vec4 = int(m % 4 == 0 and Y.data_ptr() % 16 == 0)
    rc = _lib().l1inf_colstats(Y.data_ptr(), colsum.data_ptr(),
                               colmax.data_ptr(), n, m, vec4, _stream(Y))
    _launched("colstats", rc)
    return colsum, colmax


# -----------------------------------------------------------------------------
# mu_solve
# -----------------------------------------------------------------------------

def _mu_inputs(Yabs, theta, block_m, nact_blocks):
    n, m = Yabs.shape
    theta = torch.as_tensor(theta, dtype=torch.float32, device=Yabs.device)
    if theta.ndim == 0:
        theta = theta.reshape(1)
    elif theta.numel() != m:
        raise ValueError(f"mu_solve: theta must be a scalar or ({m},), got "
                         f"{tuple(theta.shape)}")
    theta = theta.contiguous()
    if block_m <= 0:
        raise ValueError(f"mu_solve: block_m must be > 0, got {block_m}")
    if nact_blocks is None:
        nact_blocks = -(-m // block_m)
    if isinstance(nact_blocks, torch.Tensor):
        nact = nact_blocks.to(device=Yabs.device, dtype=torch.int32)
    else:      # torch.full, not a host copy: no sync on the card
        nact = torch.full((), int(nact_blocks), dtype=torch.int32,
                          device=Yabs.device)
    nact = nact.reshape(1).contiguous()
    return theta, nact


def _above(y, mu):
    """Per column: (max(count of y > mu, 1), sum of y > mu)."""
    gt = y > mu[None, :]
    k = torch.clamp(gt.to(torch.float32).sum(dim=0), min=1.0)
    return k, torch.where(gt, y, torch.zeros_like(y)).sum(dim=0)


def _cold_levels(y, th, colmax, n_bisect, n_polish):
    """Every column's level at removed mass th from nothing: n_bisect
    bisection steps on [0, colmax], n_polish Michelot steps from below,
    the payloads at the level. Returns (mu, k, S_k) for every column."""
    lo, hi = torch.zeros_like(colmax), colmax
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        removed = torch.clamp(y - mid[None, :], min=0.0).sum(dim=0)
        ge = removed >= th
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    mu = lo
    for _ in range(n_polish):
        k, S = _above(y, mu)
        mu = torch.maximum((S - th) / k, mu)
    mu = torch.clamp(mu, min=0.0)
    k, S = _above(y, mu)
    return mu, k, S


def mu_solve_cost(n: int, m: int, active: int, n_bisect: int = 26,
                  n_polish: int = 8):
    """(operations, bytes) of ``mu_solve`` on an (n, m) f32 |Y| of which
    the first ``active`` columns solve (the ``nact_blocks`` prefix, data
    dependent): two f32 operations an element of those columns on each of
    the n_bisect + n_polish + 2 passes; their values and a theta read, 13
    bytes a column written (mu, k, S_k, active)."""
    return (2 * n * active * (n_bisect + n_polish + 2),
            4 * n * active + 4 * active + 13 * m)


def mu_solve_plain(Yabs: torch.Tensor, theta: torch.Tensor, *,
                   block_m: int, nact: torch.Tensor, n_bisect: int = 26,
                   n_polish: int = 8):
    """Plain version of ``mu_solve``: the kernel's bisection + polish in f32
    over every column, then the ``nact * block_m`` prefix predicate."""
    y = Yabs.to(torch.float32).abs()
    m = y.shape[1]
    th = theta if theta.numel() == m else theta.reshape(())
    active = y.sum(dim=0) > th
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    mu, k, S = _cold_levels(y, th, y.amax(dim=0), n_bisect, n_polish)

    cols = torch.arange(m, device=y.device)
    live = active & (cols < nact.to(torch.int64) * block_m)
    return (torch.where(live, mu, zero), torch.where(live, k, zero + 1.0),
            torch.where(live, S, zero), live)


def mu_solve(Yabs: torch.Tensor, theta, *, block_m: int = 128,
             n_bisect: int = 26, n_polish: int = 8, nact_blocks=None):
    """Water level per column at removed mass theta.

    ``Yabs``: (n, m) f32 row-major (|Y|; the kernel takes |.| again).
    ``theta``: scalar or (m,) f32 (one per column for packed buffers).
    ``nact_blocks``: None (every column solves) or an int / 0-d int32
    device tensor: columns at or past ``nact_blocks * block_m`` skip the
    solve and report the inactive defaults. The kernel reads it from
    device memory, so no host sync happens.

    Returns (mu, k, S_k, active): three (m,) f32 tensors and an (m,) bool.
    Inactive columns get (0, 1, 0, False).
    """
    _check_matrix("mu_solve", Yabs, (torch.float32,))
    card = kernel_side(Yabs, "mu_solve")
    theta, nact = _mu_inputs(Yabs, theta, block_m, nact_blocks)
    if not card:
        return mu_solve_plain(Yabs, theta, block_m=block_m, nact=nact,
                              n_bisect=n_bisect, n_polish=n_polish)
    n, m = Yabs.shape
    dev = Yabs.device
    mu = torch.empty((m,), dtype=torch.float32, device=dev)
    k = torch.empty((m,), dtype=torch.float32, device=dev)
    S = torch.empty((m,), dtype=torch.float32, device=dev)
    act = torch.empty((m,), dtype=torch.bool, device=dev)
    if is_meta(Yabs):       # every column solves: the count's cap
        record_kernel("mu_solve", mu_solve_cost(n, m, m, n_bisect, n_polish))
        return mu, k, S, act
    rc = _lib().l1inf_mu_solve(
        Yabs.data_ptr(), theta.data_ptr(), 1 if theta.numel() == m and m > 1
        else 0, nact.data_ptr(), block_m, mu.data_ptr(), k.data_ptr(),
        S.data_ptr(), act.data_ptr(), n, m, n_bisect, n_polish, _stream(Yabs))
    _launched("mu_solve", rc)
    return mu, k, S, act


# -----------------------------------------------------------------------------
# clip_apply
# -----------------------------------------------------------------------------

def clip_apply_cost(n: int, m: int, itemsize: int = 4):
    """(operations, bytes) of ``clip_apply`` on an (n, m) Y of
    ``itemsize`` bytes an element: |.|, a min and the sign an element; Y
    and mu read, X written."""
    return 3 * n * m, 2 * itemsize * n * m + 4 * m


def clip_apply_plain(Y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Plain version of ``clip_apply``: sign(Y) * min(|Y|, mu_j), with mu
    rounded to Y's dtype first."""
    return torch.sign(Y) * torch.minimum(Y.abs(), mu.to(Y.dtype)[None, :])


def clip_apply(Y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """X = sign(Y) * min(|Y|, mu_j), elementwise, in Y's dtype.

    ``Y``: (n, m) f32 or bf16 row-major; ``mu``: (m,) f32 (rounded to Y's
    dtype before the clip, as the Pallas kernel does). Returns a new
    (n, m) tensor of Y's dtype.
    """
    _check_matrix("clip_apply", Y, (torch.float32, torch.bfloat16))
    n, m = Y.shape
    _check_vector("clip_apply", mu, m, Y, torch.float32)
    if not kernel_side(Y, "clip_apply"):
        return clip_apply_plain(Y, mu)
    X = torch.empty_like(Y)
    if is_meta(Y):
        record_kernel("clip_apply", clip_apply_cost(n, m, Y.element_size()))
        return X
    fn = (_lib().l1inf_clip_apply_f32 if Y.dtype == torch.float32
          else _lib().l1inf_clip_apply_bf16)
    rc = fn(Y.data_ptr(), mu.data_ptr(), X.data_ptr(), n, m, _stream(Y))
    _launched("clip_apply", rc)
    return X


# -----------------------------------------------------------------------------
# newton_loop
# -----------------------------------------------------------------------------

def eq19_step(solve, A, th_seg, sids, sum_seg, Csafe, num_segments, nact):
    """One Newton evaluation of the engine: ``solve(A, theta_cols, nact)``
    (a ``mu_solve`` returning (mu, k, S_k, active)) at the per-segment
    thetas ``th_seg``, then the segmented Eq.-(19) step. Returns (new
    theta (G,), mu (m,))."""
    G = int(num_segments)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=A.device)
    pad = torch.full((1,), _PAD_THETA, dtype=f32, device=A.device)
    mu, k, S, act = solve(A, torch.cat([th_seg, pad])[
        torch.clamp(sids, max=G)], nact)
    act = act & (sids < G)
    Aa = sum_seg(torch.where(act, S / k, zero))[:G]
    Ba = sum_seg(torch.where(act, 1.0 / k, zero))[:G]
    return (Aa - Csafe) / torch.clamp(Ba, min=1e-30), mu


def _host_loop(solve, A, sids, colsum, t1, Csafe, G, bm, shrink,
               max_newton):
    """The engine's loop from pass 2 on, one ``solve`` and one host sync
    (``any(theta > prev)``) per Newton evaluation."""
    m = A.shape[1]
    dev = A.device
    i32 = torch.int32
    nblocks = m // bm
    sum_seg = _segment_summer(sids, G + 1)
    pad = torch.full((1,), _PAD_THETA, dtype=torch.float32, device=dev)

    def step(th, nact):
        return eq19_step(solve, A, th, sids, sum_seg, Csafe, G, nact)

    if shrink:
        iota = torch.arange(m, dtype=i32, device=dev)
        col_seg = torch.clamp(sids, max=G)

        def nact_of(th):   # blocks up to the last still-alive column
            alive = (colsum > torch.cat([th, pad])[col_seg]) & (sids < G)
            last = torch.where(alive, iota, -1).max()
            return ((last + 1) + bm - 1) // bm
    else:
        all_blocks = torch.full((), nblocks, dtype=i32, device=dev)

        def nact_of(th):
            return all_blocks

    nact1 = nact_of(t1)
    t2, mu = step(t1, nact1)
    theta, prev = torch.maximum(t2, t1), t1
    work = nblocks * bm + nact1 * bm
    iters = 2
    while iters < max_newton and taken((theta > prev).any()):
        nact = nact_of(theta)
        new, mu = step(theta, nact)
        iters, theta, prev = iters + 1, torch.maximum(new, theta), theta
        work = work + nact * bm
    # max_newton cap exit: mu lags theta by one iterate; re-evaluate
    if taken((theta > prev).any()):
        mu = step(theta, nact_of(theta))[1]
    return (theta, mu, torch.tensor(iters, device=dev), work,
            nact_of(theta) * bm)


# The warm start's distance below the tangent, in units of the column's
# max: more than the f32 rounding of the previous level (a sum of up to
# n values), so the start stays below the new level.
WARM_MARGIN = 2.0 ** -16


def warm_levels(y, th, th_prev, mu_prev, k_prev, colmax, n_polish):
    """Every column's level at removed mass th, started from the level
    mu_prev (with k_prev values above it) solved at th_prev <= th.

    removed(mu) = sum (y - mu)_+ is convex, so its tangent at mu_prev puts
    the new level at or above mu_prev - (th - th_prev) / k_prev; the start
    is that, less ``WARM_MARGIN * colmax``, clamped at 0. Michelot steps
    from there climb monotonely to the exact fixed point; the first step
    that does not raise the level ends a column's solve, and its (k, S_k)
    are the payloads. A column is not ``converged`` when its first step
    lowers the level (the start was above it) or after n_polish steps that
    all raised it. Returns (mu, k, S_k, converged) for every column."""
    mu = torch.clamp(mu_prev - (th - th_prev) / k_prev - colmax * WARM_MARGIN,
                     min=0.0)
    k, S = torch.ones_like(mu), torch.zeros_like(mu)
    done = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    converged = done.clone()
    for it in range(n_polish):
        kc, Sc = _above(y, mu)
        nm = (Sc - th) / kc
        stop = ~done & (nm <= mu)
        converged |= stop & (nm == mu) if it == 0 else stop
        k, S = torch.where(stop, kc, k), torch.where(stop, Sc, S)
        done |= stop
        mu = torch.where(done, mu, nm)
    return mu, k, S, converged


def newton_loop_cost(n: int, first: int, later: int, n_bisect: int = 26,
                     n_polish: int = 8):
    """(operations, bytes) of ``newton_loop`` on n rows: data dependent, so
    its arguments are the columns of pass 2's prefix (``first``) and the
    columns summed over every later evaluation's prefix (``later``; the
    work counter less m and ``first``). The first prefix read once; two
    f32 operations an element on each of pass 2's n_bisect + n_polish + 2
    cold passes over it and on the 2 passes (a step and the one that
    confirms it) a warm evaluation takes at least over each later
    prefix."""
    return (2 * n * ((n_bisect + n_polish + 2) * first + 2 * later),
            4 * n * first)


def newton_loop_plain(A, sids, colsum, t1, Csafe, num_active, *,
                      num_segments: int, block_m: int, shrink: bool = True,
                      n_bisect: int = 26, n_polish: int = 8,
                      max_newton: int = 32):
    """Plain version of ``newton_loop``: the host loop over the kernel's
    solve (``num_active`` is not needed: it scans every column for the
    alive prefix). A column is alive while its ``colsum`` exceeds its
    theta. Pass 2 solves every column cold (``mu_solve_plain``'s
    bisection and polish); every later evaluation starts each column from
    its previous level (``warm_levels``) and solves cold only the columns
    that did not converge from there."""
    y = A.to(torch.float32).abs()
    colmax = y.amax(dim=0)
    cols = torch.arange(y.shape[1], device=y.device)
    prev = {}

    def solve(A_, th, nact):
        live = (colsum > th) & (cols < nact.to(torch.int64) * block_m)
        if not prev:
            mu, k, S = _cold_levels(y, th, colmax, n_bisect, n_polish)
        else:
            mu, k, S, ok = warm_levels(y, th, prev["th"], prev["mu"],
                                       prev["k"], colmax, n_polish)
            cold = torch.nonzero(live & ~ok)[:, 0]
            if cold.numel():
                mu[cold], k[cold], S[cold] = _cold_levels(
                    y[:, cold], th[cold], colmax[cold], n_bisect, n_polish)
        prev.update(th=th, mu=mu, k=k)
        zero = torch.zeros((), dtype=torch.float32, device=y.device)
        return (torch.where(live, mu, zero), torch.where(live, k, zero + 1.0),
                torch.where(live, S, zero), live)
    return _host_loop(solve, A, sids, colsum, t1, Csafe, int(num_segments),
                      block_m, shrink, max_newton)


def newton_loop(A: torch.Tensor, sids: torch.Tensor, colsum: torch.Tensor,
                t1: torch.Tensor, Csafe: torch.Tensor,
                num_active: torch.Tensor, *, num_segments: int,
                block_m: int, shrink: bool = True, n_bisect: int = 26,
                n_polish: int = 8, max_newton: int = 32):
    """The engine's monotone Newton on theta, from pass 2 to the end.

    ``A`` (n, m) f32 |Y| with its columns compacted (alive first, m a
    multiple of ``block_m``); ``sids`` (m,) int32 segment ids in that order
    (``num_segments`` marks padding); ``colsum`` (m,) f32 its column sums;
    ``t1`` (G,) the theta after pass 1; ``Csafe`` (G,) the radii (1 where
    <= 0); ``num_active`` int32 J, the count of columns alive at ``t1``
    (columns past it are dead for good).

    Returns (theta (G,), mu (m,), newton_iters, work_cols,
    active_cols_per_step), the counters as 0-d tensors on A's device.
    CUDA: one cooperative launch of ``l1inf_newton_loop`` and no host sync,
    for n up to ``NEWTON_LOOP_MAX_ROWS``; taller buffers run the host
    loop over the ``mu_solve`` kernel. Meta: the same choice, the launch
    (or each ``mu_solve`` of the host loop) recorded at the loop's cap.
    CPU: ``newton_loop_plain``.
    """
    _check_matrix("newton_loop", A, (torch.float32,))
    n, m = A.shape
    G = int(num_segments)
    if G < 1 or block_m <= 0 or m % block_m:
        raise ValueError(f"newton_loop: need num_segments >= 1 and m ({m}) "
                         f"a multiple of block_m ({block_m})")
    _check_vector("newton_loop", sids, m, A, torch.int32)
    _check_vector("newton_loop", colsum, m, A, torch.float32)
    _check_vector("newton_loop", t1, G, A, torch.float32)
    _check_vector("newton_loop", Csafe, G, A, torch.float32)
    _check_vector("newton_loop", num_active, 1, A, torch.int32)
    kw = dict(num_segments=G, block_m=block_m, shrink=shrink,
              n_bisect=n_bisect, n_polish=n_polish, max_newton=max_newton)
    if not kernel_side(A, "newton_loop"):
        return newton_loop_plain(A, sids, colsum, t1, Csafe, num_active,
                                 **kw)
    if n > NEWTON_LOOP_MAX_ROWS:
        def solve(A_, th, nact):
            return mu_solve(A_, th, block_m=block_m, n_bisect=n_bisect,
                            n_polish=n_polish, nact_blocks=nact)
        return _host_loop(solve, A, sids, colsum, t1, Csafe, G, block_m,
                          shrink, max_newton)
    dev = A.device
    mu = torch.empty((m,), dtype=torch.float32, device=dev)
    theta = torch.empty((G,), dtype=torch.float32, device=dev)
    stats = torch.empty((3,), dtype=torch.int64, device=dev)
    if is_meta(A):          # the cap: every evaluation over every column
        record_kernel("newton_loop", newton_loop_cost(
            n, m, (max_newton - 1) * m, n_bisect, n_polish))
        return theta, mu, stats[0], stats[1], stats[2]
    lib = _lib()
    clusters = lib.l1inf_newton_loop_clusters(n, m, G)
    if clusters < 0:
        _launched("newton_loop", -clusters)       # raises with the error
    partials = torch.empty((2 * clusters * (2 * G + 1),),
                           dtype=torch.float32, device=dev)
    rc = lib.l1inf_newton_loop(
        A.data_ptr(), sids.data_ptr(), colsum.data_ptr(), t1.data_ptr(),
        Csafe.data_ptr(), num_active.data_ptr(), mu.data_ptr(),
        theta.data_ptr(), stats.data_ptr(), partials.data_ptr(), n, m, G,
        block_m, n_bisect, n_polish, max_newton, int(bool(shrink)),
        _stream(A))
    _launched("newton_loop", rc)
    return theta, mu, stats[0], stats[1], stats[2]
