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
  * ``clip_apply`` — X = sign(Y) * min(|Y|, mu_j) in Y's dtype.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (building it at first use) or
the call raises. Each wrapper checks device, dtype, shape and contiguity
first, allocates its outputs with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch reports an error, and
adds one to its launch count (``launch_counts``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ... import _build

__all__ = ["colstats", "mu_solve", "clip_apply", "colstats_plain",
           "mu_solve_plain", "clip_apply_plain", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"colstats": 0, "mu_solve": 0, "clip_apply": 0}
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
        lib.l1inf_colstats.argtypes = [P, P, P, I, I, P]
        lib.l1inf_mu_solve.argtypes = [P, P, I, P, I, P, P, P, P, I, I, I,
                                       I, P]
        lib.l1inf_clip_apply_f32.argtypes = [P, P, P, I, I, P]
        lib.l1inf_clip_apply_bf16.argtypes = [P, P, P, I, I, P]
        for fn in (lib.l1inf_colstats, lib.l1inf_mu_solve,
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


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{x.device}")


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

def colstats_plain(Y: torch.Tensor):
    """Plain version of ``colstats``: (sum |Y|, max |Y|) per column, f32."""
    A = Y.to(torch.float32).abs()
    return A.sum(dim=0), A.amax(dim=0)


def colstats(Y: torch.Tensor):
    """Per-column (sum, max) of |Y| for an (n, m) f32 row-major matrix.

    Returns two (m,) f32 tensors on Y's device. CUDA: one launch of
    ``l1inf_colstats``; CPU: ``colstats_plain``.
    """
    _check_matrix("colstats", Y, (torch.float32,))
    if not _on_card(Y, "colstats"):
        return colstats_plain(Y)
    n, m = Y.shape
    colsum = torch.empty((m,), dtype=torch.float32, device=Y.device)
    colmax = torch.empty((m,), dtype=torch.float32, device=Y.device)
    rc = _lib().l1inf_colstats(Y.data_ptr(), colsum.data_ptr(),
                               colmax.data_ptr(), n, m, _stream(Y))
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
    nact = torch.as_tensor(nact_blocks, dtype=torch.int32,
                           device=Yabs.device).reshape(1).contiguous()
    return theta, nact


def mu_solve_plain(Yabs: torch.Tensor, theta: torch.Tensor, *,
                   block_m: int, nact: torch.Tensor, n_bisect: int = 26,
                   n_polish: int = 8):
    """Plain version of ``mu_solve``: the kernel's bisection + polish in f32
    over every column, then the ``nact * block_m`` prefix predicate."""
    y = Yabs.to(torch.float32).abs()
    m = y.shape[1]
    th = theta if theta.numel() == m else theta.reshape(())
    colsum = y.sum(dim=0)
    colmax = y.amax(dim=0)
    active = colsum > th
    zero = torch.zeros((), dtype=torch.float32, device=y.device)

    lo, hi = torch.zeros_like(colsum), colmax
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        removed = torch.clamp(y - mid[None, :], min=0.0).sum(dim=0)
        ge = removed >= th
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)

    def payloads(mu):
        gt = y > mu[None, :]
        k = torch.clamp(gt.to(torch.float32).sum(dim=0), min=1.0)
        return k, torch.where(gt, y, zero).sum(dim=0)

    mu = lo
    for _ in range(n_polish):
        k, S = payloads(mu)
        mu = torch.maximum((S - th) / k, mu)
    mu = torch.clamp(mu, min=0.0)
    k, S = payloads(mu)

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
    theta, nact = _mu_inputs(Yabs, theta, block_m, nact_blocks)
    if not _on_card(Yabs, "mu_solve"):
        return mu_solve_plain(Yabs, theta, block_m=block_m, nact=nact,
                              n_bisect=n_bisect, n_polish=n_polish)
    n, m = Yabs.shape
    dev = Yabs.device
    mu = torch.empty((m,), dtype=torch.float32, device=dev)
    k = torch.empty((m,), dtype=torch.float32, device=dev)
    S = torch.empty((m,), dtype=torch.float32, device=dev)
    act = torch.empty((m,), dtype=torch.bool, device=dev)
    rc = _lib().l1inf_mu_solve(
        Yabs.data_ptr(), theta.data_ptr(), 1 if theta.numel() == m and m > 1
        else 0, nact.data_ptr(), block_m, mu.data_ptr(), k.data_ptr(),
        S.data_ptr(), act.data_ptr(), n, m, n_bisect, n_polish, _stream(Yabs))
    _launched("mu_solve", rc)
    return mu, k, S, act


# -----------------------------------------------------------------------------
# clip_apply
# -----------------------------------------------------------------------------

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
    if not _on_card(Y, "clip_apply"):
        return clip_apply_plain(Y, mu)
    X = torch.empty_like(Y)
    fn = (_lib().l1inf_clip_apply_f32 if Y.dtype == torch.float32
          else _lib().l1inf_clip_apply_bf16)
    rc = fn(Y.data_ptr(), mu.data_ptr(), X.data_ptr(), n, m, _stream(Y))
    _launched("clip_apply", rc)
    return X
