"""The fused Adam+projection step's two kernels: wrappers and plain versions.

Both kernels are hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/fused_step.cu`` (its source note gives the design).
They replace the Pallas kernels of ``repro/kernels/fused_step/kernel.py``:

  * ``adam_colstats``   (pass 1, replaces ``kernel.py::adam_colstats``) —
    one read of (g, m, v, p[, mask]): moments updated and written, the
    update u formed from the stored moments and rounded to p's dtype, and
    its per-column sum |u| (or sum u^2) and max |u|; u is never written.
  * ``adam_clip_apply`` (pass 2, replaces ``kernel.py::adam_clip_apply``)
    — u recomputed from the stored moments, then sign(u) * min(|u|, mu_j)
    (``mode="clip"``) or u * mu_j (``mode="scale"``), masked, in p's
    dtype.

Bound on the card: bytes. At the SAE's ``enc1/w`` (10000 x 96, f32) pass 1
moves 23.0 MB (6.9 us at 3.35 TB/s) and pass 2 15.4 MB (4.6 us); the
whole working set fits the 50 MB L2.

Beside each wrapper sits a plain PyTorch version that repeats the kernel's
arithmetic operation for operation (every constant an f32 tensor, sign as
(u > 0) - (u < 0)), so on the card the two agree bit for bit on moments
and outputs and the column maxima; the column sums differ only by the
order of the reduction. Dispatch is by the tensor's device alone: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel
(building it at first use), a meta tensor (the dry-run's) gets empty meta
outputs and its launch recorded with its ``*_cost`` in the active
``roofline.counter.Counter`` (no launch count moves); any other device
raises. Each wrapper checks device,
dtype, shape and contiguity, allocates its outputs with ``torch.empty``,
launches on the current stream without synchronising, raises if the
launch reports an error, and adds one to its launch count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ... import _build
from ..._device import is_meta, kernel_side
from ...roofline.counter import record_kernel

__all__ = ["adam_colstats", "adam_clip_apply", "adam_colstats_plain",
           "adam_clip_apply_plain", "adam_colstats_cost",
           "adam_clip_apply_cost", "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"adam_colstats": 0, "adam_clip_apply": 0}
_LIB: Optional[ctypes.CDLL] = None
_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        lib = _build.library("fused_step")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_adam_colstats.argtypes = (
            [I, I] + [P] * 10 + [F] * 6 + [I] * 5 + [P])
        lib.fused_adam_clip_apply.argtypes = (
            [I, I] + [P] * 7 + [F] * 6 + [I] * 5 + [P])
        lib.fused_adam_colstats.restype = I
        lib.fused_adam_clip_apply.restype = I
        lib.fused_step_error_string.argtypes = [I]
        lib.fused_step_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().fused_step_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    _LAUNCHES[name] += 1



def _check(name: str, p: torch.Tensor, like_p, like_m, sc: torch.Tensor):
    """Validate the (L, R, C) stack ``p``, the tensors that share its dtype
    (``like_p``: g, mask), the moments (``like_m``) and the scalars."""
    if p.ndim != 3:
        raise ValueError(f"{name}: expected an (L, R, C) stack, got shape "
                         f"{tuple(p.shape)}")
    if p.dtype not in _DTYPES:
        raise TypeError(f"{name}: param dtype {p.dtype} not supported "
                        f"(one of {_DTYPES})")
    L, R, C = p.shape
    if min(L, R, C) == 0:
        raise ValueError(f"{name}: empty input {tuple(p.shape)}")
    if L > 65535 or L * R * C >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(p.shape)} too large")
    m_dtype = like_m[0].dtype
    if m_dtype not in _DTYPES:
        raise TypeError(f"{name}: moment dtype {m_dtype} not supported")
    for t, dt in [(x, p.dtype) for x in like_p if x is not None] + \
            [(x, m_dtype) for x in like_m]:
        if t.device != p.device:
            raise ValueError(f"{name}: tensors on {t.device} and {p.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
    for t in [p, *like_m, *[x for x in like_p if x is not None]]:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if (sc.device != p.device or sc.dtype != torch.float32
            or sc.shape != (4,) or not sc.is_contiguous()):
        raise ValueError(f"{name}: sc must be a contiguous (4,) f32 tensor "
                         f"on {p.device}")


def _consts(like: torch.Tensor, b1, b2, eps, wd):
    """The update's constants as f32 tensors, each formed in double first
    (1 - b1 and 1 - b2 included) and rounded once; filled on the device,
    so a CUDA graph can capture them."""
    f = lambda x: torch.full((), float(x), dtype=torch.float32,
                             device=like.device)
    return f(b1), f(1.0 - b1), f(b2), f(1.0 - b2), f(eps), f(wd)


def _u_plain(m_st, v_st, p, mk, lr_t, b1c, b2c, eps, wd, has_wd):
    """The kernels' ``adam_u``: u from the stored moments, rounded through
    p's dtype, returned in f32."""
    mhat = m_st.to(torch.float32) / b1c
    vhat = v_st.to(torch.float32) / b2c
    step = (lr_t * mhat) / (torch.sqrt(vhat) + eps)
    if has_wd:
        step = step + (lr_t * wd) * p.to(torch.float32)
    if mk is not None:
        step = step * mk.to(torch.float32)
    return (p.to(torch.float32) - step).to(p.dtype).to(torch.float32)


# -----------------------------------------------------------------------------
# pass 1: adam_colstats
# -----------------------------------------------------------------------------

def adam_colstats_cost(L: int, R: int, C: int, transpose: bool,
                       p_size: int = 4, m_size: int = 4,
                       mask: bool = False):
    """(operations, bytes) of ``adam_colstats`` on (L, R, C) stacks with
    params (and g, mask) of ``p_size`` bytes and moments of ``m_size``: 20
    f32 operations an element; g, p, m, v (and the mask) read, m and v
    written, two (L, mcols) f32 and the 16-byte scalars."""
    n = L * R * C
    mcols = R if transpose else C
    return (20 * n, n * (2 * p_size + 4 * m_size + (p_size if mask else 0))
            + 2 * 4 * L * mcols + 16)


def adam_clip_apply_cost(L: int, R: int, C: int, transpose: bool,
                         p_size: int = 4, m_size: int = 4,
                         mask: bool = False):
    """(operations, bytes) of ``adam_clip_apply``: 14 f32 operations an
    element; m, v, p (and the mask) and mu read, the params written."""
    n = L * R * C
    mcols = R if transpose else C
    return (14 * n, n * (2 * p_size + 2 * m_size + (p_size if mask else 0))
            + 4 * L * mcols + 16)


def adam_colstats_plain(sc, g, m, v, p, mask=None, *, b1, b2, eps, wd,
                        transpose: bool, stat: str = "abs"):
    """Plain version of ``adam_colstats`` (same arguments and results)."""
    b1_, omb1, b2_, omb2, eps_, wd_ = _consts(p, b1, b2, eps, wd)
    gv = (g.to(torch.float32) * sc[0]).to(g.dtype).to(torch.float32)
    if mask is not None:
        gv = gv * mask.to(torch.float32)
    m_new = (b1_ * m.to(torch.float32) + omb1 * gv).to(m.dtype)
    v_new = (b2_ * v.to(torch.float32) + (omb2 * gv) * gv).to(v.dtype)
    u = _u_plain(m_new, v_new, p, mask, sc[1], sc[2], sc[3], eps_, wd_,
                 wd != 0)
    a = u.abs()
    red = 2 if transpose else 1
    colsum = (a * a if stat == "sq" else a).sum(dim=red)
    return m_new, v_new, colsum, a.amax(dim=red)


def adam_colstats(sc: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, p: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, b1: float,
                  b2: float, eps: float, wd: float, transpose: bool,
                  stat: str = "abs"):
    """Pass 1 on contiguous (L, R, C) stacks.

    ``sc``: (4,) f32 [clip_scale, lr_t, b1c, b2c] on the same device; ``g``,
    ``p`` and the optional {0,1} ``mask`` share one dtype (f32 or bf16);
    ``m``, ``v`` share the moment dtype (f32 or bf16). Returns (m_new,
    v_new) in the moment dtype and (colsum, colmax) f32 (L, mcols), mcols =
    R when ``transpose`` else C. ``stat``: "abs" sums |u|, "sq" sums u^2.
    """
    if stat not in ("abs", "sq"):
        raise ValueError(f"unknown stat {stat!r} (abs | sq)")
    _check("adam_colstats", p, (g, mask), (m, v), sc)
    if not kernel_side(p, "adam_colstats"):
        return adam_colstats_plain(sc, g, m, v, p, mask, b1=b1, b2=b2,
                                   eps=eps, wd=wd, transpose=transpose,
                                   stat=stat)
    L, R, C = p.shape
    mcols = R if transpose else C
    m_new, v_new = torch.empty_like(m), torch.empty_like(v)
    colsum = torch.empty((L, mcols), dtype=torch.float32, device=p.device)
    colmax = torch.empty((L, mcols), dtype=torch.float32, device=p.device)
    if is_meta(p):
        record_kernel("adam_colstats", adam_colstats_cost(
            L, R, C, transpose, p.element_size(), m.element_size(),
            mask is not None))
        return m_new, v_new, colsum, colmax
    rc = _lib().fused_adam_colstats(
        _CODE[p.dtype], _CODE[m.dtype], g.data_ptr(), m.data_ptr(),
        v.data_ptr(), p.data_ptr(), None if mask is None else mask.data_ptr(),
        m_new.data_ptr(), v_new.data_ptr(), colsum.data_ptr(),
        colmax.data_ptr(), sc.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
        L, R, C, int(transpose), int(stat == "sq"),
        torch.cuda.current_stream(p.device).cuda_stream)
    _launched("adam_colstats", rc)
    return m_new, v_new, colsum, colmax


# -----------------------------------------------------------------------------
# pass 2: adam_clip_apply
# -----------------------------------------------------------------------------

def adam_clip_apply_plain(sc, m, v, p, mu, mask=None, *, b1, b2, eps, wd,
                          transpose: bool, mode: str = "clip"):
    """Plain version of ``adam_clip_apply`` (same arguments and result)."""
    _, _, _, _, eps_, wd_ = _consts(p, b1, b2, eps, wd)
    u = _u_plain(m, v, p, mask, sc[1], sc[2], sc[3], eps_, wd_, wd != 0)
    mu_b = mu[:, :, None] if transpose else mu[:, None, :]
    if mode == "scale":
        x = u * mu_b
    else:
        sgn = (u > 0).to(torch.float32) - (u < 0).to(torch.float32)
        x = sgn * torch.minimum(u.abs(), mu_b)
    if mask is not None:
        x = x * mask.to(torch.float32)
    return x.to(p.dtype)


def adam_clip_apply(sc: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    p: torch.Tensor, mu: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *, b1: float,
                    b2: float, eps: float, wd: float, transpose: bool,
                    mode: str = "clip") -> torch.Tensor:
    """Pass 2 on contiguous (L, R, C) stacks: the projected params in p's
    dtype. ``mu``: contiguous (L, mcols) f32 per-column level (clip: 1e30
    identity, 0 dead; scale: a multiplier, identity 1.0). Other arguments
    as in ``adam_colstats`` (``sc[0]`` is not read).
    """
    if mode not in ("clip", "scale"):
        raise ValueError(f"unknown mode {mode!r} (clip | scale)")
    _check("adam_clip_apply", p, (mask,), (m, v), sc)
    L, R, C = p.shape
    mcols = R if transpose else C
    if (mu.device != p.device or mu.dtype != torch.float32
            or tuple(mu.shape) != (L, mcols) or not mu.is_contiguous()):
        raise ValueError(f"adam_clip_apply: mu must be a contiguous "
                         f"({L}, {mcols}) f32 tensor on {p.device}")
    if not kernel_side(p, "adam_clip_apply"):
        return adam_clip_apply_plain(sc, m, v, p, mu, mask, b1=b1, b2=b2,
                                     eps=eps, wd=wd, transpose=transpose,
                                     mode=mode)
    x = torch.empty_like(p)
    if is_meta(p):
        record_kernel("adam_clip_apply", adam_clip_apply_cost(
            L, R, C, transpose, p.element_size(), m.element_size(),
            mask is not None))
        return x
    rc = _lib().fused_adam_clip_apply(
        _CODE[p.dtype], _CODE[m.dtype], m.data_ptr(), v.data_ptr(),
        p.data_ptr(), None if mask is None else mask.data_ptr(),
        mu.data_ptr(), x.data_ptr(), sc.data_ptr(), b1, 1.0 - b1, b2,
        1.0 - b2, eps, wd, L, R, C, int(transpose), int(mode == "scale"),
        torch.cuda.current_stream(p.device).cuda_stream)
    _launched("adam_clip_apply", rc)
    return x
