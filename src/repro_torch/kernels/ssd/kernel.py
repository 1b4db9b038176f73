"""The Mamba2 SSD forward scan: the CUDA kernels' wrapper and its plain version.

The kernels are hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/ssd.cu`` (its source note gives the design). They
replace the Pallas TPU kernel ``repro/kernels/ssd/kernel.py::ssd_fwd``:
one chunk of Q steps at a time with the (P, N) f32 state carried across
chunks; per chunk

    cum = cumsum(dt * a);  seg = cum[-1];  L = exp(cum_i - cum_j) (i >= j)
    y   = ((C B^T) * L * dt_j) x + (C * exp(cum)) h^T + d x
    h'  = exp(seg) h + x^T (dt * exp(seg - cum) * B)

Only h couples the chunks and its update is affine, so the scan runs in
three stages, each over every (head, chunk) at once: the chunk-local
updates upd = x^T (dt * exp(seg - cum) * B), the scan h_c = exp(seg_c)
h_{c-1} + upd_c over the chunks, and the outputs from the state entering
each chunk. One wrapper call launches the three kernels and counts one
launch. Bound on the card: bytes at hymba-1.5b's shape (x in and y out,
105 MB, 0.031 ms, against 1.9 GFLOP of lower-triangle work, 0.028 ms),
operations at mamba2-370m's N 128 (5.9 GFLOP, 0.089 ms). f32 on the CUDA
cores; the kernels take chunk 64, head dim P 64 and state dim N 16, 32,
64 or 128 (hymba 16, mamba2 128).

``exp(cum_i - cum_j)`` is taken only where i >= j (``torch.where`` here,
a branch in the kernel), never multiplied by a 0/1 mask: for i < j the
exponent is positive and, at the reference's full-width dt, passes 88, so
the exp is +inf and inf * 0 would be NaN.

Beside the wrapper sits a plain PyTorch version that repeats the kernels'
arithmetic: the same sequential cumsum (so cum is bit-equal), the same
three stages and the same association order. Dispatch is by the tensor's
device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernels (building them at first use) or the call raises.
The wrapper checks device, dtype, shape and contiguity, allocates its
outputs and the f32 scratch with ``torch.empty`` (the chunks' states
(BH, S / chunk, P, N), their exp(seg) and cum, and C B^T per group and
chunk), copies x, B or C if its address is not 16-byte aligned (the
kernels' vector loads need it), launches on the current stream without
synchronising, raises if a launch reports an error, and adds one to its
launch count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ... import _build

__all__ = ["ssd_fwd", "ssd_fwd_plain", "KERNEL_SHAPES", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"ssd_fwd": 0}
_LIB: Optional[ctypes.CDLL] = None
_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SHAPES = dict(chunk=(64,), P=(64,), N=(16, 32, 64, 128))


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
        lib = _build.library("ssd")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.argtypes = [I] + [P] * 12 + [I] * 6 + [P]
        lib.ssd_fwd.restype = I
        lib.ssd_error_string.argtypes = [I]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x, dt, a, d, B, C, chunk: int, groups: int):
    if x.ndim != 3 or dt.ndim != 2 or a.ndim != 1 or d.ndim != 1 \
            or B.ndim != 3 or C.ndim != 3:
        raise ValueError("ssd_fwd: expected x (BH, S, P), dt (BH, S), a/d "
                         "(BH,), B/C (BG, S, N)")
    BH, S, P = x.shape
    BG, SB, N = B.shape
    if (tuple(dt.shape) != (BH, S) or tuple(a.shape) != (BH,)
            or tuple(d.shape) != (BH,) or tuple(C.shape) != (BG, S, N)
            or SB != S):
        raise ValueError(f"ssd_fwd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match")
    if groups < 1 or BH != BG * groups:
        raise ValueError(f"ssd_fwd: BH {BH} != BG {BG} * groups {groups}")
    if min(BH, S, P, N) == 0 or chunk < 1 or S % chunk:
        raise ValueError(f"ssd_fwd: S {S} must be a positive multiple of "
                         f"chunk {chunk}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"ssd_fwd: x, dt, B, C must share one dtype of "
                        f"{_DTYPES}, got {x.dtype}, {dt.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("ssd_fwd: a and d must be float32")
    if any(t.device != x.device for t in (dt, a, d, B, C)):
        raise ValueError("ssd_fwd: inputs on different devices")


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"ssd_fwd: no kernel or plain version for device "
                     f"{x.device}")


def _cumsum_in_order(da: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim, one rounded add at a time from
    the left: the kernel's order (``torch.cumsum`` accumulates in double on
    the CPU and in a parallel scan on the card)."""
    run = torch.zeros(da.shape[:-1], dtype=da.dtype, device=da.device)
    cols = []
    for i in range(da.shape[-1]):
        run = run + da[..., i]
        cols.append(run)
    return torch.stack(cols, dim=-1)


def ssd_fwd_plain(x, dt, a, d, B, C, *, chunk: int = 64, groups: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ssd_fwd`` (same arguments and results): the
    kernels' three stages, batched over heads and chunks."""
    BH, S, P = x.shape
    N = B.shape[-1]
    Q = chunk
    nc = S // Q
    dev = x.device
    xf = x.float().reshape(BH, nc, Q, P)
    dtf = dt.float().reshape(BH, nc, Q)
    Bf = B.float().repeat_interleave(groups, dim=0).reshape(BH, nc, Q, N)
    Cf = C.float().repeat_interleave(groups, dim=0).reshape(BH, nc, Q, N)
    cum = _cumsum_in_order(dtf * a.float()[:, None, None])   # (BH, nc, Q)
    seg = cum[..., -1]                                       # (BH, nc)
    # 1. chunk-local state updates, independent of the carried state
    coef = dtf * torch.exp(seg[..., None] - cum)
    upd = xf.transpose(-1, -2) @ (coef[..., None] * Bf)      # (BH, nc, P, N)
    # 2. the scan: the state entering each chunk, and the final state
    eseg = torch.exp(seg)
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=dev)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = eseg[:, c, None, None] * h + upd[:, c]
    h_in = torch.stack(h_in, dim=1)                          # (BH, nc, P, N)
    # 3. outputs from the state entering each chunk
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    # exp(cum_i - cum_j) only where i >= j: where, never a 0/1 product
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros((), device=dev))
    M = ((Cf @ Bf.transpose(-1, -2)) * L) * dtf[..., None, :]
    ec = torch.exp(cum)
    y = M @ xf + (Cf * ec[..., None]) @ h_in.transpose(-1, -2)
    y = y + d.float()[:, None, None, None] * xf
    return y.reshape(BH, S, P).to(x.dtype), h


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            d: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
            chunk: int = 64, groups: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, S, P); dt: (BH, S); a/d: (BH,) f32; B/C: (BG, S, N) with
    BH = BG * groups; x, dt, B, C share one dtype (f32 or bf16); S a
    multiple of ``chunk``. Returns (y (BH, S, P) in x's dtype, final state
    (BH, P, N) f32). On the card: contiguous inputs, and chunk, P and N
    among ``KERNEL_SHAPES`` (else ValueError); the kernels are forward-only,
    so with grad mode on and an input that requires grad it raises
    RuntimeError rather than drop the gradient.
    """
    _check(x, dt, a, d, B, C, chunk, groups)
    if not _on_card(x):
        return ssd_fwd_plain(x, dt, a, d, B, C, chunk=chunk, groups=groups)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, d, B, C)):
        raise RuntimeError(
            "ssd_fwd: the CUDA kernel is forward-only and its outputs carry "
            "no gradient; call it under torch.no_grad() or on inputs that "
            "do not require grad")
    BH, S, P = x.shape
    N = B.shape[-1]
    if not all(t.is_contiguous() for t in (x, dt, a, d, B, C)):
        raise ValueError("ssd_fwd: inputs must be contiguous")
    if (chunk not in KERNEL_SHAPES["chunk"] or P not in KERNEL_SHAPES["P"]
            or N not in KERNEL_SHAPES["N"]):
        raise ValueError(f"ssd_fwd: chunk {chunk}, P {P}, N {N} not taken by "
                         f"the kernel ({KERNEL_SHAPES})")
    nc = S // chunk
    if nc > 65535:
        raise ValueError(f"ssd_fwd: S / chunk = {nc} > 65535")
    # the kernels read x, B and C in 16-byte (f32) or 8-byte (bf16) vectors
    x, B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, B, C))
    lib = _lib()
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = torch.empty((BH, P, N), **f32)
    # scratch: the chunks' state updates, then the state entering each
    # chunk; exp(seg) per chunk; cum; C B^T per group and chunk
    hst = torch.empty((BH, nc, P, N), **f32)
    eseg = torch.empty((BH, nc), **f32)
    cum = torch.empty((BH, S), **f32)
    G = torch.empty((BH // groups, nc, chunk, chunk), **f32)
    rc = lib.ssd_fwd(
        _CODE[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        d.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        state.data_ptr(), hst.data_ptr(), eseg.data_ptr(), cum.data_ptr(),
        G.data_ptr(), BH, S, P, N, chunk, groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_fwd kernel launch failed: CUDA error {rc} "
                           f"({lib.ssd_error_string(rc).decode()})")
    _LAUNCHES["ssd_fwd"] += 1
    return y, state
