"""Forward flash attention: the CUDA kernel's wrapper and its plain version.

The kernels are hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/flash_attention.cu`` (its source note gives the
design). They replace the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``: forward
online-softmax attention with GQA (kv head = q head // groups), optional
causal and sliding-window masks, fully masked tiles skipped, running
(m, l, acc) in f32 and out = acc / max(l, 1e-30) in q's dtype.

Bound on the card: operations. At hymba-1.5b's prefill (BH 50, S 2048,
hd 64, causal, window 1024) the unmasked pairs need 20.1 GFLOP: 0.020 ms
at the bf16 tensor cores' peak, 0.30 ms at the f32 CUDA cores' peak. bf16
runs on the tensor cores (wgmma, TMA), with p rounded to bf16 before the
product with v, as every tensor-core flash kernel does and as the TPU's
default-precision f32 dot takes its inputs; f32 runs on the CUDA cores in
full f32.

Beside the wrapper sits a plain PyTorch version that repeats the kernels'
arithmetic: the same tile test, the same -1e30 masking with p forced to 0
after the exp, the same online update, and p rounded to q's dtype before
``p @ v`` when that dtype is bf16. ``block_q`` / ``block_kv`` set its
tiles only (the kernels pick their own, by head_dim), and tails that are
not a multiple of a tile are bounds-masked in both. Dispatch is by the
tensor's device alone: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (building it at first use) or the call raises. The
wrapper checks device, dtype, shape and contiguity, copies an input whose
address is not 16-byte aligned (the kernels' vector and TMA loads need
it), allocates the output with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch reports an error, and
adds one to its launch count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ... import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain",
           "KERNEL_HEAD_DIMS", "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}
_LIB: Optional[ctypes.CDLL] = None
_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 80, 128, 256)
_NEG = -1e30


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
        lib = _build.library("flash_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [I, I, P, P, P, P] + [I] * 6 + [ctypes.c_float, P])
        lib.flash_attention_fwd.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, groups: int):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention_fwd: expected q (BH, Sq, hd) and "
                         "k/v (BKV, Skv, hd)")
    BH, Sq, hd = q.shape
    BKV, Skv, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or hdk != hd:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if groups < 1 or BH != BKV * groups:
        raise ValueError(f"flash_attention_fwd: BH {BH} != BKV {BKV} * "
                         f"groups {groups}")
    if min(BH, Sq, Skv, hd) == 0:
        raise ValueError("flash_attention_fwd: empty input")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q, k, v must share one dtype "
                        f"of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v on different devices")


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention_fwd: no kernel or plain version for "
                     f"device {x.device}")


def flash_attention_fwd_plain(q, k, v, *, groups: int = 1,
                              causal: bool = True, window: int = 0,
                              block_q: int = 128,
                              block_kv: int = 128) -> torch.Tensor:
    """Plain version of ``flash_attention_fwd`` (same arguments and result):
    the kernel's tile loop over (block_q, block_kv) tiles."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    scale = hd ** -0.5
    dev = q.device
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=0)
    vf = v.float().repeat_interleave(groups, dim=0)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    for i0 in range(0, Sq, bq):
        qt = qf[:, i0:i0 + bq]
        q_pos = torch.arange(i0, i0 + qt.shape[1], device=dev)[:, None]
        m = torch.full(qt.shape[:2], _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros(qt.shape[:2], dtype=torch.float32, device=dev)
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=dev)
        for j0 in range(0, Skv, bkv):
            if causal and j0 > i0 + bq - 1:
                break
            if window and i0 - (j0 + bkv - 1) >= window:
                continue
            kt, vt = kf[:, j0:j0 + bkv], vf[:, j0:j0 + bkv]
            kv_pos = torch.arange(j0, j0 + kt.shape[1], device=dev)[None, :]
            s = (qt @ kt.transpose(1, 2)) * scale
            mask = torch.ones((qt.shape[1], kt.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos >= kv_pos
            if window:
                mask &= (q_pos - kv_pos) < window
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if q.dtype == torch.bfloat16:   # the tensor cores' P operand
                p = p.to(torch.bfloat16).float()
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        out[:, i0:i0 + bq] = (acc / l.clamp(min=1e-30)[..., None]).to(
            q.dtype)
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, groups: int = 1, causal: bool = True,
                        window: int = 0, block_q: int = 128,
                        block_kv: int = 128) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BKV, Skv, hd) with BH = BKV * groups, all f32
    or all bf16. Returns (BH, Sq, hd) in q's dtype. Sq and Skv need not be
    multiples of a tile. On the card: contiguous inputs, head_dim one of
    ``KERNEL_HEAD_DIMS``, BH <= 65535 (else ValueError).
    """
    _check(q, k, v, groups)
    if not _on_card(q):
        return flash_attention_fwd_plain(q, k, v, groups=groups,
                                         causal=causal, window=window,
                                         block_q=block_q, block_kv=block_kv)
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not supported "
                         f"by the kernel (one of {KERNEL_HEAD_DIMS})")
    if BH > 65535:
        raise ValueError(f"flash_attention_fwd: BH {BH} > 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: inputs must be contiguous")
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    rc = _lib().flash_attention_fwd(
        _CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), BH, Sq, Skv, groups, int(bool(causal)), int(window),
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = _lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    _LAUNCHES["flash_attention_fwd"] += 1
    return out
