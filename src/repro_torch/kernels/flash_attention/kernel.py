"""Flash attention: the CUDA kernels' wrappers, their plain versions and
the autograd function that pairs the forward with its backward.

Forward: hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/flash_attention.cu`` (its source note gives the
design). It replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``: forward
online-softmax attention with GQA (kv head = q head // groups), optional
causal and sliding-window masks, fully masked tiles skipped, running
(m, l, acc) in f32 and out = acc / max(l, 1e-30) in q's dtype. In either
dtype it can also write each row's log-sum-exp, lse = m + log max(l,
1e-30) in f32, the statistics the backward needs (the Pallas kernel
returns m and l).

Backward: ``csrc/flash_attention_bwd.cu`` (its source note gives the
design), f32 on the CUDA cores: delta = rowsum(dout * out), then one
persistent kernel whose CTAs take (kv head, kv tile) items, recompute P
from the saved lse once per tile pair, keep dk and dv in registers over
the group's query tiles and add each tile's dq part to dq in a fixed turn
order (ascending kv tile): five products, and a rerun is bit-equal. It
replaces the jnp autodiff of ``repro.models.attention.chunked_attention``
that the JAX reference runs in place of a TPU backward (the Pallas kernel
is forward-only and names "the standard flash backward" as its pair).
bf16: ``csrc/flash_attention_bwd_bf16.cu``, the same item schedule and
dq turns on the tensor cores (bf16 operands, f32 sums): at head dims 64, 80
and 128 FlashAttention-3's backward made deterministic (wgmma and TMA, a
producer warpgroup and two consumers, 128-key kv tiles, P and dS fed to
dv's and dk's products from registers), at 256 mma.sync m16n8k16 with
32-key tiles. P is rounded to bf16 as dv's operand (as the forward rounds p
before p v), dS to two bf16 terms, hi + lo, as dk's and dq's (dS's rows sum
to zero, so one bf16 rounding would cost dq and dk several times JAX's f32
error), dq's parts are summed in f32 in a scratch buffer in the same turn
order (and dk's and dv's over the parts of a GQA group, where an item takes
one query head), and dq, dk, dv are rounded to bf16 once, at the end.
``bwd_tiles`` gives each backward kernel's tiles by head dim and dtype.

Bound on the card: operations. The forward at hymba-1.5b's prefill (BH 50,
S 2048, hd 64, causal, window 1024): 20.1 GFLOP of unmasked pairs, 0.020
ms at the bf16 tensor cores' peak, 0.30 ms at the f32 CUDA cores'. The
backward at stablelm-3b's training shape (BH 32, S 2048, hd 80, causal):
five products over 67.1 M pairs, 53.7 GFLOP, 0.80 ms in f32 and 0.054 ms
in bf16. bf16 runs both directions on the tensor cores (wgmma and TMA;
the backward at head dim 256 on mma.sync), with p rounded to bf16 before
the product with v; f32 runs both directions on the CUDA cores in full f32.

Head dims: the kernels are built for ``KERNEL_HEAD_DIMS``; on the card a
head_dim up to 256 is zero-padded to the next of them (q, k, v, and out
and dout for the backward) and the true ``head_dim ** -0.5`` passed as the
scale, so the padded columns add exact zeros to every logit and every
output, which is sliced back. A head_dim above 256 raises.

``flash_attention_fwd`` with grad mode on and an input that requires grad
goes through ``FlashAttentionFunction``: its forward launches the forward
kernel with lse, its backward launches ``flash_attention_bwd`` (the f32 or
the bf16 kernel, by the inputs' dtype).

Beside each wrapper sits a plain PyTorch version that repeats the kernels'
tile arithmetic: the same tile test, the same -1e30 masking with p forced
to 0 after the exp, the same online update (forward), P recomputed from lse
with masked entries 0 and dS = P (dP - delta) (backward), and p rounded to
q's dtype before ``p @ v`` when that dtype is bf16 (in the backward, P
before its product and dS as two bf16 terms). ``block_q`` / ``block_kv``
set its tiles only (the kernels pick their own, by head_dim), and tails
that are not a multiple of a tile are bounds-masked in both. The
backward's plain version takes the kernel's dq order: each
query tile's parts are summed from its first kv tile up to its last, then
scaled; its tiles default to the kernel's (``bwd_tiles``). ``scale``
(default ``head_dim ** -0.5``) lets a test run the plain versions on
zero-padded inputs as the card runs the kernels.
Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (building it at first use), a
meta tensor (the dry-run's) takes the kernel's path with its launch
replaced by a record, with its cost (``flash_attention_fwd_cost``,
``flash_attention_bwd_cost``: the unmasked pairs only), in the active
``roofline.counter.Counter`` (no launch count moves; the bf16 backward's
scratch on meta is the f32 kernel's, the card's plan being unknown); any
other device raises. The wrappers check device, dtype, shape and
contiguity, copy an input whose address is not 16-byte aligned (the
kernels' vector and TMA loads need it), allocate outputs and scratch with
``torch.empty``, launch on the current stream without synchronising, raise
if the launch reports an error, and add one to their launch count
(``flash_attention_fwd``, ``flash_attention_bwd``: one call of each, of
either dtype; ``bwd_launches_by_dtype`` splits the backward's count
between its f32 and its bf16 kernel).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ... import _build
from ..._device import is_meta, kernel_side
from ...roofline.counter import record_kernel

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "FlashAttentionFunction", "KERNEL_HEAD_DIMS", "MAX_HEAD_DIM",
           "bwd_ctas_per_sm", "bwd_kernel_attrs", "bwd_tiles",
           "kernel_head_dim", "launch_counts", "BWD_KERNELS",
           "bwd_launches_by_dtype", "reset_launch_counts",
           "attention_pairs", "flash_attention_fwd_cost",
           "flash_attention_bwd_cost"]

_LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                             "flash_attention_bwd": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 80, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
_NEG = -1e30
# the backward kernel (its csrc stem) by the inputs' dtype, and its launches
BWD_KERNELS = {torch.float32: "flash_attention_bwd",
               torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_LAUNCHES: Dict[torch.dtype, int] = {dt: 0 for dt in BWD_KERNELS}


def launch_counts() -> Dict[str, int]:
    """Snapshot {kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    for dt in _BWD_LAUNCHES:
        _BWD_LAUNCHES[dt] = 0


def bwd_launches_by_dtype() -> Dict[str, int]:
    """``flash_attention_bwd``'s launches since the last reset, by kernel:
    {"float32": n, "bfloat16": m}."""
    return {str(dt).split(".")[-1]: n for dt, n in _BWD_LAUNCHES.items()}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.library(name)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention":
            lib.flash_attention_fwd.argtypes = (
                [I, I, P, P, P, P, P] + [I] * 6 + [F, P])
            lib.flash_attention_fwd.restype = I
        else:       # a backward: bf16 takes dq's f32 partials too
            fn = getattr(lib, name)
            fn.argtypes = ([I] + [P] * (10 if name == "flash_attention_bwd"
                                        else 11) + [I] * 6 + [F, P])
            fn.restype = I
            occ = getattr(lib, f"{name}_ctas_per_sm")
            occ.argtypes, occ.restype = [I], I
            if name == "flash_attention_bwd_bf16":
                lib.flash_attention_bwd_bf16_scratch.argtypes = [I] * 5
                lib.flash_attention_bwd_bf16_scratch.restype = \
                    ctypes.c_longlong
                lib.flash_attention_bwd_bf16_attrs.argtypes = [I, P]
                lib.flash_attention_bwd_bf16_attrs.restype = I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [I], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _raise_on(rc: int, name: str, what: str):
    if rc != 0:
        msg = getattr(_lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


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



def kernel_head_dim(hd: int, what: str = "flash_attention_fwd") -> int:
    """The head dim of the kernel that runs ``hd``: the next of
    ``KERNEL_HEAD_DIMS`` (ValueError above ``MAX_HEAD_DIM``)."""
    for kd in KERNEL_HEAD_DIMS:
        if hd <= kd:
            return kd
    raise ValueError(f"{what}: head_dim {hd} > {MAX_HEAD_DIM}, the widest "
                     f"kernel (head dims {KERNEL_HEAD_DIMS})")


def _pad_hd(x: torch.Tensor, hdp: int) -> torch.Tensor:
    """x with its last dim zero-padded to hdp (x itself when it fits)."""
    if x.shape[-1] == hdp:
        return x
    return torch.nn.functional.pad(x, (0, hdp - x.shape[-1]))


def _card_shape(q, k, what: str) -> int:
    """Check what the kernels take; return the kernel's head dim."""
    hdp = kernel_head_dim(q.shape[2], what)
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: BH {q.shape[0]} > 65535")
    return hdp


def _aligned(*ts):
    """Contiguous, 16-byte aligned copies where needed (the kernels' vector
    and TMA loads)."""
    out = []
    for t in ts:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The unmasked (query, key) pairs of one head: query i sees key j
    when j <= i (causal) and i - j < window (window > 0), as the kernels'
    mask."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full_like(i, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_fwd_cost(BH: int, Sq: int, Skv: int, hd: int,
                             groups: int = 1, causal: bool = True,
                             window: int = 0, itemsize: int = 4,
                             lse: bool = False):
    """(operations, bytes) of one ``flash_attention_fwd`` launch: two
    products (q k^T, p v) over the unmasked pairs at the true head dim; q,
    k, v read once, out (and lse) written once."""
    pairs = attention_pairs(Sq, Skv, causal, window)
    BKV = BH // groups
    return (4 * hd * pairs * BH,
            itemsize * (2 * BH * Sq * hd + 2 * BKV * Skv * hd)
            + (4 * BH * Sq if lse else 0))


def flash_attention_bwd_cost(BH: int, Sq: int, Skv: int, hd: int,
                             groups: int = 1, causal: bool = True,
                             window: int = 0, itemsize: int = 4):
    """(operations, bytes) of one ``flash_attention_bwd`` call: five
    products (s and dp recomputed, dv, dk, dq) over the unmasked pairs; q,
    k, v, out, dout and lse read once, dq, dk, dv written once."""
    pairs = attention_pairs(Sq, Skv, causal, window)
    BKV = BH // groups
    return (10 * hd * pairs * BH,
            itemsize * (4 * BH * Sq * hd + 4 * BKV * Skv * hd)
            + 4 * BH * Sq)


def flash_attention_fwd_plain(q, k, v, *, groups: int = 1,
                              causal: bool = True, window: int = 0,
                              block_q: int = 128, block_kv: int = 128,
                              return_lse: bool = False,
                              scale: Optional[float] = None):
    """Plain version of ``flash_attention_fwd`` (same arguments and result):
    the kernel's tile loop over (block_q, block_kv) tiles. With
    ``return_lse`` it returns (out, lse), lse = m + log max(l, 1e-30) in
    f32 (BH, Sq), as the kernels write it. ``scale`` defaults to
    head_dim ** -0.5."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=0)
    vf = v.float().repeat_interleave(groups, dim=0)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
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
            mask = _mask(q_pos, kv_pos, causal, window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if q.dtype == torch.bfloat16:   # the tensor cores' P operand
                p = p.to(torch.bfloat16).float()
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        den = l.clamp(min=1e-30)
        out[:, i0:i0 + bq] = (acc / den[..., None]).to(q.dtype)
        lse[:, i0:i0 + bq] = m + torch.log(den)
    return (out, lse) if return_lse else out


def _mask(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= (q_pos - kv_pos) < window
    return mask


def _fwd_kernel(q, k, v, groups, causal, window, want_lse: bool):
    """Launch the forward kernel; returns (out, lse or None)."""
    hdp = _card_shape(q, k, "flash_attention_fwd")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: inputs must be contiguous")
    BH, Sq, hd = q.shape
    q, k, v = _aligned(*(_pad_hd(t, hdp) for t in (q, k, v)))
    out = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if is_meta(q):
        record_kernel("flash_attention_fwd", flash_attention_fwd_cost(
            BH, Sq, k.shape[1], hd, groups, causal, window, q.element_size(),
            want_lse))
        return (out[..., :hd].contiguous() if hdp != hd else out), lse
    rc = _lib("flash_attention").flash_attention_fwd(
        _CODE[q.dtype], hdp, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), BH, Sq,
        k.shape[1], groups, int(bool(causal)), int(window), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention", "flash_attention_fwd")
    _LAUNCHES["flash_attention_fwd"] += 1
    if hdp != hd:
        out = out[..., :hd].contiguous()
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, groups: int = 1, causal: bool = True,
                        window: int = 0, block_q: int = 128,
                        block_kv: int = 128) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BKV, Skv, hd) with BH = BKV * groups, all f32
    or all bf16. Returns (BH, Sq, hd) in q's dtype. Sq and Skv need not be
    multiples of a tile. On the card: contiguous inputs, head_dim <=
    ``MAX_HEAD_DIM`` (zero-padded to the next of ``KERNEL_HEAD_DIMS``), BH
    <= 65535 (else ValueError).

    With grad mode on and an input that requires grad, the call goes
    through ``FlashAttentionFunction``, whose backward is
    ``flash_attention_bwd`` (f32 or bf16).
    """
    _check(q, k, v, groups)
    card = kernel_side(q, "flash_attention_fwd")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, groups, causal, window,
                                            block_q, block_kv)
    if not card:
        return flash_attention_fwd_plain(q, k, v, groups=groups,
                                         causal=causal, window=window,
                                         block_q=block_q, block_kv=block_kv)
    return _fwd_kernel(q, k, v, groups, causal, window, False)[0]


# ------------------------------- backward ------------------------------------

def bwd_tiles(hd: int, dtype: torch.dtype = torch.float32):
    """(query rows, keys) of the backward kernel's tiles for a head_dim of
    ``hd`` (at the kernel head dim that runs it) and inputs of ``dtype``:
    64 x 64 in f32; in bf16 64 x 128 at kernel head dims 64, 80 and 128 (two
    64-key strips, one a consumer warpgroup) and 64 x 32 at 256."""
    if dtype == torch.bfloat16:
        return (64, 32) if kernel_head_dim(hd, "flash_attention_bwd") > 128 \
            else (64, 128)
    return 64, 64


def _kv_tiles(i0: int, bq: int, bkv: int, nkv: int, causal: bool,
              window: int):
    """(j_lo, j_hi): the kv tiles that the forward's tile test pairs with
    the query tile at row i0, as the backward kernel's turn counters count
    them (``Tiles::j_lo`` / ``j_hi`` in ``csrc/flash_attention_bwd.cu``);
    j_lo > j_hi when there is none."""
    j_hi = min(nkv - 1, (i0 + bq - 1) // bkv) if causal else nkv - 1
    lo = i0 - window + 1
    return (lo // bkv if window and lo > 0 else 0), j_hi


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, groups: int = 1,
                              causal: bool = True, window: int = 0,
                              block_q: Optional[int] = None,
                              block_kv: Optional[int] = None,
                              scale: Optional[float] = None):
    """Plain version of ``flash_attention_bwd`` (same arguments and
    results), in the kernel's order, over (block_q, block_kv) tiles (by
    default the kernel's, ``bwd_tiles``): delta = rowsum(dout * out); then
    for each query tile, from the last down to the first (the order in which a
    kernel CTA walks them), the kv tiles that the forward's tile test pairs
    with it, ascending (the kernel's dq turn order): P = exp(s * scale -
    lse) with masked entries 0, dP = dout v^T, dS = P (dP - delta), dv +=
    P^T dout and dk += dS^T q for that kv tile (the GQA group summed inside
    each tile pair), and the tile's dq part dS k stored by the first kv
    tile and added by the others; dq is scaled once its last part is in,
    dk at the end. f32 throughout; in bf16, P is rounded to bf16 and dS to
    a sum of two bf16 terms before the products that take them (the bf16
    kernel's tensor-core operands). Results in the inputs' dtypes. It
    agrees with the kernels up to the order inside each product and over
    the group, given the kernel's tiles."""
    BH, Sq, hd = q.shape
    BKV, Skv, _ = k.shape
    tq, tkv = bwd_tiles(hd, q.dtype)
    bq = min(tq if block_q is None else block_q, Sq)
    bkv = min(tkv if block_kv is None else block_kv, Skv)
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    G = BH // BKV
    qf = q.float().reshape(BKV, G, Sq, hd)
    dof = dout.float().reshape(BKV, G, Sq, hd)
    lsef = lse.float().reshape(BKV, G, Sq, 1)
    delta = (dof * out.float().reshape(BKV, G, Sq, hd)).sum(-1, keepdim=True)
    kf, vf = k.float()[:, None], v.float()[:, None]
    bf16 = q.dtype == torch.bfloat16
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((BKV, Skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    nkv = -(-Skv // bkv)
    for i0 in reversed(range(0, Sq, bq)):
        i1 = min(i0 + bq, Sq)
        qt, dot = qf[:, :, i0:i1], dof[:, :, i0:i1]
        lt, et = lsef[:, :, i0:i1], delta[:, :, i0:i1]
        q_pos = torch.arange(i0, i1, device=dev)[:, None]
        j_lo, j_hi = _kv_tiles(i0, bq, bkv, nkv, causal, window)
        part = None
        for j in range(j_lo, j_hi + 1):
            j0, j1 = j * bkv, min(j * bkv + bkv, Skv)
            kt, vt = kf[:, :, j0:j1], vf[:, :, j0:j1]
            kv_pos = torch.arange(j0, j1, device=dev)[None, :]
            s = (qt @ kt.transpose(-1, -2)) * scale
            p = torch.where(_mask(q_pos, kv_pos, causal, window),
                            torch.exp(s - lt), zero)
            ds = p * (dot @ vt.transpose(-1, -2) - et)
            if bf16:        # the tensor cores' operands: P in bf16, dS
                # as two bf16 terms (hi + lo, exact in f32)
                p, hi = p.bfloat16().float(), ds.bfloat16().float()
                ds = hi + (ds - hi).bfloat16().float()
            dv[:, j0:j1] += (p.transpose(-1, -2) @ dot).sum(1)
            dk[:, j0:j1] += (ds.transpose(-1, -2) @ qt).sum(1)
            part = ds @ kt if part is None else part + ds @ kt
        if part is not None:
            dq[:, :, i0:i1] = part * scale
    return (dq.reshape(BH, Sq, hd).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def bwd_ctas_per_sm(hd: int, dtype: torch.dtype = torch.float32) -> int:
    """CTAs of the backward's main kernel (the f32 one, or the bf16 one for
    ``dtype=torch.bfloat16``) that fit on one SM at the kernel head dim
    that takes ``hd`` (builds the kernel; needs the card)."""
    hdp = kernel_head_dim(hd, "flash_attention_bwd")
    name = BWD_KERNELS[dtype]
    return int(getattr(_lib(name), f"{name}_ctas_per_sm")(hdp))


def bwd_kernel_attrs(hd: int) -> Dict[str, int]:
    """The bf16 backward's main kernel at the kernel head dim that takes
    ``hd``, on the current card: registers a thread at launch and in its
    consumer warpgroups (after setmaxnreg; the launch count at hd 256),
    local memory a thread (spills), dynamic shared memory and CTAs an SM
    (builds the kernel; needs the card)."""
    hdp = kernel_head_dim(hd, "flash_attention_bwd")
    out = (ctypes.c_int * 5)()
    rc = _lib("flash_attention_bwd_bf16").flash_attention_bwd_bf16_attrs(
        hdp, out)
    _raise_on(rc, "flash_attention_bwd_bf16", "flash_attention_bwd_bf16")
    return dict(zip(("registers", "consumer_registers", "local_bytes",
                     "shared_bytes", "ctas_per_sm"), out))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, groups: int = 1,
                        causal: bool = True, window: int = 0,
                        block_q: Optional[int] = None,
                        block_kv: Optional[int] = None):
    """Gradients (dq, dk, dv) of ``flash_attention_fwd`` given its out, the
    incoming dout (BH, Sq, hd) and its lse (BH, Sq): out and dout in q's
    dtype (f32 or bf16), lse in f32 (TypeError otherwise). On the card:
    head_dim <= ``MAX_HEAD_DIM`` (zero-padded as the forward pads it); the
    f32 or bf16 kernel by the dtype, whose two launches (delta, main) count
    as one call. ``block_q`` / ``block_kv`` set the plain version's tiles
    only (by default the kernel's, ``bwd_tiles``)."""
    _check(q, k, v, groups)
    BH, Sq, hd = q.shape
    if tuple(out.shape) != (BH, Sq, hd) or tuple(dout.shape) != (BH, Sq, hd) \
            or tuple(lse.shape) != (BH, Sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: out {out.dtype}, dout "
                        f"{dout.dtype} must be q's dtype {q.dtype} and lse "
                        f"{lse.dtype} float32")
    if not kernel_side(q, "flash_attention_bwd"):
        return flash_attention_bwd_plain(
            q, k, v, out, dout, lse, groups=groups, causal=causal,
            window=window, block_q=block_q, block_kv=block_kv)
    if any(t.device != q.device for t in (out, dout, lse)):
        raise ValueError("flash_attention_bwd: inputs on different devices")
    hdp = _card_shape(q, k, "flash_attention_bwd")
    q, k, v, out, dout = (_pad_hd(t, hdp) for t in (q, k, v, out, dout))
    q, k, v, out, dout, lse = _aligned(q, k, v, out, dout, lse)
    name = BWD_KERNELS[q.dtype]
    if q.dtype == torch.bfloat16 and not is_meta(q):
        # delta, the turn counters and the work counter, then dk's and dv's
        # f32 partials where an item takes one query head of a group
        n = _lib(name).flash_attention_bwd_bf16_scratch(
            hdp, BH, Sq, k.shape[1], groups)
        if n < 0:
            raise RuntimeError("flash_attention_bwd: no CUDA device")
    else:
        # delta (BH * Sq), then a turn counter per (query head, query tile)
        # of at least 32 rows and the work counter
        n = BH * Sq + BH * (-(-Sq // 32)) + 1
    scratch = torch.empty((n,), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # bf16: dq's f32 partial sums between the turns
    dqacc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
             if q.dtype == torch.bfloat16 else None)
    if is_meta(q):
        record_kernel("flash_attention_bwd", flash_attention_bwd_cost(
            BH, Sq, k.shape[1], hd, groups, causal, window, q.element_size()))
        if hdp != hd:
            dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
        return dq, dk, dv
    rc = getattr(_lib(name), name)(
        hdp, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        *([] if dqacc is None else [dqacc.data_ptr()]),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq, k.shape[1],
        groups, int(bool(causal)), int(window), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, name, name)
    _LAUNCHES["flash_attention_bwd"] += 1
    _BWD_LAUNCHES[q.dtype] += 1
    if hdp != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention_fwd`` with its gradient: the forward kernel with
    lse, saved with q, k, v and out, and ``flash_attention_bwd`` (the plain
    versions of both for CPU tensors). Once differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, groups, causal, window, block_q, block_kv):
        if kernel_side(q, "flash_attention_fwd"):
            out, lse = _fwd_kernel(q, k, v, groups, causal, window, True)
        else:
            out, lse = flash_attention_fwd_plain(
                q, k, v, groups=groups, causal=causal, window=window,
                block_q=block_q, block_kv=block_kv, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(groups=groups, causal=causal, window=window,
                      block_q=block_q, block_kv=block_kv)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
