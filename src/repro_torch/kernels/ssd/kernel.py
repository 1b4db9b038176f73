"""The Mamba2 SSD scan: the CUDA kernels' wrappers, their plain versions and
the autograd function that pairs the forward with its backward.

Forward: hand-written CUDA C++ for ``sm_90a`` in
``src/repro_torch/csrc/ssd.cu`` (its source note gives the design). It
replaces the Pallas TPU kernel ``repro/kernels/ssd/kernel.py::ssd_fwd``:
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
operations at mamba2-370m's N 128 (5.9 GFLOP, 0.089 ms).

Backward: ``csrc/ssd_bwd.cu`` (its source note gives the design and the
formulas), f32: the chunk-local state gradients dy^T (C exp(cum)), their
scan in reverse over the chunks, the per-chunk gradients of x, dt, a, d,
B and C from the forward's saved state entering each chunk, its cum and
G = C B^T, and a pass that sums dB and dC over the heads of a group and
da and dd over the chunks in order. One wrapper call (four launches)
counts one launch; ``bwd_kernel_attrs`` reads the registers and CTAs an
SM of the state and chunk kernels. It replaces the jnp autodiff of
``repro.models.ssm.ssd_apply`` that the JAX reference trains through (the
Pallas kernel is forward-only). Bound: operations, 1.9 GFLOP (0.028 ms)
at hymba-1.5b's training shape, 5.9 GFLOP (0.088 ms) at mamba2-370m's.

``exp(cum_i - cum_j)`` is taken only where i >= j, in both directions:
the plain versions mask the exponent to -inf before the exp, the kernels
branch. For i < j the exponent is positive and, at the reference's
full-width dt, passes 88: the exp is +inf, inf * 0 would be NaN, and the
autodiff of a where over it is NaN (ROADMAP C-11: the reference's
gradient at hymba-1.5b's init). No exp here has a positive argument for
a < 0 and dt > 0.

Shapes on the card: the kernels are built for chunk 8, 16, 32 and 64, head
dim P 64 and state dim N 16, 32, 64 and 128 (``KERNEL_SHAPES``). A P up
to 64 and an N up to 128 are zero-padded to the next of those (x, dy,
B, C and the state's gradient); zero columns add exact zeros at the end
of every sum, so the padded results keep every bit, and are sliced back.
Another chunk, or a larger P or N, raises ValueError.

``ssd_fwd`` with grad mode on and an input that requires grad goes
through ``SSDFunction``: its forward launches the forward kernels and
keeps their scratch (the state entering each chunk, cum and G: 33.5 MB a
layer at mamba2-370m's B 1 x S 2048, 6.6 MB at hymba-1.5b's; under remat
only the layer being recomputed holds it), its backward launches
``ssd_bwd``. No ported path runs SSD in bf16, and there is no bf16
backward: on the card a bf16 input that requires grad raises.

Beside each wrapper sits a plain PyTorch version that repeats the
kernels' arithmetic: the forward's sequential cumsum (so cum is bit-equal)
and its three stages in its association order; the backward's stages and
formulas, batched over heads and chunks, at the kernels' padded P and N,
with every sum that is not a matrix product in the kernels' order (it is
held to the kernel within a tolerance, not bit for bit: the products and
fmaf differ).
Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernels (building them at first use),
a meta tensor (the dry-run's) takes the kernels' path with the launch
replaced by a record, with its cost (``ssd_fwd_cost``, ``ssd_bwd_cost``),
in the active ``roofline.counter.Counter`` (no launch count moves); any
other device raises. The wrappers check device, dtype, shape and
contiguity, allocate outputs and f32 scratch with ``torch.empty``, copy an
input whose address is not 16-byte aligned (the kernels' vector loads
need it), launch on the current stream without synchronising, raise if a
launch reports an error, and add one to their launch count (``ssd_fwd``,
``ssd_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ... import _build
from ..._device import is_meta, kernel_side
from ...roofline.counter import record_kernel

__all__ = ["ssd_fwd", "ssd_fwd_plain", "ssd_bwd", "ssd_bwd_plain",
           "SSDFunction", "KERNEL_SHAPES", "TILE_BF16_SHAPES", "kernel_shape",
           "launch_counts", "reset_launch_counts", "bwd_kernel_attrs",
           "ssd_fwd_cost", "ssd_bwd_cost"]

_LAUNCHES: Dict[str, int] = {"ssd_fwd": 0, "ssd_bwd": 0,
                             "ssd_fwd_tile_bf16": 0, "ssd_bwd_tile_bf16": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SHAPES = dict(chunk=(8, 16, 32, 64), P=(64,), N=(16, 32, 64, 128))
# the bf16-tile variant's instantiations (f32 inputs): the zoo's chunks, and
# an N up to 128 padded to 16 or 128
TILE_BF16_SHAPES = dict(chunk=(8, 64), P=(64,), N=(16, 128))
_NO_BF16_BWD = ("the SSD kernels are forward-only in bf16: there is no bf16 "
                "backward, and no ported path runs SSD in bf16; train in f32 "
                "or call under torch.no_grad()")


def launch_counts() -> Dict[str, int]:
    """Snapshot {kernel name: launches since the last reset}, the
    bf16-tile variant's (``ssd_fwd_tile_bf16``, ``ssd_bwd_tile_bf16``)
    beside the f32 kernels'."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.library(name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "ssd":
            lib.ssd_fwd.argtypes = [I] + [P] * 12 + [I] * 6 + [P]
            lib.ssd_fwd.restype = I
            lib.ssd_fwd_tile_bf16.argtypes = [P] * 12 + [I] * 6 + [P]
            lib.ssd_fwd_tile_bf16.restype = I
        else:
            for fn in (lib.ssd_bwd, lib.ssd_bwd_tile_bf16):
                fn.argtypes = [P] * 21 + [I] * 6 + [P]
                fn.restype = I
            IP = ctypes.POINTER(I)
            lib.ssd_bwd_kernel_attrs.argtypes = [I, I, I, IP, IP]
            lib.ssd_bwd_kernel_attrs.restype = I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _raise_on(rc: int, name: str):
    if rc != 0:
        msg = getattr(_lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _check(x, dt, a, d, B, C, chunk: int, groups: int, what: str = "ssd_fwd"):
    if x.ndim != 3 or dt.ndim != 2 or a.ndim != 1 or d.ndim != 1 \
            or B.ndim != 3 or C.ndim != 3:
        raise ValueError(f"{what}: expected x (BH, S, P), dt (BH, S), a/d "
                         "(BH,), B/C (BG, S, N)")
    BH, S, P = x.shape
    BG, SB, N = B.shape
    if (tuple(dt.shape) != (BH, S) or tuple(a.shape) != (BH,)
            or tuple(d.shape) != (BH,) or tuple(C.shape) != (BG, S, N)
            or SB != S):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match")
    if groups < 1 or BH != BG * groups:
        raise ValueError(f"{what}: BH {BH} != BG {BG} * groups {groups}")
    if min(BH, S, P, N) == 0 or chunk < 1 or S % chunk:
        raise ValueError(f"{what}: S {S} must be a positive multiple of "
                         f"chunk {chunk}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"{what}: x, dt, B, C must share one dtype of "
                        f"{_DTYPES}, got {x.dtype}, {dt.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"{what}: a and d must be float32")
    if any(t.device != x.device for t in (dt, a, d, B, C)):
        raise ValueError(f"{what}: inputs on different devices")



def kernel_shape(P: int, N: int, chunk: int, what: str = "ssd_fwd",
                 tile_bf16: bool = False) -> Tuple[int, int]:
    """(P, N) as the kernels take them: each zero-padded to the next of
    ``KERNEL_SHAPES`` (``TILE_BF16_SHAPES`` for the bf16-tile variant);
    ValueError for a chunk the kernels are not built for, or a P or N above
    the largest."""
    shapes = TILE_BF16_SHAPES if tile_bf16 else KERNEL_SHAPES
    if (chunk not in shapes["chunk"] or P > max(shapes["P"])
            or N > max(shapes["N"])):
        raise ValueError(f"{what}: chunk {chunk}, P {P}, N {N} not taken by "
                         f"the kernel ({shapes}; P and N are padded up to "
                         f"the next)")
    return (min(k for k in shapes["P"] if k >= P),
            min(k for k in shapes["N"] if k >= N))


def _pad(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """t zero-padded at the end of its last len(sizes) dims to ``sizes``."""
    pads = []
    for have, want in zip(reversed(t.shape[-len(sizes):]), reversed(sizes)):
        pads += [0, want - have]
    return F.pad(t, pads) if any(pads) else t


def _aligned(*ts):
    """Contiguous, 16-byte aligned copies where needed (the kernels' vector
    loads)."""
    out = []
    for t in ts:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


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


def _rb(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _decay(cum: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = exp(cum_i - cum_j) for i >= j, else 0; the exponent
    is masked to -inf before the exp, so no exp of a positive difference
    is ever evaluated."""
    Q = cum.shape[-1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.exp(diff.masked_fill(~tri, float("-inf")))


# ------------------------------- forward -------------------------------------

def ssd_fwd_cost(BH: int, S: int, P: int, N: int, chunk: int,
                 groups: int = 1, itemsize: int = 4):
    """(operations, bytes) of one ``ssd_fwd`` call at the true P and N:
    each chunk's products over the lower triangle (G = C B^T and M x) and
    its four full (Q, P, N) products; x, dt, B, C, a, d read once, y and
    the f32 final state written once."""
    Q, nc = chunk, S // chunk
    tri = Q * (Q + 1) // 2
    BG = BH // groups
    return (nc * BH * (2 * tri * (N + P) + 4 * Q * P * N),
            itemsize * (2 * BH * S * P + BH * S + 2 * BG * S * N)
            + 4 * (2 * BH + BH * P * N))


def ssd_bwd_cost(BH: int, S: int, P: int, N: int, chunk: int,
                 groups: int = 1):
    """(operations, bytes) of one ``ssd_bwd`` call (f32) at the true P and
    N: the products over the lower triangle (dy x^T, M^T dy, dG^T C, dG
    B) and the four full (Q, P, N) products of each chunk; x, dy, dt,
    cum, B, C, the saved states and G read once, dx, ddt, dB, dC, da, dd
    written once."""
    Q, nc = chunk, S // chunk
    tri = Q * (Q + 1) // 2
    BG = BH // groups
    return (nc * BH * (2 * tri * (2 * P + 2 * N) + 8 * Q * P * N),
            4 * (3 * BH * S * P + 3 * BH * S + 4 * BG * S * N
                 + BH * nc * P * N + BG * nc * Q * Q + 4 * BH))


def ssd_fwd_plain(x, dt, a, d, B, C, *, chunk: int = 64, groups: int = 1,
                  return_saved: bool = False, tile_bf16: bool = False):
    """Plain version of ``ssd_fwd`` (same arguments and results): the
    kernels' three stages, batched over heads and chunks. With
    ``return_saved`` also the forward's saved state for ``ssd_bwd``: (the
    state entering each chunk (BH, nc, P, N), cum (BH, S), G = C B^T
    (BG, nc, Q, Q)), all f32. ``tile_bf16``: round to bf16 where the
    bf16-tile kernels do: G = rb(rb(C) rb(B)^T), M = rb(rb(G rb(L))
    rb(dt_j)) and the intra term rb(M rb(x)); the saved G is the rounded
    one."""
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
    ec = torch.exp(cum)
    if tile_bf16:
        G = _rb(_rb(Cf) @ _rb(Bf).transpose(-1, -2))
        M = _rb(_rb(G * _rb(_decay(cum))) * _rb(dtf)[..., None, :])
        intra = _rb(M @ _rb(xf))
    else:
        G = Cf @ Bf.transpose(-1, -2)
        M = (G * _decay(cum)) * dtf[..., None, :]
        intra = M @ xf
    y = intra + (Cf * ec[..., None]) @ h_in.transpose(-1, -2)
    y = y + d.float()[:, None, None, None] * xf
    y = y.reshape(BH, S, P).to(x.dtype)
    if not return_saved:
        return y, h
    return y, h, (h_in, cum.reshape(BH, S), G[::groups].contiguous())


def _fwd_kernel(x, dt, a, d, B, C, chunk: int, groups: int,
                tile_bf16: bool = False):
    """Launch the forward kernels on contiguous CUDA inputs (on meta ones,
    record the launch); returns (y, final state, saved) with saved at the
    kernels' padded P and N."""
    if not all(t.is_contiguous() for t in (x, dt, a, d, B, C)):
        raise ValueError("ssd_fwd: inputs must be contiguous")
    if tile_bf16 and x.dtype != torch.float32:
        raise TypeError(f"ssd_fwd: tile_bf16 takes f32 inputs (the model's), "
                        f"got {x.dtype}")
    BH, S, P = x.shape
    BG, _, N = B.shape
    Pk, Nk = kernel_shape(P, N, chunk, tile_bf16=tile_bf16)
    nc = S // chunk
    if nc > 65535:
        raise ValueError(f"ssd_fwd: S / chunk = {nc} > 65535")
    x = _pad(x, Pk)
    B, C = _pad(B, Nk), _pad(C, Nk)
    # the kernels read x, B and C in 16-byte (f32) or 8-byte (bf16) vectors
    x, B, C = _aligned(x, B, C)
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = torch.empty((BH, Pk, Nk), **f32)
    # scratch: the chunks' state updates, then the state entering each
    # chunk; exp(seg) per chunk; cum; C B^T per group and chunk
    hst = torch.empty((BH, nc, Pk, Nk), **f32)
    eseg = torch.empty((BH, nc), **f32)
    cum = torch.empty((BH, S), **f32)
    G = torch.empty((BG, nc, chunk, chunk), **f32)
    name = "ssd_fwd_tile_bf16" if tile_bf16 else "ssd_fwd"
    if is_meta(x):
        record_kernel(name, ssd_fwd_cost(BH, S, P, N, chunk, groups,
                                         dt.element_size()))
    else:
        _fwd_launch(x, dt, a, d, B, C, y, state, hst, eseg, cum, G, chunk,
                    groups, tile_bf16)
        _LAUNCHES[name] += 1
    if (Pk, Nk) != (P, N):
        y = y[..., :P].contiguous()
        state = state[:, :P, :N].contiguous()
    return y, state, (hst, cum, G)


def _fwd_launch(x, dt, a, d, B, C, y, state, hst, eseg, cum, G, chunk,
                groups, tile_bf16):
    """Launch the forward kernels on padded, aligned CUDA tensors."""
    BH, S, Pk = x.shape
    Nk = B.shape[2]
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), d.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
            hst.data_ptr(), eseg.data_ptr(), cum.data_ptr(), G.data_ptr(),
            BH, S, Pk, Nk, chunk, groups,
            torch.cuda.current_stream(x.device).cuda_stream)
    if tile_bf16:
        rc = _lib("ssd").ssd_fwd_tile_bf16(*ptrs)
    else:
        rc = _lib("ssd").ssd_fwd(_CODE[x.dtype], *ptrs)
    _raise_on(rc, "ssd")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            d: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
            chunk: int = 64, groups: int = 1, tile_bf16: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, S, P); dt: (BH, S); a/d: (BH,) f32; B/C: (BG, S, N) with
    BH = BG * groups; x, dt, B, C share one dtype (f32 or bf16); S a
    multiple of ``chunk``. Returns (y (BH, S, P) in x's dtype, final state
    (BH, P, N) f32). On the card: contiguous inputs, chunk among
    ``KERNEL_SHAPES``, P <= 64 and N <= 128 (zero-padded; else
    ValueError).

    With grad mode on and an input that requires grad, the call goes
    through ``SSDFunction``, whose backward is ``ssd_bwd``; on the card
    that needs f32 (a bf16 input raises RuntimeError: there is no bf16
    backward).

    ``tile_bf16``: the bf16-tile variant (the reference's
    ``ssd_apply(tile_bf16=True)``): f32 inputs, G, L, M and the intra term
    rounded to bf16 (``ssd_fwd_plain``), chunk 8 or 64 on the card
    (``TILE_BF16_SHAPES``); its launches count under ``ssd_fwd_tile_bf16`` and
    ``ssd_bwd_tile_bf16``."""
    _check(x, dt, a, d, B, C, chunk, groups)
    card = kernel_side(x, "ssd_fwd")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, d, B, C)):
        if card and x.dtype != torch.float32:
            raise RuntimeError(f"ssd_fwd: {_NO_BF16_BWD}")
        return SSDFunction.apply(x, dt, a, d, B, C, chunk, groups, tile_bf16)
    if not card:
        return ssd_fwd_plain(x, dt, a, d, B, C, chunk=chunk, groups=groups,
                             tile_bf16=tile_bf16)
    return _fwd_kernel(x, dt, a, d, B, C, chunk, groups, tile_bf16)[:2]


# ------------------------------- backward ------------------------------------

def _check_bwd(x, dy, dstate, saved, chunk: int, groups: int):
    BH, S, P = x.shape
    if tuple(dy.shape) != (BH, S, P):
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if dstate is not None and (dstate.ndim != 3 or dstate.shape[0] != BH
                               or dstate.shape[1] != P):
        raise ValueError(f"ssd_bwd: dstate {tuple(dstate.shape)} is not "
                         f"(BH, P, N)")
    hst, cum, G = saved
    nc = S // chunk
    if (hst.ndim != 4 or tuple(hst.shape[:2]) != (BH, nc)
            or hst.shape[2] < P or tuple(cum.shape) != (BH, S)
            or tuple(G.shape) != (BH // groups, nc, chunk, chunk)):
        raise ValueError(f"ssd_bwd: saved state {tuple(hst.shape)}, cum "
                         f"{tuple(cum.shape)}, G {tuple(G.shape)} is not the "
                         f"forward's")
    if any(t.device != x.device for t in (dy, hst, cum, G)) or (
            dstate is not None and dstate.device != x.device):
        raise ValueError("ssd_bwd: inputs on different devices")


def _bwd_dims(P: int, N: int) -> Tuple[int, int]:
    """(P, N) as the backward kernels sum them: P zero-padded to a multiple
    of 64, N to the next of ``KERNEL_SHAPES`` (a multiple of 32 above)."""
    Pk = 64 * -(-P // 64)
    Nk = next((k for k in KERNEL_SHAPES["N"] if k >= N), 32 * -(-N // 32))
    return Pk, Nk


def _chain(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum over ``dim`` one rounded add at a time from index 0."""
    t = t.movedim(dim, -1)
    run = t[..., 0]
    for k in range(1, t.shape[-1]):
        run = run + t[..., k]
    return run


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim (a power of two) as a warp's xor shuffles
    leave it in lane 0: v[l] + v[l ^ off] for off = n/2, ..., 1."""
    n = v.shape[-1]
    lanes = torch.arange(n, device=v.device)
    off = n // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v[..., 0]


def _block_sum(terms: torch.Tensor) -> torch.Tensor:
    """The chunk kernel's sum over the last dim as its 256 threads take it:
    thread l holds entries l, l + 256, ... and sums them in order, then a
    butterfly in each warp of 32, then the eight warps in order."""
    pad = -terms.shape[-1] % 256
    terms = F.pad(terms, (0, pad)).reshape(*terms.shape[:-1], -1, 256)
    lanes = _chain(terms, -2)
    return _chain(_butterfly(lanes.reshape(*lanes.shape[:-1], 8, 32)), -1)


def _warp_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dim Q as one warp runs it: lane l sums
    its E = ceil(Q / 32) entries from E l on in order, the lanes' totals run
    through a Hillis-Steele scan (v[l] + v[l - off], off = 1, ..., 16), and
    each lane adds its exclusive prefix to its partial sums."""
    Q = v.shape[-1]
    E = -(-Q // 32)
    lanes = F.pad(v, (0, 32 * E - Q)).reshape(*v.shape[:-1], 32, E)
    loc = _cumsum_in_order(lanes)
    inc = loc[..., -1]
    for off in (1, 2, 4, 8, 16):
        inc = torch.cat([inc[..., :off], inc[..., off:] + inc[..., :-off]], -1)
    ex = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    return (ex[..., None] + loc).reshape(*v.shape[:-1], 32 * E)[..., :Q]


def _quarters(terms: torch.Tensor, width: int) -> torch.Tensor:
    """The sum over the last dim in four partial sums, [k w, k w + w) for
    k < 3 and [3 w, end), each in order, combined as (p0 + p1) + (p2 + p3)
    (four lanes and two xor shuffles)."""
    n = terms.shape[-1]
    bounds = [min(k * width, n) for k in range(4)] + [n]
    parts = [_chain(terms[..., lo:hi]) if hi > lo
             else torch.zeros_like(terms[..., 0])
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _lane_sum(terms: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim Q as one warp takes it: lane l sums t = l,
    l + 32, ... in order, then a butterfly."""
    Q = terms.shape[-1]
    E = -(-Q // 32)
    lanes = F.pad(terms, (0, 32 * E - Q)).reshape(*terms.shape[:-1], E, 32)
    return _butterfly(_chain(lanes, -2))


def _slice_width(Nk: int) -> int:
    """The state columns a slice of the chunk kernel takes."""
    return min(Nk, 32)


def _pair_sum(cu: torch.Tensor) -> torch.Tensor:
    """sum_n cu[..., n] over the last dim Nk as the chunk kernel's dC lanes
    take it: per slice of NS = min(Nk, 32) columns, lane l (of 8) sums its
    columns l, l + 8, ... in order, the 8 lanes meet in a butterfly, and
    the slices add in order."""
    Nk = cu.shape[-1]
    NS = _slice_width(Nk)
    lanes = _chain(cu.reshape(*cu.shape[:-1], Nk // NS, NS // 8, 8), -2)
    return _chain(_butterfly(lanes), -1)


def _slice_major(t: torch.Tensor) -> torch.Tensor:
    """(..., P, N) entries flattened in the order the chunk kernel reads
    them: slice of NS = min(N, 32) columns after slice, each slice's
    (P, NS) entries row-major."""
    P, N = t.shape[-2:]
    NS = _slice_width(N)
    t = t.reshape(*t.shape[:-2], P, N // NS, NS).transpose(-3, -2)
    return t.reshape(*t.shape[:-3], -1)


def _suffix_sums(Z: torch.Tensor) -> torch.Tensor:
    """ZS[..., t, j] = sum_{i>=t} Z[..., i, j] as the chunk kernel forms it:
    within each segment of 16 rows from its bottom row up, then plus the
    totals of the segments below, nearest first (carry_s = T_{s+1} +
    carry_{s+1})."""
    Q = Z.shape[-2]
    segs = [_cumsum_in_order(Z[..., s0:s0 + 16, :].flip(-2).transpose(
        -1, -2)).transpose(-1, -2).flip(-2) for s0 in range(0, Q, 16)]
    out, carry = [None] * len(segs), None
    for s in reversed(range(len(segs))):
        out[s] = segs[s] if carry is None else segs[s] + carry[..., None, :]
        carry = segs[s][..., 0, :] if carry is None \
            else segs[s][..., 0, :] + carry
    return torch.cat(out, -2)


def ssd_bwd_plain(x, dt, a, d, B, C, dy, dstate, saved, *, chunk: int = 64,
                  groups: int = 1, tile_bf16: bool = False):
    """Plain version of ``ssd_bwd`` (same arguments and results): the
    kernels' stages and formulas, batched over heads and chunks, written
    out (no autograd), never an exp of a positive cum difference. P and N
    are zero-padded to the kernels' sizes (``_bwd_dims``), and every sum
    that is not a matrix product runs in the kernels' order: Z's suffix
    sums in segments of 16 rows (``_suffix_sums``), ddaL and dcoef in four
    partial sums (``_quarters``), C . dy h in the chunk kernel's lanes and
    slices of up to 32 columns (``_pair_sum``), the sums of dh * h and
    dy * x as its threads and warps take them (``_block_sum``), the scans
    of dda as a warp runs them (``_warp_scan``), da over a warp
    (``_lane_sum``), and the chunks and the heads of a group one at a
    time. ``tile_bf16``: the gradient of the bf16-tile forward as the
    kernel takes it: L rounded to bf16 (G comes rounded in ``saved``), the
    other roundings passed through, every cotangent f32."""
    BH, S, P = x.shape
    N = B.shape[-1]
    Q = chunk
    nc = S // Q
    dev = x.device
    Pk, Nk = _bwd_dims(P, N)
    hst, cum, G = saved
    h_in = _pad(hst[:, :, :P, :N].float(), Pk, Nk)          # (BH, nc, Pk, Nk)
    xf = _pad(x.float(), Pk).reshape(BH, nc, Q, Pk)
    dyf = _pad(dy.float(), Pk).reshape(BH, nc, Q, Pk)
    dtf = dt.float().reshape(BH, nc, Q)
    Bf = _pad(B.float(), Nk).repeat_interleave(groups, dim=0).reshape(
        BH, nc, Q, Nk)
    Cf = _pad(C.float(), Nk).repeat_interleave(groups, dim=0).reshape(
        BH, nc, Q, Nk)
    G = G.float().repeat_interleave(groups, dim=0)           # (BH, nc, Q, Q)
    cum = cum.float().reshape(BH, nc, Q)
    seg = cum[..., -1]
    ec = torch.exp(cum)
    ecoef = torch.exp(seg[..., None] - cum)
    coef = dtf * ecoef
    # 1. the state gradients in reverse over the chunks: dhn[:, c] is the
    # gradient of the state leaving chunk c
    dupd = dyf.transpose(-1, -2) @ (ec[..., None] * Cf)      # (BH, nc, Pk, Nk)
    eseg = torch.exp(seg)
    dh = (torch.zeros((BH, Pk, Nk), dtype=torch.float32, device=dev)
          if dstate is None else _pad(dstate.float(), Pk, Nk))
    dhn = [None] * nc
    for c in reversed(range(nc)):
        dhn[c] = dh
        dh = eseg[:, c, None, None] * dh + dupd[:, c]
    dhn = torch.stack(dhn, dim=1)                            # (BH, nc, Pk, Nk)
    # 2. per chunk
    L = _rb(_decay(cum)) if tile_bf16 else _decay(cum)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    dM = (dyf @ xf.transpose(-1, -2)).masked_fill(~tri, 0.0)
    dtj = dtf[..., None, :]
    M = (G * L) * dtj
    W = dM * L
    dG = W * dtj
    Z = W * G
    ZS = _suffix_sums(Z).masked_fill(~tri, 0.0)
    ddtM = ZS.diagonal(dim1=-2, dim2=-1)
    ddaL = _quarters((ZS * dtj).masked_fill(~tri.tril(-1), 0.0), 16)
    V = Bf @ dhn.transpose(-1, -2)                           # (Q, Pk)
    dcoef = _quarters(xf * V, Pk // 4)
    dx = M.transpose(-1, -2) @ dyf + coef[..., None] * V \
        + d.float()[:, None, None, None] * dyf
    dBh = dG.transpose(-1, -2) @ Cf + coef[..., None] * (xf @ dhn)
    U = dyf @ h_in                                           # (Q, Nk)
    dCh = dG @ Bf + ec[..., None] * U
    dcumE = ec * _pair_sum(Cf * U)
    # the sums of dh * h and of dy * x over the chunk kernel's threads
    hsum = _block_sum(_slice_major(dhn * h_in))
    ddc = _block_sum((dyf * xf).reshape(BH, nc, -1))
    # the gradient of da_t: the L entries that span t, exp(cum_i) for
    # i >= t, coef_j for j < t, exp(seg); each a sum without cancellation
    kc = _warp_scan(dcoef * coef)
    kc_before = torch.cat([torch.zeros_like(kc[..., :1]), kc[..., :-1]], -1)
    dda = (ddaL + _warp_scan(dcumE.flip(-1)).flip(-1) + kc_before
           + (eseg * hsum)[..., None])
    ddt = ddtM + dcoef * ecoef + a.float()[:, None, None] * dda
    da, dd = _chain(_lane_sum(dtf * dda), -1), _chain(ddc, -1)
    dB = _chain(dBh.reshape(BH // groups, groups, S, Nk), 1)[..., :N]
    dC = _chain(dCh.reshape(BH // groups, groups, S, Nk), 1)[..., :N]
    dx = dx.reshape(BH, S, Pk)[..., :P]
    return (dx.to(x.dtype), ddt.reshape(BH, S).to(dt.dtype), da, dd,
            dB.to(B.dtype), dC.to(C.dtype))


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            d: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            dy: torch.Tensor, dstate: Optional[torch.Tensor], saved, *,
            chunk: int = 64, groups: int = 1, tile_bf16: bool = False):
    """Gradients (dx, ddt, da, dd, dB, dC) of ``ssd_fwd``'s (y, final
    state) given dy (BH, S, P), the final state's gradient dstate (BH, P,
    N) or None for zero, and the forward's saved state (the state entering
    each chunk, cum, G; from ``ssd_fwd_plain(..., return_saved=True)`` or
    the forward kernels, whose P and N may be padded). On the card: f32
    only (TypeError otherwise), the shapes ``ssd_fwd`` takes; the four
    launches count as one call. ``tile_bf16``: the gradient of the
    bf16-tile forward (``ssd_bwd_plain``), whose ``saved`` it takes."""
    _check(x, dt, a, d, B, C, chunk, groups, "ssd_bwd")
    _check_bwd(x, dy, dstate, saved, chunk, groups)
    if not kernel_side(x, "ssd_bwd"):
        return ssd_bwd_plain(x, dt, a, d, B, C, dy, dstate, saved,
                             chunk=chunk, groups=groups, tile_bf16=tile_bf16)
    if any(t.dtype != torch.float32 for t in (x, dy)) or (
            dstate is not None and dstate.dtype != torch.float32):
        raise TypeError(f"ssd_bwd: {_NO_BF16_BWD}")
    BH, S, P = x.shape
    BG, _, N = B.shape
    Pk, Nk = kernel_shape(P, N, chunk, "ssd_bwd", tile_bf16)
    nc = S // chunk
    if nc > 65535:
        raise ValueError(f"ssd_bwd: S / chunk = {nc} > 65535")
    hst, cum, G = saved
    x, dy = _pad(x, Pk), _pad(dy, Pk)
    B, C = _pad(B, Nk), _pad(C, Nk)
    hst = _pad(hst[:, :, :P, :N], Pk, Nk) if tuple(hst.shape[2:]) != (
        Pk, Nk) else hst
    if dstate is not None:
        dstate, = _aligned(_pad(dstate, Pk, Nk))
    x, dt, a, d, B, C, dy, cum, G, hst = _aligned(x, dt, a, d, B, C, dy,
                                                  cum, G, hst)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da, dd = torch.empty((BH,), **f32), torch.empty((BH,), **f32)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    # scratch: the state gradients by chunk; dB and dC by head; da and dd
    # by chunk
    dH = torch.empty((BH, nc, Pk, Nk), **f32)
    dBp, dCp = (torch.empty((BH, S, Nk), **f32) for _ in range(2))
    dad = torch.empty((BH, nc, 2), **f32)
    if is_meta(x):
        record_kernel("ssd_bwd_tile_bf16" if tile_bf16 else "ssd_bwd",
                      ssd_bwd_cost(BH, S, P, N, chunk, groups))
        return (dx[..., :P].contiguous() if Pk != P else dx, ddt, da, dd,
                *((t[..., :N].contiguous() for t in (dB, dC)) if Nk != N
                  else (dB, dC)))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib("ssd_bwd")
    rc = (lib.ssd_bwd_tile_bf16 if tile_bf16 else lib.ssd_bwd)(
        *(ptr(t) for t in (x, dt, a, d, B, C, dy, dstate, cum, G, hst, dx,
                           ddt, da, dd, dB, dC, dH, dBp, dCp, dad)),
        BH, S, Pk, Nk, chunk, groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "ssd_bwd")
    _LAUNCHES["ssd_bwd_tile_bf16" if tile_bf16 else "ssd_bwd"] += 1
    if Pk != P:
        dx = dx[..., :P].contiguous()
    if Nk != N:
        dB, dC = dB[..., :N].contiguous(), dC[..., :N].contiguous()
    return dx, ddt, da, dd, dB, dC


def bwd_kernel_attrs(chunk: int, N: int) -> Dict[str, Dict[str, int]]:
    """{"state": ..., "chunk": ...}: the registers a thread and resident
    CTAs an SM of ``ssd_bwd``'s state and chunk kernels on the current
    card, at ``chunk`` and N (padded as ``ssd_bwd`` pads it)."""
    _, Nk = kernel_shape(1, N, chunk, "ssd_bwd")
    out = {}
    for which, name in enumerate(("state", "chunk")):
        regs, ctas = ctypes.c_int(), ctypes.c_int()
        rc = _lib("ssd_bwd").ssd_bwd_kernel_attrs(
            chunk, Nk, which, ctypes.byref(regs), ctypes.byref(ctas))
        _raise_on(rc, "ssd_bwd")
        out[name] = {"registers": regs.value, "ctas_per_sm": ctas.value}
    return out


class SSDFunction(torch.autograd.Function):
    """``ssd_fwd`` with its gradient: the forward kernels, whose saved state
    (the state entering each chunk, cum, G) is kept with the inputs, and
    ``ssd_bwd`` (the plain versions of both for CPU tensors). A None
    gradient of the final state (``ssd_attention`` discards it) counts as
    zero. Once differentiable."""

    @staticmethod
    def forward(ctx, x, dt, a, d, B, C, chunk, groups, tile_bf16=False):
        if kernel_side(x, "ssd_fwd"):
            y, state, saved = _fwd_kernel(x, dt, a, d, B, C, chunk, groups,
                                          tile_bf16)
        else:
            y, state, saved = ssd_fwd_plain(x, dt, a, d, B, C, chunk=chunk,
                                            groups=groups, return_saved=True,
                                            tile_bf16=tile_bf16)
        ctx.save_for_backward(x, dt, a, d, B, C, *saved)
        ctx.kw = dict(chunk=chunk, groups=groups, tile_bf16=tile_bf16)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        x, dt, a, d, B, C, *saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_bwd(x, dt, a, d, B, C, dy.contiguous(), dstate,
                        tuple(saved), **ctx.kw)
        return (*grads, None, None, None)
