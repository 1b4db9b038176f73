"""Shared neural layers for the LM zoo (functional PyTorch).

Every layer is a (layout, apply) pair: ``*_layout`` returns a PM tree
(shapes + logical axes), ``*_apply`` consumes the materialized params.
Norm/softmax arithmetic is f32 regardless of param dtype.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .param import PM

__all__ = ["rmsnorm_layout", "rmsnorm_apply", "layernorm_layout",
           "layernorm_apply", "norm_layout", "norm_apply", "rope_freqs",
           "apply_rope", "sinusoidal_positions", "scatter_residual",
           "mlp_layout", "mlp_apply",
           "embed_layout", "embed_apply", "unembed_apply"]


# ----------------------------- norms ---------------------------------------

def rmsnorm_layout(d: int):
    return {"scale": PM((d,), (None,), init="ones")}


def rmsnorm_apply(params, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def layernorm_layout(d: int):
    return {"scale": PM((d,), (None,), init="ones"),
            "bias": PM((d,), (None,), init="zeros")}


def layernorm_apply(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = ((xf - mu) * torch.rsqrt(var + eps) * params["scale"].float()
           + params["bias"].float())
    return out.to(x.dtype)


def norm_layout(d: int, kind: str = "rmsnorm"):
    return layernorm_layout(d) if kind == "layernorm" else rmsnorm_layout(d)


def norm_apply(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    if kind == "layernorm":
        return layernorm_apply(params, x, eps)
    return rmsnorm_apply(params, x, eps)


# ----------------------------- RoPE -----------------------------------------

def rope_freqs(head_dim: int, theta: float, rope_frac: float = 1.0):
    """Frequency table (numpy f32) for (the first rope_frac of) a head dim,
    and the number of rotated dims."""
    rot = int(head_dim * rope_frac) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return inv, rot


@functools.lru_cache(maxsize=64)
def _inv_freq(head_dim: int, theta: float, rope_frac: float,
              device: torch.device):
    """``rope_freqs`` as a tensor on ``device``, copied there once per
    (head_dim, theta, rope_frac, device): a host-to-device copy from
    pageable memory synchronises the stream, which would stall every
    layer of a decode step."""
    inv, rot = rope_freqs(head_dim, theta, rope_frac)
    return torch.as_tensor(inv, device=device), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, heads..., head_dim); positions: (..., S) int.

    Rotates INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]) of the first
    ``rope_frac`` of the head dim, as the JAX package does (not the
    rotate-half layout)."""
    inv, rot = _inv_freq(x.shape[-1], theta, rope_frac, x.device)
    if rot == 0:
        return x
    ang = positions.float()[..., None] * inv            # (..., S, rot/2)
    # broadcast over any head dims between S and head_dim
    for _ in range(x.ndim - ang.ndim):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(S: int, d: int, offset=0, device=None
                         ) -> torch.Tensor:
    """(S, d) f32 absolute sinusoidal table (``offset`` unused, as in the
    JAX package)."""
    pos = np.arange(S)[:, None] + 0
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.as_tensor(out, device=device)


# ----------------------------- MLP ------------------------------------------

def scatter_residual(y: torch.Tensor, sel: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Scatter a compact residual contribution back to full width.

    ``y``: (..., J) — a GEMM output computed only on the J surviving
    residual-output columns of a compacted ``w2`` (``serve.compact``);
    ``sel``: int (J,) column indices; ``width``: the full residual width.
    Returns (..., width) with ``y[..., j]`` placed at column ``sel[j]`` and
    exact zeros elsewhere — what the dense GEMM produces, because a
    structurally dead output column contributes exact zero. It ADDS (not
    sets), so the padded slots a live re-compaction leaves behind —
    duplicate indices pointing at one dead column — accumulate their
    exact-zero contributions harmlessly. On the card ``index_add_`` adds
    with atomics; every output element receives one live value or only
    exact zeros, so the order of the adds cannot change a bit.

    >>> y_full = scatter_residual(h @ w2_compact, sel, d_model)
    """
    out = y.new_zeros(y.shape[:-1] + (width,))
    return out.index_add_(y.ndim - 1, sel, y)


def mlp_layout(d: int, ff: int, kind: str = "swiglu"):
    if kind in ("swiglu", "geglu"):
        return {"w1": PM((d, ff), ("fsdp", "mlp"), init="scaled"),
                "w3": PM((d, ff), ("fsdp", "mlp"), init="scaled"),
                "w2": PM((ff, d), ("mlp", "fsdp"), init="scaled")}
    return {"w1": PM((d, ff), ("fsdp", "mlp"), init="scaled"),
            "w2": PM((ff, d), ("mlp", "fsdp"), init="scaled")}


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def mlp_apply(params, x, kind: str = "swiglu"):
    """The MLP; a compacted tree (``serve.compact``) runs as it stands: a
    ``w1`` with dead hidden units gathered out has matching ``w3`` columns
    and ``w2`` rows (its ``w1_sel`` leaf is not read), and a ``w2`` with
    dead residual-output columns gathered out yields a narrow GEMM that
    ``scatter_residual`` places back at full width through ``w2_sel``.
    Every ``w2`` with a ``w2_sel`` leaf scatters, whatever its width: a
    recompacted ``w2`` whose slot width equals the residual width is still
    a permutation (live columns first, padded slots after)."""
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w1"]
        up = x @ params["w3"]
        act = F.silu(gate) if kind == "swiglu" else _gelu(gate)
        h = act * up
    else:
        h = _gelu(x @ params["w1"])
    out = h @ params["w2"]
    if "w2_sel" in params:
        out = scatter_residual(out, params["w2_sel"], x.shape[-1])
    return out


# ----------------------------- embeddings -----------------------------------

def embed_layout(vocab: int, d: int):
    return {"table": PM((vocab, d), ("vocab", "embed"), init="normal")}


def embed_apply(params, tokens: torch.Tensor, scale: Optional[float] = None):
    out = params["table"][tokens]
    if scale:           # the scale is rounded to the activation dtype first
        out = out * torch.full((), scale, dtype=out.dtype, device=out.device)
    return out


def unembed_apply(params, x: torch.Tensor,
                  true_vocab: Optional[int] = None) -> torch.Tensor:
    """Logits in the activation dtype (f32 accumulation); padded vocab
    columns (>= true_vocab) are masked to -1e30 so CE and sampling are
    exact."""
    table = params["table"]
    if x.dtype == torch.float32:
        logits = x @ table.t()
    else:
        logits = (x.float() @ table.float().t()).to(x.dtype)
    vp = table.shape[0]
    if true_vocab is not None and true_vocab < vp:
        pad = torch.arange(vp, device=x.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits
