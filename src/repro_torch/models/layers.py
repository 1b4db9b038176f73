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
from ..dist.sharding import (axis_index, active_axis, model_max, model_sum,
                             shard, tp_enter, tp_exit)

__all__ = ["rmsnorm_layout", "rmsnorm_apply", "layernorm_layout",
           "layernorm_apply", "norm_layout", "norm_apply", "rope_freqs",
           "apply_rope", "sinusoidal_positions", "scatter_residual",
           "mlp_layout", "mlp_apply",
           "embed_layout", "embed_apply", "unembed_apply",
           "vocab_parallel_ce"]


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


def mlp_apply(params, x, kind: str = "swiglu", ff: Optional[int] = None):
    """The MLP; a compacted tree (``serve.compact``) runs as it stands: a
    ``w1`` with dead hidden units gathered out has matching ``w3`` columns
    and ``w2`` rows (its ``w1_sel`` leaf is not read), and a ``w2`` with
    dead residual-output columns gathered out yields a narrow GEMM that
    ``scatter_residual`` places back at full width through ``w2_sel``.
    Every ``w2`` with a ``w2_sel`` leaf scatters, whatever its width: a
    recompacted ``w2`` whose slot width equals the residual width is still
    a permutation (live columns first, padded slots after).

    ``ff``: the full hidden width. Under a mesh whose "model" axis splits
    it (``w1`` holds fewer columns), this is the rank's share of a
    tensor-parallel MLP: ``tp_enter`` on x, its hidden columns, and
    ``tp_exit`` (the sum over model) after its rows of ``w2``."""
    tp = ff is not None and params["w1"].shape[-1] < ff
    if tp:
        x = tp_enter(x)
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w1"]
        up = x @ params["w3"]
        act = F.silu(gate) if kind == "swiglu" else _gelu(gate)
        h = act * up
    else:
        h = _gelu(x @ params["w1"])
    h = shard(h, "batch", "seq", "mlp")
    out = h @ params["w2"]
    if "w2_sel" in params:
        out = scatter_residual(out, params["w2_sel"], x.shape[-1])
    return shard(tp_exit(out) if tp else out, "batch", "seq", "embed")


# ----------------------------- embeddings -----------------------------------

def embed_layout(vocab: int, d: int):
    return {"table": PM((vocab, d), ("vocab", "embed"), init="normal")}


def _vocab_piece(table: torch.Tensor, vocab: Optional[int]):
    """(first row, rows) of the vocab rows this rank holds, or None when
    it holds them all (no mesh, or vocab not split over "model")."""
    rows = table.shape[0]
    if vocab is None or rows == vocab or active_axis("model") is None:
        return None
    return axis_index(active_axis("model"), "model") * rows, rows


def embed_apply(params, tokens: torch.Tensor, scale: Optional[float] = None,
                vocab: Optional[int] = None):
    """Token embeddings. ``vocab``: the full (padded) vocab; where the
    table holds fewer rows (vocab split over "model") each rank looks up
    the tokens in its rows, zeros the rest and ``tp_exit`` sums them."""
    piece = _vocab_piece(params["table"], vocab)
    if piece is None:
        out = params["table"][tokens]
    else:
        lo, rows = piece
        mine = (tokens >= lo) & (tokens < lo + rows)
        out = params["table"][(tokens - lo).clamp(0, rows - 1)]
        out = tp_exit(out * mine[..., None].to(out.dtype))
    if scale:           # the scale is rounded to the activation dtype first
        out = out * torch.full((), scale, dtype=out.dtype, device=out.device)
    return out


def unembed_apply(params, x: torch.Tensor,
                  true_vocab: Optional[int] = None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Logits in the activation dtype (f32 accumulation); padded vocab
    columns (>= true_vocab) are masked to -1e30 so CE and sampling are
    exact. ``vocab``: the full (padded) vocab; where the table holds fewer
    rows (vocab split over "model") these are this rank's columns of the
    logits, x entering through ``tp_enter``."""
    table = params["table"]
    piece = _vocab_piece(table, vocab)
    if piece is not None:
        x = tp_enter(x)
    if x.dtype == torch.float32:
        logits = x @ table.t()
    else:
        logits = (x.float() @ table.float().t()).to(x.dtype)
    lo, vp = (0, table.shape[0]) if piece is None else piece
    if true_vocab is not None and true_vocab < lo + vp:
        pad = torch.arange(lo, lo + vp, device=x.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return shard(logits, "batch", "seq", "vocab")


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Per-token logsumexp(logits) - logits[label] in f32 where the vocab
    is split over "model" (``logits``: this rank's columns): the row max
    by one MAX over model (``ce_max``, no gradient), then the sum of
    exp(logits - max) and the label's logit (zero on ranks not holding
    it) by one stacked SUM over model (``ce_stats``)."""
    lf = logits.float()
    rows = lf.shape[-1]
    lo = axis_index(active_axis("model"), "model") * rows
    m = model_max(lf.max(dim=-1).values, "ce_max")
    se = torch.exp(lf - m[..., None]).sum(dim=-1)
    mine = (labels >= lo) & (labels < lo + rows)
    idx = (labels - lo).clamp(0, rows - 1).long()
    take = lf.gather(-1, idx[..., None])[..., 0] * mine.float()
    stats = model_sum(torch.stack([se, take]), "ce_stats")
    return m + torch.log(stats[0]) - stats[1]
