"""Attention for the LM zoo: GQA/MQA with optional sliding window.

Full-sequence attention (train / prefill) goes through
``kernels.flash_attention.flash_attention``: the hand-written CUDA kernel
when the tensors are on the card, its plain PyTorch version on the CPU
(the JAX package's models run a jnp chunked attention here and keep the
Pallas kernel as the TPU drop-in for the same math).

Decode attends one new token against a KV cache. Caches are updated
functionally, as in the JAX package: a write returns a new cache and
leaves the old one as it was.

Cross attention and multi-head latent attention (MLA) are not ported yet
(ROADMAP queue A item 6).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .param import PM
from .layers import apply_rope
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["attn_layout", "attn_apply", "attn_prefill_cache",
           "decode_attention", "attn_decode"]

_NEG = -1e30


# ------------------------------ layouts -------------------------------------

def attn_layout(d: int, n_heads: int, n_kv: int, head_dim: int,
                qkv_bias: bool = False):
    lay = {
        "wq": PM((d, n_heads, head_dim), ("fsdp", "heads", None), init="scaled"),
        "wk": PM((d, n_kv, head_dim), ("fsdp", "kv_heads", None), init="scaled"),
        "wv": PM((d, n_kv, head_dim), ("fsdp", "kv_heads", None), init="scaled"),
        "wo": PM((n_heads, head_dim, d), ("heads", None, "fsdp"), init="scaled"),
    }
    if qkv_bias:
        lay["bq"] = PM((n_heads, head_dim), ("heads", None), init="zeros")
        lay["bk"] = PM((n_kv, head_dim), ("kv_heads", None), init="zeros")
        lay["bv"] = PM((n_kv, head_dim), ("kv_heads", None), init="zeros")
    return lay


# ------------------------------ decode helpers ------------------------------

def pos_tensor(pos, device) -> torch.Tensor:
    """A decode position (a Python int, a 0-d or (B,) tensor, or a
    sequence) as a tensor on ``device``. An int is filled on the device: a
    host-to-device copy from pageable memory would synchronise the stream
    at every layer of every decode step."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device)
    if isinstance(pos, (int, np.integer)):
        return torch.full((), int(pos), dtype=torch.long, device=device)
    return torch.as_tensor(pos, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, window: int = 0
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, KV, R, hd); caches: (B, Smax, KV, hd); pos: current position
    (tokens at indices <= pos are valid) — a scalar shared by the batch or
    a (B,) vector of per-row positions.
    """
    B, _, KVh, R, hd = q.shape
    Smax = k_cache.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bqkrh,bskh->bqkrs", q.float(),
                          k_cache.float()) * scale
    kv_pos = torch.arange(Smax, device=q.device)
    pos = pos_tensor(pos, q.device)
    pos_b = pos[:, None] if pos.ndim else pos
    valid = kv_pos <= pos_b                       # () or (B,) -> bcast
    if window:
        valid &= kv_pos > pos_b - window
    valid = torch.broadcast_to(valid, (B, Smax))
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full((), _NEG, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqkrs,bskh->bqkrh", p, v_cache.float())
    return out.to(q.dtype)


def _decode_positions(pos, B: int, device) -> torch.Tensor:
    """Normalize a decode position argument to (B, 1) int32 for RoPE:
    scalar pos broadcasts over the batch, a (B,) vector is per-row."""
    pos = pos_tensor(pos, device)
    if pos.ndim == 0:
        return pos.to(torch.int32).expand(B)[:, None]
    return pos.to(torch.int32)[:, None]


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write one new timestep into a (B, Smax, ...) cache at ``pos`` and
    return the new cache, as the JAX package does:

    * a scalar ``pos`` is ``dynamic_update_slice``: a negative pos counts
      from the end, and the start is then clamped into [0, Smax - 1];
    * a (B,) ``pos`` is a per-row scatter with ``mode="drop"``: a negative
      pos counts from the end, and a row whose pos is then out of range
      writes nothing.
    """
    B, Smax = cache.shape[:2]
    pos = pos_tensor(pos, cache.device).long()
    pos = torch.where(pos < 0, pos + Smax, pos)
    if pos.ndim == 0:
        pos = pos.clamp(0, Smax - 1).expand(B)
    rows = torch.arange(Smax, device=cache.device)[None, :] == pos[:, None]
    rows = rows.reshape((B, Smax) + (1,) * (cache.ndim - 2))
    return torch.where(rows, new.to(cache.dtype), cache)


# ------------------------------ GQA module ----------------------------------

def _proj_heads(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd", out, wo) as one matmul."""
    h, k, d = wo.shape
    return out.reshape(out.shape[:-2] + (h * k,)) @ wo.reshape(h * k, d)


def _project_qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta,
                 rope_frac):
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if rope_theta:
        q = apply_rope(q, positions, rope_theta, rope_frac)
        k = apply_rope(k, positions, rope_theta, rope_frac)
    return q, k, v


def attn_apply(params, x, *, n_heads: int, n_kv: int, head_dim: int,
               positions, causal: bool = True, window: int = 0,
               rope_theta: float = 10000.0, rope_frac: float = 1.0,
               q_chunk: int = 512, kv_chunk: int = 512,
               sliced_window: bool = False) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA. x: (B, S, d).

    ``q_chunk`` / ``kv_chunk`` are the plain version's tiles (the CUDA
    kernel picks its own). ``sliced_window`` is the reference's lever for
    how local attention is lowered (O(S * window) slices); it does not
    change the function, and the flash kernel already skips tiles that the
    window masks out, so it is accepted and has nothing to select here."""
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions,
                           rope_theta, rope_frac)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          block_q=q_chunk, block_kv=kv_chunk)
    return _out_proj(out, params["wo"])


def attn_prefill_cache(params, x, *, n_heads, n_kv, head_dim, positions,
                       rope_theta=10000.0, rope_frac=1.0):
    """K/V for cache initialization from a prefilled sequence."""
    _, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions,
                           rope_theta, rope_frac)
    return k, v


def attn_decode(params, x, cache: Tuple[torch.Tensor, torch.Tensor],
                pos, *, n_heads: int, n_kv: int, head_dim: int,
                window: int = 0, rope_theta: float = 10000.0,
                rope_frac: float = 1.0):
    """One-token decode. x: (B, 1, d); cache: (k, v) each (B, Smax, KV, hd);
    pos: index of the new token — scalar (whole batch at one depth) or (B,)
    per-row. Returns (y, new_cache)."""
    B = x.shape[0]
    pos = pos_tensor(pos, x.device)
    positions = _decode_positions(pos, B, x.device)
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv, head_dim,
                                   positions, rope_theta, rope_frac)
    k_cache, v_cache = cache
    k_cache = _cache_write(k_cache, k_new, pos)
    v_cache = _cache_write(v_cache, v_new, pos)
    R = n_heads // n_kv
    qg = q.reshape(B, 1, n_kv, R, head_dim)
    out = decode_attention(qg, k_cache, v_cache, pos, window=window)
    out = out.reshape(B, 1, n_heads, head_dim)
    return _out_proj(out, params["wo"]), (k_cache, v_cache)
