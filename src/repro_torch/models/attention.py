"""Attention for the LM zoo: GQA/MQA with optional sliding window, cross
attention and multi-head latent attention (MLA).

Full-sequence attention (train / prefill) goes through
``kernels.flash_attention.flash_attention``: the hand-written CUDA kernel
when the tensors are on the card, its plain PyTorch version on the CPU
(the JAX package's models run a jnp chunked attention here and keep the
Pallas kernel as the TPU drop-in for the same math).

Decode attends one new token against a KV cache. ``attn_decode_`` writes
the new timestep into the cache in place (``_cache_write_``), with no host
sync, so a serving step can run it under CUDA graph capture;
``attn_decode`` keeps the JAX package's functional contract (a write
returns a new cache and leaves the old one as it was) by writing into a
copy.

Cross attention (``cross_attn_apply``: llama-vision's image layers,
whisper's decoder) is non-causal flash over a memory of another length,
with no RoPE. MLA (deepseek-v2) runs its full-sequence form through flash
at q/k head dim nope + rope with v's head dim below it (``flash_attention``
zero-pads v); its decode reads and writes the compressed cache (c, k_rope),
in place in ``mla_decode_``, plainly or in the matrix-absorbed form.

Over a mesh whose "model" axis splits the heads (the reference's layout,
``launch.steps.param_shardings``), each layer computes the rank's heads
from its pieces and sums its partial output over model (``tp_exit``):
GQA by query heads (with the kv heads split too, or whole and each rank
slicing those of its query heads), cross attention by heads, MLA by
heads (its down projections and norms whole on every rank).

Decode over a mesh (``launch.steps.build_decode_step`` under the
reference's decode rules) hands each rank its pieces of the cache:

  * a cache whose sequence the rules' "cache_seq" splits
    (``dist.sharding.cache_seq_split``) holds the positions ``offset +
    arange(local)`` of this rank's slice. Keys are masked by their global
    position (against ``pos`` and the window); only the rank whose slice
    holds a row's ``pos`` writes that row's new k / v (or c / k_rope); the
    softmax is the split-softmax (``_split_softmax``): one MAX of the
    logits' row max over the sequence shards (``decode_max``), each rank's
    exp(logits - global max) summed and applied to its values in f32, and
    one SUM of those partial weights and weighted values
    (``decode_sum``). Masked keys keep the reference's finite -1e30, so a
    slice with no valid key adds exactly zero (exp(-1e30 - max) is 0.0)
    and a row with no valid key anywhere is uniform, as on one device;
  * GQA attention whose heads and kv heads the "model" axis splits (the
    train rules) computes the rank's heads against its kv heads of the
    cache, ``tp_exit`` after its rows of ``wo``; query heads split with
    the kv heads whole (the decode rules give the model axis to the
    cache's sequence) gather their weights over model and attend whole,
    as do MLA's heads where the sequence split takes the model axis;
  * cross attention's memory cache (ck / cv) split over "heads" attends
    with the rank's heads and sums the output projection over "model"
    (``cross_decode``, ``tp_exit``).

The decode path runs plain PyTorch on both packages (no ``pallas_call``
behind the reference's decode), so no kernel is launched here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .param import PM
from .layers import apply_rope, rmsnorm_apply
from ..dist.sharding import (active_axis, axis_index, cache_seq_split,
                             model_whole, seq_max, seq_sum, shard, tp_enter,
                             tp_exit)
from ..kernels.flash_attention.ops import flash_attention

__all__ = ["attn_layout", "attn_apply", "attn_prefill_cache",
           "decode_attention", "attn_decode", "attn_decode_",
           "cross_attn_layout", "cross_attn_apply", "cross_decode",
           "mla_layout", "mla_apply", "mla_decode", "mla_decode_"]

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


def mla_layout(d: int, n_heads: int, q_lora: int, kv_lora: int,
               nope: int, rope: int, v_dim: int):
    return {
        "wq_a": PM((d, q_lora), ("fsdp", None), init="scaled"),
        "q_norm": PM((q_lora,), (None,), init="ones"),
        "wq_b": PM((q_lora, n_heads, nope + rope), (None, "heads", None),
                   init="scaled"),
        "wkv_a": PM((d, kv_lora + rope), ("fsdp", None), init="scaled"),
        "kv_norm": PM((kv_lora,), (None,), init="ones"),
        "wk_b": PM((kv_lora, n_heads, nope), (None, "heads", None),
                   init="scaled"),
        "wv_b": PM((kv_lora, n_heads, v_dim), (None, "heads", None),
                   init="scaled"),
        "wo": PM((n_heads, v_dim, d), ("heads", None, "fsdp"), init="scaled"),
    }


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


def _split_softmax(logits: torch.Tensor, weigh, split) -> torch.Tensor:
    """``weigh(softmax(logits))`` over a sequence split across ranks:
    ``logits`` (..., S_local) of this rank's slice. One MAX of the row
    maxima over the shards (``decode_max``), this rank's p = exp(logits -
    global max) in f32, and one SUM of [weigh(p), sum(p)] over the shards
    (``decode_sum``), each rank's partial weighed at the global max; the
    quotient of the two sums."""
    m = seq_max(logits.amax(dim=-1), split)
    p = torch.exp(logits - m[..., None])
    part = torch.cat([weigh(p), p.sum(dim=-1)[..., None]], dim=-1)
    tot = seq_sum(part, split)
    return tot[..., :-1] / tot[..., -1:]


def _weighted_softmax(logits: torch.Tensor, weigh, split=None
                      ) -> torch.Tensor:
    """``weigh(softmax(logits, -1))``: the attention weights over the
    cache's positions applied to its values (``weigh`` is linear in the
    weights and sums over their last dim). ``split``: the cache's sequence
    shards (``cache_seq_split``), combined by ``_split_softmax``."""
    if split is None:
        return weigh(torch.softmax(logits, dim=-1))
    return _split_softmax(logits, weigh, split)


def _kv_positions(S: int, split, device) -> torch.Tensor:
    """The global positions of a cache slice of S keys: this rank's slice
    of the sequence shards, or the whole cache."""
    off = 0 if split is None else split.index * S
    return off + torch.arange(S, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, window: int = 0,
                     split=None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, KV, R, hd); caches: (B, Smax, KV, hd); pos: current position
    (tokens at indices <= pos are valid) — a scalar shared by the batch or
    a (B,) vector of per-row positions. ``split``
    (``dist.sharding.cache_seq_split``): the caches are this rank's slice
    of a sequence split over ranks; keys are masked by their global
    position and the softmax is the split-softmax.
    """
    B, _, KVh, R, hd = q.shape
    Smax = k_cache.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bqkrh,bskh->bqkrs", q.float(),
                          k_cache.float()) * scale
    kv_pos = _kv_positions(Smax, split, q.device)
    pos = pos_tensor(pos, q.device)
    pos_b = pos[:, None] if pos.ndim else pos
    valid = kv_pos <= pos_b                       # () or (B,) -> bcast
    if window:
        valid &= kv_pos > pos_b - window
    valid = torch.broadcast_to(valid, (B, Smax))
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full((), _NEG, device=q.device))
    v = v_cache.float()
    out = _weighted_softmax(
        logits, lambda p: torch.einsum("bqkrs,bskh->bqkrh", p, v), split)
    return out.to(q.dtype)


def _decode_positions(pos, B: int, device) -> torch.Tensor:
    """Normalize a decode position argument to (B, 1) int32 for RoPE:
    scalar pos broadcasts over the batch, a (B,) vector is per-row."""
    pos = pos_tensor(pos, device)
    if pos.ndim == 0:
        return pos.to(torch.int32).expand(B)[:, None]
    return pos.to(torch.int32)[:, None]


def _cache_write_(cache: torch.Tensor, new: torch.Tensor, pos,
                  split=None) -> None:
    """Write one new timestep (B, 1, ...) into a (B, Smax, ...) cache at
    ``pos``, in place, with the JAX package's semantics:

    * a scalar ``pos`` is ``dynamic_update_slice``: a negative pos counts
      from the end, and the start is then clamped into [0, Smax - 1];
    * a (B,) ``pos`` is a per-row scatter with ``mode="drop"``: a negative
      pos counts from the end, and a row whose pos is then out of range
      writes nothing.

    A dropped row writes its old value back at a clamped index, so no
    branch depends on the data and nothing waits for the device.
    ``split``: ``cache`` is this rank's slice of a sequence split over
    ranks (``cache_seq_split``); ``pos`` is global, resolved as above
    against the whole sequence, and a row whose position another rank's
    slice holds writes nothing here."""
    B, Smax = cache.shape[:2]
    pos = pos_tensor(pos, cache.device).long()
    rows = torch.arange(B, device=cache.device)
    val = new[:, 0].to(cache.dtype)
    if split is not None:
        total, off = Smax * split.ways, Smax * split.index
        pos = torch.where(pos < 0, pos + total, pos)
        if pos.ndim == 0:
            pos = pos.clamp(0, total - 1).expand(B)
        local = pos - off
        idx = local.clamp(0, Smax - 1)
        keep = ((local >= 0) & (local < Smax)).reshape(
            (B,) + (1,) * (val.ndim - 1))
        cache.index_put_((rows, idx), torch.where(keep, val,
                                                  cache[rows, idx]))
        return
    pos = torch.where(pos < 0, pos + Smax, pos)
    if pos.ndim == 0:
        cache.index_put_((rows, pos.clamp(0, Smax - 1).expand(B)), val)
        return
    idx = pos.clamp(0, Smax - 1)
    keep = ((pos >= 0) & (pos < Smax)).reshape((B,) + (1,) * (val.ndim - 1))
    cache.index_put_((rows, idx), torch.where(keep, val, cache[rows, idx]))


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """``_cache_write_`` into a copy: returns the new cache and leaves
    ``cache`` as it was."""
    out = cache.clone()
    _cache_write_(out, new, pos)
    return out


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
    window masks out, so it is accepted and has nothing to select here.

    Under a mesh whose "model" axis splits the heads (``wq`` holds fewer
    than ``n_heads``), this is the rank's share of a tensor-parallel
    block: its query and kv heads (``wq`` / ``wk`` / ``wv`` column
    pieces), ``tp_enter`` on x and ``tp_exit`` (the sum over model) after
    the row piece of ``wo``. Where the kv heads do not split (the rules
    replicate them: ``wk`` holds all ``n_kv``), the rank takes the kv
    heads of its query heads by a local slice of ``wk`` / ``wv``, whose
    gradients, parts from each rank's heads, are summed over model
    (``tp_enter``)."""
    tp = params["wq"].shape[1] < n_heads
    if tp:
        params = _own_kv_heads(params, n_heads, n_kv)
    x = shard(tp_enter(x) if tp else x, "batch", "attn_seq", "embed")
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions,
                           rope_theta, rope_frac)
    q = shard(q, "batch", "attn_seq", "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          block_q=q_chunk, block_kv=kv_chunk)
    out = shard(out, "batch", "attn_seq", "heads", None)
    y = _out_proj(out, params["wo"])
    return shard(tp_exit(y) if tp else y, "batch", "seq", "embed")


def _own_kv_heads(params, n_heads: int, n_kv: int):
    """``params`` with ``wk`` / ``wv`` (and their biases) cut to the kv
    heads of this rank's query heads, where the query heads split over
    "model" and the kv heads do not: a local slice of each replicated
    weight, entering through ``tp_enter`` (each rank's heads give a part
    of its gradient). The rank's ``h_loc`` query heads lie in whole GQA
    groups, or in one group (ValueError otherwise)."""
    if params["wk"].shape[1] < n_kv:
        return params
    h_loc = params["wq"].shape[1]
    group = n_heads // n_kv
    if h_loc % group and group % h_loc:
        raise ValueError(
            f"attention: {h_loc} query heads a rank do not lie in whole "
            f"GQA groups of {group}; split the kv heads over model too")
    lo = axis_index(active_axis("model"), "model") * h_loc // group
    n = max(h_loc // group, 1)
    out = dict(params)
    for k in ("wk", "wv", "bk", "bv"):
        if k in params:
            dim = 1 if k[0] == "w" else 0
            out[k] = tp_enter(params[k]).narrow(dim, lo, n)
    return out


def _whole_heads(params, n_heads: int, n_kv: int):
    """``params`` with every head-split weight of an attention layer
    gathered over "model" (``decode_head_gather``, one all_gather each):
    the decode step's, where the query heads split over model and the
    cache does not hold the rank's kv heads alone (the decode rules give
    the model axis to the cache's sequence, the train rules may replicate
    the kv heads), so the layer runs replicated over model."""
    dims = {"wq": (1, n_heads), "bq": (0, n_heads), "wo": (0, n_heads),
            "wk": (1, n_kv), "wv": (1, n_kv), "bk": (0, n_kv),
            "bv": (0, n_kv)}
    return {k: model_whole(v, dims[k][1], dims[k][0], "decode_head_gather")
            if k in dims else v for k, v in params.items()}


def attn_prefill_cache(params, x, *, n_heads, n_kv, head_dim, positions,
                       rope_theta=10000.0, rope_frac=1.0):
    """K/V for cache initialization from a prefilled sequence."""
    _, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions,
                           rope_theta, rope_frac)
    return k, v


def attn_decode_(params, x, cache: Tuple[torch.Tensor, torch.Tensor],
                 pos, *, n_heads: int, n_kv: int, head_dim: int,
                 window: int = 0, rope_theta: float = 10000.0,
                 rope_frac: float = 1.0) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); cache: (k, v) each (B, Smax, KV, hd),
    written in place; pos: index of the new token — scalar (whole batch at
    one depth) or (B,) per-row. Returns y.

    Over a mesh: a cache sequence split over ranks (the decode rules'
    "cache_seq") is masked by global position, written only by the rank
    whose slice holds ``pos`` and combined by the split-softmax; heads
    and kv heads split over "model" (``wq`` holding fewer than
    ``n_heads``, the cache the same kv heads as ``wk``) attend with the
    rank's heads, the output summed over model after its rows of ``wo``
    (``tp_exit``); query heads split over model with the kv heads whole
    (the cache holding them all, or its sequence split over model) gather
    their weights over model (``_whole_heads``) and attend whole."""
    B = x.shape[0]
    if (params["wq"].shape[1] < n_heads
            and params["wk"].shape[1] == cache[0].shape[2]
            and cache[0].shape[2] == n_kv):
        params = _whole_heads(params, n_heads, n_kv)
    tp = params["wq"].shape[1] < n_heads
    if tp:
        x = tp_enter(x)
    h_loc, kv_loc = params["wq"].shape[1], params["wk"].shape[1]
    k_cache, v_cache = cache
    if k_cache.shape[2] != kv_loc:
        raise ValueError(
            f"attn_decode_: the cache holds {k_cache.shape[2]} kv heads, "
            f"the weights {kv_loc}: lay the cache out under the rules the "
            f"params were laid out under (launch.steps.cache_shardings)")
    split = cache_seq_split()
    pos = pos_tensor(pos, x.device)
    positions = _decode_positions(pos, B, x.device)
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv, head_dim,
                                   positions, rope_theta, rope_frac)
    _cache_write_(k_cache, k_new, pos, split)
    _cache_write_(v_cache, v_new, pos, split)
    qg = q.reshape(B, 1, kv_loc, h_loc // kv_loc, head_dim)
    out = decode_attention(qg, k_cache, v_cache, pos, window=window,
                           split=split)
    out = out.reshape(B, 1, h_loc, head_dim)
    y = _out_proj(out, params["wo"])
    return tp_exit(y) if tp else y


def attn_decode(params, x, cache: Tuple[torch.Tensor, torch.Tensor],
                pos, **kw):
    """``attn_decode_`` on a copy of the cache. Returns (y, new_cache); the
    old cache is left as it was."""
    new = tuple(c.clone() for c in cache)
    return attn_decode_(params, x, new, pos, **kw), new


# ---------------------------- cross attention -------------------------------

def cross_attn_layout(d: int, n_heads: int, head_dim: int, d_mem: int):
    return {
        "wq": PM((d, n_heads, head_dim), ("fsdp", "heads", None), init="scaled"),
        "wk": PM((d_mem, n_heads, head_dim), ("fsdp", "heads", None),
                 init="scaled"),
        "wv": PM((d_mem, n_heads, head_dim), ("fsdp", "heads", None),
                 init="scaled"),
        "wo": PM((n_heads, head_dim, d), ("heads", None, "fsdp"), init="scaled"),
    }


def cross_attn_apply(params, x, memory, *, n_heads: int, head_dim: int,
                     q_chunk: int = 512, kv_chunk: int = 512):
    """x: (B, S, d) queries; memory: (B, Sm, d_mem) keys/values (no RoPE).
    Non-causal flash with one kv head a query head; Sm need not be a
    multiple of a tile (1600 image tokens).

    Under a mesh whose "model" axis splits the heads (``wq`` holds fewer
    than ``n_heads``): the rank's heads of q, k and v (column pieces of
    ``wq`` / ``wk`` / ``wv``; x and the memory enter through
    ``tp_enter``), its rows of ``wo`` and the partial output summed over
    model (``tp_exit``)."""
    tp = params["wq"].shape[1] < n_heads
    if tp:
        x, memory = tp_enter(x), tp_enter(memory)
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(memory, params["wk"])
    v = _proj_heads(memory, params["wv"])
    out = flash_attention(q, k, v, causal=False, block_q=q_chunk,
                          block_kv=kv_chunk)
    y = _out_proj(out, params["wo"])
    return tp_exit(y) if tp else y


def cross_decode(params, x, ck: torch.Tensor, cv: torch.Tensor, *,
                 n_heads: int, head_dim: int) -> torch.Tensor:
    """One-token cross attention against the memory cache ck / cv (B, Sm,
    H, hd), which it only reads. Where the heads split over "model" (the
    rules' "heads": ``wq`` and the cache hold the rank's share), the rank
    attends with its heads and its rows of ``wo``, the output summed over
    model (``tp_exit``)."""
    B = x.shape[0]
    h_loc = ck.shape[2]
    if params["wq"].shape[1] != h_loc:
        raise ValueError(
            f"cross_decode: the memory cache holds {h_loc} heads, the "
            f"weights {params['wq'].shape[1]}: lay the cache out under the "
            f"rules the params were laid out under "
            f"(launch.steps.cache_shardings)")
    split = h_loc < n_heads
    q = _proj_heads(tp_enter(x) if split else x, params["wq"])
    qg = q.reshape(B, 1, h_loc, 1, head_dim)
    out = decode_attention(qg, ck, cv, ck.shape[1] - 1)
    y = _out_proj(out.reshape(B, 1, h_loc, head_dim), params["wo"])
    return tp_exit(y) if split else y


# -------------------------------- MLA ---------------------------------------

def _mla_qkv(params, x, n_heads, nope, rope_dim, positions, rope_theta):
    """q_nope, q_rope (this rank's heads), the latent c and k_rope. The
    down projections and norms run whole on every rank; where the heads
    split over "model" (``wq_b`` holds fewer than ``n_heads``) cq, c and
    k_rope feed only the rank's heads, so each enters through ``tp_enter``
    (its gradient, a part from each rank's heads, summed over model)."""
    tp = params["wq_b"].shape[1] < n_heads
    enter = tp_enter if tp else (lambda t: t)
    cq = rmsnorm_apply({"scale": params["q_norm"]}, x @ params["wq_a"])
    q = _proj_heads(enter(cq), params["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    ckr = x @ params["wkv_a"]
    kv_lora = params["wkv_a"].shape[1] - rope_dim
    c, k_rope_raw = ckr[..., :kv_lora], ckr[..., kv_lora:]
    c = enter(rmsnorm_apply({"scale": params["kv_norm"]}, c))
    k_rope = enter(apply_rope(k_rope_raw, positions, rope_theta))
    return q_nope, q_rope, c, k_rope            # k_rope: (B, S, rope)


def mla_apply(params, x, *, n_heads: int, nope: int, rope_dim: int,
              v_dim: int, positions, rope_theta: float = 10000.0,
              q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Multi-head Latent Attention, full-sequence form (train / prefill):
    causal flash at q/k head dim nope + rope_dim with v at v_dim.

    Under a mesh whose "model" axis splits the heads (``wq_b``, ``wk_b``,
    ``wv_b`` and ``wo`` hold the rank's share; ``wq_a``, ``wkv_a`` and
    the norms are whole), flash runs on the rank's heads and the partial
    output after its rows of ``wo`` is summed over model (``tp_exit``)."""
    B, S, _ = x.shape
    h_loc = params["wq_b"].shape[1]
    q_nope, q_rope, c, k_rope = _mla_qkv(params, x, n_heads, nope, rope_dim,
                                         positions, rope_theta)
    k_nope = _proj_heads(c, params["wk_b"])
    v = _proj_heads(c, params["wv_b"])
    k_rope_h = k_rope[:, :, None, :].expand(B, S, h_loc, rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    out = flash_attention(q_full, k_full, v, causal=True, block_q=q_chunk,
                          block_kv=kv_chunk)
    y = _out_proj(out, params["wo"])
    return tp_exit(y) if h_loc < n_heads else y


def _promoted(*ts):
    """``ts`` in their promoted dtype, as jnp.einsum promotes its operands
    (a bf16 cache against f32 weights computes in f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def mla_decode_(params, x, cache, pos, *, n_heads: int, nope: int,
                rope_dim: int, v_dim: int, rope_theta: float = 10000.0,
                absorb: bool = False) -> torch.Tensor:
    """MLA decode over the *compressed* cache (c, k_rope), (B, Smax,
    kv_lora) and (B, Smax, rope), written in place. ``absorb=True`` uses
    the matrix-absorbed form (q projected into latent space; no per-step
    K/V materialization). ``pos`` may be a scalar or a (B,) per-row
    position vector. Over a mesh whose decode rules split the cache's
    sequence, the slice is masked by global position, written by its
    owner only and combined by the split-softmax. Heads split over
    "model" (the rank's share of ``wq_b``, ``wk_b``, ``wv_b``, ``wo``)
    attend against the whole latent cache with the rank's heads, the
    output summed over model (``tp_exit``); where the sequence split
    takes the model axis too, the heads' weights are gathered over model
    first (``decode_head_gather``) and the layer runs whole. Returns y
    (B, 1, d)."""
    B = x.shape[0]
    split = cache_seq_split()
    if (params["wq_b"].shape[1] < n_heads and split is not None
            and "model" in split.axes):
        params = {k: model_whole(v, n_heads, 0 if k == "wo" else 1,
                                 "decode_head_gather")
                  if k in ("wq_b", "wk_b", "wv_b", "wo") else v
                  for k, v in params.items()}
    h_loc = params["wq_b"].shape[1]
    pos = pos_tensor(pos, x.device)
    positions = _decode_positions(pos, B, x.device)
    q_nope, q_rope, c_new, k_rope_new = _mla_qkv(
        params, x, n_heads, nope, rope_dim, positions, rope_theta)
    c_cache, kr_cache = cache
    _cache_write_(c_cache, c_new, pos, split)
    _cache_write_(kr_cache, k_rope_new, pos, split)
    Smax = c_cache.shape[1]
    scale = (nope + rope_dim) ** -0.5
    pos_b = pos[:, None] if pos.ndim else pos
    valid = torch.broadcast_to(
        _kv_positions(Smax, split, x.device) <= pos_b, (B, Smax))
    neg = torch.full((), _NEG, device=x.device)
    if absorb:
        # q_nope (B, 1, H, nope) @ wk_b^T -> latent space (B, 1, H, kv_lora)
        q_lat = torch.einsum("bqhk,lhk->bqhl", q_nope.float(),
                             params["wk_b"].float())
        c32 = c_cache.float()
        logits = (torch.einsum("bqhl,bsl->bqhs", q_lat, c32)
                  + torch.einsum("bqhk,bsk->bqhs", q_rope.float(),
                                 kr_cache.float())) * scale
        logits = torch.where(valid[:, None, None, :], logits, neg)
        o_lat = _weighted_softmax(
            logits, lambda p: torch.einsum("bqhs,bsl->bqhl", p, c32), split)
        out = torch.einsum("bqhl,lhk->bqhk", o_lat,
                           params["wv_b"].float()).to(x.dtype)
    else:
        k_nope = _proj_heads(*_promoted(c_cache, params["wk_b"]))
        v = _proj_heads(*_promoted(c_cache, params["wv_b"]))
        k_rope_h = kr_cache[:, :, None, :].expand(
            kr_cache.shape[:2] + (h_loc, rope_dim))
        k_full = torch.cat(_promoted(k_nope, k_rope_h), dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        logits = torch.einsum("bqhk,bshk->bqhs", q_full.float(),
                              k_full.float()) * scale
        logits = torch.where(valid[:, None, None, :], logits, neg)
        v32 = v.float()
        out = _weighted_softmax(
            logits, lambda p: torch.einsum("bqhs,bshk->bqhk", p, v32),
            split).to(x.dtype)
    y = _out_proj(out, params["wo"])
    return tp_exit(y) if h_loc < n_heads else y


def mla_decode(params, x, cache, pos, **kw):
    """``mla_decode_`` on a copy of the cache. Returns (y, new_cache); the
    old cache is left as it was."""
    new = tuple(c.clone() for c in cache)
    return mla_decode_(params, x, new, pos, **kw), new

