"""Transformer stacks for the zoo: pattern-based block composition.

An architecture is a *pattern* — a short cycle of block kinds repeated over
the depth. Ported kinds:

  global    causal full attention + MLP
  local     causal sliding-window attention + MLP
  ssm       Mamba2 SSD block (no MLP when d_ff == 0)      (mamba2)
  hybrid    parallel local-attention + SSD heads + MLP    (hymba)

Not ported yet (ROADMAP queue A item 6; they raise NotImplementedError):
``cross`` (llama-vision), ``mla`` (deepseek-v2), ``enc`` / ``dec_cross``
and the encoder (whisper), and the MoE MLP (mixtral, deepseek-v2).

Parameters and caches are nested dicts with the JAX package's keys and
layouts (layer-stacked leaves under ``blocks/p{i}_{kind}``), so
``convert.params_from_numpy`` carries either across unchanged. Where the
JAX package scans over the stacked layers, this module loops in Python and
indexes the stacked leaves.

Entry points: ``forward`` (prefill / scoring logits), ``init_cache`` /
``decode_step`` (serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .param import stack_layout
from . import layers as L
from . import attention as A
from . import ssm as SSMOD
from .._device import resolve_device
from .._tree import tree_map

__all__ = ["ArchConfig", "block_layout", "block_apply_full", "model_layout",
           "forward", "init_cache", "decode_step", "cache_max_len",
           "PORTED_KINDS"]

PORTED_KINDS = ("global", "local", "ssm", "hybrid")

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | hybrid | vlm | audio | ssm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("global",)
    window: int = 0                 # sliding window for "local"/"hybrid"
    mlp_kind: str = "swiglu"        # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_frac: float = 1.0
    embed_scale: bool = False       # gemma: embeddings * sqrt(d)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"     # ep | tp
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    # enc-dec / cross
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500             # whisper encoder length for decode cells
    n_img_tokens: int = 0           # vlm stub memory length
    # runtime
    norm_eps: float = 1e-6
    q_chunk: int = 512
    kv_chunk: int = 512
    remat: bool = True
    # perf levers (§Perf; default off = paper-faithful/naive baseline)
    sliced_window: bool = False     # O(S*window) lowering for local attn
    mla_absorb: bool = False        # matrix-absorbed MLA decode
    ssd_bf16: bool = False          # bf16 SSD tile intermediates
    moe_impl: str = "gspmd"         # gspmd | shardmap (manual EP)
    remat_policy: str = "full"      # full (save nothing) | dots
    # sharding nuances: logical-rule overrides for dims that do not divide
    # the mesh (e.g. 25 heads, vocab 32001) — ("heads", None) replicates.
    rules_overrides: Tuple = ()
    # paper integration: structured-sparsity constraint specs
    projection_specs: Tuple = ()

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 (pad logits are masked)."""
        return -(-self.vocab // 128) * 128

    # None -> derive from the pattern; explicit override for mixed patterns
    # (gemma3: 5 local : 1 global still qualifies for long-context serving)
    long_context_capable: Optional[bool] = None

    def sub_quadratic(self) -> bool:
        if self.long_context_capable is not None:
            return self.long_context_capable
        kinds = set(self.pattern)
        return kinds <= {"local", "ssm", "hybrid"} or "ssm" in kinds


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue A item 6); "
        f"ported block kinds: {', '.join(PORTED_KINDS)}, dense MLP")


# ---------------------------------------------------------------------------
# block layout / apply
# ---------------------------------------------------------------------------

def _mlp_part_layout(cfg: ArchConfig):
    if cfg.d_ff <= 0:
        return {}
    if cfg.n_experts:
        raise _unported("the MoE MLP")
    return {"mlp_norm": L.norm_layout(cfg.d_model, cfg.norm_kind),
            "mlp": L.mlp_layout(cfg.d_model, cfg.d_ff, cfg.mlp_kind)}


def block_layout(cfg: ArchConfig, kind: str):
    if kind not in PORTED_KINDS:
        raise _unported(f"block kind {kind!r}")
    d = cfg.d_model
    lay: Dict[str, Any] = {}
    if kind in ("global", "local", "hybrid"):
        lay["attn_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["attn"] = A.attn_layout(d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.qkv_bias)
    if kind in ("ssm", "hybrid"):
        lay["ssm_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["ssm"] = SSMOD.ssm_layout(d, cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_headdim)
    lay.update(_mlp_part_layout(cfg))
    return lay


def _mlp_part_apply(params, x, cfg: ArchConfig):
    if cfg.d_ff <= 0:
        return x
    h = L.norm_apply(params["mlp_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_kind)


def block_apply_full(params, x, kind: str, cfg: ArchConfig, positions):
    """Full-sequence block application (prefill / scoring)."""
    if kind not in PORTED_KINDS:
        raise _unported(f"block kind {kind!r}")
    common = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.head_dim, positions=positions,
                  rope_theta=cfg.rope_theta, rope_frac=cfg.rope_frac,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                  sliced_window=cfg.sliced_window)
    if kind in ("global", "local"):
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.attn_apply(params["attn"], h, causal=True,
                             window=cfg.window if kind == "local" else 0,
                             **common)
    if kind == "ssm":
        h = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + SSMOD.ssd_apply(params["ssm"], h, headdim=cfg.ssm_headdim,
                                chunk=cfg.ssm_chunk, tile_bf16=cfg.ssd_bf16)
    if kind == "hybrid":
        # both branches read the same x: ssm_norm(x) and attn_norm(x)
        h = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind, cfg.norm_eps)
        y_ssm = SSMOD.ssd_apply(params["ssm"], h, headdim=cfg.ssm_headdim,
                                chunk=cfg.ssm_chunk, tile_bf16=cfg.ssd_bf16)
        ha = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        y_attn = A.attn_apply(params["attn"], ha, causal=True,
                              window=cfg.window, **common)
        x = x + 0.5 * (y_ssm + y_attn)
    return _mlp_part_apply(params, x, cfg)


# ---------------------------------------------------------------------------
# full-model layout
# ---------------------------------------------------------------------------

def _split_pattern(cfg: ArchConfig):
    p = len(cfg.pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def model_layout(cfg: ArchConfig):
    if cfg.encdec:
        raise _unported("the encoder-decoder stack")
    cycles, rem = _split_pattern(cfg)
    lay: Dict[str, Any] = {
        "embed": L.embed_layout(cfg.vocab_padded, cfg.d_model)}
    if cycles:
        lay["blocks"] = {
            f"p{i}_{kind}": stack_layout(block_layout(cfg, kind), cycles,
                                         "layers")
            for i, kind in enumerate(cfg.pattern)}
    for r in range(rem):
        lay[f"rem{r}_{cfg.pattern[r]}"] = block_layout(cfg, cfg.pattern[r])
    lay["final_norm"] = L.norm_layout(cfg.d_model, cfg.norm_kind)
    if not cfg.tie_embeddings:
        lay["unembed"] = L.embed_layout(cfg.vocab_padded, cfg.d_model)
    return lay


def _layer(tree, i: int):
    """Layer i of a layer-stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def _blocks(params, cfg: ArchConfig):
    """(key, kind, layer params) for every layer, in depth order."""
    cycles, rem = _split_pattern(cfg)
    for c in range(cycles):
        for i, kind in enumerate(cfg.pattern):
            key = f"p{i}_{kind}"
            yield key, kind, _layer(params["blocks"][key], c)
    for r in range(rem):
        kind = cfg.pattern[r]
        yield f"rem{r}_{kind}", kind, params[f"rem{r}_{kind}"]


# ---------------------------------------------------------------------------
# forward (prefill / scoring)
# ---------------------------------------------------------------------------

def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Logits for a full sequence. batch keys: tokens (B, S). Returns
    (logits (B, S, V) in the activation dtype, aux dict — empty: no ported
    block reports auxiliary losses)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(params["embed"], tokens,
                      scale=np.sqrt(cfg.d_model) if cfg.embed_scale else None)
    if not cfg.rope_theta:  # absolute sinusoidal positions
        x = x + L.sinusoidal_positions(S, cfg.d_model,
                                       device=x.device).to(x.dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for _, kind, blk in _blocks(params, cfg):
        x = block_apply_full(blk, x, kind, cfg, positions)
    x = L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(table, x, true_vocab=cfg.vocab), {}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def _block_cache_shape(cfg: ArchConfig, kind: str, B: int, Smax: int,
                       dtype, device) -> Dict[str, Any]:
    hd = cfg.head_dim
    kv = lambda: torch.zeros((B, Smax, cfg.n_kv_heads, hd), dtype=dtype,
                             device=device)
    if kind in ("global", "local"):
        return {"k": kv(), "v": kv()}
    if kind == "ssm":
        return SSMOD.ssm_init_cache(B, cfg.d_inner, cfg.ssm_state,
                                    cfg.ssm_headdim, dtype, device)
    if kind == "hybrid":
        c = SSMOD.ssm_init_cache(B, cfg.d_inner, cfg.ssm_state,
                                 cfg.ssm_headdim, dtype, device)
        c["k"], c["v"] = kv(), kv()
        return c
    raise _unported(f"block kind {kind!r}")


def init_cache(cfg: ArchConfig, B: int, Smax: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed decode cache tree (stacked per pattern position) on
    ``device`` (the card when None)."""
    dev = resolve_device(device)
    cycles, rem = _split_pattern(cfg)

    def stacked(kind):
        one = _block_cache_shape(cfg, kind, B, Smax, dtype, dev)
        return tree_map(lambda a: torch.zeros((cycles,) + tuple(a.shape),
                                              dtype=a.dtype, device=dev), one)

    cache: Dict[str, Any] = {}
    if cycles:
        cache["blocks"] = {f"p{i}_{kind}": stacked(kind)
                           for i, kind in enumerate(cfg.pattern)}
    for r in range(rem):
        cache[f"rem{r}_{cfg.pattern[r]}"] = _block_cache_shape(
            cfg, cfg.pattern[r], B, Smax, dtype, dev)
    return cache


def _block_decode(params, x, kind: str, cfg: ArchConfig, cache, pos):
    if kind not in PORTED_KINDS:
        raise _unported(f"block kind {kind!r}")
    if kind in ("global", "local", "hybrid"):
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        y, (k, v) = A.attn_decode(
            params["attn"], h, (cache["k"], cache["v"]), pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            window=cfg.window if kind in ("local", "hybrid") else 0,
            rope_theta=cfg.rope_theta, rope_frac=cfg.rope_frac)
        cache = {**cache, "k": k, "v": v}
        if kind == "hybrid":
            hs = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind,
                              cfg.norm_eps)
            ssm_cache = {k2: cache[k2] for k2 in
                         ("state", "conv_x", "conv_B", "conv_C")}
            y2, new_ssm = SSMOD.ssd_decode(params["ssm"], hs, ssm_cache,
                                           headdim=cfg.ssm_headdim)
            cache = {**cache, **new_ssm}
            x = x + 0.5 * (y + y2)
        else:
            x = x + y
    if kind == "ssm":
        h = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind, cfg.norm_eps)
        y, new_ssm = SSMOD.ssd_decode(params["ssm"], h, cache,
                                      headdim=cfg.ssm_headdim)
        cache = {**cache, **new_ssm}
        x = x + y
    return _mlp_part_apply(params, x, cfg), cache


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One serving step: tokens (B, 1) int at position ``pos`` — a scalar
    (the whole batch at one depth) or a (B,) vector of per-row positions.
    Returns (logits (B, 1, V) in the activation dtype, new_cache); the old
    cache is left as it was."""
    x = L.embed_apply(params["embed"], tokens,
                      scale=np.sqrt(cfg.d_model) if cfg.embed_scale else None)
    pos = A.pos_tensor(pos, x.device)        # once, not at every layer
    if not cfg.rope_theta:
        table = L.sinusoidal_positions(cache_max_len(cache, cfg),
                                       cfg.d_model, device=x.device)
        pos_a = pos
        if pos_a.ndim:                    # per-row absolute positions
            x = x + table[pos_a].to(x.dtype)[:, None]
        else:                             # clamped, as dynamic_slice does
            i = pos_a.clamp(0, table.shape[0] - 1)
            x = x + table[i].to(x.dtype)[None, None]
    cycles, rem = _split_pattern(cfg)
    per_layer: Dict[str, list] = {}
    new_cache: Dict[str, Any] = {}
    for c in range(cycles):
        for i, kind in enumerate(cfg.pattern):
            key = f"p{i}_{kind}"
            x, blk_cache = _block_decode(
                _layer(params["blocks"][key], c), x, kind, cfg,
                _layer(cache["blocks"][key], c), pos)
            per_layer.setdefault(key, []).append(blk_cache)
    if cycles:
        new_cache["blocks"] = {
            key: tree_map(lambda *ls: torch.stack(ls), *caches)
            for key, caches in per_layer.items()}
    for r in range(rem):
        kind = cfg.pattern[r]
        key = f"rem{r}_{kind}"
        x, new_cache[key] = _block_decode(params[key], x, kind, cfg,
                                          cache[key], pos)
    x = L.norm_apply(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(table, x, true_vocab=cfg.vocab), new_cache


def cache_max_len(cache, cfg: ArchConfig) -> int:
    """Max sequence capacity of the self-attention caches (for absolute
    position tables): the 'k' leaves are (cycles, B, Smax, ...) stacked or
    (B, Smax, ...) as a remainder block."""
    dims = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "k":
                dims.append(v.shape[-3])

    walk(cache)
    return max(dims) if dims else cfg.enc_seq
