"""Transformer stacks for the zoo: pattern-based block composition.

An architecture is a *pattern* — a short cycle of block kinds repeated over
the depth:

  global    causal full attention + MLP/MoE
  local     causal sliding-window attention + MLP/MoE
  cross     cross-attention to provided memory + MLP      (llama-vision)
  mla       multi-head latent attention + MoE             (deepseek-v2)
  ssm       Mamba2 SSD block (no MLP when d_ff == 0)      (mamba2)
  hybrid    parallel local-attention + SSD heads + MLP    (hymba)
  enc       bidirectional attention + MLP                 (whisper encoder)
  dec_cross causal self-attn + cross-attn + MLP           (whisper decoder)

The MLP part is the MoE MLP (``models/moe.py``) when ``n_experts``; its
auxiliaries are summed over the layers and ``train_loss`` adds them.
``moe_impl="shardmap"`` runs ``models/moe_shardmap.py`` (manual expert
parallelism over "model"; the dense MoE on one device); ``ssd_bf16``
takes the SSD kernels' bf16-tile variant.

Parameters and caches are nested dicts with the JAX package's keys and
layouts (layer-stacked leaves under ``blocks/p{i}_{kind}`` and, for an
encoder-decoder, ``enc_blocks``), so ``convert.params_from_numpy`` carries
either across unchanged. Where the JAX package scans over the stacked
layers, this module loops in Python and indexes the stacked leaves.

Entry points: ``forward`` (prefill / scoring logits), ``train_loss``
(the next-token CE, plus the MoE auxiliaries, that ``Model.loss`` and the
train loop differentiate), ``init_cache`` / ``decode_step`` (serving;
``decode_step_`` writes the cache in place, so a serving loop can capture
it into a CUDA graph). The cross-attention caches (``ck`` / ``cv``) hold
the memory's keys and values; decode reads them and never writes them.
With ``cfg.remat`` and grad mode on, ``forward`` runs each layer cycle
(and each encoder layer) under ``torch.utils.checkpoint``
(non-reentrant). ``remat_policy="full"`` keeps only the cycle's input and
recomputes the rest in the backward, as ``jax.checkpoint`` does in the
reference; ``"dots"`` (``jax.checkpoint_policies.checkpoint_dots``) also
keeps the outputs of the matrix products (``aten.mm``, ``addmm``,
``bmm``: what ``matmul``, ``linear`` and ``einsum`` lower to) through a
selective-checkpoint policy and recomputes everything else, the flash and
SSD kernels' ``Function``s included. The saved products are the values
the recompute would give, so the loss and gradients are bit-equal under
either policy and without remat.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .param import stack_layout
from . import layers as L
from . import attention as A
from . import ssm as SSMOD
from . import moe as MOE
from ..dist.sharding import (active_axis, axis_rules, axis_size,
                             cache_seq_split, current_rules, data_sum,
                             gathered, shard)
from .._device import resolve_device
from .._tree import tree_map

__all__ = ["ArchConfig", "block_layout", "block_apply_full", "model_layout",
           "forward", "train_loss", "init_cache", "decode_step",
           "decode_step_", "cache_max_len", "PORTED_KINDS"]

PORTED_KINDS = ("global", "local", "cross", "mla", "ssm", "hybrid", "enc",
                "dec_cross")

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


# ---------------------------------------------------------------------------
# block layout / apply
# ---------------------------------------------------------------------------

def _check_kind(kind: str):
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; block kinds: "
                         f"{', '.join(PORTED_KINDS)}")


def _shared_ff(cfg: ArchConfig) -> int:
    """The shared experts' hidden width (``moe_layout``'s ``shared_ff``)."""
    return cfg.d_ff * max(cfg.n_shared_experts, 1)


def _mlp_part_layout(cfg: ArchConfig):
    if cfg.d_ff <= 0:
        return {}
    lay = {"mlp_norm": L.norm_layout(cfg.d_model, cfg.norm_kind)}
    if cfg.n_experts:
        lay["moe"] = MOE.moe_layout(
            cfg.d_model, cfg.d_ff, cfg.n_experts,
            n_shared=cfg.n_shared_experts, shared_ff=_shared_ff(cfg),
            expert_sharding=cfg.expert_sharding, mlp_kind=cfg.mlp_kind)
    else:
        lay["mlp"] = L.mlp_layout(cfg.d_model, cfg.d_ff, cfg.mlp_kind)
    return lay


def block_layout(cfg: ArchConfig, kind: str):
    _check_kind(kind)
    d = cfg.d_model
    lay: Dict[str, Any] = {}
    if kind in ("global", "local", "enc", "dec_cross", "hybrid"):
        lay["attn_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["attn"] = A.attn_layout(d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.qkv_bias)
    if kind in ("cross", "dec_cross"):
        lay["cross_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["cross"] = A.cross_attn_layout(d, cfg.n_heads, cfg.head_dim, d)
    if kind == "mla":
        lay["attn_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["mla"] = A.mla_layout(d, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
                                  cfg.qk_nope, cfg.qk_rope, cfg.v_head_dim)
    if kind in ("ssm", "hybrid"):
        lay["ssm_norm"] = L.norm_layout(d, cfg.norm_kind)
        lay["ssm"] = SSMOD.ssm_layout(d, cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_headdim)
    lay.update(_mlp_part_layout(cfg))
    return lay


def _mlp_part_apply(params, x, cfg: ArchConfig, aux_acc):
    """The MLP (or MoE) part; returns (x, aux_acc) with the MoE auxiliaries
    added to ``aux_acc``."""
    if cfg.d_ff <= 0:
        return x, aux_acc
    h = L.norm_apply(params["mlp_norm"], x, cfg.norm_kind, cfg.norm_eps)
    if not cfg.n_experts:
        return x + L.mlp_apply(params["mlp"], h, cfg.mlp_kind,
                               ff=cfg.d_ff), aux_acc
    if cfg.moe_impl == "shardmap" and cfg.expert_sharding == "ep":
        from .moe_shardmap import moe_apply_shardmap
        y, aux = moe_apply_shardmap(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_kind,
            shared_ff=_shared_ff(cfg))
    else:
        y, aux = MOE.moe_apply(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_kind,
            expert_sharding=cfg.expert_sharding, d_ff=cfg.d_ff,
            shared_ff=_shared_ff(cfg))
    aux_acc = {k: aux_acc.get(k, 0.0) + v for k, v in aux.items()}
    return x + y, aux_acc


def block_apply_full(params, x, kind: str, cfg: ArchConfig, positions,
                     memory=None, aux_acc=None):
    """Full-sequence block application (train / prefill). ``memory`` (B,
    Sm, d) feeds the cross-attention kinds. Returns (x, aux_acc): the MoE
    auxiliaries added to ``aux_acc`` ({} when None)."""
    _check_kind(kind)
    x = _mix_part_apply(params, x, kind, cfg, positions, memory)
    return _mlp_part_apply(params, x, cfg,
                           aux_acc if aux_acc is not None else {})


def _mix_part_apply(params, x, kind: str, cfg: ArchConfig, positions,
                    memory=None):
    """The part before the MLP (self attention, cross attention, MLA or
    the SSM), its residual added."""
    common = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.head_dim, positions=positions,
                  rope_theta=cfg.rope_theta, rope_frac=cfg.rope_frac,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                  sliced_window=cfg.sliced_window)
    if kind in ("global", "local", "enc", "dec_cross"):
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.attn_apply(params["attn"], h, causal=(kind != "enc"),
                             window=cfg.window if kind == "local" else 0,
                             **common)
    if kind in ("cross", "dec_cross"):
        h = L.norm_apply(params["cross_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.cross_attn_apply(params["cross"], h, memory,
                                   n_heads=cfg.n_heads,
                                   head_dim=cfg.head_dim,
                                   q_chunk=cfg.q_chunk,
                                   kv_chunk=cfg.kv_chunk)
    if kind == "mla":
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.mla_apply(params["mla"], h, n_heads=cfg.n_heads,
                            nope=cfg.qk_nope, rope_dim=cfg.qk_rope,
                            v_dim=cfg.v_head_dim, positions=positions,
                            rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
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
    return x


# ---------------------------------------------------------------------------
# full-model layout
# ---------------------------------------------------------------------------

def _split_pattern(cfg: ArchConfig):
    p = len(cfg.pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def model_layout(cfg: ArchConfig):
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
    if cfg.encdec:
        lay["enc_blocks"] = stack_layout(block_layout(cfg, "enc"),
                                         cfg.n_enc_layers, "layers")
        lay["enc_norm"] = L.norm_layout(cfg.d_model, cfg.norm_kind)
    return lay


def _layer(tree, i: int):
    """Layer i of a layer-stacked tree (views, no copies). A leaf may also
    be a sequence of per-layer tensors, as the train step splits each
    stacked leaf (``train.loop``)."""
    return tree_map(lambda a: a[i], tree)


# the matrix products that remat "dots" keeps (checkpoint_dots' dot_general)
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg: ArchConfig):
    """How ``forward`` runs each layer cycle (and ``_encode`` each encoder
    layer): ``fn(*args)`` directly, or under the checkpoint of
    ``cfg.remat_policy`` ("full" or "dots"; ValueError otherwise)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return lambda fn, *args: fn(*args)
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: one of "
                         f"\"full\", \"dots\"")
    kw = {} if cfg.remat_policy == "full" else {"context_fn": _dots_context}
    # the recompute runs where the backward runs (on the card, autograd's
    # device thread), so it re-enters the forward's mesh rules: its
    # collectives are the forward's, on every rank
    state = current_rules()

    def under_rules(fn):
        if state is None:
            return fn

        def run(*args):
            with axis_rules(*state):
                return fn(*args)
        return run

    return lambda fn, *args: checkpoint(under_rules(fn), *args,
                                        use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# forward (prefill / scoring)
# ---------------------------------------------------------------------------

def _encode(params, frames, cfg: ArchConfig):
    """Whisper-style encoder over precomputed frame embeddings (B, S, d):
    sinusoidal positions, the ``enc`` stack, the encoder's final norm."""
    B, S = frames.shape[:2]
    x = frames + L.sinusoidal_positions(S, cfg.d_model,
                                        device=frames.device).to(frames.dtype)
    positions = torch.arange(S, device=frames.device).expand(B, S)
    remat = _remat(cfg)

    def layer(x, blk):
        return block_apply_full(gathered(blk), x, "enc", cfg, positions)[0]

    for i in range(cfg.n_enc_layers):
        x = remat(layer, x, _layer(params["enc_blocks"], i))
    return L.norm_apply(gathered(params["enc_norm"]), x, cfg.norm_kind,
                        cfg.norm_eps)


def _zero_aux(cfg: ArchConfig, device):
    """The MoE auxiliaries' starting sums ({} without experts)."""
    if not cfg.n_experts:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss", "dropped_frac")}


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Logits for a full sequence. batch keys: tokens (B, S) [, frames (B,
    S_enc, d) for an encoder-decoder, image_embeds (B, n_img_tokens, d)].
    Returns (logits (B, S, V) in the activation dtype, aux dict: the MoE
    auxiliaries summed over the layers, {} without experts)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    embed = gathered(params["embed"])
    x = L.embed_apply(embed, tokens,
                      scale=np.sqrt(cfg.d_model) if cfg.embed_scale else None,
                      vocab=cfg.vocab_padded)
    if not cfg.rope_theta:  # absolute sinusoidal positions
        x = x + L.sinusoidal_positions(S, cfg.d_model,
                                       device=x.device).to(x.dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    memory = None
    if cfg.encdec:
        memory = _encode(params, batch["frames"], cfg)
    elif cfg.n_img_tokens:
        memory = batch["image_embeds"]
    x = shard(x, "batch", "seq", "embed")
    aux = _zero_aux(cfg, x.device)
    cycles, rem = _split_pattern(cfg)
    remat = _remat(cfg)
    def cycle(x, aux, cyc):
        # the cycle's weights enter as its arguments and are gathered here,
        # so under remat they are not kept past the cycle: the backward's
        # recompute gathers them again
        for i, kind in enumerate(cfg.pattern):
            x, aux = block_apply_full(gathered(cyc[f"p{i}_{kind}"]), x, kind,
                                      cfg, positions, memory=memory,
                                      aux_acc=aux)
        return x, aux

    for c in range(cycles):
        cyc = {f"p{i}_{kind}": _layer(params["blocks"][f"p{i}_{kind}"], c)
               for i, kind in enumerate(cfg.pattern)}
        x, aux = remat(cycle, x, aux, cyc)
    for r in range(rem):
        kind = cfg.pattern[r]
        x, aux = block_apply_full(gathered(params[f"rem{r}_{kind}"]), x,
                                  kind, cfg, positions, memory=memory,
                                  aux_acc=aux)
    x = L.norm_apply(gathered(params["final_norm"]), x, cfg.norm_kind,
                     cfg.norm_eps)
    table = embed if cfg.tie_embeddings else gathered(params["unembed"])
    return L.unembed_apply(table, x, true_vocab=cfg.vocab,
                           vocab=cfg.vocab_padded), aux


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Mean next-token CE in f32: logsumexp of the logits minus the label
    logit, labels (B, S) of -1 ignored; with experts, plus 0.01 lb_loss +
    1e-3 z_loss. Returns (loss, metrics): {"ce": ce} and, with experts, the
    MoE auxiliaries. The label logit is a gather where the reference takes
    a one-hot product (the same function).

    Under a mesh (``dist.sharding.axis_rules``) each rank holds its rows
    of the batch: the loss is this rank's part of the global one (its
    tokens' CE over the global label count, one no-gradient SUM over data,
    ``dp_count``; the MoE auxiliaries over the data size), which the
    sharded step sums over data; with the vocab split over "model" the CE
    is ``layers.vocab_parallel_ce``."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.float()
    if lf.shape[-1] < cfg.vocab_padded:
        tok_ce = L.vocab_parallel_ce(lf, labels)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        take = lf.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
        tok_ce = lse - take
    mask = (labels >= 0).float()
    count = data_sum(mask.sum(), "dp_count")
    ce = (tok_ce * mask).sum() / count.clamp(min=1.0)
    loss, metrics = ce, {"ce": ce}
    if cfg.n_experts:
        dp = _data_ways()
        loss = loss + (0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]) / dp
        metrics.update(aux)
    return loss, metrics


def _data_ways() -> int:
    mesh = active_axis("data")
    return 1 if mesh is None else axis_size(mesh, "data")


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def _block_cache_shape(cfg: ArchConfig, kind: str, B: int, Smax: int,
                       dtype, device) -> Dict[str, Any]:
    hd = cfg.head_dim
    kv = lambda: torch.zeros((B, Smax, cfg.n_kv_heads, hd), dtype=dtype,
                             device=device)
    mem = lambda m: torch.zeros((B, m, cfg.n_heads, hd), dtype=dtype,
                                device=device)
    if kind in ("global", "local"):
        return {"k": kv(), "v": kv()}
    if kind == "dec_cross":
        return {"k": kv(), "v": kv(), "ck": mem(cfg.enc_seq),
                "cv": mem(cfg.enc_seq)}
    if kind == "cross":
        return {"ck": mem(cfg.n_img_tokens), "cv": mem(cfg.n_img_tokens)}
    if kind == "mla":
        return {"c": torch.zeros((B, Smax, cfg.kv_lora), dtype=dtype,
                                 device=device),
                "kr": torch.zeros((B, Smax, cfg.qk_rope), dtype=dtype,
                                  device=device)}
    if kind == "ssm":
        return SSMOD.ssm_init_cache(B, cfg.d_inner, cfg.ssm_state,
                                    cfg.ssm_headdim, dtype, device)
    if kind == "hybrid":
        c = SSMOD.ssm_init_cache(B, cfg.d_inner, cfg.ssm_state,
                                 cfg.ssm_headdim, dtype, device)
        c["k"], c["v"] = kv(), kv()
        return c
    raise ValueError(kind)


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


def _block_decode_(params, x, kind: str, cfg: ArchConfig, cache, pos):
    """One block's decode step; ``cache`` (the block's leaves, views of the
    stacked ones) is written in place, except the cross-attention caches
    ``ck`` / ``cv``, which it only reads."""
    _check_kind(kind)
    if kind in ("global", "local", "dec_cross", "hybrid"):
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        y = A.attn_decode_(
            params["attn"], h, (cache["k"], cache["v"]), pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            window=cfg.window if kind in ("local", "hybrid") else 0,
            rope_theta=cfg.rope_theta, rope_frac=cfg.rope_frac)
        if kind == "hybrid":
            hs = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind,
                              cfg.norm_eps)
            y2 = SSMOD.ssd_decode_(params["ssm"], hs, cache,
                                   headdim=cfg.ssm_headdim)
            x = x + 0.5 * (y + y2)
        else:
            x = x + y
    if kind in ("cross", "dec_cross"):
        h = L.norm_apply(params["cross_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.cross_decode(params["cross"], h, cache["ck"], cache["cv"],
                               n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    if kind == "mla":
        h = L.norm_apply(params["attn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + A.mla_decode_(params["mla"], h, (cache["c"], cache["kr"]),
                              pos, n_heads=cfg.n_heads, nope=cfg.qk_nope,
                              rope_dim=cfg.qk_rope, v_dim=cfg.v_head_dim,
                              rope_theta=cfg.rope_theta,
                              absorb=cfg.mla_absorb)
    if kind == "ssm":
        h = L.norm_apply(params["ssm_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + SSMOD.ssd_decode_(params["ssm"], h, cache,
                                  headdim=cfg.ssm_headdim)
    return _mlp_part_apply(params, x, cfg, {})[0]


@functools.lru_cache(maxsize=16)
def _position_table(S: int, d: int, device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions(S, d)`` on ``device``, copied there once: a
    host-to-device copy inside a decode step would stall the stream and
    cannot be captured into a CUDA graph."""
    return L.sinusoidal_positions(S, d, device=device)


def decode_step_(params, cache, tokens, pos, cfg: ArchConfig):
    """One serving step that writes ``cache`` in place: tokens (B, 1) int at
    position ``pos`` — a scalar (the whole batch at one depth) or a (B,)
    vector of per-row positions. Each layer updates views of the stacked
    cache leaves. Returns the logits (B, 1, V) in the activation dtype.
    With ``pos`` a tensor on the cache's device it never waits for the
    device, so a CUDA graph can capture it.

    Under a mesh (``launch.steps.build_decode_step``, inside its
    ``axis_rules``) the tree and cache are this rank's: its rows, its
    vocab rows of the embedding (looked up and summed over model, the
    logits its vocab columns), its pieces of the cache (``pos`` global;
    see ``models.attention`` and ``models.ssm`` for the sequence-, head-
    and width-split layers); each layer gathers its weights over data on
    entry (``dist.sharding.gathered``)."""
    embed = gathered(params["embed"])
    x = L.embed_apply(embed, tokens,
                      scale=np.sqrt(cfg.d_model) if cfg.embed_scale else None,
                      vocab=cfg.vocab_padded)
    pos = A.pos_tensor(pos, x.device)        # once, not at every layer
    if not cfg.rope_theta:
        split = cache_seq_split()             # the whole sequence's length
        table = _position_table(
            cache_max_len(cache, cfg, 1 if split is None else split.ways),
            cfg.d_model, x.device)
        if pos.ndim:                      # per-row absolute positions
            x = x + table[pos].to(x.dtype)[:, None]
        else:                             # clamped, as dynamic_slice does
            i = pos.clamp(0, table.shape[0] - 1).reshape(1)
            x = x + table[i].to(x.dtype)[None]    # a gather: no host read
    cycles, rem = _split_pattern(cfg)
    for c in range(cycles):
        for i, kind in enumerate(cfg.pattern):
            key = f"p{i}_{kind}"
            x = _block_decode_(gathered(_layer(params["blocks"][key], c)),
                               x, kind, cfg, _layer(cache["blocks"][key], c),
                               pos)
    for r in range(rem):
        kind = cfg.pattern[r]
        key = f"rem{r}_{kind}"
        x = _block_decode_(gathered(params[key]), x, kind, cfg, cache[key],
                           pos)
    x = L.norm_apply(gathered(params["final_norm"]), x, cfg.norm_kind,
                     cfg.norm_eps)
    table = embed if cfg.tie_embeddings else gathered(params["unembed"])
    return L.unembed_apply(table, x, true_vocab=cfg.vocab,
                           vocab=cfg.vocab_padded)


def decode_step(params, cache, tokens, pos, cfg: ArchConfig):
    """``decode_step_`` on a copy of the cache. Returns (logits (B, 1, V) in
    the activation dtype, new_cache); the old cache is left as it was."""
    new_cache = tree_map(torch.clone, cache)
    return decode_step_(params, new_cache, tokens, pos, cfg), new_cache


def cache_max_len(cache, cfg: ArchConfig, ways: int = 1) -> int:
    """Max sequence capacity of the self-attention caches (for absolute
    position tables): the 'k' leaves are (cycles, B, Smax, ...) stacked or
    (B, Smax, ...) as a remainder block; a rank's slices of a sequence
    split ``ways`` ways over a mesh hold 1 / ways of it."""
    dims = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "k":
                dims.append(v.shape[-3] * ways)

    walk(cache)
    return max(dims) if dims else cfg.enc_seq
