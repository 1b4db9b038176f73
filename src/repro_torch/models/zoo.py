"""Architecture zoo: build models from ArchConfig.

``SHAPES`` are the assigned input-shape cells; ``input_specs`` returns
every model input of a cell as ``meta`` tensors, nothing allocated (the
dry-run's, with ``Model.abstract_params``), and ``make_batch``
materializes small real batches for smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from .transformer import (ArchConfig, model_layout, forward, train_loss,
                          init_cache, decode_step, decode_step_)
from .param import abstract, materialize, count_params, partition_specs

__all__ = ["SHAPES", "cell_supported", "input_specs", "make_batch", "Model",
           "build", "reduce_config"]

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    dict(seq=4096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524288, batch=1,   kind="decode"),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic-attention archs."""
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return False, ("pure full-attention arch: long_500k skipped per "
                       "assignment (needs sub-quadratic attention)")
    return True, ""


def input_specs(cfg: ArchConfig, shape_name: str,
                dtype: torch.dtype = torch.bfloat16):
    """Every input of the (arch, shape) cell as ``meta`` tensors, nothing
    allocated: train / prefill a batch dict (tokens, labels for train,
    frames, image_embeds); decode {"tokens" (B, 1), "pos" (), "cache"}.
    Token ids and positions are int32, as the reference's specs."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    i32 = torch.int32
    if sh["kind"] in ("train", "prefill"):
        batch = {"tokens": meta((B, S), i32)}
        if sh["kind"] == "train":
            batch["labels"] = meta((B, S), i32)
        if cfg.encdec:
            batch["frames"] = meta((B, S, cfg.d_model), dtype)
        if cfg.n_img_tokens:
            batch["image_embeds"] = meta((B, cfg.n_img_tokens, cfg.d_model),
                                         dtype)
        return batch
    return {"tokens": meta((B, 1), i32), "pos": meta((), i32),
            "cache": init_cache(cfg, B, S, dtype, device="meta")}


def make_batch(cfg: ArchConfig, B: int, S: int, *,
               generator: Optional[torch.Generator] = None, kind="train",
               dtype=torch.float32, device=None):
    """Small real batch on ``device`` (the card when None): tokens (B, S)
    [, labels (B, S) for kind="train"][, frames, image_embeds]."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                     generator=generator, device=dev)}
    if kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab, (B, S),
                                        generator=generator, device=dev)
    if cfg.encdec:
        batch["frames"] = torch.randn((B, S, cfg.d_model),
                                      generator=generator, dtype=dtype,
                                      device=dev)
    if cfg.n_img_tokens:
        batch["image_embeds"] = torch.randn(
            (B, cfg.n_img_tokens, cfg.d_model), generator=generator,
            dtype=dtype, device=dev)
    return batch


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    layout: Any

    def abstract_params(self, dtype: torch.dtype = torch.bfloat16):
        """The params as ``meta`` tensors (``param.abstract``)."""
        return abstract(self.layout, dtype)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """Initialized params on ``device`` (the card when None)."""
        return materialize(generator, self.layout, dtype, device)

    def param_specs(self, rules: dict):
        """The ``Spec`` of every leaf under ``rules`` (no divisibility
        check; ``launch.steps.param_shardings`` fits them to a mesh)."""
        return partition_specs(self.layout, rules)

    def n_params(self) -> int:
        return count_params(self.layout)

    # functional entry points
    def loss(self, params, batch):
        """(loss, metrics): the mean next-token CE, plus 0.01 lb_loss +
        1e-3 z_loss with experts; metrics {"ce"} and, with experts, the
        MoE auxiliaries. batch: tokens, labels [, frames, image_embeds]."""
        return train_loss(params, batch, self.cfg)

    def forward(self, params, batch):
        return forward(params, batch, self.cfg)

    def init_cache(self, B, Smax, dtype=torch.bfloat16, device=None):
        return init_cache(self.cfg, B, Smax, dtype, device)

    def decode(self, params, cache, tokens, pos):
        """(logits, new_cache); ``cache`` is left as it was."""
        return decode_step(params, cache, tokens, pos, self.cfg)

    def decode_(self, params, cache, tokens, pos):
        """Logits; ``cache`` is written in place."""
        return decode_step_(params, cache, tokens, pos, self.cfg)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg, layout=model_layout(cfg))


def reduce_config(cfg: ArchConfig, **over) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    n_layers = max(len(cfg.pattern), 2 if len(cfg.pattern) == 1 else len(cfg.pattern))
    red = dict(
        n_layers=over.pop("n_layers", n_layers),
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=128,
        d_ff=0 if cfg.d_ff == 0 else 128,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        q_lora=32 if cfg.q_lora else 0,
        kv_lora=16 if cfg.kv_lora else 0,
        qk_nope=16 if cfg.qk_nope else 0,
        qk_rope=8 if cfg.qk_rope else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        ssm_headdim=8 if cfg.ssm_state else 64,
        ssm_chunk=8 if cfg.ssm_state else 64,
        n_enc_layers=2 if cfg.encdec else 0,
        enc_seq=16,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        q_chunk=16, kv_chunk=16, remat=False,
    )
    if cfg.q_lora:  # MLA family: heads decoupled from head_dim
        red.update(n_heads=4, n_kv_heads=4)
    red.update(over)
    return dataclasses.replace(cfg, **red)
