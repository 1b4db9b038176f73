"""One block's backward on the card held against the same backward on the
CPU.

``block_backward_check`` builds one block of a config at full width (the
model's own init, ``materialize`` of ``block_layout``), feeds the same
input x (B, S, d_model), for the cross-attention kinds the same memory
(B, Sm, d_model), and the same upstream gradient g to ``block_apply_full``
on the card and on CPU copies, and takes every parameter's, the input's and
the memory's gradient with ``torch.autograd.grad(..., grad_outputs=g)``.
No loss, embedding or other layer stands between the gradients and the
block, so no depth amplifies the f32 rounding (ROADMAP C-5) and every leaf
is compared, not only the unembedding and the final norm: a fault in the
glue around a kernel (``SSDFunction``, ``FlashAttentionFunction``, the
zero-padded head dims, MLA's zero-padded v) moves some leaf's gradient far
beyond the rounding.

The tolerance is a noise floor measured in the same run: a third backward
on the card, from the params multiplied by (1 + perturb * N(0, 1)) (about
ten f32 ulps at perturb 1e-6), moves each gradient by its floor. In bf16
(params, input, memory and upstream gradient all bf16, as a bf16 model
runs the block) the floor is taken at bf16's scale: perturb 2^-8, about
one bf16 ulp of each parameter. The card
and the CPU compute the same sums in other orders, a rounding of the same
size, so a gradient passes when its card-vs-CPU distance is within
``FLOOR_FACTOR`` times its floor; the factor covers the floor's own spread
from one draw of the noise to the next.

A block with a MoE MLP routes each token to its top-k experts, a choice
that rounding can flip where two gates nearly tie: a real discontinuity,
not rounding. So the three runs' routing (each token's experts and the
capacity keep mask, from the router on the MLP's own input) must be equal
before any gradient is compared; if it is not, the check fails and
reports the smallest gap between a token's k-th and (k+1)-th gate.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._tree import flatten_with_path, tree_map
from . import layers as L
from .moe import _route
from .param import materialize
from .transformer import (ArchConfig, _mix_part_apply, _mlp_part_apply,
                          block_layout)

__all__ = ["FLOOR_FACTOR", "PERTURB", "block_backward_check", "memory_len"]

FLOOR_FACTOR = 2.0
# the noise floor's relative parameter perturbation, by the block's dtype
PERTURB = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}


def memory_len(cfg: ArchConfig, kind: str) -> int:
    """The memory length a cross-attention kind attends to in the model
    (whisper's encoder positions, llama-vision's image tokens); 0 for a
    kind with no memory."""
    return {"dec_cross": cfg.enc_seq, "cross": cfg.n_img_tokens}.get(kind, 0)


def _routing(params, x, cfg: ArchConfig):
    """The routing of the block's MoE MLP on x, the residual it reads
    (None without experts): {"idx": (T, k) experts sorted ascending,
    "keep": the sorted assignments' keep mask, "min_gap": the smallest gap
    between a token's k-th and (k+1)-th router probability (None when
    every expert is chosen)}."""
    if not cfg.n_experts or cfg.d_ff <= 0:
        return None
    with torch.no_grad():
        h = L.norm_apply(params["mlp_norm"], x, cfg.norm_kind, cfg.norm_eps)
        _, probs, _, idx, _, _, keep, _ = _route(
            params["moe"], h.reshape(-1, h.shape[-1]), cfg.n_experts,
            cfg.top_k, cfg.capacity_factor, True)
        gap = None
        if cfg.top_k < cfg.n_experts:
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            gap = float((top[:, -2] - top[:, -1]).min())
        return {"idx": idx.sort(dim=-1).values.cpu(), "keep": keep.cpu(),
                "min_gap": gap}


def _grads(params, x, mem, g, kind: str, cfg: ArchConfig):
    """({path: gradient} of every param leaf, of the input ("x") and of the
    memory ("memory"), the MoE MLP's routing or None). The block runs as
    ``block_apply_full`` does: its mixing part, then its MLP part."""
    flat = flatten_with_path(params)
    names = [p for p, _ in flat] + ["x"]
    leaves = [t.detach().requires_grad_() for _, t in flat]
    xs = x.detach().requires_grad_()
    inputs = leaves + [xs]
    ms = None
    if mem is not None:
        ms = mem.detach().requires_grad_()
        names.append("memory")
        inputs.append(ms)
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device).expand(x.shape[0], S)
    xm = _mix_part_apply(p, xs, kind, cfg, pos, memory=ms)
    y, _ = _mlp_part_apply(p, xm, cfg, {})
    got = torch.autograd.grad(y, inputs, grad_outputs=g)
    return dict(zip(names, got)), _routing(p, xm, cfg)


def _same_routing(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return torch.equal(a["idx"], b["idx"]) and torch.equal(a["keep"],
                                                           b["keep"])


def block_backward_check(cfg: ArchConfig, kind: str, card, *, batch: int = 1,
                         seq: int = 2048, seed: int = 0,
                         perturb: Optional[float] = None,
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, Any]:
    """One ``kind`` block of ``cfg`` in ``dtype`` (f32 or bf16), its
    backward on ``card`` and on the CPU; a cross-attention kind attends to
    a memory of ``memory_len`` positions; ``perturb`` defaults to
    ``PERTURB[dtype]``. Returns {"ok", "leaves": {path:
    {max_abs_diff, noise_floor, scale, over_floor}}, "failed": [paths],
    "routing_equal", "min_gate_gap"}; the routing must be equal in all
    three runs, and every gradient finite and within ``FLOOR_FACTOR``
    times its noise floor of the CPU's."""
    perturb = PERTURB[dtype] if perturb is None else perturb
    gen = torch.Generator(device=card).manual_seed(seed)
    params = materialize(gen, block_layout(cfg, kind), dtype, card)
    rng = np.random.default_rng(seed)
    shape = (batch, seq, cfg.d_model)
    draw = lambda s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(dtype)
    x, g = draw(shape), draw(shape)
    n_mem = memory_len(cfg, kind)
    mem = draw((batch, n_mem, cfg.d_model)) if n_mem else None
    on = lambda t: None if t is None else t.to(card)
    on_card, r_card = _grads(params, on(x), on(mem), on(g), kind, cfg)
    noise = torch.Generator(device=card).manual_seed(seed + 1)
    pert = tree_map(lambda a: (a.float() * (1 + perturb * torch.randn(
        a.shape, generator=noise, device=card))).to(dtype), params)
    moved, r_moved = _grads(pert, on(x), on(mem), on(g), kind, cfg)
    del pert
    host, r_host = _grads(tree_map(lambda a: a.to("cpu"), params), x, mem,
                          g, kind, cfg)
    routing_equal = (_same_routing(r_card, r_host)
                     and _same_routing(r_card, r_moved))
    gaps = [r["min_gap"] for r in (r_card, r_host, r_moved)
            if r is not None and r["min_gap"] is not None]
    rows, failed = {}, []
    for path, got in on_card.items():
        got, want = got.float(), host[path].to(card).float()
        diff = float((got - want).abs().max())
        floor = float((moved[path].float() - got).abs().max())
        finite = bool(torch.isfinite(got).all())
        rows[path] = {"max_abs_diff": diff, "noise_floor": floor,
                      "scale": float(want.abs().max()),
                      "over_floor": diff / floor if floor > 0 else (
                          0.0 if diff == 0 else float("inf")),
                      "finite": finite}
        if not (finite and diff <= FLOOR_FACTOR * floor):
            failed.append(path)
    if not routing_equal:
        failed.insert(0, "routing")
    return {"ok": not failed, "leaves": rows, "failed": failed,
            "routing_equal": routing_equal,
            "min_gate_gap": min(gaps) if gaps else None}
