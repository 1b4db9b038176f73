"""One block's backward on the card held against the same backward on the
CPU.

``block_backward_check`` builds one block of a config at full width (the
model's own init, ``materialize`` of ``block_layout``), feeds the same
input x (B, S, d_model) and the same upstream gradient g to
``block_apply_full`` on the card and on CPU copies, and takes every
parameter's and the input's gradient with ``torch.autograd.grad(...,
grad_outputs=g)``. No loss, embedding or other layer stands between the
gradients and the block, so no depth amplifies the f32 rounding (ROADMAP
C-5) and every leaf is compared, not only the unembedding and the final
norm: a fault in the glue around a kernel (``SSDFunction``,
``FlashAttentionFunction``, the zero-padded head dims) moves some leaf's
gradient far beyond the rounding.

The tolerance is a noise floor measured in the same run: a third backward
on the card, from the params multiplied by (1 + perturb * N(0, 1)) (about
ten f32 ulps at perturb 1e-6), moves each gradient by its floor. The card
and the CPU compute the same sums in other orders, a rounding of the same
size, so a gradient passes when its card-vs-CPU distance is within
``FLOOR_FACTOR`` times its floor; the factor covers the floor's own spread
from one draw of the noise to the next.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._tree import flatten_with_path, tree_map
from .param import materialize
from .transformer import ArchConfig, block_apply_full, block_layout

__all__ = ["FLOOR_FACTOR", "block_backward_check"]

FLOOR_FACTOR = 2.0


def _grads(params, x, g, kind: str, cfg: ArchConfig):
    """{path: gradient} of every param leaf and of the input ("x")."""
    flat = flatten_with_path(params)
    names = [p for p, _ in flat] + ["x"]
    leaves = [t.detach().requires_grad_() for _, t in flat]
    xs = x.detach().requires_grad_()
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device).expand(x.shape[0], S)
    y = block_apply_full(p, xs, kind, cfg, pos)
    got = torch.autograd.grad(y, leaves + [xs], grad_outputs=g)
    return dict(zip(names, got))


def block_backward_check(cfg: ArchConfig, kind: str, card, *, batch: int = 1,
                         seq: int = 2048, seed: int = 0,
                         perturb: float = 1e-6) -> Dict[str, Any]:
    """One ``kind`` block of ``cfg`` (f32), its backward on ``card`` and on
    the CPU. Returns {"ok", "leaves": {path: {max_abs_diff, noise_floor,
    scale, over_floor}}, "failed": [paths]}; every gradient must be finite
    and within ``FLOOR_FACTOR`` times its noise floor of the CPU's."""
    gen = torch.Generator(device=card).manual_seed(seed)
    params = materialize(gen, block_layout(cfg, kind), torch.float32, card)
    rng = np.random.default_rng(seed)
    shape = (batch, seq, cfg.d_model)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    on_card = _grads(params, x.to(card), g.to(card), kind, cfg)
    noise = torch.Generator(device=card).manual_seed(seed + 1)
    pert = tree_map(lambda a: a * (1 + perturb * torch.randn(
        a.shape, generator=noise, device=card)), params)
    moved = _grads(pert, x.to(card), g.to(card), kind, cfg)
    del pert
    host = _grads(tree_map(lambda a: a.to("cpu"), params), x, g, kind, cfg)
    rows, failed = {}, []
    for path, got in on_card.items():
        want = host[path].to(card)
        diff = float((got - want).abs().max())
        floor = float((moved[path] - got).abs().max())
        finite = bool(torch.isfinite(got).all())
        rows[path] = {"max_abs_diff": diff, "noise_floor": floor,
                      "scale": float(want.abs().max()),
                      "over_floor": diff / floor if floor > 0 else (
                          0.0 if diff == 0 else float("inf")),
                      "finite": finite}
        if not (finite and diff <= FLOOR_FACTOR * floor):
            failed.append(path)
    return {"ok": not failed, "leaves": rows, "failed": failed}
