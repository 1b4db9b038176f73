"""Manual expert-parallel MoE (port of ``repro.models.moe_shardmap``).

The reference writes this as a ``shard_map`` so that GSPMD does not lower
the capacity buffer's cross-shard scatter / gather to replicated-buffer
all-reduces. Over the port's mesh (``dist.sharding``) the same plan runs
on each rank's pieces:

  * x holds this rank's rows of the batch and is replicated over "model"
    (it is, after attention);
  * each "model" rank owns E / model experts (``w1`` / ``w3`` / ``w2``
    split over model on the expert dim, their FSDP pieces gathered over
    data by the step, ``dist.sharding.gather_over``, the reference's
    explicit ``all_gather``s);
  * each rank routes all its tokens (the router replicated), keeps the
    assignments to ITS experts and buckets them into its own (E_loc, cap,
    d) buffer: a local gather, no dispatch traffic;
  * the expert FFN on the local buffer;
  * one sum over "model" (``moe_combine``) adds the ranks' partial
    outputs.

The capacity is the reference's: from this rank's token count and the
global expert count. The combine sums a token's k slots in a fixed order
(``models/moe.py``), every row gather's backward is a plain store, so
there are no atomics. Gradients: x and the router enter through
``tp_enter`` (their gradients summed over model: each rank's experts give
a part), and the auxiliary losses, which every rank computes whole from
the same router probabilities, enter the total at 1 / model each (one
stacked sum over model, ``moe_aux``), so that sum gives them weight 1.
Shared experts are column / row parallel over model, as the MLP. With no
"model" axis of more than one rank this is ``moe_apply``, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..dist.sharding import (active_axis, axis_index, axis_size, model_sum,
                             tp_enter)
from .layers import mlp_apply, _gelu
from .moe import _capacity, _take_rows, moe_apply

__all__ = ["moe_apply_shardmap"]


def moe_apply_shardmap(params, x: torch.Tensor, *, n_experts: int,
                       top_k: int, capacity_factor: float = 1.25,
                       mlp_kind: str = "swiglu", router_norm: bool = True,
                       shared_ff: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for ``moe_apply`` under an active mesh (expert parallelism
    over "model": ``n_experts`` a multiple of its size, else ValueError);
    ``moe_apply`` itself on one device. x: (B, S, d) -> (y, aux).
    ``shared_ff``: the shared experts' full hidden width (their pieces
    split over model compute column / row parallel)."""
    mesh = active_axis("model")
    if mesh is None:
        return moe_apply(params, x, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, mlp_kind=mlp_kind,
                         router_norm=router_norm, shared_ff=shared_ff)
    M, me = axis_size(mesh, "model"), axis_index(mesh, "model")
    if n_experts % M:
        raise ValueError(f"moe_apply_shardmap: {n_experts} experts do not "
                         f"split over a model axis of {M}")
    E_loc = n_experts // M
    if params["w1"].shape[0] != E_loc:
        raise ValueError(f"moe_apply_shardmap: w1 holds "
                         f"{params['w1'].shape[0]} experts, this rank owns "
                         f"{E_loc} (experts must split over model)")
    B, S, d = x.shape
    T = B * S
    xf = tp_enter(x).reshape(T, d)
    logits = xf.float() @ tp_enter(params["router"]).float()   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    if router_norm:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = _capacity(T, top_k, n_experts, capacity_factor)

    # local selection: the assignments routed to this rank's experts,
    # grouped by local expert (the others sort last and drop)
    flat_e = idx.reshape(-1)
    mine = (flat_e // E_loc) == me
    e_loc = torch.where(mine, flat_e % E_loc, torch.full_like(flat_e, E_loc))
    order = torch.argsort(e_loc, stable=True)
    sorted_e = e_loc[order]
    grp_start = torch.searchsorted(
        sorted_e, torch.arange(E_loc, device=x.device, dtype=sorted_e.dtype),
        side="left")
    pos = (torch.arange(T * top_k, device=x.device)
           - grp_start[sorted_e.clamp(max=E_loc - 1)])
    keep = (sorted_e < E_loc) & (pos < cap)
    dest = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, E_loc * cap))

    xs = _take_rows(xf[:, None, :].expand(T, top_k, d).reshape(T * top_k, d),
                    order)
    buf = x.new_zeros((E_loc * cap + 1, d)).index_put((dest,), xs)
    buf = buf[:-1].reshape(E_loc, cap, d)
    h1 = torch.bmm(buf, params["w1"])
    h3 = torch.bmm(buf, params["w3"])
    act = torch.nn.functional.silu(h1) if mlp_kind == "swiglu" else _gelu(h1)
    out_buf = torch.bmm(act * h3, params["w2"])

    # combine: each (token, k) slot in its own row, summed in slot order;
    # the other ranks' assignments and the dropped ones read zeros
    gathered = _take_rows(out_buf.reshape(E_loc * cap, d), dest)
    contrib = gathered * _take_rows(gate.reshape(-1, 1), order).to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * top_k, device=x.device)
    rank = torch.gather(inv.reshape(T, top_k), 1, torch.argsort(idx, dim=-1))
    slots = _take_rows(contrib, rank.reshape(-1)).reshape(T, top_k, d)
    y = slots[:, 0]
    for j in range(1, top_k):
        y = y + slots[:, j]
    y = model_sum(y.reshape(B, S, d), "moe_combine")

    me_p = probs.mean(dim=0)
    one_hot = (idx[..., None] == torch.arange(
        n_experts, device=x.device)).float()
    ce = one_hot.sum(dim=1).mean(dim=0)
    lb = n_experts * (me_p * ce).sum() / top_k
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    dropped = (1.0 - keep.float().mean() * (T * top_k)
               / mine.float().sum().clamp(min=1.0)).clamp(0.0, 1.0)
    stats = model_sum(torch.stack([lb, z, dropped.detach()]) / M, "moe_aux")
    aux = {"lb_loss": stats[0], "z_loss": stats[1],
           "dropped_frac": stats[2].detach()}
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, mlp_kind, ff=shared_ff)
    return y, aux
