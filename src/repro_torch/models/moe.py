"""Mixture-of-Experts layer: top-k router + sort-based dispatch/combine.

Dispatch is the capacity-bounded sort approach of the JAX package:
token-expert assignments are sorted by expert id (a stable sort, as
``jnp.argsort`` is), bucketed into an (E, capacity, d) buffer, run through
the stacked expert weights as batched matrix products over E, and combined
back with the gate weights. Overflowing assignments are dropped (the
capacity factor sets the rate). The router is f32 whatever the model's
dtype.

No step adds in an order the device chooses, so a rerun on the card is
bit-equal (ROADMAP's rule on determinism):

* the dispatch writes each kept assignment into its own buffer row; every
  dropped one goes to the sentinel row E * capacity, which is cut off, so
  no duplicate-index write decides a kept row;
* where the reference scatter-adds the gated rows onto their tokens
  (``y.at[tok].add``), the combine takes each token's k assignments out of
  sort order into (token, k) slots, in ascending expert id as the
  reference's sorted scatter meets them, and sums the slots one after
  another;
* every gather of rows on the path (by the sort order, into the slots, out
  of the expert buffer) goes through ``_take_rows``, whose backward
  stores each gradient row into its own source row: the indices are a
  permutation, or distinct apart from the dropped assignments' sentinel,
  whose rows are cut off. No backward adds into a row (no ``index_add``,
  ``scatter_add`` or accumulating ``index_put``, which add with atomics
  on CUDA).

Nothing in ``moe_apply`` reads a value back to the host (no boolean
masks, ``nonzero`` or ``.item()``; every shape follows from B * S), so a
serving step that runs it can be captured into a CUDA graph.

Expert sharding ("ep" / "tp") places the weights on a mesh; on one card
it selects nothing. Over a mesh whose "model" axis splits them (the
reference's GSPMD layout, ``launch.steps.param_shardings``) each rank
computes its share, and the routing is the one-device routing of its
rows, whole on every rank (the capacity, drops, auxiliaries and
``dropped_frac`` equal ``moe_apply``'s on those rows):

* "ep" (experts over model): the rank buckets and runs only the
  assignments to its own experts (a local slice of the dispatch plan,
  the others' rows and the dropped ones read zeros) and the combine's
  partial sums are summed over model (``moe_combine``);
* "tp" (d_ff over model): every expert's ``w1`` / ``w3`` are
  column-parallel and ``w2`` row-parallel on the whole dispatch buffer,
  the combine's partial output summed over model (``tp_exit``);

in both the dispatched rows and the gate weights enter through
``tp_enter`` (each rank's experts or hidden units give a part of their
gradients), and the shared experts are column / row parallel as the MLP.
``models/moe_shardmap.py`` is the manual expert parallelism of
``moe_impl="shardmap"``.

Aux outputs: switch-style load-balance loss + router z-loss, and the
fraction of assignments dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .param import PM
from .layers import mlp_layout, mlp_apply, scatter_residual, _gelu
from ..dist.sharding import (active_axis, axis_index, model_sum, tp_enter,
                             tp_exit)

__all__ = ["moe_layout", "moe_apply"]


class _TakeRows(torch.autograd.Function):
    """src[rows] for a 2-D src whose rows are distinct apart from the
    sentinel src.shape[0], which reads a zero row. The backward stores
    each gradient row into its own source row (the sentinel's are cut off)
    and adds nothing, so it is the same on every run."""

    @staticmethod
    def forward(ctx, src, rows):
        n = src.shape[0]
        ctx.save_for_backward(rows)
        ctx.n = n
        out = src[rows.clamp(max=n - 1)]
        return torch.where((rows < n)[:, None], out, out.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        rows, = ctx.saved_tensors
        grad = g.new_zeros((ctx.n + 1, g.shape[1]))
        grad.index_put_((rows,), g)
        return grad[:ctx.n], None


_take_rows = _TakeRows.apply


def moe_layout(d: int, d_ff: int, n_experts: int, n_shared: int = 0,
               shared_ff: int = 0, expert_sharding: str = "ep",
               mlp_kind: str = "swiglu"):
    e_ax = "experts" if expert_sharding == "ep" else None
    ff_ax = None if expert_sharding == "ep" else "mlp"
    lay = {
        "router": PM((d, n_experts), (None, None), init="scaled",
                     dtype=torch.float32),
        "w1": PM((n_experts, d, d_ff), (e_ax, "fsdp", ff_ax), init="scaled"),
        "w3": PM((n_experts, d, d_ff), (e_ax, "fsdp", ff_ax), init="scaled"),
        "w2": PM((n_experts, d_ff, d), (e_ax, ff_ax, "fsdp"), init="scaled"),
    }
    if n_shared:
        lay["shared"] = mlp_layout(d, shared_ff or d_ff * n_shared, mlp_kind)
    return lay


def _capacity(T: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(math.ceil(T * top_k * factor / n_experts))
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _route(params, xf: torch.Tensor, n_experts: int, top_k: int,
           capacity_factor: float, router_norm: bool):
    """The router and the sort-based dispatch plan for xf (T, d): logits and
    probs (T, E) f32, gate and idx (T, k), the stable sort order of the
    flattened assignments, each sorted assignment's buffer row ``dest``
    (E * cap for a dropped one) and ``keep``, and cap."""
    T = xf.shape[0]
    logits = xf.float() @ params["router"].float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)                # (T, k)
    if router_norm:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = _capacity(T, top_k, n_experts, capacity_factor)
    flat_e = idx.reshape(-1)                                    # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    arange_e = torch.arange(n_experts, device=xf.device,
                            dtype=sorted_e.dtype)
    grp_start = torch.searchsorted(sorted_e, arange_e, side="left")
    pos = torch.arange(T * top_k, device=xf.device) - grp_start[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return logits, probs, gate, idx, order, dest, keep, cap


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, mlp_kind: str = "swiglu",
              router_norm: bool = True, expert_sharding: str = "ep",
              d_ff: Optional[int] = None, shared_ff: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux). Gate weights renormalized over the top-k.
    ``expert_sharding`` is accepted for the reference's signature; over a
    mesh the pieces of the expert weights say how they split (module
    docstring): ``d_ff`` / ``shared_ff``, the experts' and the shared
    experts' full hidden widths, tell a piece split over model from a
    whole one (None: whole)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    logits, probs, gate, idx, order, dest, keep, cap = _route(
        params, xf, n_experts, top_k, capacity_factor, router_norm)
    E_loc = params["w1"].shape[0]
    ep = E_loc < n_experts                   # experts split over model
    tp = ep or (d_ff is not None and params["w1"].shape[-1] < d_ff)
    enter = tp_enter if tp else (lambda t: t)
    if ep:          # this rank's experts' rows of the plan, the rest cut
        lo = axis_index(active_axis("model"), "model") * E_loc * cap
        mine = (dest >= lo) & (dest < lo + E_loc * cap)
        dest = torch.where(mine, dest - lo,
                           torch.full_like(dest, E_loc * cap))

    # ---- dispatch: sorted assignment j -> buffer row dest[j] ----------
    # x repeated k times in (token, k) order, then permuted into sort order
    xs = _take_rows(enter(xf)[:, None, :].expand(T, top_k, d).reshape(
        T * top_k, d), order)
    buf = x.new_zeros((E_loc * cap + 1, d)).index_put((dest,), xs)
    buf = buf[:-1].reshape(E_loc, cap, d)

    # ---- expert FFN (batched over E) -----------------------------------
    h1 = torch.bmm(buf, params["w1"])
    h3 = torch.bmm(buf, params["w3"])
    act = torch.nn.functional.silu(h1) if mlp_kind == "swiglu" else _gelu(h1)
    out_buf = torch.bmm(act * h3, params["w2"])
    # compact serving: expert w2 with residual-output columns compiled out
    # gives a narrow buffer; scatter it back to d so the combine below
    # keeps its width. As in ``mlp_apply``, every w2 with a w2_sel leaf
    # scatters, whatever its width (a recompacted w2 as wide as d is still
    # a permutation of its columns)
    if "w2_sel" in params:
        out_buf = scatter_residual(out_buf, params["w2_sel"], d)

    # ---- combine --------------------------------------------------------
    # a dropped assignment (and, split over model, another rank's) reads
    # the sentinel row E * cap: zeros
    gathered = _take_rows(out_buf.reshape(E_loc * cap, -1), dest)
    weights = enter(_take_rows(gate.reshape(-1, 1), order).to(x.dtype))
    contrib = gathered * weights                    # (T*k, d), sort order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * top_k, device=x.device)
    # slot (t, r): token t's assignment to its r-th smallest expert, at
    # sorted position rank[t, r]; the slots summed one after another
    rank = torch.gather(inv.reshape(T, top_k), 1,
                        torch.argsort(idx, dim=-1))
    slots = _take_rows(contrib, rank.reshape(-1)).reshape(T, top_k, d)
    y = slots[:, 0]
    for j in range(1, top_k):
        y = y + slots[:, j]
    y = y.reshape(B, S, d)
    if ep:
        y = model_sum(y, "moe_combine")
    elif tp:
        y = tp_exit(y)

    # ---- shared experts (always-on dense path, deepseek) ----------------
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, mlp_kind, ff=shared_ff)

    # ---- aux losses ------------------------------------------------------
    me = probs.mean(dim=0)                                       # (E,)
    one_hot = (idx[..., None] == torch.arange(
        n_experts, device=x.device)).float()                     # (T, k, E)
    ce = one_hot.sum(dim=1).mean(dim=0)                          # frac routed
    lb_loss = n_experts * (me * ce).sum() / top_k
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    dropped = 1.0 - keep.float().mean()
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}
    return y, aux
