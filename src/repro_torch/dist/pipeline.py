"""Microbatch pipeline parallelism over one mesh axis (port of
``repro.dist.pipeline``; DESIGN.md §4).

The GPipe schedule on a ring: each rank along ``axis_name`` owns one
stage's parameters; activations flow rank -> rank + 1 one hop a tick. With
S stages and M microbatches the loop runs S + M - 1 ticks; rank r is busy
on ticks [r, r + M), so the bubble is (S - 1) / (S + M - 1).

Only the stage handoff crosses between ranks: each tick one microbatch of
activations goes to rank + 1 and one comes from rank - 1 (the reference's
``ppermute`` over the ring), as one ``all_to_all_single`` over the axis
whose only nonempty splits are those two: gloo's point-to-point send
reads host memory, and on a CUDA tensor fails ("writev ... Bad address"
on the H100), while its all-to-all stages CUDA tensors through the host.
The last stage writes its outputs, and one sum over the axis (the
reference's ``psum``; the other ranks hold zeros) gives every rank the
result. Weights never move. The returned function runs forward only: the
ring's sends carry no gradient.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .._tree import tree_map
from .sharding import axis_index, axis_size

__all__ = ["build_pipeline_fn"]


def _ring_hop(y: torch.Tensor, nxt: int, prv: int, n: int, group):
    """``y`` sent to axis rank ``nxt``, the tensor of axis rank ``prv``
    received: one ``all_to_all_single`` with those two splits nonempty."""
    k = y.numel()
    send = [k if q == nxt else 0 for q in range(n)]
    recv = [k if q == prv else 0 for q in range(n)]
    out = torch.empty_like(y)
    dist.all_to_all_single(out.reshape(-1), y.contiguous().reshape(-1),
                           recv, send, group=group)
    return out


def build_pipeline_fn(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                      n_stages: int, n_micro: int, mesh,
                      axis_name: str) -> Callable:
    """Build ``pipe(stage_params, x) -> y``.

    stage_fn:     (one stage's params, microbatch activations) ->
                  activations of the same shape;
    stage_params: nested dict whose leaves have a leading n_stages dim:
                  full tensors (every rank holds them; rank r uses
                  entry r) or ``DTensor``s split over ``axis_name`` on that
                  dim (each rank's piece is its stage);
    x:            (n_micro, *microbatch_shape), the same on every rank; y
                  has its shape and equals applying every stage in order.

    ValueError when the mesh's ``axis_name`` does not have n_stages ranks.
    """
    if axis_size(mesh, axis_name) != n_stages or (
            axis_name not in mesh.mesh_dim_names):
        raise ValueError(
            f"pipeline needs mesh axis {axis_name!r} == n_stages "
            f"({dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get(axis_name)}"
            f" != {n_stages})")
    ticks = n_stages + n_micro - 1
    group = mesh.get_group(axis_name)
    r = axis_index(mesh, axis_name)
    nxt, prv = (r + 1) % n_stages, (r - 1) % n_stages

    def stage_of(w):
        if hasattr(w, "to_local"):
            return w.to_local()[0]
        return w[r]

    @torch.no_grad()
    def pipe(stage_params, x: torch.Tensor) -> torch.Tensor:
        W = tree_map(stage_of, stage_params)
        h = torch.zeros_like(x[0])
        out = torch.zeros_like(x)
        for t in range(ticks):
            # stage 0 feeds from the input stream, the others from the ring
            inp = x[min(max(t, 0), n_micro - 1)] if r == 0 else h
            y = stage_fn(W, inp)
            # the last stage emits microbatch t - (S - 1) once the fill ends
            oi = t - (n_stages - 1)
            if r == n_stages - 1 and oi >= 0:
                out[oi] = y
            if n_stages == 1:
                h = y
                continue
            h = _ring_hop(y, nxt, prv, n_stages, group)
        # only the last stage wrote anything: the sum gives it to every rank
        if n_stages > 1:
            dist.all_reduce(out, group=group)
        return out

    return pipe
