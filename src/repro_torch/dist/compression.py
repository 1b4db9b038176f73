"""Gradient compression for data-parallel reductions (port of
``repro.dist.compression``; DESIGN.md §4).

  * ``int8_quantize`` / ``int8_dequantize`` — shared-scale symmetric int8
    (a quarter of the f32 bytes, error <= scale / 2 per element).
  * ``topk_compress`` / ``topk_decompress`` — magnitude top-k to (values,
    flat indices) and back.
  * ``ef_step`` — error feedback (Karimireddy et al.): the residual of each
    round goes into the next, so no gradient mass is dropped, only delayed.
  * ``compressed_psum`` — the sum over a process group (or a mesh's ranks)
    of a gradient tree whose payload crosses the group compressed.

The compressed modes move the compressed representation: an all-gather of
the narrow payload and a local reduction, as the reference does (an
all-reduce would put full-width values back on the wire). The top-k
scatter-add runs one ``index_add_`` per rank, in rank order: a rank's k
indices are distinct, so each call adds one value to each touched element
and the result does not depend on the order atomics land in on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .._tree import tree_map
from .layout import as_group

__all__ = ["int8_quantize", "int8_dequantize", "topk_compress",
           "topk_decompress", "ef_step", "compressed_psum"]


def int8_quantize(x: torch.Tensor, scale: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization. Returns (q int8, scale f32 scalar) with
    x ~= q * scale and |x - q * scale| <= scale / 2. An explicit ``scale``
    lets the members of a collective share one."""
    xf = x.to(torch.float32)
    if scale is None:
        scale = xf.abs().max() / 127.0
    scale = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                        device=x.device),
                        min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _k_for(size: int, k_frac: float) -> int:
    return max(1, min(size, int(round(size * k_frac))))


def topk_compress(g: torch.Tensor, k_frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k = round(k_frac * size) largest-|.| entries. Returns
    (values (k,), flat int32 indices (k,)), largest first."""
    k = _k_for(g.numel(), k_frac)
    flat = g.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx.to(torch.int32)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """Scatter (values, indices) back to a dense zero-filled tensor."""
    size = 1
    for d in shape:
        size *= int(d)
    dense = torch.zeros((size,), dtype=dtype, device=vals.device)
    dense[idx.to(torch.int64)] = vals.to(dtype)
    return dense.reshape(tuple(shape))


def ef_step(g: torch.Tensor, err: torch.Tensor, k_frac: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: sparsify (g + err), return (sparse update
    to transmit, new residual); sparse + new_err == g + err exactly."""
    corrected = g + err
    vals, idx = topk_compress(corrected, k_frac)
    sparse = topk_decompress(vals, idx, corrected.shape, corrected.dtype)
    return sparse, corrected - sparse


def _gather(x: torch.Tensor, group) -> list:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def compressed_psum(tree, group, mode: str = "int8", k_frac: float = 0.05):
    """Sum of a gradient tree over ``group`` (a process group or a
    ``DeviceMesh``, whose ranks then form the group), every rank calling
    with its own partial gradients; every rank gets the sum.

    mode:
      "none" — exact all-reduce (up to summation order).
      "int8" — shared-scale int8: a MAX all-reduce of the local absmax
               fixes one scale, the int8 payload is all-gathered and
               summed in int32. For P ranks the error is <= P * scale / 2
               and the payload is 1 byte an element where f32 takes 4.
      "topk" — magnitude top-k without error feedback: each rank sends
               its k (value, index) pairs, scatter-added in rank order
               (biased; pair with ``ef_step`` residuals to converge).
    """
    group = as_group(group)
    if mode == "none":
        def one(g):
            out = g.clone()
            dist.all_reduce(out, group=group)
            return out
        return tree_map(one, tree)

    if mode == "int8":
        def one(g):
            absmax = g.to(torch.float32).abs().max().reshape(1)
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
            q, scale = int8_quantize(g, absmax[0] / 127.0)
            total = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
            for qr in _gather(q, group):           # int8 on the wire
                total += qr.to(torch.int32)
            return int8_dequantize(total, scale, g.dtype)
        return tree_map(one, tree)

    if mode == "topk":
        def one(g):
            vals, idx = topk_compress(g, k_frac)
            flat = torch.zeros((g.numel(),), dtype=g.dtype, device=g.device)
            for vr, ir in zip(_gather(vals, group), _gather(idx, group)):
                flat.index_add_(0, ir.to(torch.int64), vr.to(g.dtype))
            return flat.reshape(g.shape)
        return tree_map(one, tree)

    raise ValueError(f"unknown compression mode {mode!r}")
