"""Counts of one step traced on ``meta`` tensors: the role of
``repro/roofline/hlo_parse.py`` in the port.

The reference parses the optimized HLO text of a compiled step. The port
has no HLO: its step is eager PyTorch, and the dry-run runs it once on
meta tensors (shapes and dtypes, no data) under ``Counter``, a
``TorchDispatchMode`` that sees every aten op the step issues. A Python
loop over layers runs every layer, so no trip-count pass is needed; the
data-dependent loops and branches take the reference's counts on meta
(``repro_torch._device.taken``: a loop runs its cap, a branch is taken).
What it records, as rank 0 sees it on a mesh:

  * dot FLOPs: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolutions,
    forward and backward, by ``torch.utils.flop_counter``'s formulas (a
    ``FlopCounterMode`` runs inside the counter, so the count is the one
    that mode gives for the same step on the card);
  * an HBM byte proxy anchored as the reference's ``_BYTE_ANCHOR_OPS``
    (``hlo_parse.py``): operands plus result for products, reductions,
    sorts, scatters, index and gather ops and copies that materialise; the
    result only for slices and ``cat`` / pad that materialise; nothing for
    views; a standalone elementwise op counts as fused into its anchor;
  * each hand-written kernel's launches and (operations, bytes) by name,
    recorded by its wrapper's meta branch (``record_kernel``) from the
    kernel's ``*_cost`` function;
  * the collectives (every ``c10d`` op: ``dist.sharding``'s counted
    autograd Functions, ``dist.layout.move``, the projection's
    all-reduces): kind, bytes and group size n;
  * the peak of live bytes: each storage's bytes from the op that made it
    until the storage dies (tracked by weakref), the maximum kept; the
    tensors handed to ``Counter(arguments=...)`` (rank 0's pieces of the
    params, moments and batch) count from the start.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["Counter", "Counts", "record_kernel"]

_ACTIVE: List["Counter"] = []

# ops whose operands and result are counted (products, reductions, sorts,
# scatters, gathers, copies that materialise)
_OPERAND_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "cumprod", "argmax", "argmin",
    "any", "all", "sort", "topk", "argsort", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_put", "index_put_", "index",
    "index_select", "gather", "take_along_dim", "embedding",
    "embedding_dense_backward", "_to_copy", "copy_", "clone",
    "nll_loss_forward", "nll_loss_backward", "native_layer_norm",
    "native_layer_norm_backward", "_fused_rms_norm",
}
# ops counted by their result only (twice: read and written), as the
# reference counts slices, pads and concatenations
_RESULT_OPS = {"cat", "constant_pad_nd", "slice_copy", "narrow_copy",
               "repeat", "repeat_interleave", "flip", "roll"}
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
}


def record_kernel(name: str, cost: Tuple[float, float]) -> None:
    """A hand-written kernel's launch on meta tensors: one launch of
    ``name`` with ``cost`` = (operations, bytes), recorded in every active
    ``Counter`` (none outside a dry-run)."""
    for c in _ACTIVE:
        k = c.counts.kernels.setdefault(
            name, {"launches": 0, "operations": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["operations"] += float(cost[0])
        k["bytes"] += float(cost[1])


@dataclasses.dataclass
class Counts:
    """What one traced run did, per device (rank 0's view on a mesh)."""
    dot_flops: float = 0.0
    bytes_proxy: float = 0.0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # one (kind, bytes of the operand or result the ring model takes,
    # group size n) per collective call
    collectives: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)
    argument_bytes: int = 0
    peak_bytes: int = 0

    @property
    def kernel_operations(self) -> float:
        return sum(k["operations"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())

    def launches(self) -> Dict[str, int]:
        """{kernel name: launches}."""
        return {n: int(k["launches"]) for n, k in self.kernels.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_of(t: torch.Tensor):
    local = getattr(t, "_local_tensor", None)     # a DTensor's piece
    t = local if local is not None else t
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class Counter(TorchDispatchMode):
    """Count what a run does (module docstring); ``counts`` holds the
    totals once the ``with`` block ends.

    >>> with Counter(arguments=[params, batch]) as c:
    ...     step(params, batch)
    >>> c.counts.dot_flops, c.counts.peak_bytes
    """

    def __init__(self, arguments: Iterable[Any] = ()):
        super().__init__()
        self.counts = Counts()
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._flops = None
        for t in _tensors(list(arguments)):
            self._track(t)
        self.counts.argument_bytes = self._live_bytes
        self.counts.peak_bytes = self._live_bytes

    # -- live bytes ---------------------------------------------------------

    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = _storage_of(t)
        if st is None:
            return
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._freed, key)
        if self._live_bytes > self.counts.peak_bytes:
            self.counts.peak_bytes = self._live_bytes

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        _ACTIVE.append(self)
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._flops.__exit__(*exc)
        self.counts.dot_flops = float(self._flops.get_total_flops())
        _ACTIVE.remove(self)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func._overloadpacket
        ns = getattr(pkt, "_qualified_op_name", "").split("::")[0]
        name = pkt.__name__
        if ns == "c10d":
            self._collective(name, args)
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if name in _OPERAND_OPS:
            self.counts.bytes_proxy += sum(map(_nbytes, _tensors(args))) \
                + sum(map(_nbytes, outs))
        elif name in _RESULT_OPS:
            self.counts.bytes_proxy += 2 * sum(map(_nbytes, outs))
        return out

    def _collective(self, name: str, args) -> None:
        import torch.distributed as dist
        kind = _COLLECTIVE_KIND.get(name)
        if kind is None:        # barrier, send / recv, ...: not counted
            return
        n = 1
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    n = dist.ProcessGroup.unbox(a).size()
                    break
                except RuntimeError:        # the ReduceOp argument
                    continue
        # the ring model's bytes: the result of an all-gather or an
        # all-to-all (argument 0, the outputs), the operand of a
        # reduce-scatter (argument 1, the inputs), the tensor of an
        # all-reduce or a broadcast (argument 0)
        nb = sum(map(_nbytes, _tensors(
            args[1] if kind == "reduce-scatter" else args[0])))
        self.counts.collectives.append((kind, int(nb), int(n)))
