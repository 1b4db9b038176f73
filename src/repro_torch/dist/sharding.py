"""Logical-axis sharding rules and the explicit collectives of the sharded
step (port of ``repro.dist.sharding``; DESIGN.md §4).

The rules are the reference's:

  * ``default_rules(multi_pod=...)`` — logical name -> mesh axes for the
    DP(+pod) x TP(model) layout with FSDP-over-data weights;
  * ``axis_rules(mesh, rules)`` / ``current_rules()`` — a thread-local,
    nestable stack of active (mesh, rules) pairs;
  * ``logical_spec(names, rules)`` — a ``Spec`` (one mesh-axes entry per
    dim) from logical names, no divisibility check;
  * ``fit_spec(mesh, spec_axes, shape)`` — the single divisibility
    policy: an axis absent from the mesh, or one that does not divide its
    dim, replicates that dim and never raises;
  * ``shard(x, *names)`` — this rank's piece of ``x`` in the layout its
    names give under the active rules.

The mesh is a ``DeviceMesh`` with named dims (``launch.mesh``). A ``Spec``
becomes one placement per mesh dim (``placements``): ``Shard(d)`` where
the mesh dim's name is among dim d's axes, ``Replicate`` elsewhere.

GSPMD partitions every op between two ``with_sharding_constraint``s and
inserts the collectives; torch does not. So the port's model computes on
local pieces in a fixed layout and calls one autograd Function per
collective, each counted by kind (``collective_counts``):

  * ``gather_over(w, "data", dim)`` — an FSDP weight's pieces gathered
    over data before use (``fsdp_gather``); its backward sums the
    gradient over data and keeps this rank's piece (``fsdp_grad_reduce``),
    which is also the data-parallel gradient sum of that weight. A weight
    not split over data gets ``dp_grad_sum``: identity forward, a sum over
    data backward. The mesh step records on each piece the dim it splits
    over data (``fsdp_piece``) and the model gathers a layer's pieces on
    entry to the layer (``gathered``), so one layer's weights are whole at
    a time;
  * ``model_whole(w, full, dim, kind)`` — a weight's pieces gathered over
    "model" at use for a region that runs whole on every model rank (an
    SSM whose inner width the axis splits through its heads,
    ``ssm_model_gather``; a decode step's head-split weights where the
    cache's sequence takes the model axis, ``decode_head_gather``); its
    backward keeps the rank's slice of the gradient, which the region
    computes whole on every model rank;
  * ``tp_enter(x)`` — identity forward, a sum over model backward
    (``tp_enter_grad_sum``): the replicated input of a column-parallel
    product, whose gradient each model rank holds a part of;
  * ``tp_exit(y)`` — a sum over model forward (``tp_exit_sum``), identity
    backward: the partial output of a row-parallel product (a contraction
    over a "heads", "mlp" or "vocab" dim);
  * ``model_sum(x)`` / ``model_max(x)`` — the cross-entropy's logsumexp
    over vocab-sharded logits (``ce_stats``, ``ce_max``), the SSM's gated
    norm over its split width (``ssm_norm``, and ``ssm_norm_grad``: its
    consumers are split, so the backward sums too), the MoE's combine and
    auxiliaries (``moe_combine``, ``moe_aux``), and a few no-gradient
    sums (``dp_count``, ``dp_loss``);
  * the decode step's, no gradient (serving runs under ``no_grad``):
    ``seq_max(x)`` / ``seq_sum(x)`` over the axes that split the cache's
    sequence (the rules' "cache_seq", ``cache_seq_split``), the
    split-softmax combine's global max (``decode_max``) and its sum of
    the partial weights and weighted values (``decode_sum``);
    ``model_gather(x)``, the SSM's new conv input columns gathered over
    "model" into the whole conv state (``ssm_conv_gather``);
    ``gather_rows(x, mesh, axes)``, the serving engine's step outputs
    gathered over its batch axes (``engine_out_gather``).

``shard`` moves a piece from the layout recorded on it (by an earlier
``shard``, or ``placed``) to the names' layout by ``dist.layout.move`` (one
all-to-all, or a local slice where no rank needs another's data), inside
an autograd Function whose backward is the adjoint move; an unrecorded
piece is taken to be in the names' layout already, as the port's model
computes each activation in the layout the reference constrains it to.
Every sum here is a gloo all-reduce: a fixed order for a fixed group, so
reruns are bit-equal and every rank gets the same bits.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Spec", "default_rules", "axis_rules", "current_rules",
           "logical_spec", "fit_spec", "shard", "placed", "placements",
           "mesh_axes", "axis_size", "axis_index", "active_axis",
           "gather_over", "fsdp_piece", "gathered", "model_whole",
           "tp_enter", "tp_exit", "model_sum", "model_max",
           "data_sum", "axes_group", "axes_index", "cache_seq_split", "seq_max",
           "seq_sum", "model_gather", "gather_rows", "collective_counts",
           "reset_collective_counts"]

Axes = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name,
    a tuple of names (split over them row-major) or None (replicated); a
    tuple, as ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"Spec{tuple(self)!r}"


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def default_rules(multi_pod: bool = False) -> dict:
    """Logical-name -> mesh-axes mapping for the production train/prefill
    layout: data parallel over ("pod",) "data", tensor parallel over
    "model", FSDP weight sharding over "data"."""
    batch = ("pod", "data") if multi_pod else "data"
    return {
        # parameters
        "fsdp": "data",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "embed": None,
        "experts": "model",
        "layers": None,
        # activations
        "batch": batch,
        "seq": None,
        "attn_seq": None,
        "expert_cap": None,
        # decode cache
        "cache_batch": batch,
        "cache_seq": None,
    }


# ---------------------------------------------------------------------------
# (mesh, rules) context
# ---------------------------------------------------------------------------

_STATE = threading.local()


def _stack():
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    return stack


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict]):
    """Activate (mesh, rules) for the ``shard`` calls and the collectives
    run inside the block. ``mesh=None`` makes them no-ops."""
    _stack().append((mesh, rules))
    try:
        yield
    finally:
        _stack().pop()


def current_rules():
    """The innermost active (mesh, rules) pair, or None outside any."""
    stack = _stack()
    return stack[-1] if stack else None


def active_axis(name: str):
    """The active mesh when it has axis ``name`` of more than one rank,
    else None (no context, a None mesh, or no such axis)."""
    state = current_rules()
    if state is None or state[0] is None:
        return None
    mesh = state[0]
    return mesh if axis_size(mesh, name) > 1 else None


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 when absent)."""
    if name not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(name))


def logical_spec(names: Sequence[Optional[str]],
                 rules: Optional[dict]) -> Spec:
    """A ``Spec`` from logical axis names via ``rules`` (no divisibility
    check). Unknown names replicate."""
    rules = rules or {}
    return Spec(*[rules.get(n) if n is not None else None for n in names])


def _axes_size(shape: Dict[str, int], axes: Axes) -> int:
    if axes is None:
        return 1
    size = 1
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if a not in shape:
            return 0               # axis absent from this mesh: replicate
        size *= shape[a]
    return size


def fit_spec(mesh, spec_axes: Sequence[Axes], shape: Tuple[int, ...]) -> Spec:
    """A ``Spec`` from already-resolved mesh axes, dropping any that are
    missing from the mesh or do not divide their dim (25 heads on a 2-way
    axis, batch 1): the single divisibility policy."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, axes in zip(shape, spec_axes):
        n = _axes_size(sizes, axes)
        out.append(axes if n and dim % n == 0 else None)
    return Spec(*out)


def _fit(mesh, names, rules, shape) -> Spec:
    return fit_spec(mesh, [rules.get(n) if n is not None else None
                           for n in names], shape)


def placements(mesh, spec: Sequence[Axes]) -> tuple:
    """One ``Shard`` / ``Replicate`` per mesh dim for ``spec``: Shard(d)
    where the mesh dim's name is among dim d's axes. A dim split over
    several axes splits in mesh-dim order (``dist.layout``'s boxes)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, axes in enumerate(spec) if axes is not None and (
            axes == name if isinstance(axes, str) else name in axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def placed(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Record on ``x`` that it is this rank's piece under ``spec`` (for a
    later ``shard``); returns ``x``."""
    x._repro_spec = Spec(*spec)
    return x


class _Move(torch.autograd.Function):
    """``layout.move`` of a piece from ``src`` to ``dst`` placements; the
    backward moves the gradient back (the adjoint)."""

    @staticmethod
    def forward(ctx, x, shape, src, dst, lay):
        ctx.args = (shape, src, dst, lay)
        from .layout import move
        return move(x, shape, src, dst, lay)

    @staticmethod
    def backward(ctx, g):
        from .layout import move
        shape, src, dst, lay = ctx.args
        return move(g.contiguous(), shape, dst, src, lay), None, None, None, \
            None


def _global_shape(local_shape, spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = mesh_axes(mesh)
    return tuple(n * _axes_size(sizes, a) if a is not None else n
                 for n, a in zip(local_shape, spec))


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """This rank's piece of activation ``x`` in the layout its logical
    ``names`` imply under the innermost ``axis_rules``; one name (or None)
    per dim. A no-op outside a context, on a None mesh, and where the
    layout does not change; else one ``layout.move``, differentiable
    (counted ``shard_move`` unless it is a local slice of a replicated
    piece)."""
    state = current_rules()
    if state is None or state[0] is None or state[1] is None:
        return x
    mesh, rules = state
    if len(names) != x.ndim:
        raise ValueError(
            f"shard: {len(names)} names for rank-{x.ndim} tensor "
            f"{tuple(x.shape)}")
    src = getattr(x, "_repro_spec", None)
    if src is None:
        return x
    shape = _global_shape(x.shape, src, mesh)
    dst = _fit(mesh, names, rules, shape)
    if tuple(src) == tuple(dst):
        return x
    from .layout import MeshLayout
    lay = MeshLayout(mesh)
    if any(axes is not None for axes in src):   # else a local slice
        _COUNTS["shard_move"] += 1
    out = _Move.apply(x, shape, placements(mesh, src), placements(mesh, dst),
                      lay)
    return placed(out, dst)


# ---------------------------------------------------------------------------
# the explicit collectives
# ---------------------------------------------------------------------------

_COUNTS: collections.Counter = collections.Counter()


def collective_counts() -> Dict[str, int]:
    """{kind: calls since the last reset}; forward and backward each
    count where they run."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _group(mesh, name: str):
    return mesh.get_group(name)


def _all_reduce(x: torch.Tensor, mesh, name: str, kind: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    _COUNTS[kind] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=_group(mesh, name))
    return out


class _GatherOver(torch.autograd.Function):
    """Forward: the pieces over mesh axis ``name`` concatenated along
    ``dim`` (one all_gather). Backward: the gradient summed over the axis
    (one all_reduce), this rank's slice kept."""

    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.args = (mesh, name, dim, x.shape[dim])
        _COUNTS["fsdp_gather"] += 1
        return _gather_dim(x, _group(mesh, name), axis_size(mesh, name), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, name, dim, size = ctx.args
        full = _all_reduce(g, mesh, name, "fsdp_grad_reduce")
        i = axis_index(mesh, name)
        return full.narrow(dim, i * size, size), None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over mesh axis ``name``."""

    @staticmethod
    def forward(ctx, x, mesh, name, kind):
        ctx.args = (mesh, name, kind)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, name, kind = ctx.args
        return _all_reduce(g, mesh, name, kind), None, None, None


class _Sum(torch.autograd.Function):
    """A sum over mesh axis ``name`` forward; identity backward (each
    rank's part enters the total with weight 1, and the total's consumers
    are the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, name, kind):
        return _all_reduce(x, mesh, name, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _SumOfParts(torch.autograd.Function):
    """A sum over mesh axis ``name`` forward whose consumers are split
    over the axis: each rank's gradient of the total is a part, so the
    backward sums them too (``<kind>_grad``)."""

    @staticmethod
    def forward(ctx, x, mesh, name, kind):
        ctx.args = (mesh, name, kind)
        return _all_reduce(x, mesh, name, kind)

    @staticmethod
    def backward(ctx, g):
        mesh, name, kind = ctx.args
        return _all_reduce(g, mesh, name, kind + "_grad"), None, None, None


def gather_over(w: torch.Tensor, name: str, dim: Optional[int]):
    """A weight's piece gathered over mesh axis ``name`` along ``dim``
    before use (``fsdp_gather``; its gradient summed over the axis and
    sliced back, ``fsdp_grad_reduce``), or, with ``dim`` None (the weight
    is not split over the axis), the weight itself with its gradient
    summed over the axis (``dp_grad_sum``). Identity without an active
    axis of more than one rank."""
    mesh = active_axis(name)
    if mesh is None:
        return w
    if dim is None:
        return _SumGrad.apply(w, mesh, name, "dp_grad_sum")
    return _GatherOver.apply(w, mesh, name, dim)


_FSDP = "_repro_fsdp_dim"


def fsdp_piece(w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """Record on ``w`` (this rank's piece of a weight, or of one layer of
    a stacked weight) the dim it is split along over "data", None when
    it is not split over data; ``gathered`` takes it whole at use.
    Returns ``w``."""
    setattr(w, _FSDP, dim)
    return w


def gathered(tree):
    """The weights of ``tree`` (a layer's dict, or one leaf) as the model
    computes with them: each leaf recorded by ``fsdp_piece`` gathered over
    data at this call (``gather_over``: ``fsdp_gather``, its gradient
    reduced over data when the backward reaches it, ``fsdp_grad_reduce``;
    ``dp_grad_sum`` for a piece not split over data); any other leaf as
    it is. The mesh step hands the model its pieces and each layer
    gathers its own on entry, so one layer's gathered weights are live at
    a time (and, under remat, gathered again by the recompute)."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and hasattr(tree, _FSDP):
        return gather_over(tree, "data", getattr(tree, _FSDP))
    return tree


class _GatherPieces(torch.autograd.Function):
    """Forward: a weight's pieces over "model" concatenated along ``dim``
    (one all_gather, counted ``kind``). The region that uses the whole
    weight runs replicated over model, so every model rank computes the
    whole gradient of it: the backward keeps this rank's slice, no
    collective."""

    @staticmethod
    def forward(ctx, w, mesh, dim, kind):
        ctx.args = (dim, w.shape[dim], axis_index(mesh, "model"))
        _COUNTS[kind] += 1
        return _gather_dim(w, mesh.get_group("model"),
                           axis_size(mesh, "model"), dim)

    @staticmethod
    def backward(ctx, g):
        dim, size, i = ctx.args
        return g.narrow(dim, i * size, size), None, None, None


def model_whole(w: torch.Tensor, full: int, dim: int, kind: str
                ) -> torch.Tensor:
    """Weight ``w`` whole along ``dim`` (``full`` wide) where its piece
    splits over "model" (one all_gather at use, counted ``kind``; the
    backward keeps the rank's slice of the gradient, which the region,
    replicated over model, computes whole); ``w`` itself where it is
    whole already."""
    mesh = active_axis("model")
    if mesh is None or w.shape[dim] == full:
        return w
    return _GatherPieces.apply(w, mesh, dim, kind)


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """The replicated input of a column-parallel product: identity
    forward, its gradient summed over "model" (``tp_enter_grad_sum``)."""
    mesh = active_axis("model")
    return x if mesh is None else _SumGrad.apply(x, mesh, "model",
                                                 "tp_enter_grad_sum")


def tp_exit(y: torch.Tensor) -> torch.Tensor:
    """The partial output of a row-parallel product summed over "model"
    (``tp_exit_sum``); identity backward."""
    mesh = active_axis("model")
    return y if mesh is None else _Sum.apply(y, mesh, "model", "tp_exit_sum")


def model_sum(x: torch.Tensor, kind: str, parts: bool = False
              ) -> torch.Tensor:
    """``x`` summed over "model", differentiable: identity backward when
    the total's consumers are the same on every rank (a loss), a sum of
    the gradient's parts over "model" when they are split over it
    (``parts``: the SSM's gated norm over its split width)."""
    mesh = active_axis("model")
    if mesh is None:
        return x
    return (_SumOfParts if parts else _Sum).apply(x, mesh, "model", kind)


def model_max(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The elementwise max of ``x`` over "model", no gradient."""
    mesh = active_axis("model")
    x = x.detach()
    return x if mesh is None else _all_reduce(x, mesh, "model", kind,
                                              dist.ReduceOp.MAX)


def data_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` summed over "data", no gradient."""
    mesh = active_axis("data")
    x = x.detach()
    return x if mesh is None else _all_reduce(x, mesh, "data", kind)


# ---------------------------------------------------------------------------
# the decode step's and the serving engine's collectives (no gradient)
# ---------------------------------------------------------------------------

def _axes_tuple(mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` (a name, a tuple of names or None) as the tuple of those
    present on ``mesh``, in the mesh's dim order."""
    if axes is None:
        return ()
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(n for n in mesh.mesh_dim_names if n in names)


def axes_group(mesh, axes: Axes):
    """One process group over the ranks that differ only in mesh ``axes``
    (a name or a tuple of names): the axis's own group for one, the mesh's
    group (``dist.layout.mesh_group``) when they are all of its dims, else
    the flattened sub-mesh's. Group rank order is the row-major order of
    the ranks' coordinates on ``axes``."""
    from .layout import mesh_group
    names = _axes_tuple(mesh, axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if len(names) == len(mesh.mesh_dim_names):
        return mesh_group(mesh)
    return mesh[names]._flatten().get_group()


def axes_index(mesh, axes: Axes) -> Tuple[int, int]:
    """(index, ways): this rank's row-major position over mesh ``axes``
    and their total size (GSPMD's order for a dim split over several)."""
    index, ways = 0, 1
    for n in _axes_tuple(mesh, axes):
        size = axis_size(mesh, n)
        index, ways = index * size + axis_index(mesh, n), ways * size
    return index, ways


# the mesh axes that split the decode cache's sequence, this rank's slice
# among them and their number
SeqSplit = collections.namedtuple("SeqSplit", "mesh axes index ways")


def cache_seq_split() -> Optional[SeqSplit]:
    """The split of the cache's sequence under the active rules: the mesh
    axes that "cache_seq" names (those of more than one rank in all), or
    None (no context, a None mesh, or no such split). The decode step
    fits "cache_seq" to the cache before it enters the rules, so a split
    named here splits every position-indexed cache leaf."""
    state = current_rules()
    if state is None or state[0] is None or state[1] is None:
        return None
    mesh, rules = state
    axes = _axes_tuple(mesh, rules.get("cache_seq"))
    index, ways = axes_index(mesh, axes)
    if ways == 1:
        return None
    return SeqSplit(mesh, axes, index, ways)


def seq_max(x: torch.Tensor, split: SeqSplit) -> torch.Tensor:
    """The elementwise max of ``x`` over the cache's sequence shards
    (``decode_max``): the split-softmax's global max."""
    _COUNTS["decode_max"] += 1
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=axes_group(split.mesh, split.axes))
    return out


def seq_sum(x: torch.Tensor, split: SeqSplit) -> torch.Tensor:
    """``x`` summed over the cache's sequence shards (``decode_sum``): the
    split-softmax's weights and weighted values, in the group's fixed
    order, so every rank gets the same bits and reruns are bit-equal."""
    _COUNTS["decode_sum"] += 1
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=axes_group(split.mesh, split.axes))
    return out


def _gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def model_gather(x: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
    """The pieces of ``x`` over "model" concatenated along ``dim`` (one
    all_gather, counted ``kind``), no gradient; ``x`` itself without an
    active model axis."""
    mesh = active_axis("model")
    if mesh is None:
        return x
    _COUNTS[kind] += 1
    return _gather_dim(x.detach(), mesh.get_group("model"),
                       axis_size(mesh, "model"), dim)


def gather_rows(x: torch.Tensor, mesh, axes: Axes, dim: int = 0,
                kind: str = "engine_out_gather") -> torch.Tensor:
    """The pieces of ``x`` over mesh ``axes`` concatenated along ``dim`` in
    the axes' row-major order (one all_gather, counted ``kind``), no
    gradient."""
    _COUNTS[kind] += 1
    return _gather_dim(x.detach(), axes_group(mesh, axes),
                       axes_index(mesh, axes)[1], dim)
