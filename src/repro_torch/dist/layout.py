"""Explicit layout moves of a leaf over a mesh.

The JAX package leaves every resharding to GSPMD: a leaf enters a
``shard_map`` in whatever sharding it has and XLA inserts the collective
that brings it to the ``in_specs``. The port makes those moves by hand,
with one primitive: ``move`` takes this rank's piece of a tensor under one
placement (a ``DTensor``'s ``Shard`` / ``Replicate`` per mesh dim) to its
piece under another, by one ``all_to_all_single`` over the mesh's ranks,
or by a local slice where no rank needs another's data. So a row-sharded
(FSDP) leaf reaches the column block the projection solves on by one
all-to-all of |leaf| / D bytes per rank, a replicated leaf by a local
slice, and neither by an all-gather. ``DTensor.redistribute`` is not
used: off the card it falls back to an all-gather.

A rank's piece under a placement is a box of the global tensor: each
mesh dim that shards a tensor dim splits it evenly, in mesh-dim order
(so a tensor dim sharded by two mesh dims is split row-major over them,
GSPMD's order for a dim sharded over several axes). Where a placement
replicates over some mesh dims, several ranks hold each element: the
receiver takes it from the holder whose coordinates on those dims are its
own, so every element crosses at most once.

>>> lay = MeshLayout(mesh)
>>> block = move(local, shape, placements_of(x, lay), column_placements(
...     x.ndim - 1, lay), lay)
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["mesh_group", "as_group", "MeshLayout", "placements_of", "local_of",
           "column_placements", "replicated_placements", "move", "wrap",
           "to_layout_of", "elementwise", "restore", "counts_once",
           "sharded_clip_scale"]


def mesh_group(mesh):
    """One process group over all the ranks of ``mesh``: its own group
    when it has one dim, the default group when it spans the world, else
    its flattened mesh's group."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    return mesh._flatten().get_group()


def as_group(group):
    """The process group of ``group``: a ``DeviceMesh``'s ranks as one
    group (``mesh_group``), a process group as it is, None (the default
    group) as None."""
    if group is None or not hasattr(group, "mesh_dim_names"):
        return group
    return mesh_group(group)


def _placement_types():
    from torch.distributed.tensor import Replicate, Shard
    return Shard, Replicate


class MeshLayout:
    """A mesh's ranks as the layout code sees them.

    ``group``: one process group over the mesh; ``coords[q]``: the mesh
    coordinate of group rank q; ``index[q]``: its row-major position in
    the mesh, the column block it owns in the canonical layout (the
    JAX package's flattened ``axis_index``); ``me``: this process's group
    rank; ``size``: the rank count.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh_group(mesh)
        self.shape = tuple(int(n) for n in mesh.mesh.shape)
        grid = [int(g) for g in mesh.mesh.reshape(-1).tolist()]
        flat = {g: i for i, g in enumerate(grid)}
        peers = dist.get_process_group_ranks(self.group)
        self.index = [flat[g] for g in peers]
        self.coords = [tuple(int(c) for c in np.unravel_index(i, self.shape))
                       for i in self.index]
        self.me = dist.get_rank(self.group)
        self.size = len(grid)

    @property
    def rank(self) -> int:
        """This process's row-major position in the mesh."""
        return self.index[self.me]


def _is_dtensor(x) -> bool:
    return hasattr(x, "placements") and hasattr(x, "to_local")


def placements_of(x, lay: MeshLayout) -> tuple:
    """``x``'s placement per mesh dim: a ``DTensor``'s own (on ``lay``'s
    mesh), all ``Replicate`` for a plain tensor (every rank holds it)."""
    _, Replicate = _placement_types()
    if not _is_dtensor(x):
        return (Replicate(),) * len(lay.shape)
    if x.device_mesh != lay.mesh:
        raise ValueError(f"leaf lives on {x.device_mesh}, not on the "
                         f"engine's mesh {lay.mesh}")
    return tuple(x.placements)


def local_of(x) -> torch.Tensor:
    """This rank's piece of ``x`` (a plain tensor is its own piece)."""
    return x.to_local() if _is_dtensor(x) else x


def column_placements(col_dim: int, lay: MeshLayout) -> tuple:
    """The canonical column layout: tensor dim ``col_dim`` split over
    every mesh dim, row-major, so group rank q holds block index[q]."""
    Shard, _ = _placement_types()
    return (Shard(col_dim),) * len(lay.shape)


def replicated_placements(lay: MeshLayout) -> tuple:
    _, Replicate = _placement_types()
    return (Replicate(),) * len(lay.shape)


def _box(shape, placements, mesh_shape, coord):
    """The (start, stop) per tensor dim of the piece held at ``coord``."""
    Shard, Replicate = _placement_types()
    lo, size = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if type(pl) is Shard:
            d = pl.dim % len(shape)
            n = mesh_shape[i]
            if size[d] % n:
                raise ValueError(
                    f"tensor dim {d} of {tuple(shape)} does not split "
                    f"evenly over mesh dim {i} ({n} ranks)")
            size[d] //= n
            lo[d] += coord[i] * size[d]
        elif type(pl) is not Replicate:
            raise ValueError(f"placement {pl!r} is not supported: leaves "
                             f"are Shard or Replicate on every mesh dim")
    return tuple((l, l + s) for l, s in zip(lo, size))


def _intersect(a, b):
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _view(x: torch.Tensor, box, origin) -> torch.Tensor:
    return x[tuple(slice(lo - o, hi - o)
                   for (lo, hi), (o, _) in zip(box, origin))]


def _numel(box) -> int:
    return int(np.prod([hi - lo for lo, hi in box], dtype=np.int64))


def _rep_dims(placements, lay: MeshLayout) -> List[int]:
    _, Replicate = _placement_types()
    return [i for i, pl in enumerate(placements)
            if type(pl) is Replicate and lay.shape[i] > 1]


def move(local: torch.Tensor, shape: Sequence[int], src: tuple, dst: tuple,
         lay: MeshLayout) -> torch.Tensor:
    """This rank's piece of a ``shape`` tensor under placements ``dst``,
    from its piece ``local`` under ``src``.

    Every rank must call it with the same ``shape``, ``src`` and ``dst``:
    whether a collective runs is decided from all ranks' boxes, so either
    all ranks enter the one ``all_to_all_single`` (of bytes, any dtype) or
    none does. A rank receives each element of its new piece from the one
    holder whose coordinates on ``src``'s replicated mesh dims are its own.
    Where ``src`` and ``dst`` agree, the piece is ``local`` itself (made
    contiguous), no copy.
    """
    if tuple(src) == tuple(dst):
        return local.contiguous()
    shape = tuple(int(n) for n in shape)
    P = len(lay.coords)
    src_box = [_box(shape, src, lay.shape, lay.coords[q]) for q in range(P)]
    dst_box = [_box(shape, dst, lay.shape, lay.coords[q]) for q in range(P)]
    rep = _rep_dims(src, lay)

    def feeds(q, p):        # does holder q send to receiver p
        return all(lay.coords[q][i] == lay.coords[p][i] for i in rep)

    pieces = {(q, p): _intersect(src_box[q], dst_box[p])
              for q, p in itertools.product(range(P), range(P))
              if feeds(q, p)}
    me = lay.me
    want = dst_box[me]
    out = local.new_empty(tuple(hi - lo for lo, hi in want))
    own = pieces.get((me, me))
    if own is not None:
        _view(out, own, want).copy_(_view(local, own, src_box[me]))
    if not any(b is not None for (q, p), b in pieces.items() if q != p):
        return out
    send, send_sizes, recv_sizes = [], [], []
    item = local.element_size()
    for q in range(P):
        b = pieces.get((me, q)) if q != me else None
        if b is not None:
            send.append(_view(local, b, src_box[me]).contiguous()
                        .view(torch.uint8).reshape(-1))
        send_sizes.append(0 if b is None else _numel(b) * item)
        r = pieces.get((q, me)) if q != me else None
        recv_sizes.append(0 if r is None else _numel(r) * item)
    sbuf = (torch.cat(send) if send
            else torch.empty((0,), dtype=torch.uint8, device=local.device))
    rbuf = torch.empty((sum(recv_sizes),), dtype=torch.uint8,
                       device=local.device)
    dist.all_to_all_single(rbuf, sbuf, recv_sizes, send_sizes,
                           group=lay.group)
    off = 0
    for q in range(P):
        if recv_sizes[q]:
            r = pieces[(q, me)]
            chunk = rbuf[off: off + recv_sizes[q]].view(local.dtype)
            _view(out, r, want).copy_(
                chunk.reshape(tuple(hi - lo for lo, hi in r)))
            off += recv_sizes[q]
    return out


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, shape: Sequence[int], placements: tuple,
         lay: MeshLayout):
    """A ``DTensor`` of global ``shape`` over ``lay``'s mesh whose piece on
    this rank is ``local`` (no collective, no check)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(n) for n in shape)
    return DTensor.from_local(local, lay.mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def to_layout_of(x, like, lay: MeshLayout) -> torch.Tensor:
    """This rank's piece of ``x`` under ``like``'s placement (``x`` and
    ``like`` of one global shape): elementwise work on two leaves of
    different layouts runs on these pieces."""
    src, dst = placements_of(x, lay), placements_of(like, lay)
    if src == dst:
        return local_of(x)
    return move(local_of(x), x.shape, src, dst, lay)


def elementwise(fn, like, args, lay: MeshLayout):
    """``fn`` applied to this rank's pieces of ``args`` (each brought to
    ``like``'s layout; None passes through), its result (a tensor or a
    tuple of them) laid out as ``like``: an elementwise function of
    leaves in any layouts, computed where ``like``'s pieces lie."""
    out = fn(*(None if x is None else to_layout_of(x, like, lay)
               for x in args))
    if not _is_dtensor(like):
        return out
    pl = placements_of(like, lay)
    back = lambda o: wrap(o, like.shape, pl, lay)
    return tuple(map(back, out)) if isinstance(out, tuple) else back(out)


def restore(local: torch.Tensor, like, solved: tuple, lay: MeshLayout):
    """The result of a solve on ``local`` (this rank's piece under
    ``solved``) in the layout it goes back to: ``like``'s own when ``like``
    is sharded on every mesh dim that has more than one rank (the inverse
    of the move in), else the solved layout itself, the reference's
    ``out_specs`` (a replicated leaf comes back column-sharded, with no
    gather). A leaf that was and stays replicated everywhere comes back as
    a plain tensor if it came as one."""
    src = placements_of(like, lay)
    if not _rep_dims(src, lay):
        out = (local if src == solved
               else move(local, like.shape, solved, src, lay))
        return wrap(out, like.shape, src, lay) if _is_dtensor(like) else out
    if not _is_dtensor(like) and not _placed(solved, lay):
        return local
    return wrap(local, like.shape, solved, lay)


def _placed(placements, lay: MeshLayout) -> bool:
    """True when some mesh dim of more than one rank shards the tensor."""
    Shard, _ = _placement_types()
    return any(type(pl) is Shard and n > 1
               for pl, n in zip(placements, lay.shape))


def counts_once(x, lay: MeshLayout) -> bool:
    """Whether this rank's piece of ``x`` counts in a sum over the mesh:
    of the ranks holding the same piece (they differ only on replicated
    mesh dims), the one at coordinate 0 on those dims counts."""
    return all(lay.coords[lay.me][i] == 0
               for i in _rep_dims(placements_of(x, lay), lay))


def sharded_clip_scale(tree_leaves, max_norm: float, lay: MeshLayout):
    """``optim.adam.clip_scale`` of leaves spread over a mesh: each rank
    sums the squares of the pieces it counts, one (1,) SUM all-reduce
    adds them up, so every rank gets the same multiplier."""
    total = torch.zeros((1,), dtype=torch.float32,
                        device=local_of(tree_leaves[0]).device)
    for x in tree_leaves:
        if counts_once(x, lay):
            total = total + torch.sum(torch.square(
                local_of(x).to(torch.float32)))
    dist.all_reduce(total, group=lay.group)
    norm = torch.sqrt(total[0])
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
