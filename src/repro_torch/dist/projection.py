"""Mesh-resident packed l1,inf projection (port of ``repro.dist.projection``;
DESIGN.md §7 and §12).

The single-device engine packs every leaf of a plan into one (n_max, sum m)
buffer. Over a mesh that would gather every sharded weight; here the math
stays the same while the shards stay resident:

  * each plan is laid out COLUMN-SHARDED over all the mesh's ranks: rank r
    (row-major in the mesh) owns columns [r * m / D, (r + 1) * m / D) of
    every matrix of every entry. Columns are independent sub-problems, so
    sort, prefix sums and clip never cross ranks;
  * a leaf reaches that column block by ``dist.layout.move``: one
    ``all_to_all_single`` of |leaf| / D bytes per rank from a row-sharded
    (FSDP) placement, a local slice from a replicated one, nothing from
    the block itself; the result goes back by the inverse all-to-all, or
    stays column-sharded where the leaf came replicated (the reference's
    ``out_specs``). No all-gather, no ``DTensor.redistribute``;
  * the segmented Newton runs on the local blocks; per Eq.-(19)
    evaluation the only traffic is one (2, num_segments) f32 all-reduce
    (``core.l1inf._segmented_newton``);
  * a leaf whose column count the mesh does not divide is REPLICATED on
    every rank, its columns counted once (on rank 0) through ``contrib``.
    Reaching that layout from a sharded placement moves the whole leaf to
    every rank each step, so ``shard_packed_plan`` warns.

The plan names its constraint family and every family's statistics are per
column given the shared theta, so plain, weighted, masked, bilevel and l1,2
plans all keep one all-reduce per evaluation; weight-aware families slice
their per-column weights rank-locally. Theta, and so the projected
weights, match the gathered solve up to summation order.

Leaves are ``DTensor``s over the mesh, or plain tensors, which every rank
holds whole (replicated).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constraints import (PackedPlan, _PackedEntry, _apply_2d,
                                _pack_entry, _project_fn, _unpack_entry,
                                _LANE)
from ..core.families import get_family, project_segmented_family_sharded
from .layout import (MeshLayout, column_placements, elementwise, local_of,
                     move, placements_of, replicated_placements, restore,
                     sharded_clip_scale)

__all__ = ["ShardedPlan", "shard_packed_plan", "project_plan_sharded",
           "fused_plan_sharded", "project_leaf_sharded",
           "projected_update_sharded"]

# per-leaf norms whose projection is per column (along the max axis): a
# sharded leaf solves on its column block with no traffic but the moves
_COLUMNWISE_PER_LEAF = ("hoyer",)


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Per-rank layout of one PackedPlan on a mesh (all fields static).

    ``local`` is a PackedPlan describing each rank's column block: entries
    keep their global rows/lead/segment ids but ``m``/``m_pad``/``col_start``
    are per-rank. ``col_sharded[i]`` says entry i's columns are split over
    the mesh (vs replicated on every rank and counted by rank 0).

    >>> sp = shard_packed_plan(plan, n_devices=8)   # sp: ShardedPlan
    """
    global_plan: PackedPlan
    local: PackedPlan
    col_sharded: Tuple[bool, ...]
    n_devices: int

    def owned_cols(self) -> np.ndarray:
        """Static part of the contribution mask: True for columns of
        column-sharded entries (every rank owns its slice); False for
        replicated entries' columns (rank 0 counts them) and for lane
        padding (invalid anyway)."""
        owned = np.zeros((self.local.total_cols,), bool)
        for e, sh in zip(self.local.entries, self.col_sharded):
            if sh:
                owned[e.col_start: e.col_start + e.lead * e.m_pad] = True
        return owned

    def virtual_owned_cols(self) -> np.ndarray:
        """Dense-layout twin of :meth:`owned_cols` for the fused step's
        virtual packing (no lane padding, entry order)."""
        parts = [np.full((e.lead * e.m,), sh, bool)
                 for e, sh in zip(self.local.entries, self.col_sharded)]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), bool))


def shard_packed_plan(plan: PackedPlan, n_devices: int) -> ShardedPlan:
    """Split a packed plan column-wise over ``n_devices`` ranks.

    Entries whose column count the rank count divides get ``m / D``
    columns per rank (lane-padded locally); the rest stay replicated, with
    a warning. Pure shape bookkeeping.

    >>> sp = shard_packed_plan(plan, n_devices=4)
    """
    entries, flags, col = [], [], 0
    for e in plan.entries:
        sharded = n_devices > 1 and e.m % n_devices == 0
        if not sharded and n_devices > 1:
            warnings.warn(
                f"sharded projection: leaf {e.shape} has {e.m} columns, "
                f"not divisible by the {n_devices}-rank mesh — this entry "
                f"is replicated (a sharded leaf then moves whole to every "
                f"rank each step)", stacklevel=2)
        m_loc = e.m // n_devices if sharded else e.m
        m_pad = -(-m_loc // _LANE) * _LANE
        entries.append(dataclasses.replace(e, m=m_loc, m_pad=m_pad,
                                           col_start=col))
        flags.append(sharded)
        col += e.lead * m_pad
    local = PackedPlan(key=plan.key, every_k=plan.every_k, n_max=plan.n_max,
                       total_cols=col, num_segments=plan.num_segments,
                       entries=tuple(entries), family=plan.family)
    return ShardedPlan(global_plan=plan, local=local,
                       col_sharded=tuple(flags), n_devices=n_devices)


def _col_dim(e: _PackedEntry) -> int:
    """Index of the canonical COLUMN dim in the entry's leaf shape (the
    trailing dim, or the one before it when the spec's max axis selected
    the trailing dim)."""
    return len(e.shape) - 2 if e.transpose else len(e.shape) - 1


def _solve_layout(e: _PackedEntry, sharded: bool, lay: MeshLayout) -> tuple:
    return (column_placements(_col_dim(e), lay) if sharded
            else replicated_placements(lay))


def _local_wcol(sp: ShardedPlan, rank: int, padded: bool, device):
    """This rank's slice of the per-column weight vector: a column-sharded
    entry owns the block [rank * m_loc, (rank + 1) * m_loc) of its global
    weights, a replicated one carries them whole. ``padded``: the packed
    buffer's layout (lane padding weighs 1.0), else the fused step's dense
    one."""
    parts = []
    for e, sh in zip(sp.local.entries, sp.col_sharded):
        width = e.m_pad if padded else e.m
        if e.weights is None:
            parts.append(np.ones((e.lead * width,), np.float32))
            continue
        wg = np.asarray(e.weights, np.float32)
        w = wg[rank * e.m:(rank + 1) * e.m] if sh else wg
        w = np.pad(w, (0, width - e.m), constant_values=1.0)
        parts.append(np.tile(w, e.lead))
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _contrib(owned: np.ndarray, lay: MeshLayout, device) -> torch.Tensor:
    return torch.from_numpy(owned | (lay.rank == 0)).to(device)


def project_plan_sharded(leaves: Sequence, plan: PackedPlan, mesh,
                         theta0: Optional[torch.Tensor] = None,
                         max_iter: int = 32):
    """Project one packed plan's leaves, shards resident.

    ``leaves`` are the plan entries' leaves in entry order: ``DTensor``s on
    ``mesh`` in any Shard/Replicate placement, or plain tensors (held whole
    by every rank); ``theta0``: optional (num_segments,) f32 warm start,
    the same on every rank. Returns (projected leaves, theta
    (num_segments,) f32 on every rank, iters int); each projected leaf is
    in its input's layout, or column-sharded where the input was
    replicated (see ``dist.layout.restore``).

    >>> outs, theta, iters = project_plan_sharded(vals, plan, mesh)
    """
    lay = MeshLayout(mesh)
    sp = shard_packed_plan(plan, lay.size)
    fam = get_family(plan.family)
    layouts, blocks = [], []
    for x, e, sh in zip(leaves, plan.entries, sp.col_sharded):
        pl = _solve_layout(e, sh, lay)
        layouts.append(pl)
        blocks.append(move(local_of(x), x.shape, placements_of(x, lay), pl,
                           lay))
    dev = blocks[0].device
    pieces = [_pack_entry(b, e, plan.n_max)
              for b, e in zip(blocks, sp.local.entries)]
    Ypk = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
    Xpk, theta, iters = project_segmented_family_sharded(
        Ypk, torch.as_tensor(sp.local.seg_ids(), device=dev),
        torch.as_tensor(plan.radii(), device=dev),
        num_segments=plan.num_segments, group=lay.group,
        family=plan.family,
        w_col=(_local_wcol(sp, lay.rank, True, dev) if fam.uses_weights
               else None),
        theta0=theta0, contrib=_contrib(sp.owned_cols(), lay, dev),
        max_iter=max_iter)
    outs = []
    for x, b, e, pl in zip(leaves, blocks, sp.local.entries, layouts):
        block = Xpk[:, e.col_start: e.col_start + e.lead * e.m_pad]
        outs.append(restore(_unpack_entry(block, e, b), x, pl, lay))
    return outs, theta, iters


def project_leaf_sharded(x, spec, mesh):
    """A per-leaf spec (a norm with no packed solve) over a mesh. A leaf
    held whole by every rank projects locally and stays so; a sharded leaf
    of a column-wise norm (``hoyer``) projects on its column block; other
    norms (the ``l1`` ball couples all entries of a leaf) need the leaf
    replicated."""
    lay = MeshLayout(mesh)
    src = placements_of(x, lay)
    fn = _project_fn(spec)
    if all(pl.is_replicate() or n == 1 for pl, n in zip(src, lay.shape)):
        return restore(_apply_2d(fn, local_of(x), spec.radius, spec.axis),
                       x, src, lay)
    if spec.norm not in _COLUMNWISE_PER_LEAF:
        raise ValueError(
            f"norm {spec.norm!r} projects a leaf as a whole: on a mesh give "
            f"{tuple(x.shape)} replicated, or use a column-wise norm")
    col = x.ndim - 2 if spec.axis in (1, -1) else x.ndim - 1
    pl = column_placements(col, lay)
    block = move(local_of(x), x.shape, src, pl, lay)
    return restore(_apply_2d(fn, block, spec.radius, spec.axis), x, pl, lay)


def fused_plan_sharded(plan: PackedPlan, mesh,
                       g_leaves: Sequence, m_leaves: Sequence,
                       v_leaves: Sequence, p_leaves: Sequence,
                       mask_leaves: Sequence, *, acfg, lr_t, b1c, b2c,
                       scale=None, theta0: Optional[torch.Tensor] = None,
                       max_iter: int = 32):
    """The two-pass fused optimizer+projection step, shards resident.

    For one packed plan whose family streams its Newton statistics
    (``from_colstats``):

      * pass 1 (``fused_adam_colstats``, the ``adam_colstats`` kernel on
        the card) runs RANK-LOCAL on each rank's column block: rows are
        resident, so every per-column (sum, max) statistic and every moment
        is bitwise the single-device value;
      * the per-segment reductions cross the mesh inside the warm-started
        segmented Newton as one (2, num_segments) all-reduce per Eq.-(19)
        evaluation (replicated entries counted once through ``contrib``);
      * pass 2 (``fused_adam_clip_apply``, the ``adam_clip_apply`` kernel)
        recomputes u from the moments pass 1 wrote and clips rank-local.

    ``g/m/v/p/mask_leaves``: the plan entries' leaves in entry order, each
    a ``DTensor`` on ``mesh`` in any Shard/Replicate placement or a plain
    tensor held whole (``mask_leaves`` entries may be None). Each moves to
    its column block (``dist.layout.move``) and the new params and moments
    go back to the layouts of ``p``, ``m`` and ``v``. ``lr_t``/``b1c``/
    ``b2c``/``scale``: the step scalars (``optim.adam.adam_scalars``, the
    mesh's clip scale), the same on every rank. Returns ``(p_new, m_new,
    v_new, theta, iters)`` with the leaf lists in entry order. Params match
    the single-device fused step up to the summation order of the theta
    all-reduces.

    >>> ps, ms, vs, th, it = fused_plan_sharded(plan, mesh, gs, ms0, vs0,
    ...     ps0, [None] * len(gs), acfg=acfg, lr_t=lr_t, b1c=b1c, b2c=b2c)
    """
    from ..core.engine import _fused_level
    from ..core.l1inf import _segmented_newton
    from ..kernels.fused_step import (fused_adam_clip_apply,
                                      fused_adam_colstats)

    lay = MeshLayout(mesh)
    sp = shard_packed_plan(plan, lay.size)
    fam = get_family(plan.family)
    stat = getattr(fam.seg_ops, "colstats_stat", "abs")
    mode = getattr(fam.seg_ops, "fused_mode", "clip")

    def block(x, pl):
        return (None if x is None else
                move(local_of(x), x.shape, placements_of(x, lay), pl, lay))

    # pass 1, rank-local: moments written, O(m_loc) statistics out — the
    # updated values never reach memory, the block never moves
    layouts, ins, new_m, new_v, sums, maxes = [], [], [], [], [], []
    for g, m, v, p, mk, e, sh in zip(g_leaves, m_leaves, v_leaves, p_leaves,
                                     mask_leaves, plan.entries,
                                     sp.col_sharded):
        pl = _solve_layout(e, sh, lay)
        gb, mb, vb, pb, mkb = (block(t, pl) for t in (g, m, v, p, mk))
        mn, vn, cs, cm = fused_adam_colstats(
            gb, mb, vb, pb, cfg=acfg, lr_t=lr_t, b1c=b1c, b2c=b2c,
            scale=scale, mask=mkb, transpose=e.transpose, stat=stat)
        layouts.append(pl)
        ins.append((pb, mkb))
        new_m.append(mn)
        new_v.append(vn)
        sums.append(cs.reshape(-1))
        maxes.append(cm.reshape(-1))
    colsum = torch.cat(sums) if len(sums) > 1 else sums[0]
    colmax = torch.cat(maxes) if len(maxes) > 1 else maxes[0]
    dev = colsum.device
    sids = torch.as_tensor(sp.local.virtual_seg_ids(), device=dev)
    w_col = (_local_wcol(sp, lay.rank, False, dev) if fam.uses_weights
             else None)
    aux = fam.seg_ops.from_colstats(colsum, colmax, w_col)
    mu, theta, iters, inside_seg, zero_seg = _segmented_newton(
        aux, sids, torch.as_tensor(plan.radii(), device=dev),
        plan.num_segments, theta0, max_iter, ops=fam.seg_ops,
        group=lay.group, contrib=_contrib(sp.virtual_owned_cols(), lay, dev))
    mu_eff = _fused_level(fam, aux, mu, inside_seg, zero_seg, sids)

    # pass 2, rank-local: u recomputed from the just-written moments,
    # clipped or scaled — the step's only param write
    new_p, off = [], 0
    for (pb, mkb), mn, vn, e in zip(ins, new_m, new_v, sp.local.entries):
        span = e.lead * e.m
        new_p.append(fused_adam_clip_apply(
            mn, vn, pb, mu_eff[off:off + span].reshape(e.lead, e.m),
            cfg=acfg, lr_t=lr_t, b1c=b1c, b2c=b2c, mask=mkb,
            transpose=e.transpose, mode=mode))
        off += span
    back = lambda outs, likes: [restore(o, x, pl, lay) for o, x, pl
                                in zip(outs, likes, layouts)]
    return (back(new_p, p_leaves), back(new_m, m_leaves),
            back(new_v, v_leaves), theta, iters)


def projected_update_sharded(engine, grads, opt_state, params, acfg, *,
                             lr=None, mask=None, state=None,
                             with_stats: bool = False,
                             count: Optional[int] = None):
    """``ProjectionEngine.projected_update`` on the engine's mesh: the step
    of the ``sharded`` and ``fused_sharded`` solvers.

    A leaf's gradient, moments and mask may lie in other layouts than the
    param: the Adam update of every leaf the fused passes do not take runs
    on this rank's pieces in the param's layout (``layout.elementwise``: a
    local slice, or one all-to-all), and the global-norm clip adds the
    pieces up with one (1,) all-reduce. Under ``fused_sharded`` the plans
    the fused passes take run ``fused_plan_sharded``; every other plan and
    per-leaf spec projects the updated leaves as ``sharded`` does. Every
    leaf comes back as a new tensor. Returns what ``projected_update``
    returns.
    """
    from .._tree import leaves, unflatten_like
    from ..core.constraints import engine_count
    from ..optim.adam import AdamState, adam_leaf_update, adam_scalars

    lay = MeshLayout(engine.mesh)
    p_l, g_l = leaves(params), leaves(grads)
    m_l, v_l = leaves(opt_state.mu), leaves(opt_state.nu)
    mk_l = leaves(mask) if mask is not None else [None] * len(p_l)
    new_count = opt_state.count + 1
    lr_t, b1c, b2c = adam_scalars(acfg, new_count, lr)
    scale = (sharded_clip_scale(g_l, acfg.clip_norm, lay)
             if acfg.clip_norm is not None else None)
    plans, per_leaf = engine.plans(params) if engine.specs else ([], [])
    fused = (engine._fused_plans(plans)
             if engine.solver == "fused_sharded" else [])
    fused_idx = {e.index for plan in fused for e in plan.entries}

    def update(g, m, v, p, mk):
        return adam_leaf_update(g, m, v, p, acfg, lr_t, b1c, b2c, mask=mk,
                                scale=scale)

    new_p, new_m, new_v = list(p_l), list(m_l), list(v_l)
    for i in range(len(p_l)):
        if i not in fused_idx:
            new_p[i], new_m[i], new_v[i] = elementwise(
                update, p_l[i], (g_l[i], m_l[i], v_l[i], p_l[i], mk_l[i]),
                lay)

    new_state, stats = {}, {}
    for plan in fused:
        engine_count(f"{plan.key}/fused_sharded")
        idx = [e.index for e in plan.entries]
        ps, ms, vs, theta, iters = fused_plan_sharded(
            plan, engine.mesh, *([lst[i] for i in idx]
                                 for lst in (g_l, m_l, v_l, p_l, mk_l)),
            acfg=acfg, lr_t=lr_t, b1c=b1c, b2c=b2c, scale=scale,
            theta0=None if state is None else state.get(plan.key))
        for i, p_i, m_i, v_i in zip(idx, ps, ms, vs):
            new_p[i], new_m[i], new_v[i] = p_i, m_i, v_i
        new_state[plan.key] = theta
        stats[plan.key] = iters

    if engine.specs:
        rest_state, rest_stats = engine._project_leaves(
            new_p, plans, per_leaf, new_count if count is None else count,
            state, skip={plan.key for plan in fused})
        new_state.update(rest_state)
        stats.update(rest_stats)
    else:
        new_state = dict(state or {})
    if mask is not None:
        # the support freeze; the fused pass 2 already masks its output
        for i in range(len(new_p)):
            if i not in fused_idx:
                new_p[i] = elementwise(torch.mul, new_p[i],
                                       (new_p[i], mk_l[i]), lay)

    new_params = unflatten_like(params, new_p)
    new_opt = AdamState(count=new_count, mu=unflatten_like(params, new_m),
                        nu=unflatten_like(params, new_v))
    if with_stats:
        return new_params, new_opt, new_state, stats
    return new_params, new_opt, new_state
