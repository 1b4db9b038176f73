"""ProjectionEngine: ONE projected-update path for every train loop (port of
``repro.core.engine``).

  * ``ProjectionEngine`` owns plan building (``core.constraints``),
    packing, per-plan theta state and solver dispatch:
      - ``newton`` — single-buffer segmented Newton (``core.l1inf``);
      - ``kernel`` — the sparsity-adaptive engine on the hand-written CUDA
        kernels (``kernels/l1inf``; the JAX package's ``pallas``). On CPU
        tensors it runs the kernels' plain versions;
      - ``fused``  — routes plans exactly as the JAX engine does: inside
        ``projected_update``, plans whose family streams its statistics
        (``from_colstats``: ``bilevel``, ``l12``) at ``every_k == 1`` take
        the two-pass fused optimizer+projection step on the
        ``kernels/fused_step`` kernels (counter ``<plan>/fused``); every
        other plan, and ``apply``, solves as ``newton``;
      - ``sharded`` — the mesh-resident solve (``dist.projection``): each
        plan solves on column blocks split over the ranks of ``mesh``,
        leaves move there by one all-to-all (never an all-gather), and the
        per-segment statistics cross the ranks as one (2, num_segments)
        all-reduce per Newton evaluation;
      - ``fused_sharded`` — ``fused`` on a mesh: the fused passes run on
        each rank's column block, and every plan they cannot take solves
        exactly as ``sharded``.
  * ``engine.apply(params, step=, state=)`` projects a parameter tree.
  * ``engine.projected_update(grads, opt_state, params, acfg, ...)`` is the
    shared step core: optimizer update, projection gated on the NEW
    optimizer count, optional support-mask freeze, warm-start threading.
  * ``apply_constraints_packed`` / ``init_projection_state`` are the JAX
    package's functional shims over the engine.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .._device import host_int
from .._tree import flatten_with_path, leaves, tree_map, unflatten_like
from .constraints import (ProjectionSpec, build_packed_plans, engine_count,
                          _apply_2d, _gated, _pack_entry, _project_fn,
                          _unpack_entry)
from .families import get_family, project_segmented_family
from .l1inf import _segmented_newton

__all__ = ["ProjectionEngine", "apply_constraints_packed",
           "init_projection_state"]

_SOLVERS = ("newton", "kernel", "fused", "sharded", "fused_sharded")
_MESH_SOLVERS = ("sharded", "fused_sharded")

# the JAX package's solver names that the port calls otherwise
_JAX_SOLVER_NAMES = {"pallas": "kernel"}

# Identity sentinel of the fused clip pass: a per-column clip level far
# above any parameter magnitude, so sign(u) * min(|u|, _MU_INF) == u.
_MU_INF = 1e30


def _fused_level(fam, aux, mu, inside_seg, zero_seg, sids):
    """Pass 2's per-column level with the identity/zero segment gating
    folded in, so the pass is one min() or multiply: clip families gate
    with the 1e30 sentinel, scale families (l1,2) turn mu into the column
    multiplier with identity 1.0."""
    if getattr(fam.seg_ops, "fused_mode", "clip") == "scale":
        lvl = fam.seg_ops.fused_scale(aux, mu)
        ident = torch.ones((), dtype=lvl.dtype, device=lvl.device)
    else:
        lvl = mu
        ident = torch.full((), _MU_INF, dtype=mu.dtype, device=mu.device)
    return torch.where(zero_seg[sids], torch.zeros_like(lvl),
                       torch.where(inside_seg[sids], ident, lvl))


class ProjectionEngine:
    """Plan building + theta state + solver dispatch for projection specs.

    ``solver`` is "newton" | "kernel" | "fused" | "sharded" |
    "fused_sharded" (see the module docstring); the last two need
    ``mesh``, a ``DeviceMesh`` over the caller's process group, and take
    leaves as ``DTensor``s on it (or plain tensors, which every rank holds
    whole). On a mesh every rank calls the engine with the same tree and
    step. The engine is stateless: the theta warm-start dict from
    ``init_state`` threads through the caller's train state.

    >>> engine = ProjectionEngine((spec,)); state = engine.init_state(params)
    """

    def __init__(self, specs: Sequence[ProjectionSpec], *,
                 solver: str = "newton", mesh=None):
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r} (one of {_SOLVERS})")
        if solver in _MESH_SOLVERS and mesh is None:
            raise ValueError(f"solver={solver!r} needs a mesh")
        self.specs = tuple(specs or ())
        self.solver = solver
        self.mesh = mesh if solver in _MESH_SOLVERS else None

    def plans(self, params: Any):
        """(packed plans, per-leaf remainder) for this parameter tree."""
        return build_packed_plans(params, self.specs)

    def init_state(self, params: Any) -> Dict[str, torch.Tensor]:
        """Zero theta warm-start vectors, one per packed plan, on the
        device of the plan's first leaf."""
        plans, _ = self.plans(params)
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        return {p.key: torch.zeros((p.num_segments,), dtype=torch.float32,
                                   device=leaves[p.entries[0].index].device)
                for p in plans}

    # -- the projection ------------------------------------------------------

    def _solve_plan(self, plan, leaves, theta0):
        """One packed solve of one family sub-buffer. Returns
        (projected-by-leaf-index dict, theta, iters); iters is -1 under
        the kernel solver, which keeps its own counters. Under
        ``fused_sharded`` a plan solves exactly as under ``sharded``."""
        eff = {"fused": "newton",
               "fused_sharded": "sharded"}.get(self.solver, self.solver)
        engine_count(f"{plan.key}/{eff}")
        if eff == "sharded":
            from ..dist.projection import project_plan_sharded
            outs, theta, iters = project_plan_sharded(
                [leaves[e.index] for e in plan.entries], plan, self.mesh,
                theta0=theta0)
            return (dict(zip((e.index for e in plan.entries), outs)),
                    theta, iters)
        fam = get_family(plan.family)
        pieces = [_pack_entry(leaves[e.index], e, plan.n_max)
                  for e in plan.entries]
        Ypk = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
        dev = Ypk.device
        sids = torch.as_tensor(plan.seg_ids(), device=dev)
        C_seg = torch.as_tensor(plan.radii(), device=dev)
        w_col = (torch.as_tensor(plan.col_weights(), device=dev)
                 if fam.uses_weights else None)
        if self.solver == "kernel" and fam.kernel_loader is not None:
            Xpk, theta = fam.kernel_loader()(
                Ypk, sids, C_seg, num_segments=plan.num_segments,
                theta0=theta0)
            iters = -1
        else:
            Xpk, theta, iters = project_segmented_family(
                Ypk, sids, C_seg, num_segments=plan.num_segments,
                family=plan.family, w_col=w_col, theta0=theta0)
        outs = {}
        for e in plan.entries:
            block = Xpk[:, e.col_start: e.col_start + e.lead * e.m_pad]
            outs[e.index] = _unpack_entry(block, e, leaves[e.index])
        return outs, theta, iters

    def _project_leaves(self, leaves, plans, per_leaf, step, state,
                        skip=frozenset()):
        """Project the flat ``leaves`` list in place: one solve per plan
        whose key is not in ``skip``, then the per-leaf specs, each gated
        on ``step`` by its ``every_k`` (a gated plan keeps its previous
        theta). A host int ``step`` gates on the host: a plan or spec off
        its step is not solved at all. Returns (theta state, {plan.key:
        iters})."""
        new_state: Dict[str, torch.Tensor] = {}
        stats: Dict[str, Any] = {}
        if self.mesh is not None and isinstance(step, torch.Tensor):
            # every rank must take the same solves: gate on the host (None
            # on meta, where every gate fires)
            step = host_int(step)
        off = lambda every_k: isinstance(step, int) and step % every_k != 0
        for plan in plans:
            if plan.key in skip:
                continue
            theta0 = None if state is None else state.get(plan.key)
            if off(plan.every_k):
                new_state[plan.key] = theta0 if theta0 is not None else \
                    torch.zeros((plan.num_segments,), dtype=torch.float32,
                                device=leaves[plan.entries[0].index].device)
                continue
            projected, theta, iters = self._solve_plan(plan, leaves, theta0)
            for e in plan.entries:
                leaves[e.index] = _gated(projected[e.index], leaves[e.index],
                                         step, plan.every_k)
            if isinstance(step, torch.Tensor) and plan.every_k > 1:
                prev = (theta0 if theta0 is not None
                        else torch.zeros_like(theta))
                theta = torch.where((step % plan.every_k) == 0, theta, prev)
            new_state[plan.key] = theta
            stats[plan.key] = iters

        for i, spec in per_leaf:
            if off(spec.every_k):
                continue
            engine_count("per_leaf")
            if self.mesh is not None:
                from ..dist.projection import project_leaf_sharded
                projected = project_leaf_sharded(leaves[i], spec, self.mesh)
            else:
                projected = _apply_2d(_project_fn(spec), leaves[i],
                                      spec.radius, spec.axis)
            leaves[i] = _gated(projected, leaves[i], step, spec.every_k)
        return new_state, stats

    def apply(self, params: Any, *, step: Optional[torch.Tensor] = None,
              state: Optional[Dict[str, torch.Tensor]] = None,
              with_stats: bool = False):
        """Project matching leaves of ``params``: ONE solve per (family,
        every_k) sub-buffer, the per-leaf path for unpackable norms.

        ``state`` threads the per-plan theta vectors between steps;
        ``step`` (a 0-d tensor, or a host int that skips the solves off
        their step) gates ``every_k > 1`` specs. Returns (params,
        new_state), plus {plan.key: Eq.-(19) eval count} when
        ``with_stats``.
        """
        if not self.specs:
            out = (params, dict(state or {}))
            return out + ({},) if with_stats else out
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        plans, per_leaf = self.plans(params)
        new_state, stats = self._project_leaves(leaves, plans, per_leaf,
                                                step, state)

        params = unflatten_like(params, leaves)
        if with_stats:
            return params, new_state, stats
        return params, new_state

    # -- the shared projected-update step core -------------------------------

    def projected_update(self, grads: Any, opt_state, params: Any, acfg, *,
                         lr=None, mask: Any = None,
                         state: Optional[Dict[str, torch.Tensor]] = None,
                         with_stats: bool = False,
                         count: Optional[int] = None,
                         inplace: bool = False,
                         grad_reduce: Optional[Any] = None):
        """Optimizer update + projection + gating: the step core of the
        port's train loops.

        Runs ``adam_update`` (optional ``lr`` override and ``mask``
        gradient freeze), projects through ``apply`` gated on the NEW
        optimizer count, re-applies ``mask`` to the params (the
        double-descent support freeze) and threads the theta state.

        Under ``solver="fused"``, plans whose family streams its Newton
        statistics (``from_colstats``) at ``every_k == 1`` take the
        two-pass fused step instead (``_projected_update_fused``); every
        other plan and per-leaf spec replays this unfused path.
        On a mesh (``sharded``, ``fused_sharded``) the whole step is
        ``dist.projection.projected_update_sharded``: the same passes on
        each rank's pieces and column blocks.

        ``grad_reduce``: optional callable applied to ``grads`` first: the
        hook for data-parallel callers whose gradients are still per-rank
        partials (e.g. ``dist.compression.compressed_psum``). It leaves the
        projection's one all-reduce per evaluation untouched.

        ``count`` is the NEW optimizer count as a host int, when the
        caller tracks it: the ``every_k`` gates then run on the host and a
        plan off its step is not solved (no launch). ``inplace`` has the
        unfused Adam update write into the tensors of ``params`` and
        ``opt_state`` (``adam_update``), so a full-size train step holds
        no second copy of its state; projected leaves, and every leaf of
        the fused step, come back as new tensors (on a mesh every leaf
        does).

        Returns (params, opt_state, proj_state), plus {plan.key: Eq.-(19)
        evaluation count} when ``with_stats``.
        """
        if grad_reduce is not None:
            grads = grad_reduce(grads)
        if self.mesh is not None:
            from ..dist.projection import projected_update_sharded
            return projected_update_sharded(
                self, grads, opt_state, params, acfg, lr=lr, mask=mask,
                state=state, with_stats=with_stats, count=count)
        if self.solver == "fused" and self.specs:
            plans, per_leaf = self.plans(params)
            fused_plans = self._fused_plans(plans)
            if fused_plans:
                return self._projected_update_fused(
                    grads, opt_state, params, acfg, lr=lr, mask=mask,
                    state=state, plans=plans, per_leaf=per_leaf,
                    fused_plans=fused_plans, with_stats=with_stats,
                    host_count=count)
        from ..optim.adam import adam_update
        new_params, new_opt = adam_update(grads, opt_state, params, acfg,
                                          lr=lr, mask=mask, inplace=inplace)
        stats: Dict[str, Any] = {}
        if self.specs:
            new_params, state, stats = self.apply(
                new_params, step=new_opt.count if count is None else count,
                state=state, with_stats=True)
            if mask is not None:
                new_params = tree_map(lambda p, m: p * m, new_params, mask)
        else:
            state = dict(state or {})
        if with_stats:
            return new_params, new_opt, state, stats
        return new_params, new_opt, state

    @staticmethod
    def _fused_plans(plans):
        """The plans the fused passes take: families that stream their
        Newton statistics (``from_colstats``), at ``every_k == 1``."""
        return [p for p in plans if p.every_k == 1 and hasattr(
            get_family(p.family).seg_ops, "from_colstats")]

    def _projected_update_fused(self, grads, opt_state, params: Any, acfg, *,
                                lr, mask, state, plans, per_leaf,
                                fused_plans, with_stats, host_count=None):
        """The two-pass step. ``fused_plans`` take the fused kernels; every
        other plan and leaf replays the unfused path on the updated leaves,
        so mixed spec lists stay exact.

        Per fused plan: pass 1 (``fused_adam_colstats``) over each leaf
        writes the moments and emits per-column statistics; the segmented
        Newton runs on the O(columns) statistics; pass 2
        (``fused_adam_clip_apply``) recomputes the update from the stored
        moments and writes the projected params. The updated, unprojected
        params are never materialized.
        """
        from ..kernels.fused_step import (fused_adam_clip_apply,
                                          fused_adam_colstats)
        from ..optim.adam import (AdamState, adam_leaf_update, adam_scalars,
                                  clip_scale)

        p_leaves, g_leaves = leaves(params), leaves(grads)
        m_leaves, v_leaves = leaves(opt_state.mu), leaves(opt_state.nu)
        mk_leaves = (leaves(mask) if mask is not None
                     else [None] * len(p_leaves))

        count = opt_state.count + 1
        lr_t, b1c, b2c = adam_scalars(acfg, count, lr)
        scale = (clip_scale(grads, acfg.clip_norm)
                 if acfg.clip_norm is not None else None)

        fused_idx = {e.index for plan in fused_plans for e in plan.entries}
        new_p, new_m, new_v = list(p_leaves), list(m_leaves), list(v_leaves)
        for i in range(len(p_leaves)):
            if i not in fused_idx:
                new_p[i], new_m[i], new_v[i] = adam_leaf_update(
                    g_leaves[i], m_leaves[i], v_leaves[i], p_leaves[i], acfg,
                    lr_t, b1c, b2c, mask=mk_leaves[i], scale=scale)

        new_state: Dict[str, torch.Tensor] = {}
        stats: Dict[str, Any] = {}
        for plan in fused_plans:
            engine_count(f"{plan.key}/fused")
            fam = get_family(plan.family)
            theta0 = None if state is None else state.get(plan.key)
            stat = getattr(fam.seg_ops, "colstats_stat", "abs")
            mode = getattr(fam.seg_ops, "fused_mode", "clip")
            sums, maxes = [], []
            # pass 1: moments written, O(m) statistics out per leaf
            for e in plan.entries:
                i = e.index
                new_m[i], new_v[i], cs, cm = fused_adam_colstats(
                    g_leaves[i], m_leaves[i], v_leaves[i], p_leaves[i],
                    cfg=acfg, lr_t=lr_t, b1c=b1c, b2c=b2c, scale=scale,
                    mask=mk_leaves[i], transpose=e.transpose, stat=stat)
                sums.append(cs.reshape(-1))
                maxes.append(cm.reshape(-1))
            colsum = torch.cat(sums) if len(sums) > 1 else sums[0]
            colmax = torch.cat(maxes) if len(maxes) > 1 else maxes[0]
            dev = colsum.device
            sids = torch.as_tensor(plan.virtual_seg_ids(), device=dev)
            C_seg = torch.as_tensor(plan.radii(), device=dev)
            w_col = (torch.as_tensor(plan.virtual_col_weights(), device=dev)
                     if fam.uses_weights else None)
            aux = fam.seg_ops.from_colstats(colsum, colmax, w_col)
            mu, theta, iters, inside_seg, zero_seg = _segmented_newton(
                aux, sids, C_seg, plan.num_segments, theta0, 32,
                ops=fam.seg_ops)
            mu_eff = _fused_level(fam, aux, mu, inside_seg, zero_seg, sids)
            # pass 2: the update recomputed from the stored moments,
            # clipped or scaled and written: the step's only param write
            off = 0
            for e in plan.entries:
                span = e.lead * e.m
                i = e.index
                new_p[i] = fused_adam_clip_apply(
                    new_m[i], new_v[i], p_leaves[i],
                    mu_eff[off:off + span].reshape(e.lead, e.m), cfg=acfg,
                    lr_t=lr_t, b1c=b1c, b2c=b2c, mask=mk_leaves[i],
                    transpose=e.transpose, mode=mode)
                off += span
            new_state[plan.key] = theta
            stats[plan.key] = iters

        # unfused remainder: every_k-gated plans and families without the
        # streaming hook (packed Newton), then the per-leaf norms
        rest_state, rest_stats = self._project_leaves(
            new_p, plans, per_leaf, count if host_count is None
            else host_count, state, skip={plan.key for plan in fused_plans})
        new_state.update(rest_state)
        stats.update(rest_stats)

        if mask is not None:
            # support freeze on the unfused leaves; the fused pass 2
            # already multiplies its output by the mask
            for i in range(len(new_p)):
                if i not in fused_idx:
                    new_p[i] = new_p[i] * mk_leaves[i]

        new_params = unflatten_like(params, new_p)
        new_opt = AdamState(count=count,
                            mu=unflatten_like(params, new_m),
                            nu=unflatten_like(params, new_v))
        if with_stats:
            return new_params, new_opt, new_state, stats
        return new_params, new_opt, new_state


def init_projection_state(params: Any, specs: Sequence[ProjectionSpec]
                          ) -> Dict[str, torch.Tensor]:
    """Zero theta warm-start vectors, one per packed plan.

    Returns ``{plan key: (num_segments,) f32 zeros}`` on the device of
    each plan's first leaf — the state threaded through
    ``apply_constraints_packed`` between steps.

    >>> state = init_projection_state(params, specs)
    """
    return ProjectionEngine(specs).init_state(params)


def apply_constraints_packed(params: Any, specs: Sequence[ProjectionSpec],
                             step: Optional[torch.Tensor] = None,
                             state: Optional[Dict[str, torch.Tensor]] = None,
                             engine: str = "newton", mesh=None):
    """Project matching leaves with packed multi-tensor batching.

    Functional form of ``ProjectionEngine.apply``: ``engine`` names the
    solver ("newton" | "kernel" | "fused" | "sharded"; the JAX name
    "pallas" means "kernel"; "sharded" needs ``mesh``). ``step``: optional
    scalar int (every_k gating); ``state``: the dict from
    ``init_projection_state`` or a previous call. Returns (projected
    params, new_state).

    >>> params, state = apply_constraints_packed(params, specs, state=state)
    """
    solver = _JAX_SOLVER_NAMES.get(engine, engine)
    return ProjectionEngine(specs, solver=solver, mesh=mesh).apply(
        params, step=step, state=state)
