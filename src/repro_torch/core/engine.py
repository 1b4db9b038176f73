"""ProjectionEngine: ONE projected-update path for every train loop (port of
``repro.core.engine``).

  * ``ProjectionEngine`` owns plan building (``core.constraints``),
    packing, per-plan theta state and solver dispatch:
      - ``newton`` — single-buffer segmented Newton (``core.l1inf``);
      - ``kernel`` — the sparsity-adaptive engine on the hand-written CUDA
        kernels (``kernels/l1inf``; the JAX package's ``pallas``). On CPU
        tensors it runs the kernels' plain versions;
      - ``fused``  — routes plans exactly as the JAX engine does: plans
        whose family streams its statistics (``from_colstats``) at
        ``every_k == 1`` take the fused optimizer+projection step, every
        other plan solves as ``newton``. No ported family has that hook
        yet, so every plan takes the Newton path; a plan that reached the
        fused branch would raise NotImplementedError.
    ``sharded`` and ``fused_sharded`` are not ported yet and raise
    NotImplementedError.
  * ``engine.apply(params, step=, state=)`` projects a parameter tree.
  * ``engine.projected_update(grads, opt_state, params, acfg, ...)`` is the
    shared step core: optimizer update, projection gated on the NEW
    optimizer count, optional support-mask freeze, warm-start threading.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .._tree import flatten_with_path, tree_map, unflatten_like
from .constraints import (ProjectionSpec, build_packed_plans, engine_count,
                          _apply_2d, _gated, _pack_entry, _project_fn,
                          _unpack_entry)
from .families import get_family, project_segmented_family

__all__ = ["ProjectionEngine"]

_SOLVERS = ("newton", "kernel", "fused")
_NOT_PORTED = {
    "sharded": "ROADMAP.md queue A item 8 (distributed)",
    "fused_sharded": "ROADMAP.md queue A item 8 (distributed)",
}
_FUSED_ITEM = "ROADMAP.md queue A item 1 (fused step and families)"


class ProjectionEngine:
    """Plan building + theta state + solver dispatch for projection specs.

    ``solver`` is "newton" | "kernel" | "fused" (see the module
    docstring). The engine is stateless: the theta warm-start dict from
    ``init_state`` threads through the caller's train state.

    >>> engine = ProjectionEngine((spec,)); state = engine.init_state(params)
    """

    def __init__(self, specs: Sequence[ProjectionSpec], *,
                 solver: str = "newton"):
        if solver in _NOT_PORTED:
            raise NotImplementedError(
                f"solver={solver!r} is not ported: {_NOT_PORTED[solver]}")
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r} (one of {_SOLVERS})")
        self.specs = tuple(specs or ())
        self.solver = solver

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
        the kernel solver, which keeps its own counters."""
        eff = "newton" if self.solver == "fused" else self.solver
        engine_count(f"{plan.key}/{eff}")
        fam = get_family(plan.family)
        pieces = [_pack_entry(leaves[e.index], e, plan.n_max)
                  for e in plan.entries]
        Ypk = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
        dev = Ypk.device
        sids = torch.as_tensor(plan.seg_ids(), device=dev)
        C_seg = torch.as_tensor(plan.radii(), device=dev)
        if self.solver == "kernel" and fam.kernel_loader is not None:
            Xpk, theta = fam.kernel_loader()(
                Ypk, sids, C_seg, num_segments=plan.num_segments,
                theta0=theta0)
            iters = -1
        else:
            Xpk, theta, iters = project_segmented_family(
                Ypk, sids, C_seg, num_segments=plan.num_segments,
                family=plan.family, theta0=theta0)
        outs = {}
        for e in plan.entries:
            block = Xpk[:, e.col_start: e.col_start + e.lead * e.m_pad]
            outs[e.index] = _unpack_entry(block, e, leaves[e.index])
        return outs, theta, iters

    def apply(self, params: Any, *, step: Optional[torch.Tensor] = None,
              state: Optional[Dict[str, torch.Tensor]] = None,
              with_stats: bool = False):
        """Project matching leaves of ``params``: ONE solve per (family,
        every_k) sub-buffer, the per-leaf path for unpackable norms.

        ``state`` threads the per-plan theta vectors between steps;
        ``step`` gates ``every_k > 1`` specs. Returns (params, new_state),
        plus {plan.key: Eq.-(19) eval count} when ``with_stats``.
        """
        if not self.specs:
            out = (params, dict(state or {}))
            return out + ({},) if with_stats else out
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        plans, per_leaf = self.plans(params)
        new_state: Dict[str, torch.Tensor] = {}
        stats: Dict[str, Any] = {}

        for plan in plans:
            theta0 = None if state is None else state.get(plan.key)
            projected, theta, iters = self._solve_plan(plan, leaves, theta0)
            for e in plan.entries:
                leaves[e.index] = _gated(projected[e.index], leaves[e.index],
                                         step, plan.every_k)
            if step is not None and plan.every_k > 1:
                prev = (theta0 if theta0 is not None
                        else torch.zeros_like(theta))
                theta = torch.where((step % plan.every_k) == 0, theta, prev)
            new_state[plan.key] = theta
            stats[plan.key] = iters

        for i, spec in per_leaf:
            engine_count("per_leaf")
            projected = _apply_2d(_project_fn(spec), leaves[i], spec.radius,
                                  spec.axis)
            leaves[i] = _gated(projected, leaves[i], step, spec.every_k)

        params = unflatten_like(params, leaves)
        if with_stats:
            return params, new_state, stats
        return params, new_state

    # -- the shared projected-update step core -------------------------------

    def projected_update(self, grads: Any, opt_state, params: Any, acfg, *,
                         lr=None, mask: Any = None,
                         state: Optional[Dict[str, torch.Tensor]] = None):
        """Optimizer update + projection + gating: the step core of the
        port's train loops.

        Runs ``adam_update`` (optional ``lr`` override and ``mask``
        gradient freeze), projects through ``apply`` gated on the NEW
        optimizer count, re-applies ``mask`` to the params (the
        double-descent support freeze) and threads the theta state.
        Under ``solver="fused"`` plans are routed as in the JAX engine;
        a plan whose family streams its statistics would need the fused
        step kernels, which are not ported yet (NotImplementedError).

        Returns (params, opt_state, proj_state).
        """
        if self.solver == "fused" and self.specs:
            plans, _ = self.plans(params)
            fused = [p.key for p in plans if p.every_k == 1 and hasattr(
                get_family(p.family).seg_ops, "from_colstats")]
            if fused:
                raise NotImplementedError(
                    f"plans {fused} need the fused optimizer+projection "
                    f"step, which is not ported: {_FUSED_ITEM}")
        from ..optim.adam import adam_update
        new_params, new_opt = adam_update(grads, opt_state, params, acfg,
                                          lr=lr, mask=mask)
        if self.specs:
            new_params, state = self.apply(new_params, step=new_opt.count,
                                           state=state)
            if mask is not None:
                new_params = tree_map(lambda p, m: p * m, new_params, mask)
        else:
            state = dict(state or {})
        return new_params, new_opt, state
