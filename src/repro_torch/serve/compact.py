"""Model-generic compaction: derive support, gather, serve — port of
``repro.serve.compact``.

After l1,inf-projected training most constrained columns are STRUCTURAL
zeros (the projected step writes the projection output into the weight, so
a dead column is exact zero, not a small number). This module compiles
those zeros out of any param tree under any ``ProjectionSpec`` list.

Three pieces compose:

  * ``support_selection`` derives the per-leaf surviving-column sets from
    ``core.constraints.column_masks`` — the SAME mask the double-descent
    freeze uses, so training and serving can never disagree;
  * a ``CompactRule`` says what a dead column of one leaf MEANS for the
    rest of the tree: which sibling leaves co-compact with the same index
    vector (``coupled``), and whether the compact output feeds the
    residual stream and must scatter back to full width (``scatter``);
  * ``compact_model`` executes the rules with ``core.compact_columns``
    (the one gather primitive) and returns a ``CompactModel`` whose param
    tree carries int32 ``*_sel`` index leaves on the params' device, so
    the support TRAVELS WITH the checkpoint and refreshed params serve
    through the same step.

``ZOO_RULES`` covers the model zoo's constrained leaves (configs/*.py):
MLP/MoE ``w1`` hidden-unit compaction (dead ff column => act(0) * up = 0
exactly, so ``w3`` columns and ``w2`` rows co-compact) and MLP/MoE ``w2``
residual-output compaction (dead output column => that residual feature
receives exact zero, so the compact GEMM scatters into full width —
``models.layers.scatter_residual``). Spec-matched leaves no rule covers
(e.g. ``ssm/wx``) are left dense and reported in ``CompactModel.skipped``.
The MoE rules are kept for the contract; no ported model has an MoE block
yet.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._tree import flatten_with_path
from ..core.constraints import (ProjectionSpec, column_masks, _first_match,
                                _stacked_axis)
from ..core.l1inf import compact_columns, support_indices

__all__ = ["LeafSupport", "support_selection", "CompactRule", "ZOO_RULES",
           "CompactModel", "compact_model"]


@dataclasses.dataclass(frozen=True)
class LeafSupport:
    """Surviving-column set of one constrained leaf (all fields static).

    ``sel``: int32 (J,) surviving canonical-column indices (ascending, host
    numpy); ``col_axis``: the axis of the ORIGINAL leaf the columns live on
    (the non-max axis of the trailing 2-D slice — stacked leading dims
    shift it); ``n_cols``: the full column count m, so ``ratio = J / m``.

    >>> LeafSupport(sel=np.array([0, 2], np.int32), col_axis=0, n_cols=4).ratio
    0.5
    """
    sel: np.ndarray
    col_axis: int
    n_cols: int

    @property
    def n_selected(self) -> int:
        """J — the number of surviving columns."""
        return int(self.sel.size)

    @property
    def ratio(self) -> float:
        """Compaction ratio J / m in [0, 1] (1.0 = nothing pruned)."""
        return self.n_selected / max(self.n_cols, 1)


def support_selection(params: Any, specs: Sequence[ProjectionSpec]
                      ) -> Dict[str, LeafSupport]:
    """Derive {leaf path: LeafSupport} for every spec-matching leaf.

    ``params``: nested-dict param tree (float leaves of any dtype, any
    device); ``specs``: the ProjectionSpec tuple the model trained under.
    The support comes from ``column_masks`` — a column the projection
    killed is an exact-zero slice, so the test is exact, not a tolerance.
    A stacked (ndim > 2) leaf keeps the UNION of its slices' supports (a
    column dropped only where it is zero in EVERY slice — the gather stays
    exact and the compact leaf stays rectangular; for layer-stacked zoo
    blocks this means one shared support across the stack). Host-side:
    copies one boolean per column to the host.

    >>> sup = support_selection(params, specs)["blocks/p0_global/mlp/w1"]
    """
    masks = dict(flatten_with_path(column_masks(params, specs)))
    out: Dict[str, LeafSupport] = {}
    for path, leaf in flatten_with_path(params):
        spec = _first_match(specs, path, leaf)
        if spec is None:
            continue
        max_axis = _stacked_axis(spec.axis, leaf.ndim)
        col_axis = leaf.ndim - 2 if spec.axis in (1, -1) else leaf.ndim - 1
        # one representative row per column (the mask is constant along the
        # max axis), then union over any stacked leading dims
        alive = torch.select(masks[path], max_axis, 0) != 0
        alive = alive.reshape(-1, leaf.shape[col_axis]).any(dim=0)
        out[path] = LeafSupport(sel=support_indices(alive),
                                col_axis=col_axis,
                                n_cols=int(leaf.shape[col_axis]))
    return out


@dataclasses.dataclass(frozen=True)
class CompactRule:
    """How one constrained leaf kind compacts (all fields static).

    ``primary``: regex on the full '/'-joined leaf path of the constrained
    leaf. ``col_axis``: the NEGATIVE axis its prunable columns must live on
    — a spec pruning any other axis of a matching leaf is refused (serving
    silently wrong results is worse than refusing). ``coupled``: (relative
    path, negative axis) pairs naming sibling leaves that gather with the
    SAME index vector (paths resolve from the primary's parent; ``..``
    climbs; missing siblings are skipped — e.g. no ``w3`` in a non-gated
    MLP). ``scatter``: True when the compact output feeds the residual
    stream and the forward path must scatter it back to full width.
    ``base_ndim``: the unstacked rank of the primary (2 for ``mlp/w1``, 3
    for stacked-expert ``moe/w1``) — leading dims beyond it are layer
    stacking, and the emitted sel leaf broadcasts over them so the stack
    slices it per layer like every other leaf. ``sel_key``: where the int32
    sel leaf lands, relative to the primary's parent (default
    ``"<leafname>_sel"`` beside the primary).

    >>> rule = CompactRule(primary=r"(^|/)mlp/w1$", coupled=(("w2", -2),))
    """
    primary: str
    col_axis: int = -1
    coupled: Tuple[Tuple[str, int], ...] = ()
    scatter: bool = False
    base_ndim: int = 2
    sel_key: Optional[str] = None


# The model zoo's compaction contract (configs/*.py declare the specs):
#   w1 hidden-unit pruning — a dead ff column makes the gate pre-activation
#   exactly 0, silu/gelu(0) = 0, so the unit's whole channel is exact zero:
#   w3 loses the same columns and w2 the same rows, output width unchanged;
#   w2 residual-output pruning — a dead output column contributes exact 0
#   to that residual feature, so the compact GEMM computes only the (J,)
#   support and scatter_residual places it back at full width.
ZOO_RULES: Tuple[CompactRule, ...] = (
    CompactRule(primary=r"(^|/)mlp/w1$", col_axis=-1,
                coupled=(("w3", -1), ("w2", -2))),
    CompactRule(primary=r"(^|/)mlp/w2$", col_axis=-1, scatter=True),
    CompactRule(primary=r"(^|/)moe/w1$", col_axis=-1,
                coupled=(("w3", -1), ("w2", -2)), base_ndim=3),
    CompactRule(primary=r"(^|/)moe/w2$", col_axis=-1, scatter=True,
                base_ndim=3),
)


@dataclasses.dataclass(frozen=True)
class _Gather:
    """One static re-gather: leaf ``path`` loses ``axis`` columns outside
    the sel of ``primary`` (axis negative; applies to dense checkpoints)."""
    path: str
    axis: int
    primary: str


@dataclasses.dataclass(frozen=True)
class _SelLeaf:
    """One emitted sel leaf: int32 sel of ``primary`` broadcast to
    ``lead + (J,)`` at tree position ``path`` (lead = layer-stack dims)."""
    path: str
    primary: str
    lead: Tuple[int, ...]


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _resolve(base: str, rel: str) -> str:
    """Resolve a rule-relative path against the primary's parent path."""
    parts = base.split("/") if base else []
    for seg in rel.split("/"):
        if seg == "..":
            if not parts:
                raise ValueError(f"relative path {rel!r} climbs above the "
                                 f"param-tree root (base {base!r})")
            parts.pop()
        else:
            parts.append(seg)
    return "/".join(parts)


def _materialize(dense_params: Any, gathers: Tuple[_Gather, ...],
                 sel_leaves: Tuple[_SelLeaf, ...],
                 sels: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Apply the static gather records to a dense checkpoint and insert
    the sel leaves (int32, on the primary's device) — the shared body of
    compact/refresh/recompact."""
    flat = dict(flatten_with_path(dense_params))
    devices = {s.primary: flat[s.primary].device for s in sel_leaves}
    for g in gathers:
        flat[g.path] = compact_columns(flat[g.path], sels[g.primary],
                                       axis=g.axis)
    for s in sel_leaves:
        sel = torch.as_tensor(sels[s.primary], dtype=torch.int32,
                              device=devices[s.primary])
        flat[s.path] = sel.expand(s.lead + tuple(sel.shape)).contiguous()
    return _unflatten(flat)


@dataclasses.dataclass(frozen=True)
class CompactModel:
    """A projected-trained param tree with its structural zeros compiled out.

    ``params``: the compact tree — constrained leaves gathered to their
    (J,)-support, coupled leaves co-gathered, plus one int32 ``*_sel`` leaf
    per compacted group riding IN the tree (broadcast over layer-stack
    dims) so a refreshed checkpoint serves through the same step with its
    own support. ``sels``/``live``: per-primary slot index vector (length
    J_slot, host numpy) and live count — after ``recompact_model`` the live
    support occupies the ascending prefix and the tail re-gathers an
    already-dead column (exact zeros), keeping shapes frozen. ``supports``:
    full-width ``LeafSupport`` per primary; ``skipped``: spec-matched
    leaves no rule covers (served dense); ``specs``/``rules``/``gathers``/
    ``sel_leaves``: the static recipe ``refresh_model``/``recompact_model``
    replay on new checkpoints.

    >>> cm = compact_model(params, cfg.projection_specs)   # then cm.params
    """
    params: Dict[str, Any]
    specs: Tuple[ProjectionSpec, ...]
    rules: Tuple[CompactRule, ...]
    supports: Dict[str, LeafSupport]
    sels: Dict[str, np.ndarray]
    live: Dict[str, int]
    gathers: Tuple[_Gather, ...]
    sel_leaves: Tuple[_SelLeaf, ...]
    skipped: Tuple[str, ...]

    def compaction_ratios(self) -> Dict[str, float]:
        """{primary leaf path: J_live / m} — the width fraction each
        constrained leaf still serves (slot padding not counted live)."""
        return {p: self.live[p] / max(s.n_cols, 1)
                for p, s in self.supports.items()}

    def slot_width(self, path: str) -> int:
        """J_slot of one primary — the frozen compact width (>= live)."""
        return int(self.sels[path].size)


def compact_model(params: Any, specs: Sequence[ProjectionSpec],
                  rules: Sequence[CompactRule] = ZOO_RULES) -> CompactModel:
    """Compact a projected-trained param tree for serving.

    ``params``: dense checkpoint (nested dict of tensors, any float dtype,
    any device); ``specs``: the ProjectionSpec tuple it trained under
    (typically ``cfg.projection_specs``); ``rules``: the compaction
    contract (first matching rule wins per constrained leaf; defaults to
    the zoo's MLP/MoE rules). Returns a ``CompactModel`` whose forward
    outputs equal the dense model's up to float summation order. Raises
    ``ValueError`` if a spec prunes an axis its rule cannot serve exactly.
    Host-side, one-off: run once per checkpoint, then hand
    ``CompactModel.params`` to ``forward`` / ``decode_step``.

    >>> cm = compact_model(params, cfg.projection_specs)
    """
    sups_all = support_selection(params, specs)
    flat = dict(flatten_with_path(params))
    gathers: list = []
    sel_leaves: list = []
    sels: Dict[str, np.ndarray] = {}
    live: Dict[str, int] = {}
    supports: Dict[str, LeafSupport] = {}
    skipped: list = []
    seen_gathers = set()
    for path, sup in sups_all.items():
        rule = next((r for r in rules if re.search(r.primary, path)), None)
        if rule is None:
            skipped.append(path)
            continue
        leaf = flat[path]
        if sup.col_axis - leaf.ndim != rule.col_axis:
            raise ValueError(
                f"spec prunes axis {sup.col_axis - leaf.ndim} of {path!r} "
                f"but rule {rule.primary!r} serves axis {rule.col_axis} "
                f"compaction only — no exactness argument covers the "
                f"requested axis")
        parent, _, name = path.rpartition("/")
        group = [(path, rule.col_axis)]
        for rel, ax in rule.coupled:
            cpath = _resolve(parent, rel)
            if cpath in flat:           # e.g. no w3 in a non-gated MLP
                group.append((cpath, ax))
        for gpath, gax in group:
            if (gpath, gax) in seen_gathers:
                raise ValueError(
                    f"two rules gather axis {gax} of {gpath!r} — "
                    f"overlapping CompactRules are ambiguous")
            seen_gathers.add((gpath, gax))
            gathers.append(_Gather(path=gpath, axis=gax, primary=path))
        sel_path = _resolve(parent, rule.sel_key or f"{name}_sel")
        if sel_path in flat:
            raise ValueError(f"sel leaf path {sel_path!r} already exists "
                             f"in the param tree")
        lead = tuple(int(d) for d in leaf.shape[: leaf.ndim - rule.base_ndim])
        sel_leaves.append(_SelLeaf(path=sel_path, primary=path, lead=lead))
        sels[path] = np.asarray(sup.sel, np.int32)
        live[path] = sup.n_selected
        supports[path] = sup
    compact = _materialize(params, tuple(gathers), tuple(sel_leaves), sels)
    return CompactModel(
        params=compact, specs=tuple(specs), rules=tuple(rules),
        supports=supports, sels=sels, live=live, gathers=tuple(gathers),
        sel_leaves=tuple(sel_leaves), skipped=tuple(skipped))
