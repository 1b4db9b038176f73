"""Training-time integration: structured-sparsity constraints on parameter
trees (port of ``repro.core.constraints``).

A ``ProjectionSpec`` selects parameter leaves by path regex (the
``'/'``-joined nested-dict keys, e.g. ``enc1/w``) and applies one of the
ball projections after each optimizer update (the paper's Algorithm 3).

Packed multi-tensor batching: every leaf of a registered constraint family
is canonicalized (max axis -> 0), padded to a multiple of 128 columns and
concatenated into ONE (n_max, sum m) buffer per (family, every_k) pair
with a per-column segment id; a stacked (L, n, m) leaf contributes L
segments. The layout is the JAX package's, column for column, so theta
states and segment ids carry across the two packages unchanged. This
module owns the static side (specs, matching, plans, pack/unpack, masks,
reports, invocation counters); ``core.engine`` owns the runtime side.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._tree import flatten_with_path, tree_map, unflatten_like
from .families import family_for_norm, registered_norms
from .norms import project_l1_ball

__all__ = ["ProjectionSpec", "apply_constraints", "build_packed_plans",
           "PackedPlan", "column_masks", "apply_masks", "sparsity_report",
           "engine_count", "engine_counters", "engine_counters_reset"]

# spec norms: every registered family's norms plus the per-leaf l1 ball
_EXTRA_NORMS = {"l1"}
_LANE = 128   # per-matrix column padding unit (the JAX package's layout)
_SUBLANE = 8  # packed-buffer row padding unit

# Projection-engine invocation counters, keyed "<plan key>/<solver>" for
# packed solves and "per_leaf" for the per-matrix path.
_COUNTERS: Dict[str, int] = {}


def _known_norms():
    return registered_norms() | _EXTRA_NORMS


def engine_count(key: str) -> None:
    """Increment one invocation counter (engine-internal).

    >>> engine_count("l1inf_packed/k1/newton")
    """
    _COUNTERS[key] = _COUNTERS.get(key, 0) + 1


def engine_counters() -> Dict[str, int]:
    """Snapshot ``{key: int}`` of the invocation counters."""
    return dict(_COUNTERS)


def engine_counters_reset() -> None:
    """Zero every invocation counter."""
    _COUNTERS.clear()


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """One structured-sparsity constraint.

    pattern:  regex matched against the '/'-joined parameter path.
    norm:     a registered family norm (``l1inf`` | ``l1inf_sorted``) or
              the per-leaf ``l1`` ball.
    radius:   ball radius C (> 0).
    axis:     the *max* axis of the trailing 2-D slice (paper: 0).
    every_k:  apply every k optimizer steps (1 = every step).

    The JAX spec's per-column ``weights`` come with the weighted family
    (not ported yet).

    >>> spec = ProjectionSpec(pattern=r"enc1/w", norm="l1inf", radius=0.1, axis=1)
    """
    pattern: str
    norm: str = "l1inf"
    radius: float = 1.0
    axis: int = 0
    every_k: int = 1

    def __post_init__(self):
        if self.norm not in _known_norms():
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.radius <= 0:
            raise ValueError("radius must be > 0")


def _project_fn(spec: ProjectionSpec) -> Callable:
    """Per-leaf projection (x_2d, C, axis) -> x_2d for one spec."""
    if spec.norm == "l1inf_sorted":
        from .l1inf import project_l1inf_sorted
        return lambda x, C, axis: project_l1inf_sorted(x, C, axis=axis)
    if spec.norm == "l1":
        return lambda x, C, axis: project_l1_ball(x, C)
    fam = family_for_norm(spec.norm)
    return lambda x, C, axis: fam.project_leaf(x, C, axis=axis)


def _apply_2d(fn: Callable, x: torch.Tensor, C: float,
              axis: int) -> torch.Tensor:
    """Apply a 2-D projection to the trailing 2 dims, looping over the
    leading (stacked) dims."""
    if x.ndim < 2:
        raise ValueError(f"projection target must have >=2 dims, got "
                         f"{tuple(x.shape)}")
    if x.ndim == 2:
        return fn(x, C, axis)
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = torch.stack([fn(mat, C, axis) for mat in flat])
    return out.reshape(x.shape)


def _first_match(specs: Sequence[ProjectionSpec], name: str, leaf):
    for spec in specs:
        if re.search(spec.pattern, name) and hasattr(leaf, "ndim") \
                and leaf.ndim >= 2:
            return spec
    return None


def _gated(projected, original, step, every_k):
    """``projected`` on steps where ``step % every_k == 0``, else
    ``original`` (no gate for every_k == 1 or step None)."""
    if step is not None and every_k > 1:
        return torch.where((step % every_k) == 0, projected, original)
    return projected


def apply_constraints(params: Any, specs: Sequence[ProjectionSpec],
                      step: Optional[torch.Tensor] = None) -> Any:
    """Project matching leaves of ``params``, one solve per matrix (the
    simple per-leaf reference). Returns a tree of the same structure.

    >>> params = apply_constraints(params, (spec,))
    """
    if not specs:
        return params
    leaves = []
    for name, leaf in flatten_with_path(params):
        spec = _first_match(specs, name, leaf)
        out = leaf
        if spec is not None:
            engine_count("per_leaf")
            projected = _apply_2d(_project_fn(spec), out, spec.radius,
                                  spec.axis)
            out = _gated(projected, out, step, spec.every_k)
        leaves.append(out)
    return unflatten_like(params, leaves)


# -----------------------------------------------------------------------------
# packed multi-tensor batching
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PackedEntry:
    """One leaf's slot inside a packed plan (all fields static)."""
    index: int                 # position in the flattened leaf list
    shape: Tuple[int, ...]     # original leaf shape
    lead: int                  # number of stacked (leading-dim) matrices
    n: int                     # canonical max-axis length
    m: int                     # canonical column count per matrix
    transpose: bool            # spec.axis selected the trailing dim
    radius: float
    m_pad: int                 # m padded up to the lane multiple
    col_start: int             # first column in the packed buffer
    seg_start: int             # first segment id


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """Static packing layout for one (family, every_k) sub-buffer."""
    key: str
    every_k: int
    n_max: int                 # padded row count of the packed buffer
    total_cols: int
    num_segments: int
    entries: Tuple[_PackedEntry, ...]
    family: str = "l1inf"

    def seg_ids(self) -> np.ndarray:
        """Per-column segment id; ``num_segments`` marks lane padding."""
        sids = np.full((self.total_cols,), self.num_segments, np.int32)
        for e in self.entries:
            for l in range(e.lead):
                lo = e.col_start + l * e.m_pad
                sids[lo: lo + e.m] = e.seg_start + l
        return sids

    def radii(self) -> np.ndarray:
        C = np.zeros((self.num_segments,), np.float32)
        for e in self.entries:
            C[e.seg_start: e.seg_start + e.lead] = e.radius
        return C


def build_packed_plans(params: Any, specs: Sequence[ProjectionSpec]):
    """Split the leaves into packed plans — one per (family, every_k) —
    and a per-leaf remainder [(leaf_index, spec)] for unpackable norms.

    Pure shape bookkeeping. Returns ``(plans, per_leaf)``.

    >>> plans, per_leaf = build_packed_plans(params, specs)
    """
    groups: Dict[Tuple[str, int], list] = {}
    per_leaf = []
    for i, (name, leaf) in enumerate(flatten_with_path(params)):
        spec = _first_match(specs, name, leaf)
        if spec is None:
            continue
        fam = family_for_norm(spec.norm)
        if fam is not None and fam.seg_ops is not None:
            groups.setdefault((fam.name, spec.every_k), []).append(
                (i, leaf, spec))
        else:
            per_leaf.append((i, spec))

    plans = []
    for family, every_k in sorted(groups):
        col, seg, entries, n_max = 0, 0, [], 0
        for i, leaf, spec in groups[(family, every_k)]:
            shape = tuple(leaf.shape)
            lead = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            n, m = shape[-2:]
            transpose = spec.axis in (1, -1)
            if transpose:
                n, m = m, n
            m_pad = -(-m // _LANE) * _LANE
            entries.append(_PackedEntry(
                index=i, shape=shape, lead=lead, n=n, m=m,
                transpose=transpose, radius=float(spec.radius),
                m_pad=m_pad, col_start=col, seg_start=seg))
            col += lead * m_pad
            seg += lead
            n_max = max(n_max, n)
        n_max = -(-n_max // _SUBLANE) * _SUBLANE
        plans.append(PackedPlan(
            key=f"{family}_packed/k{every_k}", every_k=every_k, n_max=n_max,
            total_cols=col, num_segments=seg, entries=tuple(entries),
            family=family))
    return plans, per_leaf


def _pack_entry(x: torch.Tensor, e: _PackedEntry,
                n_max: int) -> torch.Tensor:
    """Leaf -> (n_max, lead * m_pad) canonical column block (f32)."""
    x2 = x.reshape((-1,) + tuple(x.shape[-2:])) if x.ndim > 2 else x[None]
    if e.transpose:
        x2 = x2.transpose(1, 2)
    x2 = F.pad(x2.to(torch.float32), (0, e.m_pad - e.m, 0, n_max - e.n))
    return x2.permute(1, 0, 2).reshape(n_max, e.lead * e.m_pad)


def _unpack_entry(block: torch.Tensor, e: _PackedEntry,
                  like: torch.Tensor) -> torch.Tensor:
    """(n_max, lead * m_pad) column block -> leaf with ``like``'s shape and
    dtype."""
    x2 = block.reshape(block.shape[0], e.lead, e.m_pad).permute(1, 0, 2)
    x2 = x2[:, : e.n, : e.m]
    if e.transpose:
        x2 = x2.transpose(1, 2)
    return x2.reshape(like.shape).to(like.dtype).contiguous()


def _stacked_axis(axis: int, ndim: int) -> int:
    """A spec's max axis (on the trailing 2-D slice) as an axis of an
    ndim-rank leaf."""
    return axis if axis < 0 else axis + ndim - 2


def column_masks(params: Any, specs: Sequence[ProjectionSpec]) -> Any:
    """Per-leaf {0,1} masks from the current column support of matching
    leaves (the paper's double-descent mask M0); other leaves get ones.

    >>> masks = column_masks(params, (spec,))
    """
    out = []
    for name, leaf in flatten_with_path(params):
        mask = None
        for spec in specs:
            if re.search(spec.pattern, name) and hasattr(leaf, "ndim") \
                    and leaf.ndim >= 2:
                nz = (leaf != 0).any(dim=_stacked_axis(spec.axis, leaf.ndim),
                                     keepdim=True)
                mask = nz.expand(leaf.shape).to(leaf.dtype)
                break
        out.append(torch.ones_like(leaf) if mask is None else mask)
    return unflatten_like(params, out)


def apply_masks(tree: Any, masks: Any) -> Any:
    """Elementwise tree * mask (Algorithm 3's gradient masking).

    >>> grads = apply_masks(grads, masks)
    """
    return tree_map(lambda t, m: t * m, tree, masks)


def sparsity_report(params: Any, specs: Sequence[ProjectionSpec]) -> dict:
    """Column sparsity (%) per matching leaf — the paper's ``Colsp``.

    >>> sparsity_report(params, (spec,))   # {'enc1/w': 99.0}
    """
    out = {}
    for name, leaf in flatten_with_path(params):
        for spec in specs:
            if re.search(spec.pattern, name) and hasattr(leaf, "ndim") \
                    and leaf.ndim >= 2:
                mat = (leaf.reshape((-1,) + tuple(leaf.shape[-2:]))
                       if leaf.ndim > 2 else leaf[None])
                dead = (mat == 0).all(dim=_stacked_axis(spec.axis, 3))
                out[name] = float(100.0 * dead.to(torch.float32).mean())
                break
    return out
