"""Constraint-family registry (port of ``repro.core.families``).

A ``ConstraintFamily`` declares the ``ProjectionSpec.norm`` strings it
serves, its per-column segmented-Newton hooks (``seg_ops``, the
``core.l1inf._PlainSegOps`` contract, or None for a per-leaf-only family),
its norm, its per-leaf projection, an independent reference, and
optionally a ``kernel_loader`` — the port's counterpart of the JAX
``pallas_loader``: it imports the family's packed solver on the
hand-written kernels, which the engine's ``"kernel"`` solver calls.
``seg_ops`` with a ``from_colstats`` hook qualify a family for the fused
optimizer+projection step (``kernels/fused_step``).

Registered, as in the JAX package: ``l1inf`` (plain, also serving
``l1inf_sorted``), ``l1inf_weighted``, ``l1inf_masked`` (Eq. 20),
``bilevel`` (arXiv:2407.16293; fusable, kernel solver), ``l12`` (group
lasso; fusable) and ``hoyer`` (per-leaf only).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .._device import taken
from .bilevel import _BilevelSegOps, project_bilevel, project_bilevel_ref
from .hoyer import hoyer_sparseness, project_hoyer, project_hoyer_ref
from .l12 import _L12SegOps
from .l1inf import (_PlainSegOps, _segmented_solve, l1inf_norm,
                    project_l1inf_newton, project_l1inf_sorted)
from .masked import _MaskedSegOps, project_l1inf_masked
from .norms import l12_norm, project_l12_ball
from .weighted import (_WeightedSegOps, l1inf_weighted_norm,
                       project_l1inf_weighted)

__all__ = [
    "ConstraintFamily",
    "register_family",
    "get_family",
    "family_for_norm",
    "family_names",
    "packable_norms",
    "registered_norms",
    "project_segmented_family",
    "project_segmented_family_sharded",
]


@dataclasses.dataclass(frozen=True)
class ConstraintFamily:
    """One registered constraint ball.

    ``norms`` (the spec norms served), ``seg_ops`` (segmented-Newton hooks,
    or None for per-leaf-only families), ``norm_fn`` ``(Y, axis, w) ->
    scalar``, ``project_leaf``/``reference`` ``(Y, C, axis, w) -> X``, an
    optional ``kernel_loader`` returning the packed kernel solver,
    ``uses_weights`` (``ProjectionSpec.weights`` feeds a per-column weight
    vector into the solve) and an optional ``feasible`` ``(Y, C, axis, w)
    -> bool`` for constraints that are not norm(Y) <= C (``hoyer``).

    >>> fam = ConstraintFamily(name="l1inf", norms=("l1inf",), seg_ops=ops,
    ...                        norm_fn=nf, project_leaf=pl, reference=ref)
    """
    name: str
    norms: Tuple[str, ...]
    seg_ops: object
    norm_fn: Callable
    project_leaf: Callable           # (Y, C, axis, w) -> X
    reference: Callable              # (Y, C, axis, w) -> X (independent)
    kernel_loader: Optional[Callable] = None
    uses_weights: bool = False
    feasible: Optional[Callable] = None   # (Y, C, axis, w) -> bool


_REGISTRY: Dict[str, ConstraintFamily] = {}
_NORM_TO_FAMILY: Dict[str, str] = {}


def register_family(fam: ConstraintFamily) -> ConstraintFamily:
    """Register ``fam`` under its name and each of its spec norms.

    Re-registering a name replaces it; a norm already claimed by a
    DIFFERENT family is an error.

    >>> register_family(my_family)
    """
    for norm in fam.norms:
        owner = _NORM_TO_FAMILY.get(norm)
        if owner is not None and owner != fam.name:
            raise ValueError(
                f"norm {norm!r} is already served by family {owner!r}")
    for norm, owner in list(_NORM_TO_FAMILY.items()):
        if owner == fam.name and norm not in fam.norms:
            del _NORM_TO_FAMILY[norm]
    _REGISTRY[fam.name] = fam
    for norm in fam.norms:
        _NORM_TO_FAMILY[norm] = fam.name
    return fam


def get_family(name: str) -> ConstraintFamily:
    """Look up a registered family by name; ValueError lists the known
    ones.

    >>> fam = get_family("l1inf")
    """
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown constraint family {name!r} "
            f"(registered: {family_names()})") from None


def family_for_norm(norm: str) -> Optional[ConstraintFamily]:
    """The family serving a spec norm, or None (the hand-wired ``l1``
    ball has no family).

    >>> family_for_norm("l1inf_sorted").name   # 'l1inf'
    """
    name = _NORM_TO_FAMILY.get(norm)
    return _REGISTRY[name] if name is not None else None


def family_names() -> Tuple[str, ...]:
    """Sorted tuple of every registered family name."""
    return tuple(sorted(_REGISTRY))


def packable_norms() -> frozenset:
    """Every spec norm that packs into a family sub-buffer (the norms of
    families WITH seg_ops); ``l1`` and ``hoyer`` stay per leaf.

    >>> "bilevel" in packable_norms()   # True
    """
    return frozenset(n for n, f in _NORM_TO_FAMILY.items()
                     if _REGISTRY[f].seg_ops is not None)


def registered_norms() -> frozenset:
    """Every spec norm any registered family serves, packable or not."""
    return frozenset(_NORM_TO_FAMILY)


def project_segmented_family(Y: torch.Tensor, seg_ids, C_seg, *,
                             num_segments: int, family: str = "l1inf",
                             w_col: Optional[torch.Tensor] = None,
                             theta0: Optional[torch.Tensor] = None,
                             max_iter: int = 32):
    """Project each column group of a packed (n, M) buffer onto its own
    ball of the named family (segmented Newton). ``w_col`` (M,) are the
    per-column weights of a weight-aware family (ignored otherwise).

    Returns (X (n, M), theta_seg (num_segments,), iters int).

    >>> X, theta, iters = project_segmented_family(Y, sids, C, num_segments=3)
    """
    fam = get_family(family)
    if fam.seg_ops is None:
        raise ValueError(f"family {family!r} is per-leaf only (seg_ops=None)")
    return _segmented_solve(Y, seg_ids, C_seg, num_segments, theta0,
                            max_iter, ops=fam.seg_ops,
                            w_col=w_col if fam.uses_weights else None)


def project_segmented_family_sharded(Y: torch.Tensor, seg_ids, C_seg, *,
                                     num_segments: int, group,
                                     family: str = "l1inf",
                                     w_col: Optional[torch.Tensor] = None,
                                     theta0: Optional[torch.Tensor] = None,
                                     contrib: Optional[torch.Tensor] = None,
                                     max_iter: int = 32):
    """Sharded twin of ``project_segmented_family``: ``Y``, ``seg_ids``,
    ``w_col`` and ``contrib`` are this rank's column block, ``group`` the
    process group the columns are split over. Every
    family keeps one (2, num_segments) all-reduce per Eq.-(19)
    evaluation; a weight-aware family's ``w_col`` is the rank's own slice
    and never crosses the group.

    Returns (X block, theta_seg (num_segments,), iters int).

    >>> X, th, it = project_segmented_family_sharded(
    ...     Yl, sidl, C, num_segments=3, group=lay.group)
    """
    fam = get_family(family)
    if fam.seg_ops is None:
        raise ValueError(f"family {family!r} is per-leaf only (seg_ops=None)")
    return _segmented_solve(Y, seg_ids, C_seg, num_segments, theta0,
                            max_iter, ops=fam.seg_ops,
                            w_col=w_col if fam.uses_weights else None,
                            group=group, contrib=contrib)


def _load_plain_kernel():
    from ..kernels.l1inf.ops import project_l1inf_kernel_segmented
    return project_l1inf_kernel_segmented


def _load_bilevel_kernel():
    from ..kernels.l1inf.ops import project_bilevel_kernel_segmented
    return project_bilevel_kernel_segmented


def _weights_or_ones(Y, axis, w):
    if w is not None:
        return torch.as_tensor(w, dtype=torch.float32, device=Y.device)
    return torch.ones((Y.shape[1 if axis in (0, -2) else 0],),
                      dtype=torch.float32, device=Y.device)


register_family(ConstraintFamily(
    name="l1inf",
    norms=("l1inf", "l1inf_sorted"),
    seg_ops=_PlainSegOps,
    norm_fn=lambda Y, axis=0, w=None: l1inf_norm(Y, axis=axis),
    project_leaf=lambda Y, C, axis=0, w=None:
        project_l1inf_newton(Y, C, axis=axis),
    reference=lambda Y, C, axis=0, w=None:
        project_l1inf_sorted(Y, C, axis=axis),
    kernel_loader=_load_plain_kernel,
))

register_family(ConstraintFamily(
    name="l1inf_weighted",
    norms=("l1inf_weighted",),
    seg_ops=_WeightedSegOps,
    norm_fn=lambda Y, axis=0, w=None: l1inf_weighted_norm(
        Y, _weights_or_ones(Y, axis, w), axis=axis),
    project_leaf=lambda Y, C, axis=0, w=None: project_l1inf_weighted(
        Y, _weights_or_ones(Y, axis, w), C, axis=axis),
    reference=lambda Y, C, axis=0, w=None: project_l1inf_weighted(
        Y, _weights_or_ones(Y, axis, w), C, axis=axis),
    uses_weights=True,
))

register_family(ConstraintFamily(
    name="l1inf_masked",
    norms=("l1inf_masked",),
    seg_ops=_MaskedSegOps,
    norm_fn=lambda Y, axis=0, w=None: l1inf_norm(Y, axis=axis),
    project_leaf=lambda Y, C, axis=0, w=None:
        project_l1inf_masked(Y, C, axis=axis),
    reference=lambda Y, C, axis=0, w=None:
        project_l1inf_masked(Y, C, axis=axis),
))

register_family(ConstraintFamily(
    name="bilevel",
    norms=("bilevel",),
    seg_ops=_BilevelSegOps,
    norm_fn=lambda Y, axis=0, w=None: l1inf_norm(Y, axis=axis),
    project_leaf=lambda Y, C, axis=0, w=None:
        project_bilevel(Y, C, axis=axis),
    reference=lambda Y, C, axis=0, w=None:
        project_bilevel_ref(Y, C, axis=axis),
    kernel_loader=_load_bilevel_kernel,
))

# l1,2 / group lasso: both per-leaf slots are the sort-based closed form
# (as in the JAX package); the packed and fused solves run the Newton on
# column energies. No kernel_loader: solver="kernel" takes the packed
# Newton for it.
register_family(ConstraintFamily(
    name="l12",
    norms=("l12",),
    seg_ops=_L12SegOps,
    norm_fn=lambda Y, axis=0, w=None: l12_norm(Y, axis=axis),
    project_leaf=lambda Y, C, axis=0, w=None:
        project_l12_ball(Y, C, axis=axis),
    reference=lambda Y, C, axis=0, w=None:
        project_l12_ball(Y, C, axis=axis),
))

# Hoyer sparseness ratio: per-leaf only (seg_ops=None). The radius is the
# target sparseness s in (0, 1]; ``feasible`` (min column sparseness >= s)
# is the authoritative test and ``norm_fn`` reports that min ratio.
register_family(ConstraintFamily(
    name="hoyer",
    norms=("hoyer",),
    seg_ops=None,
    norm_fn=lambda Y, axis=0, w=None: hoyer_sparseness(Y, axis=axis).min(),
    project_leaf=lambda Y, C, axis=0, w=None:
        project_hoyer(Y, C, axis=axis),
    reference=lambda Y, C, axis=0, w=None:
        project_hoyer_ref(Y, C, axis=axis),
    feasible=lambda Y, C, axis=0, w=None:
        taken(hoyer_sparseness(Y, axis=axis).min() >= C - 1e-5),
))
