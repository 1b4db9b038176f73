"""Constraint-family registry (port of ``repro.core.families``).

A ``ConstraintFamily`` declares the ``ProjectionSpec.norm`` strings it
serves, its per-column segmented-Newton hooks (``seg_ops``, the
``core.l1inf._PlainSegOps`` contract), its norm, its per-leaf projection,
an independent reference, and optionally a ``kernel_loader`` — the port's
counterpart of the JAX ``pallas_loader``: it imports the family's packed
solver on the hand-written kernels, which the engine's ``"kernel"`` solver
calls.

Registered here: ``l1inf`` (plain, also serving ``l1inf_sorted`` specs).
The JAX package's other families (``l1inf_weighted``, ``l1inf_masked``,
``bilevel``, ``l12``, ``hoyer``) are not ported yet; their norms are
rejected by ``ProjectionSpec`` until they are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .l1inf import (_PlainSegOps, _segmented_solve, l1inf_norm,
                    project_l1inf_newton, project_l1inf_sorted)

__all__ = [
    "ConstraintFamily",
    "register_family",
    "get_family",
    "family_for_norm",
    "family_names",
    "registered_norms",
    "project_segmented_family",
]


@dataclasses.dataclass(frozen=True)
class ConstraintFamily:
    """One registered constraint ball.

    ``norms`` (the spec norms served), ``seg_ops`` (segmented-Newton hooks,
    or None for per-leaf-only families), ``norm_fn`` ``(Y, axis) ->
    scalar``, ``project_leaf``/``reference`` ``(Y, C, axis) -> X``, and an
    optional ``kernel_loader`` returning the packed kernel solver. (The
    JAX record's per-column weights ``w``, ``uses_weights`` and
    ``feasible`` come with the families that need them.)

    >>> fam = ConstraintFamily(name="l1inf", norms=("l1inf",), seg_ops=ops,
    ...                        norm_fn=nf, project_leaf=pl, reference=ref)
    """
    name: str
    norms: Tuple[str, ...]
    seg_ops: object
    norm_fn: Callable
    project_leaf: Callable           # (Y, C, axis) -> X
    reference: Callable              # (Y, C, axis) -> X (independent)
    kernel_loader: Optional[Callable] = None


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


def registered_norms() -> frozenset:
    """Every spec norm any registered family serves."""
    return frozenset(_NORM_TO_FAMILY)


def project_segmented_family(Y: torch.Tensor, seg_ids, C_seg, *,
                             num_segments: int, family: str = "l1inf",
                             theta0: Optional[torch.Tensor] = None,
                             max_iter: int = 32):
    """Project each column group of a packed (n, M) buffer onto its own
    ball of the named family (segmented Newton).

    Returns (X (n, M), theta_seg (num_segments,), iters int).

    >>> X, theta, iters = project_segmented_family(Y, sids, C, num_segments=3)
    """
    fam = get_family(family)
    if fam.seg_ops is None:
        raise ValueError(f"family {family!r} is per-leaf only (seg_ops=None)")
    return _segmented_solve(Y, seg_ids, C_seg, num_segments, theta0,
                            max_iter, ops=fam.seg_ops)


def _load_plain_kernel():
    from ..kernels.l1inf.ops import project_l1inf_kernel_segmented
    return project_l1inf_kernel_segmented


register_family(ConstraintFamily(
    name="l1inf",
    norms=("l1inf", "l1inf_sorted"),
    seg_ops=_PlainSegOps,
    norm_fn=lambda Y, axis=0: l1inf_norm(Y, axis=axis),
    project_leaf=lambda Y, C, axis=0: project_l1inf_newton(Y, C, axis=axis),
    reference=lambda Y, C, axis=0: project_l1inf_sorted(Y, C, axis=axis),
    kernel_loader=_load_plain_kernel,
))
