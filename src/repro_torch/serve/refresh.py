"""Checkpoint lifecycle for compact serving: hot refresh + live
re-compaction — port of ``repro.serve.refresh``.

Two operations, both shape-preserving, so a serving step (or a CUDA graph
captured around one) sees the same shapes across checkpoints:

  * ``refresh_model`` — replay the frozen gather recipe on a new dense
    checkpoint: same ``sel``, same shapes, new values. Exact as long as the
    new support is a subset of the slot set (guaranteed under the training
    mask freeze, verified by default);
  * ``recompact_model`` — periodic live re-compaction: derive the NEW
    support (it can only have shrunk under the frozen mask — a growth is
    a contract violation and raises), pack it into the ascending prefix of
    the SAME slot width, and point the tail at an already-dead column so
    the padded gathers read exact zeros. A monotone incremental gather:
    no shape changes; recompacting an unchanged support is the identity.

Shrinking the slot width itself (reclaiming the padded FLOPs) changes
shapes: call ``compact_model`` again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .compact import CompactModel, support_selection, _materialize

__all__ = ["refresh_model", "recompact_model"]


def _new_supports(compact: CompactModel, new_params: Any):
    sups = support_selection(new_params, compact.specs)
    missing = set(compact.sels) - set(sups)
    if missing:
        raise ValueError(
            f"new checkpoint lost constrained leaves {sorted(missing)} — "
            f"refresh/recompact require the same tree structure")
    return sups


def refresh_model(compact: CompactModel, new_params: Any,
                  validate: bool = True) -> CompactModel:
    """Hot-refresh a ``CompactModel`` from a new dense checkpoint.

    ``compact``: the serving model whose gather recipe (sels, slot widths,
    sel-leaf layout) is FROZEN; ``new_params``: the new dense checkpoint
    (same tree structure). Returns a new ``CompactModel`` with identical
    shapes — a serving step built on the old ``params`` accepts the new
    ones, and the riding sel leaves mean it also gathers with the
    refreshed (not a stale closed-over) support. Exactness needs
    the new checkpoint's support to still be covered by the slot set;
    under the training mask freeze support only shrinks, so this holds —
    ``validate=True`` (default) checks it and raises on violation rather
    than serve silently-wrong logits.

    >>> cm = refresh_model(cm, new_checkpoint_params)
    """
    if validate:
        for path, sup in _new_supports(compact, new_params).items():
            if path not in compact.sels:
                continue        # skipped leaf: served dense, any support ok
            if not np.isin(sup.sel, compact.sels[path]).all():
                raise ValueError(
                    f"checkpoint support of {path!r} grew outside the "
                    f"compact slot set — the frozen-mask contract is "
                    f"violated; rebuild with compact_model")
    params = _materialize(new_params, compact.gathers, compact.sel_leaves,
                          compact.sels)
    return dataclasses.replace(compact, params=params)


def recompact_model(compact: CompactModel, new_params: Any) -> CompactModel:
    """Live re-compaction: adopt a (monotonically smaller) fresh support.

    ``compact``: the serving model; ``new_params``: a new dense checkpoint.
    Derives the new support per primary leaf and asserts it is a SUBSET of
    the current live support (under the frozen training mask support can
    only shrink — growth raises ``ValueError``). The new sel keeps the slot
    width J_slot: live indices in the ascending prefix, the tail pointed at
    one already-dead column so padded gathers read exact zeros (and padded
    scatter-back slots add exact zeros). Shapes are unchanged; an
    unchanged support returns the exact same sel (identity).
    ``CompactModel.live`` tracks the shrink for operators deciding when a
    full (shape-changing) ``compact_model`` re-slot pays off.

    >>> cm = recompact_model(cm, new_checkpoint_params)
    """
    new_sups = _new_supports(compact, new_params)
    sels: Dict[str, np.ndarray] = {}
    liv: Dict[str, int] = {}
    supports = dict(compact.supports)
    for path, old_sel in compact.sels.items():
        sup = new_sups[path]
        new_idx = np.asarray(sup.sel, np.int32)
        old_live = old_sel[: compact.live[path]]
        if not np.isin(new_idx, old_live).all():
            raise ValueError(
                f"support of {path!r} grew (monotonicity violated): "
                f"{int((~np.isin(new_idx, old_live)).sum())} new column(s) "
                f"outside the live set — the training mask freeze must "
                f"keep dead columns dead")
        if new_idx.size == old_live.size:
            sel = old_sel.copy()            # unchanged support -> identity
        else:
            pad = old_sel.size - new_idx.size
            dead = np.setdiff1d(old_sel, new_idx)   # nonempty: pad > 0
            sel = np.concatenate(
                [new_idx, np.full((pad,), dead[0], np.int32)])
        sels[path] = sel
        liv[path] = int(new_idx.size)
        supports[path] = sup
    params = _materialize(new_params, compact.gathers, compact.sel_leaves,
                          sels)
    return dataclasses.replace(compact, params=params, sels=sels, live=liv,
                               supports=supports)
