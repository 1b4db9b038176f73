"""Compacted SAE serving — the paper's feature-selection payoff at inference
(port of ``repro.sae.serve``).

After projected training (Algorithm 3) the l1,inf constraint leaves a small
fraction of the encoder's input-feature columns alive; the rest are
STRUCTURAL zeros (the projected step writes the projection output into the
weight, so a dead column is an exact-zero row of ``enc1/w``, not a small
number). Serving the dense encoder then spends GEMM work on rows that
contribute exact zeros.

This module is a thin adapter over the model-generic compaction layer
(``serve.compact``): the SAE's coupling — encoder feature rows primary,
decoder output columns + bias co-compacted, the ``sel`` leaf at the tree
root — is one ``CompactRule``, and ``compact_sae`` is ``compact_model``
under that rule. ``compact_leaf`` is a one-line shim over the one gather
primitive ``core.compact_columns``.

Why only the FEATURE axis compacts: a dead feature row of ``enc1/w``
removes its input exactly because ``x @ W1`` is linear in the rows. The
hidden axis does NOT share this property — a dead hidden COLUMN still
contributes ``relu(b1_j)`` through its bias — so ``compact_sae`` refuses
specs whose column axis is the hidden one.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.constraints import ProjectionSpec
from ..core.l1inf import compact_columns
from ..serve.compact import (CompactRule, LeafSupport, compact_model,
                             support_selection)
from .model import sae_apply

__all__ = ["compact_leaf", "CompactSAE", "compact_sae", "make_serve_step"]

# The SAE's compaction coupling: enc1/w's FEATURE rows are the primary
# columns (axis -2 of the (d, h) encoder); the reconstruction head
# addresses the same feature index space, so dec2/w output columns and
# dec2/b co-gather; the sel leaf rides at the tree root.
_SAE_RULES: Tuple[CompactRule, ...] = (
    CompactRule(primary=r"(^|/)enc1/w$", col_axis=-2,
                coupled=(("../dec2/w", -1), ("../dec2/b", -1)),
                sel_key="../sel"),
)


def compact_leaf(leaf: torch.Tensor, sup: LeafSupport) -> torch.Tensor:
    """Gather one leaf's surviving columns into a dense compact tensor.

    A shim over the one gather primitive ``core.compact_columns``.
    ``leaf``: (..., n, m)-shaped (any float dtype, stacked dims allowed);
    ``sup``: its ``LeafSupport``. Returns the leaf with ``sup.col_axis``
    reduced from m to J, dtype preserved.

    >>> w_c = compact_leaf(params["enc1"]["w"], sup)   # (d, h) -> (J, h)
    """
    return compact_columns(leaf, sup.sel, axis=sup.col_axis)


@dataclasses.dataclass(frozen=True)
class CompactSAE:
    """A projected-trained SAE with the dead encoder columns compiled out.

    ``params``: the compact param tree — ``enc1/w`` is (J, h) (surviving
    feature rows, original dtype), ``dec2/w`` is (h, J) and ``dec2/b`` (J,)
    (decoder OUTPUT co-compacted by the same index vector), all other
    weight leaves untouched, plus a ``"sel"`` leaf (int32 (J,), on the
    params' device) so the support TRAVELS WITH the checkpoint — a serving
    step fed a refreshed ``CompactSAE.params`` gathers with the refreshed
    support, never a stale closure; ``sel``: the same indices as a host
    array; ``n_features``: the original d. Built by ``compact_sae``.

    >>> z, xhat_sel = compact.apply(compact.select(x))
    """
    params: Dict[str, Any]
    sel: np.ndarray
    n_features: int

    @property
    def n_selected(self) -> int:
        """J — the number of surviving input features."""
        return int(self.sel.size)

    @property
    def compaction_ratio(self) -> float:
        """J / d: the fraction of encoder GEMM work serving still pays."""
        return self.n_selected / max(self.n_features, 1)

    def select(self, x: torch.Tensor) -> torch.Tensor:
        """Gather the selected features of full-width ``x``: (..., d) ->
        (..., J). The only full-width op left on the serving path."""
        return compact_columns(x, self.sel, axis=-1)

    def apply(self, x_sel: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward pass on pre-selected inputs ``x_sel``: (B, J) -> logits
        (B, k) and reconstruction (B, J) of the SELECTED features. Equals
        dense ``sae_apply(params, x)`` as (Z, Xhat[:, sel]) up to float
        summation order — dead rows of enc1/w only ever add exact zeros to
        the pre-ReLU sums."""
        return sae_apply(self.params, x_sel)


def compact_sae(params: Dict[str, Any],
                specs: Sequence[ProjectionSpec]) -> CompactSAE:
    """Compact a projected-trained SAE param tree for serving.

    ``params``: the ``sae_init`` tree after projected training (any float
    dtype, any device); ``specs``: the training ProjectionSpec tuple — it
    must constrain ``enc1/w`` along the FEATURE axis (the paper's axis=1 on
    the (d, h) encoder; the hidden axis cannot compact exactly because dead
    hidden units still emit relu(b) — refused with ValueError). Returns a
    ``CompactSAE`` whose ``apply`` matches dense ``sae_apply`` on the
    support. Host-side, one-off: run once per checkpoint, then serve the
    result via ``make_serve_step``.

    >>> compact = compact_sae(result.params, (spec,))
    """
    sups = support_selection(params, specs)
    enc_key = next((k for k in sups if re.search(r"enc1/w$", k)), None)
    if enc_key is None:
        raise ValueError(
            f"specs select no enc1/w leaf (matched: {sorted(sups)} — "
            f"compact_sae serves the paper's encoder feature selection)")
    if sups[enc_key].col_axis != params["enc1"]["w"].ndim - 2:
        raise ValueError(
            "compact_sae: spec prunes the hidden axis of enc1/w — dead "
            "hidden units still contribute relu(b1) so compaction would "
            "not be exact; the serving contract covers the feature axis "
            "(spec.axis in (1, -1) on the (d, h) encoder)")
    cm = compact_model(params, specs, rules=_SAE_RULES)
    d = int(params["enc1"]["w"].shape[params["enc1"]["w"].ndim - 2])
    return CompactSAE(params=cm.params, sel=cm.sels[enc_key], n_features=d)


def make_serve_step(compact: CompactSAE, *, mesh=None, rules=None):
    """Build the batched serving step for a ``CompactSAE``.

    Returns a plain function ``step(params, x) -> (z, xhat_sel)`` taking
    FULL-width inputs ``x`` (B, d) — one gather selects the J surviving
    features, then every GEMM runs at compact width. Pass
    ``compact.params`` as ``params``: it carries its own ``"sel"`` leaf,
    so a refreshed ``CompactSAE`` with a DIFFERENT surviving set serves
    correctly through an old step.

    With ``mesh`` (a ``DeviceMesh``; every rank calls the step with the
    same arguments) the batch is laid out over the mesh axes that
    ``rules`` (``dist.sharding.default_rules()`` when None) assign to
    "batch": B must divide, and rules that map "batch" to None are
    refused (every rank would compute the whole batch). ``params`` are
    replicated (every rank holds them whole); ``x`` is the global batch
    (every rank's copy the same) or a ``DTensor`` already split so. Each
    rank serves its rows, so no collective runs in the step (rows are
    independent); ``z`` and ``xhat_sel`` come back as ``DTensor``s of its
    rows under that layout.

    >>> step = make_serve_step(compact)   # then: z, xr = step(compact.params, x)
    """

    def step(params, x):
        x_sel = torch.index_select(x, x.ndim - 1, params["sel"])
        return sae_apply(params, x_sel)

    if mesh is None:
        return step

    from ..dist.layout import MeshLayout, local_of, wrap
    from ..dist.sharding import Spec, axes_index, default_rules, placements
    rules = default_rules() if rules is None else rules
    batch_axes = rules.get("batch")
    if batch_axes is None:
        raise ValueError(
            "make_serve_step: the sharding rules map 'batch' to None — "
            "every rank would redundantly compute the FULL batch; name a "
            "mesh axis for 'batch' (see dist.sharding.default_rules)")
    index, ways = axes_index(mesh, batch_axes)
    lay = MeshLayout(mesh)

    def mesh_step(params, x):
        B = x.shape[0]
        if B % ways:
            raise ValueError(f"make_serve_step: batch {B} does not divide "
                             f"over {ways} ranks of {batch_axes!r}")
        n = B // ways
        rows = local_of(x) if hasattr(x, "placements") else \
            x[index * n:(index + 1) * n]
        outs = step(params, rows)
        return tuple(wrap(o.contiguous(), (B,) + tuple(o.shape[1:]),
                          placements(mesh, Spec(batch_axes,
                                                *(None,) * (o.ndim - 1))),
                          lay) for o in outs)

    return mesh_step
