"""Model-generic compact serving: structural zeros compiled out of any
projected-trained param tree (port of ``repro.serve``).

``compact.py`` owns the static side — support derivation from
``ProjectionSpec`` lists (the same ``column_masks`` contract the training
freeze uses), ``CompactRule`` coupling (which sibling leaves co-compact,
which outputs scatter back into the residual stream), and ``compact_model``
which gathers a dense checkpoint into a ``CompactModel``. ``refresh.py``
owns the checkpoint lifecycle — ``refresh_model`` (value refresh through
the frozen ``sel``) and ``recompact_model`` (live re-compaction: support
only shrinks under the frozen mask, so the re-gather is monotone and
shape-preserving). The SAE path (``sae/serve.py``) is a thin adapter over
this layer. The serving loop (the JAX package's ``FleetEngine``) is not
ported yet.
"""
from .compact import (LeafSupport, support_selection, CompactRule, ZOO_RULES,
                      CompactModel, compact_model)
from .refresh import refresh_model, recompact_model

__all__ = ["LeafSupport", "support_selection", "CompactRule", "ZOO_RULES",
           "CompactModel", "compact_model", "refresh_model",
           "recompact_model"]
