"""Model-generic compact serving and the serving loop (port of
``repro.serve``).

``compact.py`` owns the static side — support derivation from
``ProjectionSpec`` lists (the same ``column_masks`` contract the training
freeze uses), ``CompactRule`` coupling (which sibling leaves co-compact,
which outputs scatter back into the residual stream), and ``compact_model``
which gathers a dense checkpoint into a ``CompactModel``. ``refresh.py``
owns the checkpoint lifecycle — ``refresh_model`` (value refresh through
the frozen ``sel``) and ``recompact_model`` (live re-compaction: support
only shrinks under the frozen mask, so the re-gather is monotone and
shape-preserving).

``engine.py`` owns the serving loop itself — ``FleetEngine``, the
continuous-batching engine that keeps one decode step hot under churn:
on-device slot state, in-step sampling, masked admission, a cache written
in place, one CUDA graph on the card, and a ``RecompactScheduler`` that
turns checkpoint refreshes into live re-compactions with hysteresis.

The SAE path (``sae/serve.py``) and the LM zoo path (``train/serve.py``'s
``BatchServer``) are both thin adapters over this layer.
"""
from .compact import (LeafSupport, support_selection, CompactRule, ZOO_RULES,
                      CompactModel, compact_model)
from .refresh import refresh_model, recompact_model
from .engine import (EngineConfig, Request, Completion, LatencyStats,
                     RecompactScheduler, FleetEngine)

__all__ = ["LeafSupport", "support_selection", "CompactRule", "ZOO_RULES",
           "CompactModel", "compact_model", "refresh_model",
           "recompact_model", "EngineConfig", "Request", "Completion",
           "LatencyStats", "RecompactScheduler", "FleetEngine"]
