"""Batched serving: the cohort ``generate`` API over the fleet engine —
port of ``repro.train.serve``.

``BatchServer`` keeps the reference's surface (``load`` / ``load_compact`` /
``refresh`` / ``recompact`` / ``generate`` / ``n_traces``) as a thin adapter
over ``serve.engine.FleetEngine``: per-slot state lives on the device,
sampling and next-feed selection run inside the one step (one CUDA graph on
the card), and the cache is written in place — ``generate`` is "submit the
cohort, drain the engine". The cache is allocated in ``cache_dtype``
(default: the checkpoint's param dtype), and ``generate(...,
with_meta=True)`` returns the per-request ``Completion`` records whose
``truncated`` flag says a row ran out of cache depth before emitting its
full ``max_new`` budget.

Ragged prompts run continuously per row (each row feeds its own next token
— prompt tokens while the prompt lasts, then its own samples), so a ragged
batch reproduces the single-prompt outputs exactly, and ``generate``
accepts more prompts than slots: the engine streams them through freed
slots. Compact serving keeps its contract: sel leaves ride in the param
tree, ``refresh`` / ``recompact`` are shape-preserving, and ``n_traces``
counts one build (one capture on the card) across the whole lifecycle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from ..models.zoo import Model
from ..serve import CompactModel
from ..serve.engine import EngineConfig, FleetEngine, RecompactScheduler

__all__ = ["ServeConfig", "BatchServer"]


@dataclasses.dataclass
class ServeConfig:
    """Cohort-API serving knobs (a subset of ``serve.EngineConfig``)."""
    max_seq: int = 256
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    cache_dtype: Any = None      # None -> match the checkpoint's dtype


class BatchServer:
    """Fixed B decode slots; requests are prompts (lists of token ids).

    ``mesh`` / ``rules`` (optional) pass to the engine: the slots laid out
    over the mesh axes the rules assign to "batch", params replicated,
    each rank stepping its rows with no collective in the step, and one
    all-gather of the step's outputs a step (``serve.engine``). Every rank
    makes the same calls.
    ``scheduler`` (optional ``serve.RecompactScheduler``) lets ``refresh``
    upgrade itself to a live re-compaction when the live/slot ratio of a
    new checkpoint decays past the scheduler's threshold.
    """

    def __init__(self, model: Model, batch_slots: int, scfg: ServeConfig,
                 mesh=None, rules=None,
                 scheduler: Optional[RecompactScheduler] = None):
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.B = batch_slots
        self.engine = FleetEngine(
            model, batch_slots,
            EngineConfig(max_seq=scfg.max_seq,
                         temperature=scfg.temperature,
                         seed=scfg.seed,
                         cache_dtype=scfg.cache_dtype),
            mesh=mesh, rules=rules, scheduler=scheduler)

    # ---------------------- checkpoint lifecycle -------------------------

    @property
    def params(self):
        """The currently-served param tree (dense or compact)."""
        return self.engine.params

    @property
    def compact(self) -> Optional[CompactModel]:
        """The served ``CompactModel`` (None when serving dense)."""
        return self.engine.compact

    @property
    def n_traces(self) -> int:
        """Step builds / graph captures (the no-retrace contract)."""
        return self.engine.n_traces

    def load(self, params):
        """Serve a dense checkpoint (drops any compact state)."""
        self.engine.load(params)

    def load_compact(self, compact: Optional[CompactModel] = None, *,
                     params=None):
        """Serve a compacted checkpoint. Pass a prebuilt
        ``serve.CompactModel``, or a dense ``params`` tree to compact here
        under the model's own ``projection_specs``."""
        self.engine.load_compact(compact, params=params)

    def refresh(self, new_dense_params):
        """Hot refresh: re-gather a NEW dense checkpoint through the frozen
        compact recipe. Shapes unchanged — the step is not rebuilt."""
        self.engine.refresh(new_dense_params)

    def recompact(self, new_dense_params):
        """Live re-compaction: adopt the new checkpoint's (monotonically
        smaller) support inside the frozen slot widths. Not rebuilt."""
        self.engine.recompact(new_dense_params)

    # ---------------------- generation ----------------------------------

    def generate(self, prompts: List[List[int]], max_new: int = 32,
                 with_meta: bool = False):
        """Greedy/temperature generation for the given prompts (any count —
        beyond B they stream through freed slots). Prefill steps the cache
        through the prompt tokens (teacher forcing) — exactly the decode
        path. Rows advance independently, so ragged batches never see pad
        tokens and match solo outputs exactly. Returns prompt+generated
        token lists; with ``with_meta=True`` also the per-request
        ``Completion`` records (TTFT, per-token times, ``truncated``)."""
        rids = [self.engine.submit(p, max_new, sample_seed=i)
                for i, p in enumerate(prompts)]
        by_rid = {c.rid: c for c in self.engine.drain()}
        comps = [by_rid[r] for r in rids]
        outs = [c.tokens for c in comps]
        return (outs, comps) if with_meta else outs
