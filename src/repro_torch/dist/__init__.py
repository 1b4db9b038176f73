"""Distributed substrate (port of ``repro.dist``).

Submodules:
  compression — error-feedback top-k + shared-scale int8, compressed_psum
  projection  — the mesh-resident packed l1,inf projection (segmented
                Newton on column blocks, one (2, G) all-reduce per
                evaluation; DESIGN.md §7, §12)
  layout      — the explicit layout moves the projection makes in place of
                GSPMD's resharding (one all-to-all, never an all-gather)
  watchdog    — StepWatchdog EWMA straggler detector

Sharding rules and the pipeline wait for ROADMAP.md queue A item 8b.
"""
from . import compression, layout, projection, watchdog
from .compression import (compressed_psum, ef_step, int8_dequantize,
                          int8_quantize, topk_compress, topk_decompress)
from .projection import (fused_plan_sharded, project_plan_sharded,
                         shard_packed_plan)
from .watchdog import StepWatchdog

__all__ = [
    "compression", "layout", "projection", "watchdog",
    "ef_step", "int8_quantize", "int8_dequantize", "topk_compress",
    "topk_decompress", "compressed_psum", "project_plan_sharded",
    "shard_packed_plan", "fused_plan_sharded", "StepWatchdog",
]
