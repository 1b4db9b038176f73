"""Distributed substrate (port of ``repro.dist``).

Submodules:
  compression — error-feedback top-k + shared-scale int8, compressed_psum
  projection  — the mesh-resident packed l1,inf projection (segmented
                Newton on column blocks, one (2, G) all-reduce per
                evaluation; DESIGN.md §7, §12)
  layout      — the explicit layout moves the projection makes in place of
                GSPMD's resharding (one all-to-all, never an all-gather)
  watchdog    — StepWatchdog EWMA straggler detector
  sharding    — the logical-axis rules (DESIGN.md §4) and the explicit
                collectives of the sharded step (FSDP gathers, tensor-
                parallel sums), each an autograd Function counted by kind
  pipeline    — the GPipe ring over one mesh axis
"""
from . import compression, layout, pipeline, projection, sharding, watchdog
from .compression import (compressed_psum, ef_step, int8_dequantize,
                          int8_quantize, topk_compress, topk_decompress)
from .projection import (fused_plan_sharded, project_plan_sharded,
                         shard_packed_plan)
from .pipeline import build_pipeline_fn
from .sharding import (axis_rules, current_rules, default_rules, fit_spec,
                       logical_spec, shard)
from .watchdog import StepWatchdog

__all__ = [
    "compression", "layout", "pipeline", "projection", "sharding",
    "watchdog", "build_pipeline_fn", "axis_rules", "current_rules",
    "default_rules", "fit_spec", "logical_spec", "shard",
    "ef_step", "int8_quantize", "int8_dequantize", "topk_compress",
    "topk_decompress", "compressed_psum", "project_plan_sharded",
    "shard_packed_plan", "fused_plan_sharded", "StepWatchdog",
]
