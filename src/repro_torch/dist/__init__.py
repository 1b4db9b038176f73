"""Distributed substrate (port of ``repro.dist``).

Only ``watchdog`` (``StepWatchdog``, the train loop's straggler detector)
is ported. Sharding rules, gradient compression, the pipeline and the
sharded projection wait for ROADMAP.md queue A item 8.
"""
from . import watchdog
from .watchdog import StepWatchdog

__all__ = ["watchdog", "StepWatchdog"]
