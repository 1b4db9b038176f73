"""The dry-run's counts and the roofline (port of ``repro.roofline``):
``counter.py`` traces a step on meta tensors and counts its dot FLOPs,
HBM bytes, kernel launches, collectives and live bytes (the role of
``repro/roofline/hlo_parse.py``), ``analysis.py`` turns the counts into
the three roofline terms at the H100's constants."""
from .analysis import (CollectiveStats, Roofline, active_params, analyze,
                       collective_stats, kernel_bound_ms, model_flops_for)
from .counter import Counter, Counts, record_kernel

__all__ = ["Counter", "Counts", "record_kernel", "CollectiveStats",
           "Roofline", "analyze", "collective_stats", "kernel_bound_ms",
           "model_flops_for", "active_params"]
