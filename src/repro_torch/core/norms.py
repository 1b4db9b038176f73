"""The comparison norms of the SAE experiments — the part the port's slice
imports: the flat l1 ball that ``core.constraints`` serves per leaf for
``norm="l1"`` specs (``repro.core.norms`` re-exports it the same way)."""
from __future__ import annotations

from .simplex import project_l1_ball

__all__ = ["project_l1_ball"]
