"""Core library of the port: the l1,inf projection and its integration.

    project_l1inf / _newton / _sorted / _segmented, theta_l1inf,
    l1inf_norm, column_support, active_compaction, support_indices,
    compact_columns                         — ``core.l1inf``
    project_l1_ball                         — ``core.simplex``
    ConstraintFamily registry               — ``core.families`` (l1inf)
    ProjectionSpec, build_packed_plans, column_masks, apply_masks,
    sparsity_report, engine counters        — ``core.constraints``
    ProjectionEngine (newton | kernel | fused) — ``core.engine``
"""
from .simplex import project_l1_ball, simplex_threshold
from .l1inf import (l1inf_norm, project_l1inf, project_l1inf_sorted,
                    project_l1inf_newton, project_l1inf_newton_stats,
                    project_l1inf_segmented, theta_l1inf, column_support,
                    active_compaction, support_indices, compact_columns)
from .families import (ConstraintFamily, register_family, get_family,
                       family_for_norm, family_names,
                       registered_norms, project_segmented_family)
from .constraints import (ProjectionSpec, PackedPlan, apply_constraints,
                          build_packed_plans, column_masks, apply_masks,
                          sparsity_report, engine_count, engine_counters,
                          engine_counters_reset)
from .engine import ProjectionEngine
