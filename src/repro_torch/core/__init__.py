"""Core library of the port: the l1,inf projection family and its
integration.

    project_l1inf / _newton / _sorted / _segmented, theta_l1inf,
    l1inf_norm, column_support, active_compaction, support_indices,
    compact_columns                         — ``core.l1inf``
    project_l1_ball, project_simplex_sort, project_weighted_l1_ball,
    simplex_threshold (+ numpy Michelot / Condat) — ``core.simplex``
    project_l1inf_heap, theta_l1inf_heap, project_l1inf_naive — the
                                              paper's Algorithms 2 and 1
                                              (``core.heap``, numpy)
    project_l1inf_quattoni, project_l1inf_bejar, project_l1inf_newton_np
                                            — ``core.baselines`` (numpy)
    project_l12_ball, prox_linf1, linf1_norm, l12_norm — ``core.norms``
    project_l1inf_masked, l1inf_column_mask — ``core.masked`` (Eq. 20)
    project_l1inf_weighted, l1inf_weighted_norm — ``core.weighted``
    project_bilevel (+ _stats, _ref)        — ``core.bilevel``
    project_l12_newton, project_l12_stats   — ``core.l12``
    hoyer_sparseness, project_hoyer (+ _ref) — ``core.hoyer``
    ConstraintFamily registry               — ``core.families`` (l1inf,
        l1inf_weighted, l1inf_masked, bilevel, l12, hoyer)
    ProjectionSpec, build_packed_plans, column_masks, apply_masks,
    sparsity_report, leaf_path_str, engine counters — ``core.constraints``
    ProjectionEngine (newton | kernel | fused), apply_constraints_packed,
    init_projection_state                   — ``core.engine``
"""
from .simplex import (project_simplex_sort, project_l1_ball,
                      project_weighted_l1_ball, simplex_threshold,
                      project_simplex_michelot_np, project_simplex_condat_np)
from .l1inf import (l1inf_norm, project_l1inf, project_l1inf_sorted,
                    project_l1inf_newton, project_l1inf_newton_stats,
                    project_l1inf_segmented, theta_l1inf, column_support,
                    active_compaction, support_indices, compact_columns)
from .heap import project_l1inf_heap, project_l1inf_naive, theta_l1inf_heap
from .baselines import (project_l1inf_quattoni, project_l1inf_bejar,
                        project_l1inf_newton_np)
from .norms import project_l12_ball, prox_linf1, linf1_norm, l12_norm
from .masked import project_l1inf_masked, l1inf_column_mask
from .weighted import project_l1inf_weighted, l1inf_weighted_norm
from .bilevel import (project_bilevel, project_bilevel_stats,
                      project_bilevel_ref, bilevel_norm)
from .l12 import project_l12_newton, project_l12_stats
from .hoyer import hoyer_sparseness, project_hoyer, project_hoyer_ref
from .families import (ConstraintFamily, register_family, get_family,
                       family_for_norm, family_names, packable_norms,
                       registered_norms, project_segmented_family)
from .constraints import (ProjectionSpec, PackedPlan, apply_constraints,
                          build_packed_plans, column_masks, apply_masks,
                          sparsity_report, leaf_path_str, engine_count,
                          engine_counters, engine_counters_reset)
from .engine import (ProjectionEngine, apply_constraints_packed,
                     init_projection_state)
