"""The production step builders, meshes and the training launcher (port of
``repro.launch``): ``launch/steps.py`` builds the train, prefill and
decode steps and picks the projection engine (``fused_sharded`` on a mesh),
``launch/mesh.py`` builds meshes over the caller's process group,
``launch/train.py`` is the CLI (``python -m repro_torch.launch.train``),
``launch/dryrun.py`` the dry-run (``python -m repro_torch.launch.dryrun``:
every (arch x shape x mesh) cell traced on meta tensors by
``lower_cell`` as rank 0 of a fake process group, with its roofline).
The steps take a (data, model) mesh and per-cell rules
(``rules_for_cell``, ``param_shardings``)."""
from .steps import (LoweredCell, build_decode_step, build_prefill_step,
                    build_train_step, lower_cell, param_shardings,
                    projection_engine_for, rules_for_cell)

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "projection_engine_for", "rules_for_cell", "param_shardings",
           "lower_cell", "LoweredCell"]
