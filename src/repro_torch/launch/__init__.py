"""The production step builders, meshes and the training launcher (port of
``repro.launch``): ``launch/steps.py`` builds the train, prefill and
decode steps and picks the projection engine (``fused_sharded`` on a mesh),
``launch/mesh.py`` builds meshes over the caller's process group,
``launch/train.py`` is the CLI (``python -m repro_torch.launch.train``).
The sharding rules, the steps over a mesh, ``lower_cell`` and ``dryrun``
wait for ROADMAP.md queue A item 8b."""
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    projection_engine_for)

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "projection_engine_for"]
