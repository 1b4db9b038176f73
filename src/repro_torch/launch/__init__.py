"""The production step builders and the training launcher (port of
``repro.launch``, one device): ``launch/steps.py`` builds the train,
prefill and decode steps, ``launch/train.py`` is the CLI
(``python -m repro_torch.launch.train``). What needs a mesh (the sharding
rules, ``lower_cell``, ``dryrun``, ``mesh``) waits for the distributed
layer (ROADMAP.md queue A item 8)."""
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    projection_engine_for)

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "projection_engine_for"]
