"""The LM train loop and the batched serving front end (port of
``repro.train``): ``train/loop.py`` trains, ``train/serve.py``'s
``BatchServer`` serves cohorts through ``serve.engine.FleetEngine``."""
from .loop import TrainConfig, train, build_accum_step, lr_at
from .serve import ServeConfig, BatchServer

__all__ = ["TrainConfig", "train", "build_accum_step", "lr_at",
           "ServeConfig", "BatchServer"]
