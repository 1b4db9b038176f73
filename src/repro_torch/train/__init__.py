"""The LM train loop (port of ``repro.train``). The batched serving
front end (``train/serve.py``) waits for ROADMAP.md queue A item 7."""
from .loop import TrainConfig, train, build_accum_step, lr_at

__all__ = ["TrainConfig", "train", "build_accum_step", "lr_at"]
