"""Checkpointing in the JAX package's on-disk format (port of
``repro.checkpoint``)."""
from .ckpt import (save, restore, restore_tree, latest_step, gc_keep_last,
                   AsyncCheckpointer)

__all__ = ["save", "restore", "restore_tree", "latest_step", "gc_keep_last",
           "AsyncCheckpointer"]
