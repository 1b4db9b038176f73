from .adam import (AdamConfig, AdamState, adam_init, adam_update,
                   adam_scalars, adam_leaf_update, global_norm,
                   clip_by_global_norm, clip_scale)
from .schedule import constant, cosine_with_warmup, step_decay
