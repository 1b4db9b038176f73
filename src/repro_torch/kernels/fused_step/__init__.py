from .ops import fused_adam_colstats, fused_adam_clip_apply
from .kernel import launch_counts, reset_launch_counts
from . import ref
