from .ops import flash_attention
from .kernel import flash_attention_fwd, launch_counts, reset_launch_counts
from . import ref
