from .ops import ssd_attention
from .kernel import ssd_fwd, launch_counts, reset_launch_counts
from . import ref
