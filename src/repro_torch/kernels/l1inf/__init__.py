from .ops import project_l1inf_kernel, project_l1inf_kernel_segmented
from .kernel import (colstats, mu_solve, clip_apply, launch_counts,
                     reset_launch_counts)
from . import ref
