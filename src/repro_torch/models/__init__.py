"""The LM zoo: layers, attention (GQA, cross, MLA; flash kernels), Mamba2
SSD (SSD kernels), the MoE MLP, pattern-built stacks (an encoder-decoder
too) with ``forward`` and ``decode_step`` (``decode_step_`` in place), and
``build``."""
from .param import (PM, is_pm, abstract, materialize, stack_layout,
                    count_params)
from .transformer import (ArchConfig, block_layout, block_apply_full,
                          model_layout, forward, init_cache, decode_step,
                          decode_step_, cache_max_len)
from .zoo import (SHAPES, Model, build, cell_supported, input_specs,
                  make_batch, reduce_config)
