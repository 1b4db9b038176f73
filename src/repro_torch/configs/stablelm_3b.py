"""stablelm-3b [dense] — 32L d_model=2560 32H (kv=32) d_ff=6912
vocab=50304, LayerNorm, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    pattern=("global",), mlp_kind="swiglu", norm_kind="layernorm",
    rope_frac=0.25, tie_embeddings=False,
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/mlp/w1$", norm="l1inf",
                       radius=48.0, axis=0, every_k=10),
    ),
)
