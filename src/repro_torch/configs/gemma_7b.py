"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    pattern=("global",), mlp_kind="geglu", norm_kind="rmsnorm",
    embed_scale=True, tie_embeddings=True, rope_theta=10000.0,
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/mlp/w1$", norm="l1inf",
                       radius=64.0, axis=0, every_k=10),
    ),
)
