"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab=152064,
    pattern=("global",), mlp_kind="swiglu", qkv_bias=True,
    tie_embeddings=False, rope_theta=1_000_000.0,
    # 40 heads / 8 kv do not divide the 16-way model axis -> replicate heads,
    # TP lives on d_ff and vocab.
    rules_overrides=(("heads", None), ("kv_heads", None)),
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/mlp/w1$", norm="l1inf",
                       radius=64.0, axis=0, every_k=10),
    ),
)
