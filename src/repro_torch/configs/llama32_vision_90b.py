"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attn image layers (every 5th layer), vision
frontend stubbed as precomputed patch embeddings (assignment).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    pattern=("global", "global", "global", "global", "cross"),
    n_img_tokens=1600, tie_embeddings=False, rope_theta=500_000.0,
    rules_overrides=(("kv_heads", None),),   # kv=8 < 16-way model axis
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/mlp/w1$", norm="l1inf",
                       radius=96.0, axis=0, every_k=10),
    ),
)
