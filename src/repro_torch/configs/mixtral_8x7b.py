"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=("local",), window=4096,
    n_experts=8, top_k=2, capacity_factor=1.25,
    expert_sharding="tp",     # 8 experts < 16-way axis: TP inside experts
    tie_embeddings=False, rope_theta=1_000_000.0,
    rules_overrides=(("kv_heads", None),),
    projection_specs=(
        # expert-structured sparsity: per-expert column pruning (vmapped)
        ProjectionSpec(pattern=r"blocks/.*/moe/w1$", norm="l1inf",
                       radius=64.0, axis=0, every_k=10),
    ),
)
