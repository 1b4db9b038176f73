"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA (kv_lora=512, q_lora=1536, nope 128 + rope 64, v 128),
2 shared + 160 routed experts top-6. [arXiv:2405.04434; hf]

Deviation (DESIGN.md §6): the released model's first dense layer is modeled
as MoE like the rest (uniform scan stack)."""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=1536, vocab=102400,
    pattern=("mla",),
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, capacity_factor=1.25,
    expert_sharding="ep", tie_embeddings=False,
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/moe/w1$", norm="l1inf",
                       radius=16.0, axis=0, every_k=10),
    ),
)
