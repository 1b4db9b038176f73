"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per layer,
sliding-window attention. [arXiv:2411.13676; hf]

Deviations (DESIGN.md §6): the 3 full-attention layers of the released model
are approximated as sliding-window like the rest; meta-tokens are omitted
(frontend-level detail)."""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    pattern=("hybrid",), window=1024,
    ssm_state=16, ssm_expand=2, ssm_headdim=64,
    tie_embeddings=True,
    # 25 heads / 5 kv don't divide the 16-way model axis (vocab 32001 is
    # padded to 32128 by the layout and shards normally)
    rules_overrides=(("heads", None), ("kv_heads", None)),
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/(mlp/w1|ssm/wx)$", norm="l1inf",
                       radius=32.0, axis=0, every_k=10),
    ),
)
