"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, mlp_kind="geglu", embed_scale=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    long_context_capable=True,   # 5:1 local:global -> long_500k runs

    rules_overrides=(("heads", None), ("kv_heads", None)),
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/mlp/w1$", norm="l1inf",
                       radius=48.0, axis=0, every_k=10),
    ),
)
