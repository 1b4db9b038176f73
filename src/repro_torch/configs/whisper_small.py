"""whisper-small [audio] — enc-dec, 12L each, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865; conv frontend stubbed as precomputed frame
embeddings (assignment). [arXiv:2212.04356; unverified]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    pattern=("dec_cross",), encdec=True, n_enc_layers=12, enc_seq=1500,
    mlp_kind="gelu", norm_kind="layernorm", rope_theta=0.0,  # sinusoidal
    tie_embeddings=True,
    rules_overrides=(("heads", None), ("kv_heads", None)),
    projection_specs=(
        ProjectionSpec(pattern=r"(blocks|enc_blocks)/.*/mlp/w1$",
                       norm="l1inf", radius=24.0, axis=0, every_k=10),
    ),
)
