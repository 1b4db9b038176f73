"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from ..models.transformer import ArchConfig
from ..core.constraints import ProjectionSpec

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    pattern=("ssm",), ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_chunk=64, tie_embeddings=True,   # vocab pads 50280 -> 50304
    # attention-free: the paper's technique applies to the SSM in/out
    # projections (DESIGN.md §5) — not inapplicable.
    projection_specs=(
        ProjectionSpec(pattern=r"blocks/.*/ssm/wx$", norm="l1inf",
                       radius=24.0, axis=0, every_k=10),
    ),
)
