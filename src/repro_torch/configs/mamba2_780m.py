"""mamba2-780m [ssm]: SSD state-space duality [arXiv:2405.21060; unverified].

48 layers, d_model=1536, attention-free (d_ff=0), vocab=50280, state=128,
expand=2 (d_inner=3072), head_dim=64 (48 SSD heads), conv width 4.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv1d_width=4,
    tie_embeddings=True,
)
