"""whisper-medium [audio]: enc-dec, conv frontend stubbed to frame embeddings.

24 enc + 24 dec layers, d_model=1024, 16 heads (MHA), d_ff=4096,
vocab=51865 [arXiv:2212.04356; unverified].  LayerNorm + GELU + biased
projections, learned decoder positions, tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    glu=False,
    mlp_bias=True,
    encoder_layers=24,
    n_frames=1500,
    tie_embeddings=True,
    rope_theta=0.0,  # absolute positions (learned/sinusoidal), no RoPE
)
