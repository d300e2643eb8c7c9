"""mixtral-8x7b [moe]: 8 experts top-2, SWA [arXiv:2401.04088; hf].

32 layers, d_model=4096, 32 heads (GQA kv=8), expert d_ff=14336, vocab=32000,
sliding window 4096.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    attn_window=4096,
    layer_pattern=("attn_local",),
)
