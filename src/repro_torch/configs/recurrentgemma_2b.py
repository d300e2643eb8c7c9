"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern.

26 layers, d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU),
vocab=256000, window=2048 [arXiv:2402.19427; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="gelu",
    glu=True,
    attn_window=2048,
    layer_pattern=("rec", "rec", "attn_local"),
    lru_width=2560,
    conv1d_width=4,
    emb_scale=True,
    tie_embeddings=True,
)
