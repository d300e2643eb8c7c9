"""qwen2.5-14b [dense]: GQA kv=8, QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf].

48 layers, d_model=5120, 40 heads, d_ff=13824, vocab=152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
