"""codeqwen1.5-7b [dense]: qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].

32 layers, d_model=4096, 32 heads (kv=32), d_ff=13440, vocab=92416.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
