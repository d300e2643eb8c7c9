"""internvl2-26b [vlm]: InternViT (stub) + InternLM2 backbone
[arXiv:2404.16821; hf].

48 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553.
Vision frontend is a STUB: input_specs provides precomputed patch embeddings
(n_vis_tokens=256) that replace the leading token positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_vis_tokens=256,
)
