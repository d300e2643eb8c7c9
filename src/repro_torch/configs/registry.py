"""Architecture registry of the port: the full configs (the reference's, as
data) and their reduced smoke variants (same family, tiny dims) for CPU tests.

All ten architectures are here, because the planner (``plan/``) and the
``residency`` / ``pipeline`` instance families read any of them.  The model
path serves those in ``PORTED_ARCH_IDS``: recurrentgemma-2b (rec +
attn_local), mamba2-780m (ssm), the global-attention decoders qwen2.5-14b,
codeqwen1.5-7b and qwen1.5-32b (attn), the MoE decoders granite-moe-1b-a400m
(attn) and mixtral-8x7b (sliding-window attn_local), the vision-language
internvl2-26b (attn, vision tokens) and the encoder-decoder whisper-medium
(``models.encdec``).  llama3-405b's kinds run too, at its smoke config; at
full width it fits no single card.  ``models.decoder.check_supported``
refuses what training does not run yet, naming what it waits for.
"""
from __future__ import annotations

import dataclasses
import importlib

from .base import ModelConfig

ARCH_IDS = (
    "whisper-medium",
    "recurrentgemma-2b",
    "qwen2.5-14b",
    "llama3-405b",
    "qwen1.5-32b",
    "codeqwen1.5-7b",
    "mixtral-8x7b",
    "granite-moe-1b-a400m",
    "mamba2-780m",
    "internvl2-26b",
)

# archs the port's model path serves
PORTED_ARCH_IDS = ("recurrentgemma-2b", "mamba2-780m", "qwen2.5-14b", "codeqwen1.5-7b",
                   "qwen1.5-32b", "granite-moe-1b-a400m", "whisper-medium", "internvl2-26b",
                   "mixtral-8x7b")

_MODULE_OF = {a: a.replace(".", "_").replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"{__package__}.{_MODULE_OF[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family: few layers, narrow width, tiny vocab."""
    cfg = get_config(arch_id)
    n_layers = min(cfg.n_layers, 4)
    if len(cfg.layer_pattern) > 1:
        # >= 2 full pattern periods, as the reference's smoke configs have
        n_layers = max(n_layers, 2 * len(cfg.layer_pattern))
    kw = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        lru_width=128 if cfg.lru_width else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else None,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        n_frames=32 if cfg.encoder_layers else 1500,
        n_vis_tokens=8 if cfg.n_vis_tokens else 0,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **kw)
