"""The sizes of a configuration file, as the weights, the reference and the
operation counts read them.

A configuration file holds the published ``config.json`` keys with their
values as run (``departures`` names where the run differs from the source).
This reads the decoder-only LM with global attention and a dense GLU MLP or a
top-k MoE, which is what the benchmark's configurations are; any other
layer kind is refused here rather than guessed.
"""
from __future__ import annotations

import dataclasses

_PAD_VOCAB = 256     # the port rounds its vocabulary up to a multiple of 256


@dataclasses.dataclass(frozen=True)
class Arch:
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    experts: int        # 0: a dense MLP
    top_k: int
    vocab: int
    eps: float
    theta: float
    qkv_bias: bool
    tied: bool
    attn_scale: float
    emb_mult: float
    res_mult: float
    logit_div: float
    dtype: str

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // _PAD_VOCAB) * _PAD_VOCAB


def arch_of(config: dict) -> Arch:
    """The sizes of ``config`` (a configuration file's contents)."""
    if config.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{config['name']}: activation {config['hidden_act']!r} not read")
    if config.get("use_sliding_window", False) or config.get("layer_types"):
        raise ValueError(f"{config['name']}: only global attention layers are read")
    d, heads = config["hidden_size"], config["num_attention_heads"]
    head_dim = config.get("head_dim") or d // heads
    return Arch(
        n_layers=config["num_hidden_layers"], d=d, heads=heads,
        kv_heads=config.get("num_key_value_heads", heads), head_dim=head_dim,
        ff=config["intermediate_size"], experts=config.get("num_local_experts", 0),
        top_k=config.get("num_experts_per_tok", 0), vocab=config["vocab_size"],
        eps=config["rms_norm_eps"], theta=config["rope_theta"],
        qkv_bias=config.get("attention_bias", False),
        tied=config.get("tie_word_embeddings", False),
        attn_scale=config.get("attention_multiplier", head_dim ** -0.5),
        emb_mult=config.get("embedding_multiplier", 1.0),
        res_mult=config.get("residual_multiplier", 1.0),
        logit_div=config.get("logits_scaling", 1.0),
        dtype=config["torch_dtype"])
