"""The encoder-decoder transformer of the port (Whisper's backbone).

The audio frontend (log-mel + the two-conv stem) is a stub, as in the
reference: ``frames`` arrive as frame embeddings (B, n_frames, d_model) with
their positions already added.  The transformer is whole: a bidirectional
encoder, a causal decoder with cross-attention over the encoder states,
learned decoder positions, LayerNorm + GELU + biased projections, tied
embeddings.  No layer is roped (``rope_theta`` is 0).

Attention over a sequence goes through the flash kernel (K2): non-causal over
the frames in the encoder, causal in the decoder's self-attention, and
non-causal from the decoder rows over the encoder rows in the
cross-attention.  A decode step reads its caches in PyTorch: the decoder's
self-attention cache (linear, ``max_len`` slots) and the cross-attention
keys and values, computed once from the encoder states at the prefill.

The decode cache is a list with one dict per decoder layer: {"k", "v"}
(B, max_len, KVH, HD) and {"cross_k", "cross_v"} (B, n_frames, KVH, HD).
The layers are two ``nn.ModuleList``s (``enc_layers``, ``dec_layers``);
``repro_torch.convert`` maps them to and from the reference's stacked trees.

Training (``EncDec(cfg, master=True)``: fp32 masters cast at use) runs each
encoder and decoder layer in a non-reentrant recompute region unless
``cfg.remat`` is "none", as the reference wraps its layer body in
``jax.checkpoint``.  The reference hands the encoder-decoder no residency
plan, so a region holds only its inputs and K2 runs again in its replay.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import blocks
from .attention import attention, attn_defs, cross_decode_attention, decode_attention, \
    kv_cache_defs
from ..sharding import shard
from ..sharding.partitioning import product
from .common import CacheDef, DefModule, ParamDef, embedding, tag
from .decoder import (_pad_cache, _tied, _zeros, apply_norm, check_supported, norm_defs,
                      working_dtype)

__all__ = [
    "EncDec",
    "MAX_DEC_POSITIONS",
    "encdec_encode",
    "encdec_forward",
    "encdec_prefill",
    "encdec_decode_step",
    "encdec_cache_defs",
    "encdec_init_cache",
]

# the reference's default size of the learned decoder position table
MAX_DEC_POSITIONS = 32_768


class EncLayer(DefModule):
    """ln1 -> bidirectional self-attention -> residual, ln2 -> mlp -> residual."""

    def __init__(self, cfg: ModelConfig, dtype, device, master: bool = False):
        super().__init__({**norm_defs(cfg, "ln1"), **norm_defs(cfg, "ln2")}, dtype, device,
                         master)
        self.attn = DefModule(attn_defs(cfg), dtype, device, master)
        self.mlp = DefModule(blocks.mlp_defs(cfg), dtype, device, master)


class DecLayer(DefModule):
    """ln1 -> causal self-attention, ln_x -> cross-attention over the encoder
    states, ln2 -> mlp; each with its residual."""

    def __init__(self, cfg: ModelConfig, dtype, device, master: bool = False):
        super().__init__({**norm_defs(cfg, "ln1"), **norm_defs(cfg, "ln_x"),
                          **norm_defs(cfg, "ln2")}, dtype, device, master)
        self.self_attn = DefModule(attn_defs(cfg), dtype, device, master)
        self.cross_attn = DefModule(attn_defs(cfg), dtype, device, master)
        self.mlp = DefModule(blocks.mlp_defs(cfg), dtype, device, master)


class EncDec(DefModule):
    """Token embedding (tied output projection), learned decoder positions
    (``MAX_DEC_POSITIONS`` rows), the encoder and decoder stacks, and each
    stack's final LayerNorm.  Serving: parameters in the working type, norms
    fp32; ``master=True``: fp32 masters that require gradients, cast to the
    working type at use (training)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 master: bool = False):
        check_supported(cfg)
        if not cfg.encoder_layers:
            raise ValueError(f"{cfg.arch_id} has no encoder: build it with "
                             "models.decoder.Decoder")
        dtype = working_dtype(cfg)
        device = resolve_device(device)
        d = cfg.d_model
        super().__init__({"tok_emb": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"),
                                              scale=1.0),
                          "pos_emb": ParamDef((MAX_DEC_POSITIONS, d), (None, "embed"),
                                              scale=0.02),
                          **norm_defs(cfg, "ln_enc_f"), **norm_defs(cfg, "ln_dec_f")},
                         dtype, device, master)
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype, device, master)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device, master)
                                        for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        return encdec_forward(self.cfg, self, tokens, frames)


def _regions(cfg: ModelConfig, model: EncDec) -> bool:
    """Whether the layers run in recompute regions: a training forward
    (gradients on, fp32 masters) unless ``cfg.remat`` is "none"."""
    return (cfg.remat != "none" and torch.is_grad_enabled()
            and model.master("tok_emb").requires_grad)


def _run(regions: bool, fn, *args) -> torch.Tensor:
    """``fn(*args)``, in a non-reentrant recompute region if ``regions``."""
    if not regions:
        return fn(*args)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                       preserve_rng_state=False)


def _enc_layer(cfg: ModelConfig, layer: EncLayer, positions, rules,
               x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, layer, "ln1", x)
    x = x + attention(cfg, layer.attn, h, positions=positions, causal=False, rope=False,
                      rules=rules)
    return tag(x + blocks.mlp(cfg, layer.mlp, apply_norm(cfg, layer, "ln2", x), rules),
               "enc_resid")


def encdec_encode(cfg: ModelConfig, model: EncDec, frames: torch.Tensor, *,
                  rules=None) -> torch.Tensor:
    """frames (B, F, E), the stub frontend's output -> encoder states (B, F, E)."""
    x = shard(frames.to(working_dtype(cfg)), ("batch", "seq", "embed"), rules)
    positions = torch.arange(x.shape[1], device=x.device)
    regions = _regions(cfg, model)
    for layer in model.enc_layers:
        x = _run(regions, functools.partial(_enc_layer, cfg, layer, positions, rules), x)
    return apply_norm(cfg, model, "ln_enc_f", x)


def _embed(cfg: ModelConfig, model: EncDec, tokens: torch.Tensor, pos0: int) -> torch.Tensor:
    """Token embeddings plus the learned positions ``pos0 ..``."""
    s = tokens.shape[1]
    n_pos = model.master("pos_emb").shape[0]
    if pos0 + s > n_pos:
        raise ValueError(f"positions up to {pos0 + s} are past the decoder's "
                         f"{n_pos} learned positions")
    # gathered from the stored tables, then cast (a training model scatters
    # the gradient into its fp32 masters), as decoder._embed
    x = embedding(model.master("tok_emb"), tokens).to(working_dtype(cfg))
    return x + model.master("pos_emb")[pos0:pos0 + s].to(x.dtype)[None]


def _dec_layer(cfg: ModelConfig, layer: DecLayer, positions, enc_positions,
               x: torch.Tensor, enc: torch.Tensor, entries: list | None = None,
               max_len: int | None = None, rules=None) -> torch.Tensor:
    """One decoder layer; with ``max_len`` it appends its cache entry to
    ``entries``."""
    out, (k, v) = attention(cfg, layer.self_attn, apply_norm(cfg, layer, "ln1", x),
                            positions=positions, causal=True, rope=False, return_kv=True,
                            rules=rules)
    x = x + out
    out, (ck, cv) = attention(cfg, layer.cross_attn, apply_norm(cfg, layer, "ln_x", x),
                              positions=enc_positions, causal=False, rope=False,
                              kv_x=enc, return_kv=True, rules=rules)
    x = x + out
    x = tag(x + blocks.mlp(cfg, layer.mlp, apply_norm(cfg, layer, "ln2", x), rules),
            "dec_resid")
    if max_len is not None:
        entries.append({"k": _pad_cache(k, max_len), "v": _pad_cache(v, max_len),
                        "cross_k": ck, "cross_v": cv})
    return x


def _decoder(cfg: ModelConfig, model: EncDec, x: torch.Tensor, enc: torch.Tensor,
             max_len: int | None, rules=None):
    """The decoder stack over the whole sequence; with ``max_len`` also each
    layer's cache entry (self-attention keys and values padded to
    ``max_len`` slots, the cross-attention keys and values)."""
    positions = torch.arange(x.shape[1], device=x.device)
    enc_positions = torch.arange(enc.shape[1], device=x.device)
    entries = []
    regions = max_len is None and _regions(cfg, model)
    for layer in model.dec_layers:
        x = _run(regions, functools.partial(_dec_layer, cfg, layer, positions, enc_positions,
                                            entries=entries, max_len=max_len, rules=rules),
                 x, enc)
    return x, entries


def _logits(cfg: ModelConfig, model: EncDec, x: torch.Tensor) -> torch.Tensor:
    return product(_tied, apply_norm(cfg, model, "ln_dec_f", x), model.tok_emb)


def encdec_forward(cfg: ModelConfig, model: EncDec, tokens: torch.Tensor,
                   frames: torch.Tensor, *, rules=None) -> torch.Tensor:
    """Token logits (B, S, padded_vocab) of the decoder over ``tokens (B, S)``
    conditioned on ``frames (B, F, E)``."""
    enc = encdec_encode(cfg, model, frames, rules=rules)
    x = shard(_embed(cfg, model, tokens, 0), ("batch", "seq", "embed"), rules)
    x, _ = _decoder(cfg, model, x, enc, None, rules)
    return shard(_logits(cfg, model, x), ("batch", "seq", "vocab"), rules)


def encdec_prefill(cfg: ModelConfig, model: EncDec, tokens: torch.Tensor,
                   frames: torch.Tensor, *, max_len: int | None = None, rules=None):
    """Encode the frames, forward the decoder prompt, build the decode cache.
    Returns (last-position logits (B, padded_vocab), cache)."""
    s = tokens.shape[1]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    enc = encdec_encode(cfg, model, frames, rules=rules)
    x = shard(_embed(cfg, model, tokens, 0), ("batch", "seq", "embed"), rules)
    x, cache = _decoder(cfg, model, x, enc, max_len, rules)
    return _logits(cfg, model, x[:, -1:])[:, 0], cache


def encdec_decode_step(cfg: ModelConfig, model: EncDec, cache: list, tokens: torch.Tensor,
                       pos: int, *, rules=None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, padded_vocab), the cache); the self-attention caches are
    updated in place, the cross-attention caches are read only."""
    x = _embed(cfg, model, tokens, pos)
    for layer, entry in zip(model.dec_layers, cache):
        h = apply_norm(cfg, layer, "ln1", x)
        out, self_kv = decode_attention(cfg, layer.self_attn, h, entry, pos, rope=False,
                                        rules=rules)
        entry.update(self_kv)
        x = x + out
        x = x + cross_decode_attention(cfg, layer.cross_attn, apply_norm(cfg, layer, "ln_x", x),
                                       entry["cross_k"], entry["cross_v"])
        x = x + blocks.mlp(cfg, layer.mlp, apply_norm(cfg, layer, "ln2", x), rules)
    return _logits(cfg, model, x)[:, 0], cache


def encdec_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    """Per decoder layer, name -> (shape, fp32?) of the decode cache."""
    cross = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
    axes = ("batch", None, "kv_heads", "head_dim")
    return [{**kv_cache_defs(cfg, batch, max_len),
             "cross_k": CacheDef(cross, False, axes), "cross_v": CacheDef(cross, False, axes)}
            for _ in range(cfg.n_layers)]


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list[dict]:
    """A zero decode cache on ``device``."""
    return [_zeros(d, working_dtype(cfg), device)
            for d in encdec_cache_defs(cfg, batch, max_len)]
