"""The decoder-only LM of the port, as far as the ported layer kinds go:
RecurrentGemma's pattern of RG-LRU blocks ("rec") and sliding-window
attention ("attn_local"), each followed by a GLU MLP; Mamba-2's stack of SSD
blocks ("ssm"), which have no MLP; and the Qwen decoders' stack of global
attention layers ("attn", with qkv biases) and GLU MLPs.  Embeddings are
tied, or untied with an ``lm_head (d_model, padded_vocab)``.

The reference stacks whole pattern periods (or, for a uniform stack, all
layers) for ``lax.scan``; here the layers are one ``nn.ModuleList`` in order,
and ``repro_torch.convert`` maps between the layouts.  The decode cache is a
list with one dict per layer: {"k", "v"} for attention, a ring of
``min(max_len, window)`` slots for "attn_local" and a linear cache of
``max_len`` slots for "attn"; {"h" (fp32), "conv"} for a recurrent or SSM
layer.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import blocks
from .attention import attention, attn_defs, decode_attention, kv_cache_defs
from .common import DefModule, ParamDef, rms_norm

__all__ = [
    "KINDS",
    "Decoder",
    "check_supported",
    "working_dtype",
    "forward",
    "prefill",
    "decode_step",
    "cache_defs",
    "init_cache",
]

KINDS = ("rec", "attn_local", "ssm", "attn")
_ATTN = ("attn", "attn_local")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def working_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def has_mlp(cfg: ModelConfig, kind: str) -> bool:
    """The reference's rule: a layer has an MLP unless it is an SSM layer or
    the config has none."""
    return cfg.d_ff > 0 and kind != "ssm"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's decoder does not run yet."""
    missing = [k for k in sorted(set(cfg.kinds)) if k not in KINDS]
    if missing:
        raise NotImplementedError(f"{cfg.arch_id}: layer kinds {missing} are not ported "
                                  f"(the port runs {KINDS})")
    unsupported = {
        "encoder_layers": cfg.encoder_layers, "n_experts": cfg.n_experts,
        "n_vis_tokens": cfg.n_vis_tokens, "mlp_bias": cfg.mlp_bias,
        "non-GLU MLP": not cfg.glu, "layernorm": cfg.norm != "rmsnorm",
        "no attention window": "attn_local" in cfg.kinds and cfg.attn_window is None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.arch_id}: not ported: {', '.join(bad)}")
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"{cfg.arch_id}: working type {cfg.dtype!r} not ported")


def _norm(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), init="ones", fp32=True)


class Layer(DefModule):
    """One layer: ln1 -> mixer (rec, attn or ssm) -> residual, then, where the
    layer has one, ln2 -> mlp -> residual."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        mlp = has_mlp(cfg, kind)
        norms = {"ln1_w": _norm(cfg), **({"ln2_w": _norm(cfg)} if mlp else {})}
        super().__init__(norms, dtype, device)
        self.kind = kind
        if kind == "rec":
            self.rec = DefModule(blocks.rec_defs(cfg), dtype, device)
        elif kind == "ssm":
            self.ssm = DefModule(blocks.ssm_defs(cfg), dtype, device)
        else:
            self.attn = DefModule(attn_defs(cfg), dtype, device)
        self.mlp = DefModule(blocks.mlp_defs(cfg), dtype, device) if mlp else None


class Decoder(DefModule):
    """Embedding, the layers, the final norm, and the output projection: the
    embedding's transpose where the config ties them, else ``lm_head``."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        check_supported(cfg)
        dtype = working_dtype(cfg)
        device = resolve_device(device)
        defs = {"tok_emb": ParamDef((cfg.padded_vocab, cfg.d_model), scale=1.0)}
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab))
        super().__init__({**defs, "ln_f_w": _norm(cfg)}, dtype, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Layer(cfg, kind, dtype, device) for kind in cfg.kinds)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self, tokens)


def _embed(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    x = model.tok_emb[tokens]
    if cfg.emb_scale:
        # the scale is rounded to the working type first, as the reference does
        # (50.5 in bf16 for d 2560), on the host: no copy to the card, no wait
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _logits(cfg: ModelConfig, model: Decoder, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.ln_f_w)
    if cfg.tie_embeddings:
        return torch.einsum("bse,ve->bsv", x, model.tok_emb)
    return torch.einsum("bse,ev->bsv", x, model.lm_head)


def _ring_from_full(k: torch.Tensor, window: int) -> torch.Tensor:
    """Arrange the last ``window`` positions of (B,S,KVH,D) into ring slots
    (position p in slot p % window)."""
    s = k.shape[1]
    if s >= window:
        tail = k[:, s - window:]
        shift = (s - window) % window
        return torch.roll(tail, shifts=shift, dims=1) if shift else tail.clone()
    pad = torch.zeros((k.shape[0], window - s, *k.shape[2:]), dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _pad_cache(k: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,S,KVH,D) -> a linear cache of ``max_len`` slots (position p in slot p)."""
    s = k.shape[1]
    if s == max_len:
        return k
    pad = torch.zeros((k.shape[0], max_len - s, *k.shape[2:]), dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _window(cfg: ModelConfig, kind: str) -> int | None:
    """The attention window of a layer kind: none for global attention."""
    return cfg.attn_window if kind == "attn_local" else None


def _layer(cfg: ModelConfig, layer: Layer, x: torch.Tensor, positions, max_len):
    """One layer over the whole sequence; with ``max_len`` also its cache entry."""
    h = rms_norm(x, layer.ln1_w)
    entry = None
    if layer.kind in _ATTN:
        win = _window(cfg, layer.kind)
        out, (k, v) = attention(cfg, layer.attn, h, positions=positions, causal=True,
                                window=win, return_kv=True)
        if max_len is not None and win is not None:
            slots = min(max_len, win)
            entry = {"k": _ring_from_full(k, slots), "v": _ring_from_full(v, slots)}
        elif max_len is not None:
            entry = {"k": _pad_cache(k, max_len), "v": _pad_cache(v, max_len)}
    else:
        state = None
        if max_len is not None:   # prefill starts from a zero state, as a decode would
            state = _zeros(_STATE_DEFS[layer.kind](cfg, x.shape[0]), x.dtype, x.device)
        block = blocks.rec_block if layer.kind == "rec" else blocks.ssm_block
        out, entry = block(cfg, getattr(layer, layer.kind), h, state)
    x = x + out
    if layer.mlp is not None:
        x = x + blocks.mlp(cfg, layer.mlp, rms_norm(x, layer.ln2_w))
    return x, entry


def forward(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    """Token logits (B, S, padded_vocab)."""
    x = _embed(cfg, model, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for layer in model.layers:
        x, _ = _layer(cfg, layer, x, positions, None)
    return _logits(cfg, model, x)


def prefill(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor, *,
            max_len: int | None = None):
    """Forward the prompt and build the decode cache.  Returns
    (last-position logits (B, padded_vocab), cache)."""
    s = tokens.shape[1]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    x = _embed(cfg, model, tokens)
    positions = torch.arange(s, device=tokens.device)
    cache = []
    for layer in model.layers:
        x, entry = _layer(cfg, layer, x, positions, max_len)
        cache.append(entry)
    return _logits(cfg, model, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, model: Decoder, cache: list, tokens: torch.Tensor,
                pos: int):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, padded_vocab), the new cache); attention caches are updated in
    place."""
    x = _embed(cfg, model, tokens)
    new_cache = []
    for layer, entry in zip(model.layers, cache):
        h = rms_norm(x, layer.ln1_w)
        if layer.kind in _ATTN:
            out, entry = decode_attention(cfg, layer.attn, h, entry, pos,
                                          window=_window(cfg, layer.kind))
        elif layer.kind == "rec":
            out, entry = blocks.rec_decode(cfg, layer.rec, h, entry)
        else:
            out, entry = blocks.ssm_decode(cfg, layer.ssm, h, entry)
        x = x + out
        if layer.mlp is not None:
            x = x + blocks.mlp(cfg, layer.mlp, rms_norm(x, layer.ln2_w))
        new_cache.append(entry)
    return _logits(cfg, model, x)[:, 0], new_cache


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    """Per layer, name -> (shape, fp32?) of the decode cache (sliding-window
    layers get rings of ``min(max_len, window)`` slots, global attention
    layers linear caches of ``max_len``)."""
    return [kv_cache_defs(cfg, batch, min(max_len, _window(cfg, kind) or max_len))
            if kind in _ATTN else _STATE_DEFS[kind](cfg, batch)
            for kind in cfg.kinds]


# the decode state of the recurrent kinds: name -> (shape, fp32?)
_STATE_DEFS = {"rec": blocks.rec_cache_defs, "ssm": blocks.ssm_cache_defs}


def _zeros(defs: dict, dtype, device) -> dict:
    return {name: torch.zeros(shape, dtype=torch.float32 if fp32 else dtype, device=device)
            for name, (shape, fp32) in defs.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list[dict]:
    """A zero decode cache on ``device``."""
    return [_zeros(d, working_dtype(cfg), device) for d in cache_defs(cfg, batch, max_len)]
