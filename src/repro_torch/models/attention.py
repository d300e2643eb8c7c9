"""Attention layers: GQA/MHA/MQA projections (with the qkv biases where the
config has them) + RoPE (unless the layer has absolute positions) + the
flash kernel for the prompt, self- or cross-attention (keys and values from
``kv_x``), and single-token decode against a KV cache: a ring of ``window``
slots for a sliding-window layer, a linear cache of ``max_len`` slots for a
global one, or a fixed cross-attention cache of encoder states
(:func:`cross_decode_attention`).

One card holds the whole cache, so decode is the reference's single-shard
branch (``_local_decode``); its sequence-sharded ``shard_map`` form belongs
to the multi-device work.  Decode writes the new key and value into the cache
in place (the reference returns an updated copy): the caller hands the cache
on and never reads the old one, and a copy per layer per token would double
the traffic of the step.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import ParamDef, apply_rope, tag

__all__ = ["attn_defs", "attention", "decode_attention", "cross_decode_attention",
           "kv_cache_defs"]

_NEG = -1e30


def attn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd)),
        "wk": ParamDef((d, kvh, hd)),
        "wv": ParamDef((d, kvh, hd)),
        "wo": ParamDef((h, hd, d)),
    }
    if cfg.qkv_bias:
        # the reference's four biases; ``bo`` is the reference's own (the
        # published Qwen models have no output-projection bias)
        defs["bq"] = ParamDef((h, hd), init="zeros")
        defs["bk"] = ParamDef((kvh, hd), init="zeros")
        defs["bv"] = ParamDef((kvh, hd), init="zeros")
        defs["bo"] = ParamDef((d,), init="zeros")
    return defs


def _project_q(cfg: ModelConfig, p, x):
    q = torch.einsum("bse,ehd->bshd", x, p.wq)
    return q + p.bq if cfg.qkv_bias else q


def _project_qkv(cfg: ModelConfig, p, x, kv_x=None):
    """x: (B, S, E) -> q (B,S,H,HD), k/v (B,Skv,KVH,HD) from ``kv_x`` (default
    ``x``), biased before RoPE."""
    kv_x = x if kv_x is None else kv_x
    k = torch.einsum("bse,ehd->bshd", kv_x, p.wk)
    v = torch.einsum("bse,ehd->bshd", kv_x, p.wv)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return _project_q(cfg, p, x), k, v


def _out(cfg: ModelConfig, p, y):
    return y + p.bo if cfg.qkv_bias else y


def attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, window: int | None = None, rope: bool = True,
              kv_x: torch.Tensor | None = None, return_kv: bool = False):
    """Full-sequence attention (prefill, encoder): x (B, S, E) -> (B, S, E)
    [+ the (roped) k and the v, (B, Skv, KVH, HD) each].  ``window=None`` is
    global attention; ``kv_x (B, Skv, E)`` makes it cross-attention (keys and
    values from ``kv_x``); ``rope=False`` for absolute positions."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = tag(q, "attn_q"), tag(k, "attn_kv"), tag(v, "attn_kv")
    out = tag(ops.flash_attention(q, k, v, causal=causal, window=window, name="attn_out"),
              "attn_out")
    y = _out(cfg, p, torch.einsum("bshd,hde->bse", out, p.wo))
    return (y, (k, v)) if return_kv else y


def kv_cache_defs(cfg: ModelConfig, batch: int, slots: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": (shape, False), "v": (shape, False)}


def _attend(cfg: ModelConfig, p, q: torch.Tensor, k_cache, v_cache, valid=None):
    """One query token per row over a cache: q (B, 1, H, HD), caches (B, S,
    KVH, HD), ``valid`` (S,) bool or None for all; fp32 scores and softmax,
    then the output projection -> (B, 1, E)."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = (q[:, 0] * hd ** -0.5).float().reshape(b, kvh, h // kvh, hd)
    logits = torch.einsum("bcgd,bkcd->bcgk", qg, k_cache.float())
    if valid is not None:
        logits = torch.where(valid, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    s = e.sum(dim=-1)
    o = torch.einsum("bcgk,bkcd->bcgd", e, v_cache.float())
    out = (o / s.clamp_min(1e-30)[..., None]).reshape(b, h, hd).to(q.dtype)
    return _out(cfg, p, torch.einsum("bhd,hde->be", out, p.wo))[:, None]


def decode_attention(cfg: ModelConfig, p, x: torch.Tensor, cache: dict, pos: int, *,
                     rope: bool = True, window: int | None = None):
    """One token against a cache of ``S_max`` slots: x (B, 1, E), cache
    {"k","v"}: (B, S_max, KVH, HD), ``pos`` the token's absolute position.

    With a ``window`` the cache is a ring: the token goes to slot
    ``pos % S_max``, slots up to it are live, and every slot is once the ring
    has wrapped (``pos >= S_max``).  Without one it is linear: the token goes
    to slot ``pos`` (which must be inside the cache) and slots ``<= pos`` are
    live.  ``rope=False`` for absolute positions.  Returns ((B, 1, E), cache)
    with the cache updated in place."""
    q, k_new, v_new = _project_qkv(cfg, p, x)
    if rope:
        pos_t = torch.arange(pos, pos + 1, device=x.device)   # made on the card: no host wait
        q = apply_rope(q, pos_t, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_t, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[1]
    ring = window is not None
    if not ring and pos >= s_max:
        raise ValueError(f"position {pos} is past the linear cache's {s_max} slots")
    slot = pos % s_max if ring else pos
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    valid = torch.arange(s_max, device=x.device) <= slot
    if ring and pos >= s_max:
        valid = torch.ones_like(valid)
    return _attend(cfg, p, q, k_cache, v_cache, valid), cache


def cross_decode_attention(cfg: ModelConfig, p, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over a fixed cache of encoder keys and
    values, k/v (B, F, KVH, HD), every row live: x (B, 1, E) -> (B, 1, E).
    The reference's oracle math (fp32 scores, no mask), as a plain einsum."""
    return _attend(cfg, p, _project_q(cfg, p, x), k, v)
