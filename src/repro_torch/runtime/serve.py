"""Prefill and serve step factories (the reference's ``runtime.train`` minus
training): the functions the serving launcher calls.

PyTorch runs eagerly, so a factory only fixes the config, the device and the
sampling temperature and returns a plain function.  The steps are the same
for every arch the port runs (``configs.PORTED_ARCH_IDS``): what differs is
the model's layers and their cache entries, and what the batch carries
besides ``tokens``: ``frames`` for an encoder-decoder, ``vis_embeds`` for a
vision-language model.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..models import arch_decode_step
from ..models.decoder import prefill
from ..models.encdec import encdec_prefill
from ..sharding.partitioning import active, is_dtensor

__all__ = ["make_prefill_step", "make_serve_step", "next_token"]

_NEG = -1e30


def next_token(cfg: ModelConfig, logits: torch.Tensor, temperature: float = 0.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, padded_vocab) logits -> (B,) int32 ids, never a padded-vocab id:
    argmax at temperature 0, else a draw from ``generator``.  DTensor logits
    (a sharded step) are gathered first."""
    if is_dtensor(logits):
        logits = logits.full_tensor()
    lf = logits.float()
    vocab_ids = torch.arange(lf.shape[-1], device=lf.device)
    lf = torch.where(vocab_ids[None, :] < cfg.vocab_size, lf, _NEG)
    if temperature == 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs an explicit torch.Generator")
    probs = torch.softmax(lf / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *, max_len: int | None = None,
                      device: str | torch.device = "cuda", rules=None):
    """Prefill: (model, batch) -> (last-position logits (B, V), decode cache).
    An encoder-decoder encodes ``batch["frames"]`` first; a decoder takes
    ``batch["vis_embeds"]`` where the batch has them.  With ``rules`` the
    model and the batch are DTensors on the mesh set."""
    dev = resolve_device(device)

    def prefill_step(model, batch):
        with active(rules):
            tokens = batch["tokens"].to(dev)
            if cfg.encoder_layers:
                return encdec_prefill(cfg, model, tokens, batch["frames"].to(dev),
                                      max_len=max_len, rules=rules)
            vis = batch.get("vis_embeds")
            return prefill(cfg, model, tokens, vis_embeds=None if vis is None else vis.to(dev),
                           max_len=max_len, rules=rules)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, temperature: float = 0.0,
                    device: str | torch.device = "cuda", rules=None):
    """One decode step: (model, cache, tokens (B,1), pos, generator) ->
    (next (B,1) int32, cache)."""
    dev = resolve_device(device)

    def serve_step(model, cache, tokens, pos: int, generator=None):
        logits, new_cache = arch_decode_step(cfg, model, cache, tokens.to(dev), pos,
                                             rules=rules)
        return next_token(cfg, logits, temperature, generator)[:, None], new_cache

    return serve_step
