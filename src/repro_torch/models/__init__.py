"""Model facade of the port: one API over the archs it runs
(``configs.PORTED_ARCH_IDS``): the decoder-only recurrentgemma-2b,
mamba2-780m, the global-attention decoders qwen2.5-14b, codeqwen1.5-7b and
qwen1.5-32b, the MoE decoders granite-moe-1b-a400m and mixtral-8x7b, the
vision-language internvl2-26b, and the encoder-decoder whisper-medium.

``batch`` dicts carry ``tokens (B, S)``, and ``frames (B, F, E)`` for the
audio encoder-decoder or ``vis_embeds (B, Nv, E)`` for the vision-language
model (their frontends are stubs, as in the reference).  Parameters live in
a :class:`~repro_torch.models.decoder.Decoder` module, or an
:class:`~repro_torch.models.encdec.EncDec` where ``cfg.encoder_layers`` is
set; every entry point takes an explicit device, ``"cuda"`` by default
(which raises without a GPU).

``rules`` (``repro_torch.sharding``) shard a model over a ``DeviceMesh``:
:func:`distribute_params` makes each parameter a DTensor placed by its
logical axes (the reference's ``in_shardings``), and the entry points
constrain the activations at the reference's sites.
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..sharding.partitioning import active
from . import blocks, common
from .attention import attention, decode_attention
from .common import DefModule, ParamDef, init_params_, param_defs, placements, spec_tree
from .decoder import (Decoder, cache_defs, cross_entropy_loss, decode_step,
                      default_scan_group, forward, init_cache)
from .encdec import (EncDec, encdec_cache_defs, encdec_decode_step, encdec_forward,
                     encdec_init_cache)

__all__ = [
    "ParamDef", "Decoder", "EncDec", "init_params_", "param_defs", "spec_tree",
    "distribute_params", "shard_grads",
    "arch_init_params", "arch_forward", "arch_cache_defs", "arch_init_cache",
    "arch_decode_step", "attention", "decode_attention", "blocks", "common",
    "cross_entropy_loss", "default_scan_group",
]


def arch_init_params(cfg: ModelConfig, generator: torch.Generator, *,
                     device: str | torch.device = "cuda",
                     master: bool = False) -> Decoder | EncDec:
    """The arch's model on ``device`` (an :class:`EncDec` where the config
    has an encoder, else a :class:`Decoder`) with random parameters drawn
    from ``generator`` (which must live on ``device``); ``master=True`` for
    training (fp32 masters that require gradients)."""
    if cfg.encoder_layers:
        return init_params_(EncDec(cfg, device=device, master=master), generator)
    return init_params_(Decoder(cfg, device=device, master=master), generator)


def distribute_params(model: torch.nn.Module, mesh, rules) -> torch.nn.Module:
    """Place every parameter of ``model`` on ``mesh`` as a DTensor by its
    logical axes through ``rules.params`` (each rank keeps its shard; the
    full value is read from every rank's copy).  In place; returns
    ``model``."""
    from torch.distributed.tensor import distribute_tensor

    for mod in model.modules():
        if isinstance(mod, DefModule):
            for name, d in mod.defs.items():
                p = mod.master(name)
                pl = placements(spec_tree(d, rules.params), mesh)
                mod._parameters[name] = shard_grads(torch.nn.Parameter(
                    distribute_tensor(p.detach(), mesh, pl), requires_grad=p.requires_grad))
    return model


def shard_grads(p: torch.nn.Parameter) -> torch.nn.Parameter:
    """Have each gradient of the DTensor parameter ``p`` brought to ``p``'s
    placements as it is produced (a partial sum reduce-scattered, FSDP's
    way), so no rank holds a gathered gradient until the update.  Returns
    ``p``."""
    if p.requires_grad:
        p.register_hook(lambda g: g if tuple(g.placements) == tuple(p.placements)
                        else g.redistribute(p.device_mesh, p.placements))
    return p


def arch_forward(cfg: ModelConfig, model, batch: dict[str, Any], *, rules=None,
                 scan_group: int | None = None, remat_policy=None) -> torch.Tensor:
    with active(rules):
        if cfg.encoder_layers:
            return encdec_forward(cfg, model, batch["tokens"], batch["frames"], rules=rules)
        return forward(cfg, model, batch["tokens"], vis_embeds=batch.get("vis_embeds"),
                       scan_group=scan_group, remat_policy=remat_policy, rules=rules)


def arch_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    if cfg.encoder_layers:
        return encdec_cache_defs(cfg, batch, max_len)
    return cache_defs(cfg, batch, max_len)


def arch_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device: str | torch.device = "cuda") -> list[dict]:
    if cfg.encoder_layers:
        return encdec_init_cache(cfg, batch, max_len, resolve_device(device))
    return init_cache(cfg, batch, max_len, resolve_device(device))


def arch_decode_step(cfg: ModelConfig, model, cache: list, tokens: torch.Tensor, pos: int, *,
                     rules=None):
    with active(rules):
        if cfg.encoder_layers:
            return encdec_decode_step(cfg, model, cache, tokens, pos, rules=rules)
        return decode_step(cfg, model, cache, tokens, pos, rules=rules)
