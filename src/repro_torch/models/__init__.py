"""Model facade of the port: one API over the decoder-only archs it runs
(recurrentgemma-2b, mamba2-780m and the global-attention decoders
qwen2.5-14b, codeqwen1.5-7b and qwen1.5-32b: ``configs.PORTED_ARCH_IDS``).

``batch`` dicts carry ``tokens (B, S)``.  Parameters live in a
:class:`~repro_torch.models.decoder.Decoder` module; every entry point takes
an explicit device, ``"cuda"`` by default (which raises without a GPU).
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import blocks, common
from .attention import attention, decode_attention
from .common import ParamDef, init_params_
from .decoder import (Decoder, cache_defs, cross_entropy_loss, decode_step,
                      default_scan_group, forward, init_cache)

__all__ = [
    "ParamDef", "Decoder", "init_params_",
    "arch_init_params", "arch_forward", "arch_cache_defs", "arch_init_cache",
    "arch_decode_step", "attention", "decode_attention", "blocks", "common",
    "cross_entropy_loss", "default_scan_group",
]


def arch_init_params(cfg: ModelConfig, generator: torch.Generator, *,
                     device: str | torch.device = "cuda", master: bool = False) -> Decoder:
    """A :class:`Decoder` on ``device`` with random parameters drawn from
    ``generator`` (which must live on ``device``); ``master=True`` for
    training (fp32 masters that require gradients)."""
    return init_params_(Decoder(cfg, device=device, master=master), generator)


def arch_forward(cfg: ModelConfig, model: Decoder, batch: dict[str, Any], *,
                 scan_group: int | None = None, remat_policy=None) -> torch.Tensor:
    return forward(cfg, model, batch["tokens"], scan_group=scan_group,
                   remat_policy=remat_policy)


def arch_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    return cache_defs(cfg, batch, max_len)


def arch_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device: str | torch.device = "cuda") -> list[dict]:
    return init_cache(cfg, batch, max_len, resolve_device(device))


def arch_decode_step(cfg: ModelConfig, model: Decoder, cache: list, tokens: torch.Tensor,
                     pos: int):
    return decode_step(cfg, model, cache, tokens, pos)
