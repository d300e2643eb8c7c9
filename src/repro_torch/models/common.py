"""Shared model machinery of the port: parameter definitions and their
initialisation from a ``torch.Generator``, norms, RoPE, activations.

A module lists its parameters as :class:`ParamDef`s (shape, initialiser,
whether the value stays fp32) and :class:`DefModule` registers them.  Matmul
weights, embeddings and biases are held in the working type, cast once when
they are set: the reference keeps fp32 masters and casts at every use, which
gives the same values.  Norm weights and ``a_param`` stay fp32, as the
reference reads them in fp32.  Serving needs no gradients, so the parameters
do not require them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ParamDef",
    "DefModule",
    "init_params_",
    "rms_norm",
    "rope_table",
    "apply_rope",
    "activation",
    "gelu_tanh",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | small
    scale: float | None = None      # overrides fan-in scaling
    fp32: bool = False              # kept in fp32 whatever the working type


class DefModule(nn.Module):
    """A module whose parameters are given by ``defs()`` (name -> ParamDef)."""

    def __init__(self, defs: dict[str, ParamDef], dtype: torch.dtype, device):
        super().__init__()
        self.defs = defs
        for name, d in defs.items():
            dt = torch.float32 if d.fp32 else dtype
            self.register_parameter(
                name, nn.Parameter(torch.empty(d.shape, dtype=dt, device=device),
                                   requires_grad=False))


def _draw(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    z = torch.randn(d.shape, generator=gen, device=device, dtype=torch.float32)
    if d.init == "small":
        return 0.1 * z
    fan_in = d.shape[0] if len(d.shape) > 1 else max(1, d.shape[-1])
    return (d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)) * z


@torch.no_grad()
def init_params_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every :class:`DefModule` parameter of ``model`` in fp32 from
    ``gen`` (whose device must be the parameters'), in module order, and store
    it in the parameter's type."""
    for mod in model.modules():
        if isinstance(mod, DefModule):
            for name, d in mod.defs.items():
                p = getattr(mod, name)
                p.copy_(_draw(d, gen, p.device))
    return model


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * weight.float()).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) absolute token positions."""
    d = x.shape[-1]
    cos, sin = rope_table(positions, d, theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's GELU everywhere is the tanh form."""
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": gelu_tanh, "relu": F.relu}[name]
