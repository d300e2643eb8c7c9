"""Non-attention blocks of the port: the dense GLU MLP and the RG-LRU
recurrent block (Griffin / RecurrentGemma) with its decode state.  MoE and
the Mamba-2 SSD block come with the slices that serve those archs."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import ParamDef, activation, gelu_tanh

__all__ = ["mlp_defs", "mlp", "rec_defs", "rec_block", "rec_decode", "rec_cache_defs"]


def mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": ParamDef((d, f)), "wg": ParamDef((d, f)), "wo": ParamDef((f, d))}


def mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """GLU MLP: act(x wg) * (x wi), then wo."""
    h = activation(cfg.act)(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


def rec_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width
    return {
        "wx": ParamDef((d, w)),                        # recurrent branch in
        "wy": ParamDef((d, w)),                        # gate branch in
        "conv_w": ParamDef((cw, w), scale=0.1),
        "conv_b": ParamDef((w,), init="zeros"),
        "a_param": ParamDef((w,), init="small", fp32=True),
        "w_input_gate": ParamDef((w, w), scale=0.02),
        "b_input_gate": ParamDef((w,), init="zeros"),
        "w_a_gate": ParamDef((w, w), scale=0.02),
        "b_a_gate": ParamDef((w,), init="zeros"),
        "wo": ParamDef((w, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: (B,T,W); w: (CW,W); state: (B,CW-1,W).
    Returns (y, the last CW-1 inputs as the next state)."""
    cw, t = w.shape[0], x.shape[1]
    pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device) \
        if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + t] * w[i] for i in range(cw))
    new_state = xp[:, t:].clone()       # the last CW-1 rows, not a view of xp
    return y + b.to(x.dtype), new_state


def rec_block(cfg: ModelConfig, p, x: torch.Tensor, state: dict | None = None):
    """Griffin recurrent block: (linear -> GeLU gate) * (linear -> conv ->
    RG-LRU) -> out.  With ``state`` ({"h": (B, W) fp32, "conv": (B, CW-1, W)})
    also returns the next state."""
    gate = gelu_tanh(x @ p.wy)
    u = x @ p.wx
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, None if state is None else state["conv"])
    ig = torch.sigmoid(u @ p.w_input_gate + p.b_input_gate)
    ag = torch.sigmoid(u @ p.w_a_gate + p.b_a_gate)
    y, h_last = ops.rglru_scan(u, p.a_param, ig, ag, None if state is None else state["h"])
    out = (y * gate) @ p.wo
    return out, (None if state is None else {"h": h_last, "conv": new_conv})


def rec_cache_defs(cfg: ModelConfig, batch: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    w = cfg.lru_width or cfg.d_model
    return {"h": ((batch, w), True), "conv": ((batch, cfg.conv1d_width - 1, w), False)}


def rec_decode(cfg: ModelConfig, p, x: torch.Tensor, state: dict):
    """One token: the full block at T = 1, conv state included."""
    return rec_block(cfg, p, x, state)
