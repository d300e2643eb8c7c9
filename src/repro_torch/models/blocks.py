"""Non-attention blocks of the port: the dense MLP (GLU or not, with or
without biases), the top-k routed MoE, the RG-LRU recurrent block (Griffin /
RecurrentGemma) and the Mamba-2 SSD block, the last two with their decode
state."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import ParamDef, activation, gelu_tanh, recompute, tag

__all__ = [
    "mlp_defs", "mlp",
    "moe_defs", "moe_route", "moe",
    "rec_defs", "rec_block", "rec_decode", "rec_cache_defs",
    "ssm_defs", "ssm_block", "ssm_decode", "ssm_cache_defs",
]


def mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"wi": ParamDef((d, f))}
    if cfg.glu:
        defs["wg"] = ParamDef((d, f))
    defs["wo"] = ParamDef((f, d))
    if cfg.mlp_bias:
        defs["bi"] = ParamDef((f,), init="zeros")
        defs["bo"] = ParamDef((d,), init="zeros")
    return defs


def _hidden(act, g: torch.Tensor | None, u: torch.Tensor) -> torch.Tensor:
    """act(g) * u for a GLU, else act(u); in a recompute region when training."""
    if g is None:
        return recompute(act, u)
    return recompute(lambda a, b: act(a) * b, g, u)


def mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The dense MLP: act(x wg) * (x wi + bi) for a GLU, else act(x wi + bi),
    then wo (+ bo); the biases where the config has them."""
    act = activation(cfg.act)
    g = x @ p.wg if cfg.glu else None
    u = x @ p.wi
    if cfg.mlp_bias:
        u = u + p.bi
    y = tag(_hidden(act, g, u), "mlp_hidden") @ p.wo
    return y + p.bo if cfg.mlp_bias else y


def moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    # the router stays fp32: the reference routes in fp32 from its fp32 master
    defs = {"router": ParamDef((d, e), scale=0.02, fp32=True),
            "wi": ParamDef((e, d, f)), "wo": ParamDef((e, f, d))}
    if cfg.glu:
        defs["wg"] = ParamDef((e, d, f))
    return defs


def moe_route(cfg: ModelConfig, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 router logits (B, S, E) and each token's top ``top_k``
    expert ids (B, S, k), the largest logit first."""
    logits = x.float() @ p.router
    return logits, torch.topk(logits, cfg.top_k, dim=-1).indices


def moe(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed MoE with the reference's dense dispatch: fp32 router
    logits, a softmax over each token's top ``top_k``, and every expert run
    on every token, its output weighted by the token's routing mass for it
    (zero outside the top k).  Equal in value to a sparse dispatch."""
    act = activation(cfg.act)
    logits, top_i = moe_route(cfg, p, x)
    gate = torch.softmax(logits.gather(-1, top_i), dim=-1)
    comb = torch.zeros_like(logits).scatter_(-1, top_i, gate)
    g = torch.einsum("bse,xef->bsxf", x, p.wg) if cfg.glu else None
    u = torch.einsum("bse,xef->bsxf", x, p.wi)
    h = tag(_hidden(act, g, u), "moe_hidden")                  # (B, S, E, F)
    y = torch.einsum("bsxf,xfd->bsxd", h, p.wo)
    return torch.einsum("bsxd,bsx->bsd", y, comb.to(x.dtype))


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
    y, h_last = ops.rglru_scan(u, p.a_param, ig, ag, None if state is None else state["h"],
                               name="rec_out")
    out = (tag(y, "rec_out") * gate) @ p.wo
    return out, (None if state is None else {"h": h_last, "conv": new_conv})


def rec_cache_defs(cfg: ModelConfig, batch: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    w = cfg.lru_width or cfg.d_model
    return {"h": ((batch, w), True), "conv": ((batch, cfg.conv1d_width - 1, w), False)}


def rec_decode(cfg: ModelConfig, p, x: torch.Tensor, state: dict):
    """One token: the full block at T = 1, conv state included."""
    return rec_block(cfg, p, x, state)


def ssm_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "wz": ParamDef((d, di)),
        "wx": ParamDef((d, di)),
        "wB": ParamDef((d, g * n)),
        "wC": ParamDef((d, g * n)),
        "wdt": ParamDef((d, nh), scale=0.02),
        "dt_bias": ParamDef((nh,), init="zeros", fp32=True),
        "a_log": ParamDef((nh,), init="small", fp32=True),
        "d_skip": ParamDef((nh,), init="ones", fp32=True),
        "conv_w": ParamDef((cfg.conv1d_width, conv_ch), scale=0.1),
        "conv_b": ParamDef((conv_ch,), init="zeros"),
        "norm_w": ParamDef((di,), init="ones", fp32=True),
        "wo": ParamDef((di, d)),
    }


def ssm_block(cfg: ModelConfig, p, x: torch.Tensor, state: dict | None = None):
    """Mamba-2 block: in-projections (z, x, B, C, dt) -> causal conv + SiLU
    over (x, B, C) -> SSD -> gated RMSNorm with z -> out-projection.  With
    ``state`` ({"h": (B, H, P, N) fp32, "conv": (B, CW-1, conv_ch)}) also
    returns the next state."""
    b, t, _ = x.shape
    di, g, n, nh, hp = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z = x @ p.wz
    xbc = torch.cat([x @ p.wx, x @ p.wB, x @ p.wC], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus((x @ p.wdt).float() + p.dt_bias)
    y, h_last = ops.ssd_chunked(xin.reshape(b, t, nh, hp), dt, p.a_log,
                                bmat.reshape(b, t, g, n), cmat.reshape(b, t, g, n), p.d_skip,
                                None if state is None else state["h"], name="ssm_out")
    # gated RMSNorm (mamba2), in fp32
    yf = tag(y.reshape(b, t, di), "ssm_out").float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6) * p.norm_w
    out = yf.to(x.dtype) @ p.wo
    return out, (None if state is None else {"h": h_last, "conv": new_conv})


def ssm_cache_defs(cfg: ModelConfig, batch: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"h": ((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), True),
            "conv": ((batch, cfg.conv1d_width - 1, conv_ch), False)}


def ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, state: dict):
    """One token: the full block at T = 1, conv state included."""
    return ssm_block(cfg, p, x, state)
