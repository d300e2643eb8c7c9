"""Non-attention blocks of the port: the dense MLP (GLU or not, with or
without biases), the top-k routed MoE, the RG-LRU recurrent block (Griffin /
RecurrentGemma) and the Mamba-2 SSD block, the last two with their decode
state.

Each takes ``rules`` and constrains its activations to their logical axes
at the reference's sites (``sharding.shard``).  With DTensor activations K3
and K4 run channel-parallel on each rank's ``lru`` / ``ssm_inner`` shard
(``local_map``): the scans are exact per channel, and recurrent archs never
shard the sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tracing
from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.fake import is_fake
from ..sharding import shard, shard_map
from ..sharding.partitioning import (group_slice, is_dtensor, like, local_start, matmul,
                                      on_rows, placements_of, split_grad)
from .common import CacheDef, ParamDef, activation, gelu_tanh, recompute, tag

__all__ = [
    "mlp_defs", "mlp",
    "moe_defs", "moe_route", "moe_branch", "sparse_experts", "moe",
    "rec_defs", "rec_block", "rec_decode", "rec_cache_defs",
    "ssm_defs", "ssm_block", "ssm_decode", "ssm_cache_defs",
]


def mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"wi": ParamDef((d, f), ("embed", "ff"))}
    if cfg.glu:
        defs["wg"] = ParamDef((d, f), ("embed", "ff"))
    defs["wo"] = ParamDef((f, d), ("ff", "embed"))
    if cfg.mlp_bias:
        defs["bi"] = ParamDef((f,), ("ff",), init="zeros")
        defs["bo"] = ParamDef((d,), ("embed",), init="zeros")
    return defs


def _hidden(act, g: torch.Tensor | None, u: torch.Tensor) -> torch.Tensor:
    """act(g) * u for a GLU, else act(u); in a recompute region when training."""
    if g is None:
        return recompute(act, u)
    return recompute(lambda a, b: act(a) * b, g, u)


def mlp(cfg: ModelConfig, p, x: torch.Tensor, rules=None) -> torch.Tensor:
    """The dense MLP: act(x wg) * (x wi + bi) for a GLU, else act(x wi + bi),
    then wo (+ bo); the biases where the config has them."""
    act = activation(cfg.act)
    g = matmul(x, p.wg) if cfg.glu else None
    u = matmul(x, p.wi)
    if cfg.mlp_bias:
        u = u + p.bi
    h = tag(shard(_hidden(act, g, u), ("batch", "seq", "ff"), rules), "mlp_hidden")
    y = matmul(h, p.wo)
    return shard(y + p.bo if cfg.mlp_bias else y, ("batch", "seq", "embed"), rules)


def moe_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    # the router stays fp32: the reference routes in fp32 from its fp32 master
    defs = {"router": ParamDef((d, e), ("embed", "experts"), scale=0.02, fp32=True),
            "wi": ParamDef((e, d, f), ("experts", "embed", "ff")),
            "wo": ParamDef((e, f, d), ("experts", "ff", "embed"))}
    if cfg.glu:
        defs["wg"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
    return defs


def moe_route(cfg: ModelConfig, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 router logits (B, S, E) and each token's top ``top_k``
    expert ids (B, S, k), the largest logit first.  For a DTensor ``x`` on
    each rank's rows with the router whole (``on_rows``): DTensor would
    otherwise split the logits, or their gradient from the dispatch, along
    the sequence, which a product over the rows folds."""
    xf = x.float()
    logits = on_rows(torch.matmul, xf, p.router) if is_dtensor(xf) else xf @ p.router
    return logits, torch.topk(logits, cfg.top_k, dim=-1).indices


def _unsplit(x: torch.Tensor, *weights: torch.Tensor) -> bool:
    """Whether an einsum over ``x`` (B, S, D) and the expert ``weights``
    flattens no split dim: ``x`` plain or split on its batch dim only, and
    the weights plain or replicated."""
    if not is_dtensor(x):
        return True
    return (all(pl.is_replicate() or pl.is_shard(0) for pl in x.placements)
            and all(pl.is_replicate() for w in weights for pl in w.placements))


def sparse_experts(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s experts are the ones the sparse dispatch runs:
    SwiGLU (a gated MLP with SiLU)."""
    return cfg.glu and cfg.act == "silu"


def moe_branch(cfg: ModelConfig, p, x: torch.Tensor) -> str:
    """Which dispatch :func:`moe` runs on ``x``: ``"sparse"`` for a plain
    (not DTensor, not fake) CUDA bf16 tensor into SwiGLU experts, the
    kernels' route; ``"bmm"`` for a DTensor whose experts' products would
    flatten a split dim (:func:`_unsplit`); ``"dense"`` (one einsum per
    weight) for the rest: CPU tensors, other types, fake tensors, other
    experts, DTensors that flatten none."""
    if is_dtensor(x):
        weights = (p.wi, p.wo, *((p.wg,) if cfg.glu else ()))
        return "dense" if _unsplit(x, *weights) else "bmm"
    if x.is_cuda and x.dtype == torch.bfloat16 and not is_fake(x) and sparse_experts(cfg):
        return "sparse"
    return "dense"


def moe(cfg: ModelConfig, p, x: torch.Tensor, rules=None) -> torch.Tensor:
    """Top-k routed MoE: fp32 router logits, a softmax over each token's top
    ``top_k``, and each expert's output weighted by the token's routing mass
    for it.  Three dispatches of equal value (:func:`moe_branch`):

    * ``sparse`` (CUDA bf16, SwiGLU experts): the pairs sorted by expert,
      each token's rows gathered, each expert's products run on its own rows
      (the gate and up products as one), and each token's ``k`` rows combined
      (:mod:`..kernels.moe_dispatch`): ``B S k`` rows, ``(B S k, .)``
      activations, no value read back to the host.
    * ``dense`` (the reference's dense dispatch: CPU tensors, the other
      types, fake tensors, other experts, DTensors that flatten no split
      dim): every expert run on every token, zero weight outside the top k,
      one einsum per weight, each a single GEMM forward and backward.
    * ``bmm`` (DTensors otherwise): the experts as one batched product per
      weight over the tokens (``(E, N, D) @ (E, D, F) -> (E, N, F)``, N =
      B S, the tokens broadcast over the experts), so no sharded dim is
      flattened inside another (DTensor would track such a dim as a strided
      shard); its backward builds the (E, N, D) gradient of the broadcast,
      which the einsum does not.

    Under a profiler the block is the span ``repro.moe``, forward and
    backward (:mod:`..tracing`), and counts the token-expert pairs routed
    (``moe.pairs_routed``, B S k) and computed (``moe.pairs_computed``: B S k
    on the sparse dispatch, B S E on the dense ones, which run every
    expert)."""
    with tracing.span("moe") as sp:
        x = sp.grad_input(x)
        b, s, d = x.shape
        branch = moe_branch(cfg, p, x)
        tracing.count("moe.pairs_routed", b * s * cfg.top_k)
        tracing.count("moe.pairs_computed",
                      b * s * (cfg.top_k if branch == "sparse" else cfg.n_experts))
        logits, out = _moe(cfg, p, x, rules, branch)
        return sp.grad_output(out, logits)


def _moe(cfg: ModelConfig, p, x: torch.Tensor, rules=None, branch: str | None = None):
    """:func:`moe`'s body on ``branch`` (default :func:`moe_branch`'s): the
    router's logits and the block's output."""
    branch = branch or moe_branch(cfg, p, x)
    act = activation(cfg.act)
    b, s, d = x.shape
    logits, top_i = moe_route(cfg, p, x)
    gate = torch.softmax(logits.gather(-1, top_i), dim=-1)
    if branch == "sparse":
        return logits, _moe_sparse(cfg, p, x, top_i, gate, rules)
    comb = torch.zeros_like(logits).scatter(-1, top_i, gate)
    if branch == "dense":
        g = torch.einsum("bse,xef->bsxf", x, p.wg) if cfg.glu else None
        u = torch.einsum("bse,xef->bsxf", x, p.wi)
        h = tag(_hidden(act, g, u), "moe_hidden")                  # (B, S, E, F)
        y = torch.einsum("bsxf,xfd->bsxd", h, p.wo)
        return logits, shard(torch.einsum("bsxd,bsx->bsd", y, comb.to(x.dtype)),
                             ("batch", "seq", "embed"), rules)
    xn = x.reshape(b * s, d).expand(cfg.n_experts, b * s, d)
    g = torch.bmm(xn, p.wg) if cfg.glu else None
    u = torch.bmm(xn, p.wi)
    h = tag(shard(_hidden(act, g, u), ("experts", "batch", "ff"), rules),
            "moe_hidden")                                          # (E, N, F)
    y = torch.bmm(h, p.wo)                                         # (E, N, D)
    out = torch.einsum("xnd,nx->nd", y, comb.to(x.dtype).reshape(b * s, -1))
    return logits, shard(out.reshape(b, s, d), ("batch", "seq", "embed"), rules)


def _moe_sparse(cfg: ModelConfig, p, x: torch.Tensor, top_i: torch.Tensor,
                gate: torch.Tensor, rules=None) -> torch.Tensor:
    """The sparse dispatch of :func:`moe` (SwiGLU experts) on ``x (B, S,
    D)``, its top-k ids and fp32 gates ``(B, S, k)``: the gate and up
    products as one (``[wg | wi]``, the weights read where they are), SwiGLU
    as one op.  The ops route by device, so on the CPU it runs their plain
    versions."""
    if not sparse_experts(cfg):
        raise ValueError(f"the sparse dispatch runs SwiGLU experts, not {cfg.act} "
                         f"(glu={cfg.glu})")
    b, s, d = x.shape
    order = ops.moe_order(top_i.reshape(b * s, cfg.top_k), cfg.n_experts)
    xs = ops.moe_permute(x.reshape(b * s, d), order)                # (N k, D)
    gu = ops.grouped_mm(xs, p.wg, order.offsets, p.wi)              # (N k, 2F)
    h = tag(ops.moe_swiglu(gu), "moe_hidden")                      # (N k, F)
    y = ops.grouped_mm(h, p.wo, order.offsets)                     # (N k, D)
    out = ops.moe_combine(y, gate.reshape(b * s, cfg.top_k), order)
    return shard(out.reshape(b, s, d), ("batch", "seq", "embed"), rules)


def rec_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width
    return {
        "wx": ParamDef((d, w), ("embed", "lru")),          # recurrent branch in
        "wy": ParamDef((d, w), ("embed", "lru")),          # gate branch in
        "conv_w": ParamDef((cw, w), ("conv", "lru"), scale=0.1),
        "conv_b": ParamDef((w,), ("lru",), init="zeros"),
        "a_param": ParamDef((w,), ("lru",), init="small", fp32=True),
        "w_input_gate": ParamDef((w, w), ("lru_in", "lru"), scale=0.02),
        "b_input_gate": ParamDef((w,), ("lru",), init="zeros"),
        "w_a_gate": ParamDef((w, w), ("lru_in", "lru"), scale=0.02),
        "b_a_gate": ParamDef((w,), ("lru",), init="zeros"),
        "wo": ParamDef((w, d), ("lru", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: (B,T,W); w: (CW,W); state: (B,CW-1,W).
    Returns (y, the last CW-1 inputs as the next state)."""
    cw, t = w.shape[0], x.shape[1]
    pad = like(torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device), x) \
        if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + t] * w[i] for i in range(cw))
    new_state = xp[:, t:].clone()       # the last CW-1 rows, not a view of xp
    return y + b.to(x.dtype), new_state


def _rglru(u, a_param, ig, ag, h0, rules):
    """K3; for DTensors, channel-parallel on each rank's ``lru`` shard (a
    plain ``h0``, a prefill's zero state, is split as the rules place it)."""
    if not is_dtensor(u):
        return ops.rglru_scan(u, a_param, ig, ag, h0, name="rec_out")
    mesh = u.device_mesh
    seq, chan, row = (placements_of(a, rules, mesh) for a in
                      (("batch", None, "lru"), ("lru",), ("batch", "lru")))
    specs = (seq, chan, seq, seq, None if h0 is None else row)
    return shard_map(lambda *t: ops.rglru_scan(*t, name="rec_out"), mesh=mesh, in_specs=specs,
                     out_specs=[seq, row],
                     in_grad_specs=tuple(None if sp is None else split_grad(sp, seq)
                                         for sp in specs))(u, a_param, ig, ag,
                                                           None if h0 is None else like(h0, u))


def rec_block(cfg: ModelConfig, p, x: torch.Tensor, rules=None, state: dict | None = None):
    """Griffin recurrent block: (linear -> GeLU gate) * (linear -> conv ->
    RG-LRU) -> out.  With ``state`` ({"h": (B, W) fp32, "conv": (B, CW-1, W)})
    also returns the next state."""
    gate = gelu_tanh(matmul(x, p.wy))
    u = shard(matmul(x, p.wx), ("batch", "seq", "lru"), rules)
    u, new_conv = _causal_conv(u, p.conv_w, p.conv_b, None if state is None else state["conv"])
    ig = torch.sigmoid(matmul(u, p.w_input_gate) + p.b_input_gate)
    ag = torch.sigmoid(matmul(u, p.w_a_gate) + p.b_a_gate)
    y, h_last = _rglru(u, p.a_param, ig, ag, None if state is None else state["h"], rules)
    out = shard(matmul(tag(y, "rec_out") * gate, p.wo), ("batch", "seq", "embed"), rules)
    return out, (None if state is None else {"h": h_last, "conv": new_conv})


def rec_cache_defs(cfg: ModelConfig, batch: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    w = cfg.lru_width or cfg.d_model
    return {"h": CacheDef((batch, w), True, ("batch", "lru")),
            "conv": CacheDef((batch, cfg.conv1d_width - 1, w), False, ("batch", None, "lru"))}


def rec_decode(cfg: ModelConfig, p, x: torch.Tensor, state: dict, rules=None):
    """One token: the full block at T = 1, conv state included."""
    return rec_block(cfg, p, x, rules, state)


def ssm_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "wz": ParamDef((d, di), ("embed", "ssm_inner")),
        "wx": ParamDef((d, di), ("embed", "ssm_inner")),
        "wB": ParamDef((d, g * n), ("embed", None)),
        "wC": ParamDef((d, g * n), ("embed", None)),
        "wdt": ParamDef((d, nh), ("embed", None), scale=0.02),
        "dt_bias": ParamDef((nh,), (None,), init="zeros", fp32=True),
        "a_log": ParamDef((nh,), (None,), init="small", fp32=True),
        "d_skip": ParamDef((nh,), (None,), init="ones", fp32=True),
        "conv_w": ParamDef((cfg.conv1d_width, conv_ch), ("conv", None), scale=0.1),
        "conv_b": ParamDef((conv_ch,), (None,), init="zeros"),
        "norm_w": ParamDef((di,), ("ssm_inner",), init="ones", fp32=True),
        "wo": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _ssd(x, dt, a_log, b_mat, c_mat, d_skip, h0, rules):
    """K4; for DTensors, head-parallel on each rank's ``ssm_inner`` shard (a
    rank's heads read the B / C groups of their heads, whose gradients are
    then partial sums; a plain ``h0`` is split as the rules place it)."""
    if not is_dtensor(x):
        return ops.ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, h0, name="ssm_out")
    mesh = x.device_mesh
    hx, hdt, head, grp, hh = (placements_of(a, rules, mesh) for a in (
        ("batch", None, "ssm_inner", None), ("batch", None, "ssm_inner"), ("ssm_inner",),
        ("batch", None, None, None), ("batch", "ssm_inner", None, None)))
    nh, ng = x.shape[2], b_mat.shape[2]

    def local(x_, dt_, a_, b_, c_, d_, h_):
        if x_.shape[2] != nh:
            groups = group_slice(x_.shape[2], local_start(mesh, hx, 2, nh), nh, ng)
            b_, c_ = b_[:, :, groups], c_[:, :, groups]
        return ops.ssd_chunked(x_, dt_, a_, b_, c_, d_, h_, name="ssm_out")

    specs = (hx, hdt, head, grp, grp, None if d_skip is None else head,
             None if h0 is None else hh)
    grads = tuple(None if sp is None else split_grad(sp, hx) for sp in specs)
    return shard_map(local, mesh=mesh, in_specs=specs, out_specs=[hx, hh],
                     in_grad_specs=grads)(x, dt, a_log, b_mat, c_mat, d_skip,
                                          None if h0 is None else like(h0, x))


def ssm_block(cfg: ModelConfig, p, x: torch.Tensor, rules=None, state: dict | None = None):
    """Mamba-2 block: in-projections (z, x, B, C, dt) -> causal conv + SiLU
    over (x, B, C) -> SSD -> gated RMSNorm with z -> out-projection.  With
    ``state`` ({"h": (B, H, P, N) fp32, "conv": (B, CW-1, conv_ch)}) also
    returns the next state."""
    b, t, _ = x.shape
    di, g, n, nh, hp = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z = matmul(x, p.wz)
    xbc = torch.cat([matmul(x, p.wx), matmul(x, p.wB), matmul(x, p.wC)], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(matmul(x, p.wdt).float() + p.dt_bias)
    y, h_last = _ssd(xin.reshape(b, t, nh, hp), dt, p.a_log, bmat.reshape(b, t, g, n),
                     cmat.reshape(b, t, g, n), p.d_skip, None if state is None else state["h"],
                     rules)
    # gated RMSNorm (mamba2), in fp32
    yf = tag(y.reshape(b, t, di), "ssm_out").float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6) * p.norm_w
    out = shard(matmul(yf.to(x.dtype), p.wo), ("batch", "seq", "embed"), rules)
    return out, (None if state is None else {"h": h_last, "conv": new_conv})


def ssm_cache_defs(cfg: ModelConfig, batch: int):
    """Shapes and whether the entry is fp32 (else the working type)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"h": CacheDef((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), True,
                          ("batch", None, None, "state")),
            "conv": CacheDef((batch, cfg.conv1d_width - 1, conv_ch), False,
                             ("batch", None, None))}


def ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, state: dict, rules=None):
    """One token: the full block at T = 1, conv state included."""
    return ssm_block(cfg, p, x, rules, state)
