"""The plain float32 reference of the benchmark's decoder LMs.

Written from the published architecture (Llama-style blocks: RMSNorm, RoPE on
halves, grouped-query attention with optional q / k / v biases, a SwiGLU MLP
or a top-k MoE whose gates are a softmax over each token's top-k router
logits), with the configuration file's values as run: its ``departures``
(granite's muP multipliers and tied embedding, Qwen's RMSNorm epsilon) are
followed, since they are what the program computes.  Plain ``torch``
operations only: no kernel, cache or batching of the program, and nothing of
it imported.  Attention is computed a block of query rows at a time so that a
long prompt fits beside the program's weights; the MoE runs each expert on
the tokens routed to it.

Every product with a weight goes through a :class:`Precision`'s ``mm``, and
every tensor the program holds in its working type (bf16) through its
``store``: :data:`FP32`, the reference, multiplies in float32 (TF32 off,
:func:`exact_matmuls`) and stores as it is; :data:`FP8`, the control, is the
same computation one precision below bf16: each product's operands and each
stored tensor rounded to float8 e4m3 under a per-tensor scale, and each
gradient flowing back through them rounded to e5m2; :data:`FP8_PRODUCTS`
rounds the products' operands alone (float8 GEMMs, the rest as the
reference).  Norms, softmaxes, the router and the loss stay in float32 in
all, as the program keeps them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..harness.arch import Arch

__all__ = ["Precision", "FP32", "FP8", "FP8_PRODUCTS", "exact_matmuls", "rope_tables", "layer",
           "logits", "embed", "forward", "loss"]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _qdq(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8 type) under a per-tensor scale
    that maps its largest magnitude to the type's largest, back in fp32."""
    top = torch.finfo(dtype).max
    scale = top / t.detach().abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(torch.float32) / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _qdq(x, torch.float8_e4m3fn), _qdq(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _qdq(g, torch.float8_e5m2)
        dx = gq @ wq.transpose(-1, -2)
        dw = xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(x, w)


class _FP8Store(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _qdq(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, torch.float8_e5m2)


class Precision(NamedTuple):
    mm: Callable          # (x, w) -> x @ w
    store: Callable       # t -> t as held between operations


FP32 = Precision(matmul, lambda t: t)
FP8 = Precision(fp8_matmul, _FP8Store.apply)
FP8_PRODUCTS = Precision(fp8_matmul, lambda t: t)


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope_tables(a: Arch, length: int, device):
    """cos, sin of (length, head_dim / 2): position p, frequency
    theta ** (-i / (head_dim / 2))."""
    half = a.head_dim // 2
    freqs = 1.0 / (a.theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    ang = torch.arange(length, device=device).float()[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """x (B, S, H, D): the first half and the second half of each head
    rotated as pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, scale: float, block: int):
    """Causal attention, q (B, S, H, D), k / v (B, S, KVH, D); query head h
    reads kv head h // (H / KVH).  A block of query rows at a time, over the
    keys up to its last row."""
    s, h = q.shape[1], q.shape[2]
    group = h // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    out = []
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1], k[:, :r1]) * scale
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v[:, :r1]))
    return torch.cat(out, dim=1)


def _moe(a: Arch, p: dict, h, prec: Precision):
    """Top-k routing on fp32 router logits, gates a softmax over the top-k
    logits; each expert runs on its own tokens."""
    b, s, d = h.shape
    flat = h.reshape(-1, d)
    top_v, top_i = (flat @ p["router"]).topk(a.top_k, dim=-1)
    gate = torch.softmax(top_v, dim=-1)
    mm, st = prec
    rows, ys = [], []
    for e in range(a.experts):
        r, slot = (top_i == e).nonzero(as_tuple=True)
        if r.numel() == 0:
            continue
        xe = flat[r]
        hid = st(F.silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]))
        rows.append(r)
        ys.append(st(mm(hid, p["w_down"][e])) * gate[r, slot][:, None])
    out = torch.zeros_like(flat).index_add(0, torch.cat(rows), torch.cat(ys))
    return st(out.view(b, s, d))


def layer(a: Arch, p: dict, x, cos, sin, prec: Precision = FP32, block: int = 1024):
    """One layer over x (B, S, d): attention then the MLP or MoE, each added
    to the residual times ``residual_multiplier``."""
    b, s, _ = x.shape
    mm, st = prec
    h = st(rms_norm(x, p["attn_norm"], a.eps))
    q, k, v = mm(h, p["wq"]), mm(h, p["wk"]), mm(h, p["wv"])
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = st(_rope(q.view(b, s, a.heads, a.head_dim), cos, sin))
    k = st(_rope(k.view(b, s, a.kv_heads, a.head_dim), cos, sin))
    v = st(v.view(b, s, a.kv_heads, a.head_dim))
    o = st(_attention(q, k, v, a.attn_scale, block).reshape(b, s, -1))
    x = st(x + a.res_mult * mm(o, p["wo"]))
    h = st(rms_norm(x, p["mlp_norm"], a.eps))
    if a.experts:
        y = _moe(a, p, h, prec)
    else:
        y = mm(st(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"])), p["w_down"])
    return st(x + a.res_mult * y)


def embed(a: Arch, table, tokens, prec: Precision = FP32):
    return prec.store(table[tokens].float() * a.emb_mult)


def logits(a: Arch, top: dict, x, prec: Precision = FP32):
    """The final norm, then the head (the embedding's transpose if tied),
    divided by ``logits_scaling``."""
    head = top["embed"].transpose(0, 1) if a.tied else top["lm_head"]
    return prec.store(prec.mm(prec.store(rms_norm(x, top["final_norm"], a.eps)), head)
                      / a.logit_div)


def forward(a: Arch, params: dict, tokens, prec: Precision = FP32, remat: bool = True,
            block: int = 1024):
    """Logits (B, S, vocab) over ``params`` (``"embed"``, ``"layers.{i}.wq"``,
    ...), each layer in a recompute region when ``remat`` (so only the
    residual between layers is held for the backward)."""
    x = embed(a, params["embed"], tokens, prec)
    cos, sin = rope_tables(a, tokens.shape[1], tokens.device)
    for i in range(a.n_layers):
        p = {k.split(".", 2)[2]: v for k, v in params.items() if k.startswith(f"layers.{i}.")}

        def run(xc, p=p):
            return layer(a, p, xc, cos, sin, prec, block)

        x = (torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
             if remat and torch.is_grad_enabled() else run(x))
    return logits(a, params, x, prec)


def loss(logits_, labels, z_loss: float):
    """Mean next-token cross-entropy over the labels that are not -1, plus
    ``z_loss * logsumexp ** 2`` per token."""
    lf = logits_.reshape(-1, logits_.shape[-1])
    lb = labels.reshape(-1)
    lz = torch.logsumexp(lf, dim=-1)
    nll = lz - lf.gather(1, lb.clamp_min(0)[:, None])[:, 0] + z_loss * lz * lz
    mask = (lb >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
