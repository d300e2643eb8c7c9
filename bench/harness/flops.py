"""The yardstick: the chip's peaks, and the operations and bytes of the
model's steps and of the attention kernels, from shapes alone.

Frozen copies of ``chip_smoke.py``'s ``flash_pairs``, ``flash_bound``,
``flash_bwd_bound`` and ``train_model_flops`` (with the port's parameter
count, ``ModelConfig.param_count``, written out here), so that no change to
the program moves the yardstick.  ``train_model_flops``'s SSD term (at the
port's ``kernels.ssd.CHUNK``) is left out with the SSM layers themselves,
which no configuration here has (``arch.arch_of`` refuses them).
"""
from __future__ import annotations

import numpy as np

from .arch import Arch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def flash_pairs(sq: int, skv: int, causal: bool, window: int | None = None,
                q_offset: int = 0) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work this call needs."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _bound(ops: float, nbytes: float, dtype: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return {"operations": ops, "bytes": nbytes, "seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_bound(b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool,
                dtype: str, window: int | None = None, with_lse: bool = False) -> dict:
    """Least time for attention's forward: q, k, v read and the output (and
    the log-sum-exp) written once over the memory rate, against 4 D
    operations per unmasked pair (2 D for q.k, 2 D for p.v) at the peak rate
    of the input type."""
    e = _BYTES[dtype]
    pairs = flash_pairs(sq, skv, causal, window) * b * h
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kvh * d) * e + (b * sq * h * 4 if with_lse else 0)
    return _bound(4 * d * pairs, nbytes, dtype)


def flash_bwd_bound(b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool,
                    dtype: str, window: int | None = None) -> dict:
    """Least time for attention's backward: q, k, v, out and dO read and dq,
    dk, dv written once (the log-sum-exp read, fp32) over the memory rate,
    against 10 D operations per unmasked pair (the scores again, dP, dV, dK
    and dQ, 2 D each) at the peak rate of the input type."""
    e = _BYTES[dtype]
    pairs = flash_pairs(sq, skv, causal, window) * b * h
    q_el, kv_el = b * sq * h * d, b * skv * kvh * d
    nbytes = (4 * q_el + 2 * 2 * kv_el) * e + b * sq * h * 4
    return _bound(10 * d * pairs, nbytes, dtype)


def param_count(a: Arch) -> int:
    """Parameters as the port counts them (``ModelConfig.param_count``): the
    padded vocabulary's embedding (and head, untied), each layer's
    projections, biases, MLP or experts and router, and two norms a layer."""
    d, v, hd = a.d, a.padded_vocab, a.head_dim
    total = v * d * (1 if a.tied else 2)
    per = d * hd * (a.heads + 2 * a.kv_heads) + a.heads * hd * d + 2 * d
    if a.qkv_bias:
        per += hd * (a.heads + 2 * a.kv_heads)
    per += a.experts * 3 * d * a.ff + d * a.experts if a.experts else 3 * d * a.ff
    return total + a.n_layers * per


def active_param_count(a: Arch) -> int:
    """A MoE's parameters touched per token: ``top_k`` of its experts."""
    if not a.experts:
        return param_count(a)
    return param_count(a) - a.n_layers * (a.experts - a.top_k) * 3 * a.d * a.ff


def _attn_ops(a: Arch, batch: int, seq: int) -> int:
    """4 D operations per visible pair, per head and layer (q.k and p.v)."""
    return 4 * a.head_dim * a.heads * batch * a.n_layers * flash_pairs(seq, seq, True)


def train_model_flops(a: Arch, batch: int, seq: int) -> int:
    """Model FLOPs of one training step of ``batch`` x ``seq`` tokens: 6 per
    active parameter per token (the embedding tables counted, as 6 N counts
    them), plus attention's scores, x3 for the backward.  A MoE's dense
    dispatch, which runs every expert, is credited with its top-k only."""
    return 6 * active_param_count(a) * batch * seq + 3 * _attn_ops(a, batch, seq)


def prefill_model_flops(a: Arch, prompt: int) -> int:
    """Model FLOPs of one prompt's prefill: 2 per non-embedding active
    parameter per token, plus attention's scores."""
    emb = a.padded_vocab * a.d * (1 if a.tied else 2)
    return 2 * (active_param_count(a) - emb) * prompt + _attn_ops(a, 1, prompt)
