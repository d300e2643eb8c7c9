"""The model kernels as ``torch.library`` custom ops, so that shape-only
runs can take them: a fake (shape-only) implementation for
``FakeTensorMode`` and a flop formula for ``FlopCounterMode``'s registry.

The wrappers (``flash_attention``, ``rglru_scan``, ``ssd_chunked`` and their
backwards) route a fake tensor here and nowhere else: a CUDA tensor still
launches its kernel (or raises) and a CPU tensor takes the plain version,
as before.  So a dry run (``launch.dryrun``) lowers a step through the
kernels' own shapes and counts their work, never the plain versions' (K2's
plain version would count the whole score matrix).  A real tensor never
reaches these ops (it takes its wrapper's route), and raises if it does.

Flops count what the function needs on this call's shapes, as the bounds
of ``chip_smoke.py`` do: K2 4 D per unmasked (q, k) pair and its backward
10 D; K3 a multiply and an add per element and its backward three; K4 the
chunked form at the kernel's chunk (C B^T once per group).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

__all__ = ["is_fake", "flash_pairs", "ssd_operations", "ssd_bwd_operations"]


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (a shape-only run)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def flash_pairs(sq: int, skv: int, causal: bool, window: int | None, q_offset: int) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work this call needs."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def ssd_operations(t: int, p: int, n: int, chunk: int) -> tuple[int, int]:
    """K4's chunked form over ``t`` steps of one (batch, head), as (C B^T,
    the rest): per chunk of q steps 2 q^2 N, then 2 q^2 P + 4 q N P."""
    cb = rest = 0
    for c0 in range(0, t, chunk):
        q = min(chunk, t - c0)
        cb += 2 * q * q * n
        rest += 2 * q * q * p + 4 * q * n * p
    return cb, rest


def ssd_bwd_operations(t: int, p: int, n: int, chunk: int) -> tuple[int, int]:
    """K4's backward over ``t`` steps of one (batch, head), as (C B^T, the
    rest): per chunk 2 q^2 N, then 4 q^2 P + 4 q^2 N + 12 q N P."""
    cb = rest = 0
    for c0 in range(0, t, chunk):
        q = min(chunk, t - c0)
        cb += 2 * q * q * n
        rest += 4 * q * q * p + 4 * q * q * n + 12 * q * n * p
    return cb, rest


def _real(t: Tensor) -> RuntimeError:
    return RuntimeError(f"the kernels' custom ops take fake tensors only; a {t.device} "
                        "tensor takes its wrapper's route")


def _absent(like: Tensor) -> Tensor:
    """The stand-in for an absent gradient (an op returns tensors only)."""
    return like.new_empty((0,))


# ---- K2 ---------------------------------------------------------------------
@custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int, q_offset: int,
              scale: float) -> tuple[Tensor, Tensor]:
    """(out, lse) of K2; ``window`` 0 is none."""
    raise _real(q)


@flash_fwd.register_fake
def _(q, k, v, causal, window, q_offset, scale):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, sq, h), dtype=torch.float32)


@custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, d_out: Tensor,
              causal: bool, window: int, q_offset: int,
              scale: float) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of K2; ``window`` 0 is none."""
    raise _real(q)


@flash_bwd.register_fake
def _(q, k, v, out, lse, d_out, causal, window, q_offset, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, q_offset, scale, *args,
                     **kwargs) -> int:
    b, sq, h, d = q_shape
    return 4 * d * b * h * flash_pairs(sq, k_shape[1], causal, window, q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, do_shape, causal, window,
                     q_offset, scale, *args, **kwargs) -> int:
    b, sq, h, d = q_shape
    return 10 * d * b * h * flash_pairs(sq, k_shape[1], causal, window, q_offset)


# ---- K3 ---------------------------------------------------------------------
@custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan(a: Tensor, xb: Tensor, h0: Tensor | None) -> Tensor:
    """The states y of K3's scan ``y_t = a_t y_{t-1} + xb_t`` (fp32)."""
    raise _real(a)


@rglru_scan.register_fake
def _(a, xb, h0):
    return a.new_empty(a.shape)


@custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def rglru_scan_bwd(a: Tensor, y: Tensor, h0: Tensor | None, dy: Tensor,
                   dh_last: Tensor | None) -> tuple[Tensor, Tensor, Tensor]:
    """(da, dx~, dh0) of K3's scan (fp32)."""
    raise _real(a)


@rglru_scan_bwd.register_fake
def _(a, y, h0, dy, dh_last):
    return a.new_empty(a.shape), a.new_empty(a.shape), a.new_empty((a.shape[0], a.shape[2]))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _rglru_flops(a_shape, *args, **kwargs) -> int:
    return 2 * int(np.prod(a_shape))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _rglru_bwd_flops(a_shape, *args, **kwargs) -> int:
    return 3 * int(np.prod(a_shape))


# ---- K4 ---------------------------------------------------------------------
@custom_op("repro_torch::ssd_fwd", mutates_args=())
def ssd_fwd(x: Tensor, dt: Tensor, a_log: Tensor, b_mat: Tensor, c_mat: Tensor,
            d_skip: Tensor | None, h0: Tensor | None) -> tuple[Tensor, Tensor]:
    """(y, h_last) of K4."""
    raise _real(x)


@ssd_fwd.register_fake
def _(x, dt, a_log, b_mat, c_mat, d_skip, h0):
    b, _, h, p = x.shape
    return x.new_empty(x.shape), x.new_empty((b, h, p, b_mat.shape[3]), dtype=torch.float32)


@custom_op("repro_torch::ssd_bwd", mutates_args=())
def ssd_bwd(x: Tensor, dt: Tensor, a_log: Tensor, b_mat: Tensor, c_mat: Tensor,
            d_skip: Tensor | None, h0: Tensor | None, dy: Tensor,
            dh_last: Tensor | None) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                                             Tensor]:
    """(dx, ddt, da_log, dB, dC, dd_skip, dh0) of K4, an absent input's
    gradient as an empty tensor."""
    raise _real(x)


@ssd_bwd.register_fake
def _(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last):
    f32 = torch.float32
    return (x.new_empty(x.shape), dt.new_empty(dt.shape, dtype=f32),
            a_log.new_empty(a_log.shape, dtype=f32), b_mat.new_empty(b_mat.shape),
            c_mat.new_empty(c_mat.shape),
            _absent(x) if d_skip is None else d_skip.new_empty(d_skip.shape, dtype=f32),
            _absent(x) if h0 is None else h0.new_empty(h0.shape, dtype=f32))


def _ssd_flops(x_shape, b_shape, ops) -> int:
    from .ssd import CHUNK

    b, t, h, p = x_shape
    g, n = b_shape[2:]
    cb, rest = ops(t, p, n, CHUNK)
    return b * g * cb + b * h * rest


@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _ssd_fwd_flops(x_shape, dt_shape, a_shape, b_shape, *args, **kwargs) -> int:
    return _ssd_flops(x_shape, b_shape, ssd_operations)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _ssd_bwd_flops(x_shape, dt_shape, a_shape, b_shape, *args, **kwargs) -> int:
    return _ssd_flops(x_shape, b_shape, ssd_bwd_operations)


def ssd_grads(grads: tuple) -> tuple:
    """:func:`ssd_bwd`'s outputs with the absent gradients as None."""
    return tuple(None if g.dim() == 1 and g.shape[0] == 0 and i in (5, 6) else g
                 for i, g in enumerate(grads))
