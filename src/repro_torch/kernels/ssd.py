"""Mamba-2 SSD (state-space duality), chunked: the CUDA kernel and its plain
version.

Per (batch, head) and per chunk of ``CHUNK`` time steps, with
``L = cumsum(dt A)`` inside the chunk (``A = -exp(a_log)``)::

    M[t, s] = (C_t . B_s) exp(L_t - L_s) dt_s          for s <= t, else 0
    Y       = M X + (C * exp(L)) h^T
    h'      = exp(L_last) h + X^T (B * dt exp(L_last - L))

with the fp32 state ``h (P, N)`` carried from chunk to chunk; head ``h``
reads B/C group ``h // (H / G)``.  ``d_skip * x`` is added in fp32 and ``y``
is rounded to ``x``'s type once.

* :func:`ssd_chunked` — the wrapper.  For CUDA tensors it launches one of the
  two kernels of ``csrc/ssd.cu`` and counts the launch in
  ``ssd_chunked.launches``; a tensor the kernels do not take raises.  bf16
  x/B/C with ``T >= TENSOR_CORE_MIN_T`` (a prefill) take the tensor-core
  kernel (a block per (batch, head, 32 head_dim columns) walking its chunks in
  order, the state in fp32 registers, the products as bf16 ``mma.sync``);
  float32, and a bf16 decode step (``T = 1``), take the CUDA-core kernel (a
  block per (batch, head), fp32 FMAs, the state in shared memory).  For CPU
  tensors it runs the plain version.
* :func:`ssd_chunked_torch` — the plain PyTorch version: the same chunked
  algorithm as a loop over chunks.  The last chunk may be short; T = 1 is one
  chunk of one step.

Returns ``(y (B, T, H, P) in x's type, h_last (B, H, P, N) fp32)``.

When an input requires a gradient, :func:`ssd_chunked` is differentiable
(``_SSD``); its backward is :func:`ssd_chunked_bwd`: the kernels of
``csrc/ssd_bwd.cu`` for CUDA tensors (counted in
``ssd_chunked_bwd.launches``; bf16 takes the tensor-core passes, float32
the CUDA-core ones, :func:`bwd_entry_points`), :func:`ssd_chunked_bwd_torch`
for CPU tensors.  The reference has no TPU kernel for it: it differentiates through
``ref.ssd_chunked_reference``.  Per (batch, head) and chunk, with the
chunk's incoming state ``H``, the gradient ``dH'`` of its outgoing state,
``E[t, s] = exp(L_t - L_s)`` for ``s <= t`` (else 0), ``W_s = dt_s
exp(L_last - L_s)`` and ``V_s = dH' B_s``::

    dx_s  = sum_t M[t, s] dy_t + W_s V_s + D dy_s
    dB_s  = sum_t E[t, s] dt_s (dy_t . x_s) C_t + W_s dH'^T x_s
    dC_t  = sum_s E[t, s] dt_s (dy_t . x_s) B_s + exp(L_t) H^T dy_t
    dH    = exp(L_last) dH' + sum_t exp(L_t) dy_t C_t^T      (to the chunk before)

and ``dt`` reaches the loss twice: directly (through M and W) and through
``L``.  The gradient ``dl_u`` of ``l_u = dt_u a`` sums the terms ``l_u``
moves (the pairs ``s < u <= t`` of M, ``exp(L_t)`` in ``y_t`` for ``t >= u``,
``W_s`` for ``s < u``, and ``exp(L_last)`` on ``H``) and gives ``ddt_u +=
dl_u a`` and ``da = sum dl_u dt_u``; ``da_log = da a``, ``dD = sum dy . x``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import replay
from .fake import is_fake, ssd_grads

__all__ = ["CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "TENSOR_CORE_MIN_T", "on_tensor_cores",
           "bwd_entry_points", "bwd_scratch", "ssd_chunked", "ssd_chunked_torch",
           "ssd_chunked_bwd", "ssd_chunked_bwd_torch", "ssd_chunked_torch_grad"]

CHUNK = 64          # time steps per chunk, the kernel's and the plain version's
MAX_HEAD_DIM = 64   # P: the kernel's register tiles cover 64 columns
MAX_STATE = 128     # N: shared-memory rows of B, C and the state
# bf16 x/B/C with at least this many steps take the tensor-core kernel; a
# decode step (T = 1) is host-bound and keeps the CUDA-core kernel
TENSOR_CORE_MIN_T = 2
_DTYPES = (torch.float32, torch.bfloat16)


def on_tensor_cores(dtype: torch.dtype, t: int) -> bool:
    """Whether a launch with x/B/C in ``dtype`` over ``t`` steps runs on the
    tensor cores (bf16 products, fp32 sums) or on the CUDA cores (fp32)."""
    return dtype == torch.bfloat16 and t >= TENSOR_CORE_MIN_T


def _check(x, dt, a_log, b_mat, c_mat, d_skip, h0):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, T, H, P), got shape {tuple(x.shape)}")
    b, t, h, p = x.shape
    if t == 0:
        raise ValueError("x has no time steps")
    if tuple(dt.shape) != (b, t, h):
        raise ValueError(f"dt must be ({b}, {t}, {h}), got {tuple(dt.shape)}")
    if tuple(a_log.shape) != (h,):
        raise ValueError(f"a_log must be ({h},), got {tuple(a_log.shape)}")
    if b_mat.dim() != 4 or tuple(b_mat.shape[:2]) != (b, t) or c_mat.shape != b_mat.shape:
        raise ValueError(f"b_mat and c_mat must be ({b}, {t}, G, N), got "
                         f"{tuple(b_mat.shape)} and {tuple(c_mat.shape)}")
    g, n = b_mat.shape[2:]
    if g == 0 or h % g:
        raise ValueError(f"{h} heads cannot be grouped over {g} B/C groups")
    if d_skip is not None and tuple(d_skip.shape) != (h,):
        raise ValueError(f"d_skip must be ({h},), got {tuple(d_skip.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, h, p, n):
        raise ValueError(f"h0 must be ({b}, {h}, {p}, {n}), got {tuple(h0.shape)}")
    for name, v in (("dt", dt), ("a_log", a_log), ("b_mat", b_mat), ("c_mat", c_mat),
                    ("d_skip", d_skip), ("h0", h0)):
        if v is not None and v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x is on {x.device}")
    return b, t, h, p, g, n


def _sum_type(x: torch.Tensor) -> torch.dtype:
    """The plain versions' type of every sum: float32, or float64 for
    float64 inputs (a test's exact reading; the kernels take no float64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_chunked_torch(x, dt, a_log, b_mat, c_mat, d_skip=None, h0=None, chunk: int = CHUNK, *,
                      name: str | None = None):
    """The plain version: the chunked algorithm, one chunk of ``chunk`` steps
    (the kernel's ``CHUNK`` unless asked) at a time, all (batch, head) pairs
    at once (``name`` is the wrapper's and is not used here).  ``C B^T`` is
    taken once per group; the causal mask is applied to ``L_t - L_s`` before
    the ``exp`` and selects again after it (``torch.where``), so the ``exp``
    of a positive ``L_t - L_s`` above the diagonal is never taken."""
    b, t, h, p, g, n = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    r = h // g
    dev, ft = x.device, _sum_type(x)
    a = -torch.exp(a_log.to(ft)).reshape(g, r)                          # (G, R)
    xf = x.to(ft).reshape(b, t, g, r, p)
    dtf = dt.to(ft).reshape(b, t, g, r)
    bf, cf = b_mat.to(ft), c_mat.to(ft)                                 # (B, T, G, N)
    state = torch.zeros((b, h, p, n), dtype=ft, device=dev) if h0 is None \
        else h0.to(ft).clone()
    state = state.reshape(b, g, r, p, n)
    y = torch.empty((b, t, g, r, p), dtype=ft, device=dev)
    for c0 in range(0, t, chunk):
        q = min(chunk, t - c0)
        xc, dtc = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]                   # (B,Q,G,R,P), (B,Q,G,R)
        bc, cc = bf[:, c0:c0 + q], cf[:, c0:c0 + q]                     # (B, Q, G, N)
        L = torch.cumsum(dtc * a, dim=1)                                # (B, Q, G, R)
        causal = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        cb = torch.einsum("btgn,bsgn->bgts", cc, bc)                   # (B, G, Q, Q)
        lt = L.permute(0, 2, 3, 1)                                      # (B, G, R, Q)
        # masked before the exp: exp(L_t - L_s) above the diagonal may be inf,
        # and autograd through the plain version would meet inf * 0
        decay = torch.exp(torch.where(causal, lt[..., :, None] - lt[..., None, :], -torch.inf))
        m = torch.where(causal, cb[:, :, None] * decay * dtc.permute(0, 2, 3, 1)[..., None, :],
                        0.0)
        yc = torch.einsum("bgrts,bsgrp->btgrp", m, xc)
        yc = yc + torch.einsum("btgn,bgrpn->btgrp", cc, state) * torch.exp(L)[..., None]
        y[:, c0:c0 + q] = yc
        w = dtc * torch.exp(L[:, -1:] - L)                              # (B, Q, G, R)
        state = torch.exp(L[:, -1])[..., None, None] * state + torch.einsum(
            "bsgrp,bsgn->bgrpn", xc * w[..., None], bc)
    if d_skip is not None:
        y = y + d_skip.to(ft).reshape(g, r)[:, :, None] * xf
    return y.reshape(b, t, h, p).to(x.dtype), state.reshape(b, h, p, n)


def ssd_chunked_bwd_torch(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last=None,
                          chunk: int = CHUNK):
    """The plain backward: the gradients of :func:`ssd_chunked_torch`'s
    ``(y, h_last)`` given ``dy`` and ``dh_last`` (None: zeros), as the
    module docstring writes them.  A loop forward over the chunks gives each
    chunk's incoming state; a loop backward carries the state gradient from
    chunk to chunk.  The causal mask is applied to ``L_t - L_s`` before the
    ``exp``.  Returns ``(dx, ddt, da_log, dB, dC, dd_skip, dh0)``: dx, dB,
    dC in their inputs' types, the rest fp32; ``dd_skip`` / ``dh0`` None
    where ``d_skip`` / ``h0`` is."""
    b, t, h, p, g, n = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if tuple(dy.shape) != (b, t, h, p):
        raise ValueError(f"dy must be {(b, t, h, p)}, got {tuple(dy.shape)}")
    if dh_last is not None and tuple(dh_last.shape) != (b, h, p, n):
        raise ValueError(f"dh_last must be {(b, h, p, n)}, got {tuple(dh_last.shape)}")
    r = h // g
    dev, ft = x.device, _sum_type(x)
    a = -torch.exp(a_log.to(ft)).reshape(g, r)                          # (G, R)
    xf = x.to(ft).reshape(b, t, g, r, p)
    dyf = dy.to(ft).reshape(b, t, g, r, p)
    dtf = dt.to(ft).reshape(b, t, g, r)
    bf, cf = b_mat.to(ft), c_mat.to(ft)                                 # (B, T, G, N)
    starts = list(range(0, t, chunk))
    # the incoming state of every chunk, in the forward's order
    state = torch.zeros((b, g, r, p, n), dtype=ft, device=dev) if h0 is None \
        else h0.to(ft).reshape(b, g, r, p, n).clone()
    states = []
    for c0 in starts:
        q = min(chunk, t - c0)
        dtc, bc = dtf[:, c0:c0 + q], bf[:, c0:c0 + q]
        L = torch.cumsum(dtc * a, dim=1)
        states.append(state)
        w = dtc * torch.exp(L[:, -1:] - L)
        state = torch.exp(L[:, -1])[..., None, None] * state + torch.einsum(
            "bsgrp,bsgn->bgrpn", xf[:, c0:c0 + q] * w[..., None], bc)
    dx = torch.empty((b, t, g, r, p), dtype=ft, device=dev)
    ddt = torch.empty((b, t, g, r), dtype=ft, device=dev)
    db = torch.empty((b, t, g, n), dtype=ft, device=dev)
    dc = torch.empty((b, t, g, n), dtype=ft, device=dev)
    da = torch.zeros((g, r), dtype=ft, device=dev)
    dstate = torch.zeros((b, g, r, p, n), dtype=ft, device=dev) if dh_last is None \
        else dh_last.to(ft).reshape(b, g, r, p, n).clone()
    for c0, hs in zip(reversed(starts), reversed(states)):
        q = min(chunk, t - c0)
        xc, dyc, dtc = xf[:, c0:c0 + q], dyf[:, c0:c0 + q], dtf[:, c0:c0 + q]
        bc, cc = bf[:, c0:c0 + q], cf[:, c0:c0 + q]
        L = torch.cumsum(dtc * a, dim=1)                                # (B, Q, G, R)
        lt = L.permute(0, 2, 3, 1)                                      # (B, G, R, Q)
        causal = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        e = torch.exp(torch.where(causal, lt[..., :, None] - lt[..., None, :], -torch.inf))
        dts = dtc.permute(0, 2, 3, 1)[..., None, :]                     # dt_s (B, G, R, 1, Q)
        cb = torch.einsum("btgn,bsgn->bgts", cc, bc)[:, :, None]       # (B, G, 1, Q, Q)
        dyx = torch.einsum("btgrp,bsgrp->bgrts", dyc, xc)               # dy_t . x_s
        m = cb * e * dts
        sm = e * dts * dyx                                              # the dB / dC weights
        gd = cb * e * dyx                                               # d y / d dt_s, per t
        el, elast = torch.exp(L), torch.exp(L[:, -1])                   # (B,Q,G,R), (B,G,R)
        f = torch.exp(L[:, -1:] - L)                                    # exp(L_last - L_s)
        w = dtc * f
        v = torch.einsum("bsgn,bgrpn->bsgrp", bc, dstate)               # dH' B_s
        z = torch.einsum("btgn,bgrpn->btgrp", cc, hs)                   # H C_t
        dx[:, c0:c0 + q] = torch.einsum("bgrts,btgrp->bsgrp", m, dyc) + w[..., None] * v
        db[:, c0:c0 + q] = torch.einsum("bgrts,btgn->bsgn", sm, cc) + torch.einsum(
            "bsgrp,bgrpn->bsgn", xc * w[..., None], dstate)
        dc[:, c0:c0 + q] = torch.einsum("bgrts,bsgn->btgn", sm, bc) + torch.einsum(
            "btgrp,bgrpn->btgn", dyc * el[..., None], hs)
        xv = (xc * v).sum(-1)                                           # x_s . V_s
        # dl_u, the gradient of l_u = dt_u a, is summed over what l_u moves:
        # the pairs s < u <= t of M, exp(L_t) in y_t for t >= u, W_s for s < u
        # and exp(L_last); no term is added and taken away again
        gm = gd * dts                                                   # G[t, s]
        before = torch.cumsum(torch.nn.functional.pad(gm[..., :-1], (1, 0)), -1)  # s < u
        pairs = torch.where(causal, before, 0.0).sum(-2).permute(0, 3, 1, 2)   # over t >= u
        yz = el * (dyc * z).sum(-1)                                     # (B, Q, G, R)
        kx = w * xv
        dl = pairs + torch.flip(torch.cumsum(torch.flip(yz, (1,)), 1), (1,)) \
            + torch.cumsum(torch.cat([torch.zeros_like(kx[:, :1]), kx[:, :-1]], 1), 1) + (elast * (dstate * hs).sum((-2, -1)))[:, None]
        ddt[:, c0:c0 + q] = gd.sum(-2).permute(0, 3, 1, 2) + f * xv + dl * a
        da += (dl * dtc).sum((0, 1))
        dstate = elast[..., None, None] * dstate + torch.einsum(
            "btgrp,btgn->bgrpn", dyc * el[..., None], cc)
    dd_skip = None
    if d_skip is not None:
        dx += d_skip.to(ft).reshape(g, r)[:, :, None] * dyf
        dd_skip = (dyf * xf).sum((0, 1, 4)).reshape(h)
    return (dx.reshape(b, t, h, p).to(x.dtype), ddt.reshape(b, t, h), (da * a).reshape(h),
            db.to(b_mat.dtype), dc.to(c_mat.dtype), dd_skip,
            None if h0 is None else dstate.reshape(b, h, p, n))


@functools.cache
def _c_fn(dtype: torch.dtype, tensor_cores: bool):
    """The forward's C entry point for ``dtype`` (``tensor_cores``: the
    tensor-core kernel, see :func:`on_tensor_cores`), built and loaded at
    first use and typed once."""
    from . import _build

    name = "ssd_chunked_bf16_mma" if tensor_cores else \
        {torch.float32: "ssd_chunked_f32", torch.bfloat16: "ssd_chunked_bf16"}[dtype]
    fn = getattr(_build.load("ssd"), name)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p] * 9 + [ll] * 9 + [i] * 6 + [p]
    fn.restype = ctypes.c_int
    return fn


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_cuda_types(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape):
    """What the forward and the backward kernels take, or raise."""
    b, t, h, p, g, n = shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD kernel takes x in float32 or bfloat16, got {x.dtype}")
    for name, v in (("b_mat", b_mat), ("c_mat", c_mat)):
        if v.dtype != x.dtype:
            raise TypeError(f"{name} is {v.dtype}, x is {x.dtype}")
    for name, v in (("dt", dt), ("a_log", a_log), ("d_skip", d_skip), ("h0", h0)):
        if v is not None and v.dtype != torch.float32:
            raise TypeError(f"the SSD kernel takes {name} in float32, got {v.dtype}")
    if p > MAX_HEAD_DIM or n > MAX_STATE or n % 4:
        raise ValueError(f"head_dim {p} / state {n}: the kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and a state <= {MAX_STATE} that is a multiple of 4")
    if b >= 65536 or max(x.numel(), b_mat.numel(), b * h * p * n) >= 2**62:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")


def _launch_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape):
    b, t, h, p, g, n = shape
    _check_cuda_types(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape)
    x, b_mat, c_mat = _unit_last(x), _unit_last(b_mat), _unit_last(c_mat)
    dt, a_log = dt.contiguous(), a_log.contiguous()
    d_skip = None if d_skip is None else d_skip.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    dev = x.device
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _c_fn(x.dtype, on_tensor_cores(x.dtype, t))(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            None if d_skip is None else d_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            *x.stride()[:3], *b_mat.stride()[:3], *c_mat.stride()[:3],
            b, t, h, g, p, n, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd_chunked.launches += 1
    return y, h_last


def bwd_entry_points(dtype: torch.dtype) -> tuple[str, str, str]:
    """The C entry points of ``csrc/ssd_bwd.cu`` a backward with x/B/C in
    ``dtype`` launches, in order: the state pass, the chunk pass and the sums.
    bf16 (any T) takes the tensor-core passes: hi + lo bf16 chunk states and
    state gradients, dB / dC summed over each group's heads inside the chunk
    pass, and the heads' da / dD sums alone.  float32 takes the CUDA-core
    passes (fp32 FMAs, fp32 states, per-head dB / dC partials), which the
    1e-4 float32 gate needs."""
    if dtype == torch.bfloat16:
        return "ssd_bwd_states_bf16_mma", "ssd_bwd_chunks_bf16_mma", "ssd_bwd_reduce_heads"
    if dtype == torch.float32:
        return "ssd_bwd_states_f32", "ssd_bwd_chunks_f32", "ssd_bwd_reduce_f32"
    raise TypeError(f"the SSD backward kernels take float32 or bfloat16, got {dtype}")


def bwd_scratch(dtype: torch.dtype, b: int, t: int, h: int, p: int, n: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The scratch one backward with x/B/C in ``dtype`` allocates, by name:
    ``(shape, type)``.  Every chunk's incoming state and the gradient of its
    outgoing state (fp32, or on the tensor cores hi + lo bf16 pairs in the
    same bytes), the per-(batch, head, chunk) da / dD partials and, off the
    tensor cores, the per-head dB / dC rows that the sums add up (on the
    tensor cores the chunk pass writes dB / dC whole)."""
    nc = -(-t // CHUNK)
    if dtype == torch.bfloat16:
        state = ((b, h, nc, 2, p, n), torch.bfloat16)
        return {"states": state, "dstates": state, "head_part": ((2, b, h, nc), torch.float32)}
    state = ((b, h, nc, p, n), torch.float32)
    return {"states": state, "dstates": state, "head_part": ((2, b, h, nc), torch.float32),
            "db_part": ((b, t, h, n), torch.float32), "dc_part": ((b, t, h, n), torch.float32)}


@functools.cache
def _c_bwd_fns(names: tuple[str, str, str]):
    """The backward's C entry points ``names`` (:func:`bwd_entry_points`),
    built and loaded at first use and typed once."""
    from . import _build

    lib = _build.load("ssd_bwd")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    states, chunks, reduce = (getattr(lib, name) for name in names)
    states.argtypes = [p] * 11 + [ll] * 9 + [i] * 6 + [p]
    chunks.argtypes = [p] * 14 + [ll] * 9 + [i] * 6 + [p]
    reduce.argtypes = [p] * 8 + [i] * 6 + [p]
    for fn in (states, chunks, reduce):
        fn.restype = ctypes.c_int
    return states, chunks, reduce


def _launch_bwd_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last):
    """The passes of ``csrc/ssd_bwd.cu`` on the current stream
    (:func:`bwd_entry_points`): the chunk states and state gradients (and
    dh0), every chunk's gradients (dB / dC whole on the tensor cores, else
    per head), and the fixed-order sums."""
    b, t, h, p, g, n = shape = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    dev = x.device
    if tuple(dy.shape) != (b, t, h, p) or dy.device != dev:
        raise ValueError(f"dy must be {(b, t, h, p)} on {dev}, got {tuple(dy.shape)} on "
                         f"{dy.device}")
    if dh_last is not None and (tuple(dh_last.shape) != (b, h, p, n) or dh_last.device != dev):
        raise ValueError(f"dh_last must be {(b, h, p, n)} on {dev}")
    _check_cuda_types(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape)
    for name, v in (("dy", dy), ("dh_last", dh_last)):
        if v is not None and v.dtype != (x.dtype if name == "dy" else torch.float32):
            raise TypeError(f"{name} is {v.dtype}: the SSD backward takes dy in x's type "
                            "and dh_last in float32")
    x, b_mat, c_mat = _unit_last(x), _unit_last(b_mat), _unit_last(c_mat)
    dt, a_log, dy = dt.contiguous(), a_log.contiguous(), dy.contiguous()
    d_skip = None if d_skip is None else d_skip.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    tensor_cores = x.dtype == torch.bfloat16
    scratch = {name: torch.empty(shape, dtype=dtype, device=dev)
               for name, (shape, dtype) in bwd_scratch(x.dtype, b, t, h, p, n).items()}
    states, dstates, head_part = scratch["states"], scratch["dstates"], scratch["head_part"]
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, h), **f32)
    db = torch.empty((b, t, g, n), dtype=b_mat.dtype, device=dev)
    dc = torch.empty((b, t, g, n), dtype=c_mat.dtype, device=dev)
    # the chunk pass writes into db_part / dc_part: dB / dC themselves on the
    # tensor cores, else the per-head rows that the sums add up
    db_part, dc_part = (db, dc) if tensor_cores else (scratch["db_part"], scratch["dc_part"])
    da_log = torch.empty((h,), **f32)
    dd_skip = None if d_skip is None else torch.empty((h,), **f32)
    dh0 = None if h0 is None else torch.empty((b, h, p, n), **f32)
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    strides = (*x.stride()[:3], *b_mat.stride()[:3], *c_mat.stride()[:3])
    dims = (b, t, h, g, p, n)
    fn_states, fn_chunks, fn_reduce = _c_bwd_fns(bwd_entry_points(x.dtype))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn_states(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
                        c_mat.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh_last),
                        states.data_ptr(), dstates.data_ptr(), ptr(dh0), *strides, *dims,
                        stream)
        if err == 0:
            err = fn_chunks(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
                            c_mat.data_ptr(), ptr(d_skip), dy.data_ptr(), states.data_ptr(),
                            dstates.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                            db_part.data_ptr(), dc_part.data_ptr(), head_part.data_ptr(),
                            *strides, *dims, stream)
        if err == 0:
            sums = (None, None) if tensor_cores else (db_part, dc_part)
            out = (None, None) if tensor_cores else (db, dc)
            err = fn_reduce(*map(ptr, sums), head_part.data_ptr(), a_log.data_ptr(),
                            *map(ptr, out), da_log.data_ptr(), ptr(dd_skip), *dims, stream)
    if err != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: CUDA error {err}")
    ssd_chunked_bwd.launches += 1
    return dx, ddt, da_log, db, dc, dd_skip, dh0


def ssd_chunked_bwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last=None):
    """``(dx, ddt, da_log, dB, dC, dd_skip, dh0)`` of :func:`ssd_chunked`
    from its inputs, ``dy`` and ``dh_last`` (None: zeros): the kernels of
    ``csrc/ssd_bwd.cu`` for CUDA tensors (asynchronous, on the current
    stream; dx, dB, dC in x's type, the rest fp32), :func:`ssd_chunked_bwd_torch`
    for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunked_bwd runs on cuda or cpu tensors, got {x.device}")
    return _bwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last, x.device.type == "cpu")


ssd_chunked_bwd.launches = 0  # calls that launched the kernels (four kernels each)


def _fwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, plain: bool, chunk: int = CHUNK, shape=None):
    """``(y, h_last)`` on its one route: the custom op for a fake tensor
    (:mod:`.fake`), the plain version at ``chunk`` if ``plain``, else the
    kernel (``shape``: ``_check``'s, computed here if None)."""
    if is_fake(x):
        return torch.ops.repro_torch.ssd_fwd(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if plain:
        return ssd_chunked_torch(x, dt, a_log, b_mat, c_mat, d_skip, h0, chunk)
    return _launch_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0,
                        shape or _check(x, dt, a_log, b_mat, c_mat, d_skip, h0))


def _bwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last, plain: bool, chunk: int = CHUNK):
    """The gradients on the forward's route (:func:`_fwd`)."""
    if is_fake(x):
        return ssd_grads(torch.ops.repro_torch.ssd_bwd(x, dt, a_log, b_mat, c_mat, d_skip, h0,
                                                       dy, dh_last))
    if plain:
        return ssd_chunked_bwd_torch(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last, chunk)
    return _launch_bwd_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0, dy, dh_last)


class _SSD(torch.autograd.Function):
    """The SSD ``(x, dt, a_log, B, C, d_skip, h0) -> (y, h_last)`` with the
    hand-written backward (``plain``: the plain versions of both, on any
    device, at ``chunk`` steps a chunk).  ``name`` is the output's activation
    class for a residency plan's keeper (:mod:`.replay`)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_skip, h0, plain, chunk, name):
        keeper = replay.current() if name else None
        key = keeper.key(name) if keeper is not None else None
        held = keeper.lookup(key) if keeper is not None else None
        if held is not None:
            y, h_last = held
        else:
            y, h_last = _fwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, plain, chunk)
            if keeper is not None:
                keeper.keep(key, (y, h_last))
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_skip, h0)
        ctx.plain, ctx.chunk = plain, chunk
        ctx.keeper, ctx.key = keeper, key
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, a_log, b_mat, c_mat, d_skip, h0 = ctx.saved_tensors
        if ctx.keeper is not None:
            ctx.keeper.release(ctx.key)
        if dy is None:
            dy = torch.zeros_like(x)
        grads = _bwd(x, dt, a_log, b_mat, c_mat, d_skip, h0,
                     dy if ctx.plain else dy.to(x.dtype), dh_last, ctx.plain, ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip=None, h0=None, *, name: str | None = None):
    """Mamba-2 SSD over ``x (B, T, H, P)``, ``dt (B, T, H)``, ``a_log (H,)``,
    ``b_mat``/``c_mat (B, T, G, N)``, optional ``d_skip (H,)`` and ``h0 (B, H,
    P, N)`` (zeros if None): the CUDA kernel for CUDA tensors (asynchronous, on
    the current stream), the plain version for CPU tensors.  When an input
    requires a gradient the call is differentiable, its backward
    :func:`ssd_chunked_bwd`; ``name`` is then the output's activation class
    for a residency plan."""
    shape = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunked runs on cuda or cpu tensors, got {x.device}")
    if _needs_grad(x, dt, a_log, b_mat, c_mat, d_skip, h0):
        return _SSD.apply(x, dt, a_log, b_mat, c_mat, d_skip, h0, x.device.type == "cpu",
                          CHUNK, name)
    return _fwd(x, dt, a_log, b_mat, c_mat, d_skip, h0, x.device.type == "cpu", shape=shape)


def ssd_chunked_torch_grad(x, dt, a_log, b_mat, c_mat, d_skip=None, h0=None, *,
                           chunk: int = CHUNK, name: str | None = None):
    """The plain forward and the plain backward as one differentiable
    function, on any device, at ``chunk`` steps a chunk: what
    :func:`ssd_chunked` runs for CPU tensors.  The port routes no CUDA tensor
    here; a comparison of the kernels with their plain versions on the card
    does."""
    _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if _needs_grad(x, dt, a_log, b_mat, c_mat, d_skip, h0):
        return _SSD.apply(x, dt, a_log, b_mat, c_mat, d_skip, h0, True, chunk, None)
    return ssd_chunked_torch(x, dt, a_log, b_mat, c_mat, d_skip, h0, chunk)


ssd_chunked.launches = 0  # kernel launches made through this wrapper
