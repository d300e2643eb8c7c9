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
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "TENSOR_CORE_MIN_T", "on_tensor_cores",
           "ssd_chunked", "ssd_chunked_torch"]

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


def ssd_chunked_torch(x, dt, a_log, b_mat, c_mat, d_skip=None, h0=None, chunk: int = CHUNK):
    """The plain version: the chunked algorithm, one chunk of ``chunk`` steps
    (the kernel's ``CHUNK`` unless asked) at a time, all (batch, head) pairs
    at once.  ``C B^T`` is taken once per group; the causal mask selects
    (``torch.where``), so the ``exp`` of a positive ``L_t - L_s`` above the
    diagonal never reaches the result."""
    b, t, h, p, g, n = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    r = h // g
    dev = x.device
    a = -torch.exp(a_log.float()).reshape(g, r)                        # (G, R)
    xf = x.float().reshape(b, t, g, r, p)
    dtf = dt.float().reshape(b, t, g, r)
    bf, cf = b_mat.float(), c_mat.float()                               # (B, T, G, N)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev) if h0 is None \
        else h0.float().clone()
    state = state.reshape(b, g, r, p, n)
    y = torch.empty((b, t, g, r, p), dtype=torch.float32, device=dev)
    for c0 in range(0, t, chunk):
        q = min(chunk, t - c0)
        xc, dtc = xf[:, c0:c0 + q], dtf[:, c0:c0 + q]                   # (B,Q,G,R,P), (B,Q,G,R)
        bc, cc = bf[:, c0:c0 + q], cf[:, c0:c0 + q]                     # (B, Q, G, N)
        L = torch.cumsum(dtc * a, dim=1)                                # (B, Q, G, R)
        causal = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
        cb = torch.einsum("btgn,bsgn->bgts", cc, bc)                   # (B, G, Q, Q)
        lt = L.permute(0, 2, 3, 1)                                      # (B, G, R, Q)
        decay = torch.exp(lt[..., :, None] - lt[..., None, :])          # (B, G, R, Q, Q)
        m = torch.where(causal, cb[:, :, None] * decay * dtc.permute(0, 2, 3, 1)[..., None, :],
                        0.0)
        yc = torch.einsum("bgrts,bsgrp->btgrp", m, xc)
        yc = yc + torch.einsum("btgn,bgrpn->btgrp", cc, state) * torch.exp(L)[..., None]
        y[:, c0:c0 + q] = yc
        w = dtc * torch.exp(L[:, -1:] - L)                              # (B, Q, G, R)
        state = torch.exp(L[:, -1])[..., None, None] * state + torch.einsum(
            "bsgrp,bsgn->bgrpn", xc * w[..., None], bc)
    if d_skip is not None:
        y = y + d_skip.float().reshape(g, r)[:, :, None] * xf
    return y.reshape(b, t, h, p).to(x.dtype), state.reshape(b, h, p, n)


def _c_fn(dtype: torch.dtype, t: int):
    from . import _build

    name = "ssd_chunked_bf16_mma" if on_tensor_cores(dtype, t) else \
        {torch.float32: "ssd_chunked_f32", torch.bfloat16: "ssd_chunked_bf16"}[dtype]
    fn = getattr(_build.load("ssd"), name)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p] * 9 + [ll] * 9 + [i] * 6 + [p]
    fn.restype = ctypes.c_int
    return fn


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape):
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
    x, b_mat, c_mat = _unit_last(x), _unit_last(b_mat), _unit_last(c_mat)
    dt, a_log = dt.contiguous(), a_log.contiguous()
    d_skip = None if d_skip is None else d_skip.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    dev = x.device
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _c_fn(x.dtype, t)(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            None if d_skip is None else d_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            *x.stride()[:3], *b_mat.stride()[:3], *c_mat.stride()[:3],
            b, t, h, g, p, n, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd_chunked.launches += 1
    return y, h_last


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip=None, h0=None):
    """Mamba-2 SSD over ``x (B, T, H, P)``, ``dt (B, T, H)``, ``a_log (H,)``,
    ``b_mat``/``c_mat (B, T, G, N)``, optional ``d_skip (H,)`` and ``h0 (B, H,
    P, N)`` (zeros if None): the CUDA kernel for CUDA tensors (asynchronous, on
    the current stream), the plain version for CPU tensors.  It has no
    backward yet: an input that requires a gradient raises (ROADMAP A8)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a_log, b_mat, c_mat, d_skip, h0)):
        raise NotImplementedError(
            "ssd_chunked has no backward yet (K4's backward, ROADMAP A8): "
            "call it under torch.no_grad() or on tensors that need no gradient")
    shape = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if x.device.type == "cpu":
        return ssd_chunked_torch(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked runs on cuda or cpu tensors, got {x.device}")
    return _launch_cuda(x, dt, a_log, b_mat, c_mat, d_skip, h0, shape)


ssd_chunked.launches = 0  # kernel launches made through this wrapper
