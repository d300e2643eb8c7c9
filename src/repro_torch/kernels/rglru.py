"""RG-LRU gated linear recurrence: the CUDA scan kernel and its plain version.

The gate math (``a = exp(-c softplus(a_param) a_gate)``,
``x~ = sqrt(1 - a^2) input_gate x``) is elementwise and stays in PyTorch
(:func:`rglru_gates`); the scan ``h_t = a_t h_{t-1} + x~_t`` with an fp32 carry
is the kernel's.

* :func:`rglru_scan` — the wrapper.  For CUDA tensors it launches
  ``csrc/rglru.cu`` (a warp per 32 channels of a batch row, h in a register,
  t in order, the a / x~ tiles streamed through a ring of cp.async stages in
  shared memory; a single step takes a one-thread-per-channel kernel) and
  counts the launch in ``rglru_scan.launches``; for CPU tensors it runs the
  plain scan.
* :func:`rglru_scan_torch` — the plain PyTorch version: the same gates, then a
  Python loop over t.  Both round ``a * h`` and ``+ x~`` separately, so the
  kernel is bit-equal to it.

Returns ``(y, h_last)``: ``y (B, T, D)`` in ``x``'s type and the fp32 state
after the last step ``(B, D)``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["rglru_gates", "rglru_scan", "rglru_scan_torch", "scan_torch"]

C = 8.0   # Griffin's fixed gate constant c (arXiv:2402.19427, eq. 4)


def rglru_gates(x, a_param, input_gate, a_gate):
    """``(a, x~)`` in fp32, in the reference kernel's order of operations."""
    log_a = -C * F.softplus(a_param.float()) * a_gate.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * input_gate.float() * x.float()


def scan_torch(a, xb, h0=None):
    """``y_t = a_t * y_{t-1} + xb_t`` over axis 1, from ``h0`` (zeros if None)."""
    b, t, d = a.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=a.device) if h0 is None \
        else h0.float()
    y = torch.empty_like(a)
    for s in range(t):
        h = a[:, s] * h + xb[:, s]
        y[:, s] = h
    return y


def _check(x, a_param, input_gate, a_gate, h0):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got shape {tuple(x.shape)}")
    b, t, d = x.shape
    if t == 0:
        raise ValueError("x has no time steps")
    if input_gate.shape != x.shape or a_gate.shape != x.shape:
        raise ValueError(f"gates must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(input_gate.shape)} and {tuple(a_gate.shape)}")
    if tuple(a_param.shape) != (d,):
        raise ValueError(f"a_param must be ({d},), got {tuple(a_param.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, d):
        raise ValueError(f"h0 must be ({b}, {d}), got {tuple(h0.shape)}")


def rglru_scan_torch(x, a_param, input_gate, a_gate, h0=None):
    """The plain version: gates, then the Python loop over t."""
    _check(x, a_param, input_gate, a_gate, h0)
    y = scan_torch(*rglru_gates(x, a_param, input_gate, a_gate), h0)
    return y.to(x.dtype), y[:, -1].clone()


def _c_fn():
    from . import _build

    fn = _build.load("rglru").rglru_scan_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(a, xb, h0):
    b, t, d = a.shape
    if b * t * d >= 2**31 or b >= 65536:
        raise ValueError(f"shape {(b, t, d)} exceeds the kernel's int32 indexing / grid")
    dev = a.device
    a, xb = a.contiguous(), xb.contiguous()   # the kernel indexes (B, T, D) densely
    if h0 is not None:
        if h0.device != dev:
            raise ValueError(f"h0 is on {h0.device}, expected {dev}")
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty_like(a)
    with torch.cuda.device(dev):
        err = _c_fn()(a.data_ptr(), xb.data_ptr(), None if h0 is None else h0.data_ptr(),
                      y.data_ptr(), b, t, d, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return y


def rglru_scan(x, a_param, input_gate, a_gate, h0=None):
    """RG-LRU over ``x``/gates ``(B, T, D)``: the CUDA scan for CUDA tensors
    (asynchronous, on the current stream), the plain scan for CPU tensors."""
    _check(x, a_param, input_gate, a_gate, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, got {x.device}")
    for name, t in (("a_param", a_param), ("input_gate", input_gate), ("a_gate", a_gate)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
    a, xb = rglru_gates(x, a_param, input_gate, a_gate)
    y = scan_torch(a, xb, h0) if x.device.type == "cpu" else _launch_cuda(a, xb, h0)
    return y.to(x.dtype), y[:, -1].clone()


rglru_scan.launches = 0  # kernel launches made through this wrapper
