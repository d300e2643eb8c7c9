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

* :func:`rglru_scan_bwd` — the scan's backward: ``(da, dx~, dh0)`` from the
  saved ``a``, the states ``y``, ``h0`` and the gradients of ``y`` and of
  ``h_last``.  For CUDA tensors it launches the reverse scan of
  ``csrc/rglru.cu`` (``h_{t-1}`` read from the saved states) and counts the
  launch in ``rglru_scan_bwd.launches``; for CPU tensors it runs
  :func:`scan_bwd_torch`, the reference's ``_scan_bwd``
  (src/repro/kernels/rglru_xla.py:56) as a loop over t in the same order of
  operations, so the kernel is bit-equal to it.  A warp of the reverse scan
  takes 8 or 32 channels (:func:`bwd_group`: enough warps for every SM at
  batch 1).
* When an input requires a gradient, :func:`rglru_scan` runs the scan
  through an autograd function over ``(a, x~, h0) -> (y, h_last)``; the gate
  math stays outside it, in autograd.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import replay
from .fake import is_fake

__all__ = ["rglru_gates", "rglru_scan", "rglru_scan_torch", "rglru_scan_torch_grad",
           "rglru_scan_bwd", "scan_torch", "scan_bwd_torch"]

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


def scan_bwd_torch(a, y, h0, dy, dh_last=None):
    """The adjoint of :func:`scan_torch`, a loop over t from the last step:
    ``g_t = dy_t + a_{t+1} g_{t+1}`` (``+ dh_last`` at the last step),
    ``dx_t = g_t``, ``da_t = g_t h_{t-1}``, ``dh0 = a_0 g_0``, with
    ``h_{t-1}`` the saved state ``y_{t-1}`` (``h0``, or 0, before the first
    step).  Returns ``(da, dx, dh0)``, fp32."""
    b, t, d = a.shape
    carry = torch.zeros((b, d), dtype=torch.float32, device=a.device) if dh_last is None \
        else dh_last.float().clone()
    h_init = torch.zeros((b, d), dtype=torch.float32, device=a.device) if h0 is None \
        else h0.float()
    da = torch.empty_like(a)
    dx = torch.empty_like(a)
    for s in range(t - 1, -1, -1):
        g = dy[:, s] + carry
        dx[:, s] = g
        da[:, s] = g * (y[:, s - 1] if s > 0 else h_init)
        carry = a[:, s] * g
    return da, dx, carry


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


def rglru_scan_torch(x, a_param, input_gate, a_gate, h0=None, *, name: str | None = None):
    """The plain version: gates, then the Python loop over t (``name`` is the
    wrapper's and is not used here)."""
    _check(x, a_param, input_gate, a_gate, h0)
    y = scan_torch(*rglru_gates(x, a_param, input_gate, a_gate), h0)
    return y.to(x.dtype), y[:, -1].clone()


@functools.cache
def _c_fn():
    """The forward's C entry point (built and loaded at first use, typed once)."""
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


@functools.cache
def _c_bwd_fn():
    """The backward's C entry point (built and loaded at first use, typed once)."""
    from . import _build

    fn = _build.load("rglru").rglru_scan_bwd_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


BWD_GROUPS = (32, 8)   # channels a warp of the reverse scan can take


def bwd_group(b: int, d: int, n_sms: int) -> int:
    """Channels a warp of the reverse scan takes at ``(b, d)`` on a card of
    ``n_sms`` SMs: 32 (128-byte rows) when its one-warp blocks,
    ``b * ceil(d / 32)``, give every SM two, else 8 (the training shape
    (1, 4096, 2560) on an H100's 132 SMs: 8, 320 warps; batch 4: 32)."""
    return 32 if b * -(-d // 32) >= 2 * n_sms else 8


@functools.cache
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bwd_cuda(a, y, h0, dy, dh_last, group: int | None = None):
    b, t, d = a.shape
    if b * t * d >= 2**31 or b >= 65536:
        raise ValueError(f"shape {(b, t, d)} exceeds the kernel's int32 indexing / grid")
    dev = a.device
    if group is None:
        group = bwd_group(b, d, _n_sms(dev.index))   # a CUDA tensor's device has an index
    if group not in BWD_GROUPS:
        raise ValueError(f"group must be one of {BWD_GROUPS}, got {group}")
    for name, v in (("y", y), ("dy", dy), ("h0", h0), ("dh_last", dh_last)):
        if v is not None and v.device != dev:
            raise ValueError(f"{name} is on {v.device}, expected {dev}")
    a, y, dy = (v.to(torch.float32).contiguous() for v in (a, y, dy))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    dh_last = None if dh_last is None else dh_last.to(torch.float32).contiguous()
    dx, da = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _c_bwd_fn()(a.data_ptr(), y.data_ptr(), None if h0 is None else h0.data_ptr(),
                          dy.data_ptr(), None if dh_last is None else dh_last.data_ptr(),
                          dx.data_ptr(), da.data_ptr(), dh0.data_ptr(), b, t, d, group,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru backward kernel launch failed: CUDA error {err}")
    rglru_scan_bwd.launches += 1
    return da, dx, dh0


def rglru_scan_bwd(a, y, h0, dy, dh_last=None):
    """``(da, dx~, dh0)`` of the scan ``y_t = a_t y_{t-1} + x~_t`` from its
    fp32 ``a``, states ``y`` and ``h0`` (None: zeros), the gradient ``dy`` of
    the states and, if given, of the last state: the reverse-scan kernel for
    CUDA tensors, the plain loop for CPU tensors."""
    if a.shape != y.shape or dy.shape != a.shape:
        raise ValueError(f"a, y and dy must have one shape, got {tuple(a.shape)}, "
                         f"{tuple(y.shape)}, {tuple(dy.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan_bwd runs on cuda or cpu tensors, got {a.device}")
    return _bwd(a, y, h0, dy, dh_last, a.device.type == "cpu")


rglru_scan_bwd.launches = 0  # kernel launches made through this wrapper


class _Scan(torch.autograd.Function):
    """The scan ``(a, x~, h0) -> (y, h_last)`` with the hand-written backward
    (``plain``: the plain versions of both, on any device).  ``name`` is the
    states' activation class for a residency plan's keeper (:mod:`.replay`)."""

    @staticmethod
    def forward(ctx, a, xb, h0, plain, name):
        keeper = replay.current() if name else None
        key = keeper.key(name) if keeper is not None else None
        held = keeper.lookup(key) if keeper is not None else None
        if held is not None:
            (y,) = held
        else:
            y = _fwd(a, xb, h0, plain)
            if keeper is not None:
                keeper.keep(key, (y,))
        ctx.save_for_backward(a, y, h0)
        ctx.plain, ctx.has_h0 = plain, h0 is not None
        ctx.keeper, ctx.key = keeper, key
        return y, y[:, -1].clone()

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        if ctx.keeper is not None:
            ctx.keeper.release(ctx.key)
        if dy is None:
            dy = torch.zeros_like(y)
        da, dx, dh0 = _bwd(a, y, h0, dy, dh_last, ctx.plain)
        return da, dx, (dh0 if ctx.has_h0 else None), None, None


def _scan(x, a_param, input_gate, a_gate, h0, plain, name):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a_param, input_gate, a_gate, h0)):
        # the gate math in autograd, run again in the backward (a recompute
        # region, as the reference recomputes it under its layer checkpoint):
        # its fp32 intermediates are not held from the forward to the backward
        from torch.utils.checkpoint import checkpoint

        a, xb = checkpoint(rglru_gates, x, a_param, input_gate, a_gate, use_reentrant=False,
                           preserve_rng_state=False)
        y, h_last = _Scan.apply(a, xb, None if h0 is None else h0.float(), plain, name)
        return y.to(x.dtype), h_last
    a, xb = rglru_gates(x, a_param, input_gate, a_gate)
    y = _fwd(a, xb, h0, plain)
    return y.to(x.dtype), y[:, -1].clone()


def _fwd(a, xb, h0, plain: bool):
    """The scan's states: the custom op for a fake tensor (:mod:`.fake`),
    the plain loop if ``plain``, else the kernel."""
    if is_fake(a):
        return torch.ops.repro_torch.rglru_scan(a, xb, h0)
    return scan_torch(a, xb, h0) if plain else _launch_cuda(a, xb, h0)


def _bwd(a, y, h0, dy, dh_last, plain: bool):
    """``(da, dx~, dh0)`` on the forward's route (:func:`_fwd`)."""
    if is_fake(a):
        return torch.ops.repro_torch.rglru_scan_bwd(a, y, h0, dy, dh_last)
    if plain:
        return scan_bwd_torch(a, y, h0, dy.float(), dh_last)
    return _launch_bwd_cuda(a, y, h0, dy, dh_last)


def rglru_scan(x, a_param, input_gate, a_gate, h0=None, *, name: str | None = None):
    """RG-LRU over ``x``/gates ``(B, T, D)``: the CUDA scan for CUDA tensors
    (asynchronous, on the current stream), the plain scan for CPU tensors.
    When an input requires a gradient the call is differentiable, the scan's
    backward :func:`rglru_scan_bwd`; ``name`` is then the states' activation
    class for a residency plan."""
    _check(x, a_param, input_gate, a_gate, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, got {x.device}")
    for label, t in (("a_param", a_param), ("input_gate", input_gate), ("a_gate", a_gate)):
        if t.device != x.device:
            raise ValueError(f"{label} is on {t.device}, x is on {x.device}")
    return _scan(x, a_param, input_gate, a_gate, h0, x.device.type == "cpu", name)


def rglru_scan_torch_grad(x, a_param, input_gate, a_gate, h0=None, *,
                          name: str | None = None):
    """The plain scan and its plain backward as one differentiable function,
    on any device: what :func:`rglru_scan` runs for CPU tensors.  The port
    routes no CUDA tensor here; a comparison of the kernels with their plain
    versions on the card does."""
    _check(x, a_param, input_gate, a_gate, h0)
    return _scan(x, a_param, input_gate, a_gate, h0, True, None)


rglru_scan.launches = 0  # kernel launches made through this wrapper
