"""Blockwise online-softmax attention: the CUDA kernel and its plain version.

* :func:`flash_attention` — the wrapper.  For CUDA tensors it launches the
  hand-written ``csrc/flash_attention.cu`` (a loop over the kv tiles that the
  causal mask and the window leave visible, fp32 running max / sum /
  accumulator) and counts the launch in ``flash_attention.launches``; a tensor
  the kernel does not take raises.  bf16 runs on the tensor cores (a block per
  128 (position, head) rows of one kv group, bf16 ``mma.sync`` products, P
  rounded to bf16 before P V); float32 on the CUDA cores (a block per (batch,
  head, 64 q rows), fp32 FMAs).  For CPU tensors it runs the plain version.
* :func:`flash_attention_torch` — the plain PyTorch version of the same
  function: dense masked scores in fp32, a few q rows at a time.

* :func:`flash_attention_bwd` — the backward's wrapper: dq, dk and dv from
  ``(q, k, v, out, lse, d_out)``.  For CUDA tensors it launches
  ``csrc/flash_attention_bwd.cu`` and counts the launch in
  ``flash_attention_bwd.launches``: four kernels, deterministic (no atomics,
  every sum in a fixed order) — delta, a dk / dv pass per (64 kv rows, q
  head), a fixed-order sum over each kv head's group, a dq pass.  bf16 runs
  both passes on the tensor cores (``mma.sync`` bf16 -> fp32, ``cp.async``
  double-buffered tiles): the dk / dv pass computes S^T and dP^T a warp per
  16 x 32, stages P^T and dS^T in shared memory as bf16 and accumulates dk
  and dv over all 8 warps (128 fp32 registers a thread at d 256, 222 KB of
  shared memory); the dq pass is laid out as the forward, a block per 128
  (position, head) rows of a kv group over 32-key tiles, dq in registers.
  float32 runs both on the CUDA cores (fp32 FMAs, 32 x 32 tiles), which its
  1e-5 check needs.  For CPU tensors it runs
  :func:`flash_attention_bwd_torch`, a straight port of the reference's
  ``_flash_bwd`` (src/repro/kernels/flash_xla.py:76), chunked over q rows.
* When an input requires a gradient, :func:`flash_attention` goes through an
  autograd function whose backward is :func:`flash_attention_bwd`; it saves
  ``(q, k, v, out, lse)``, as the reference's custom VJP does.
* A fake tensor (a shape-only run, ``FakeTensorMode``) takes the custom ops
  of :mod:`.fake` (shapes and a flop count, no plain version).

Layout (the reference's): ``q (B, Sq, H, D)``, ``k``/``v (B, Skv, KVH, D)``;
head ``h`` reads kv head ``h // (H / KVH)``.  Masking: causal keeps
``k_pos <= q_pos``, a window keeps ``k_pos > q_pos - window``, with
``q_pos = q_offset + row``.  A row that sees no key gives zeros (and lse
-1e30), as the TPU kernel does, and zero gradient.  Returns the output in the
input type and, with ``return_lse``, the fp32 log-sum-exp ``(B, Sq, H)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import replay
from .fake import is_fake

__all__ = ["flash_attention", "flash_attention_torch", "flash_attention_bwd",
           "flash_attention_bwd_torch", "flash_attention_torch_grad", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_NEG = -1e30
_Q_CHUNK = 1024   # q rows per dense score block of the plain version
_BWD_CHUNK = 256  # q rows per block of the plain backward (the reference's chunk)
_FN_BY_DTYPE = {torch.float32: "flash_attention_fwd_f32",
                torch.bfloat16: "flash_attention_fwd_bf16"}
_BWD_FN_BY_DTYPE = {torch.float32: "flash_attention_bwd_f32",
                    torch.bfloat16: "flash_attention_bwd_bf16"}
_INT32_MAX = 2**31 - 1


def _shapes(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, H, D) tensors, got shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={b}, Skv, KVH, D={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} q heads cannot be grouped over {kvh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return b, sq, h, d, k.shape[1], kvh


def _mask(n: int, skv: int, q0: int, causal: bool, window, device):
    """(n, skv) bool: which keys the q rows ``q0 .. q0 + n - 1`` (absolute
    positions) see."""
    q_pos = q0 + torch.arange(n, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((n, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0, scale: float | None = None,
                          return_lse: bool = False, name: str | None = None):
    """The plain version: per block of ``_Q_CHUNK`` q rows, dense fp32 scores,
    masked, ``p = exp(s - max)`` with masked entries exactly 0, ``o = p v /
    max(sum p, 1e-30)``.  ``name`` is the wrapper's and is not used here."""
    b, sq, h, d, skv, kvh = _shapes(q, k, v, window)
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for s0 in range(0, sq, _Q_CHUNK):
        qc = q[:, s0:s0 + _Q_CHUNK].float() * scale
        n = qc.shape[1]
        logits = torch.einsum("bqcgd,bkcd->bcgqk", qc.reshape(b, n, kvh, g, d), kf)
        mask = _mask(n, skv, q_offset + s0, causal, window, dev)
        logits = torch.where(mask, logits, _NEG)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bcgqk,bkcd->bqcgd", p, vf) / safe.permute(0, 3, 1, 2, 4)
        outs.append(o.reshape(b, n, h, d).to(q.dtype))
        if return_lse:
            lse = (m + torch.log(safe))[..., 0]                    # (B, KVH, G, n)
            lses.append(lse.permute(0, 3, 1, 2).reshape(b, n, h))
    out = torch.cat(outs, dim=1) if outs else q.new_empty(q.shape)
    if return_lse:
        lse = torch.cat(lses, dim=1) if lses else q.new_empty((b, sq, h), dtype=torch.float32)
        return out, lse
    return out


def flash_attention_bwd_torch(q, k, v, out, lse, d_out, *, causal: bool = True,
                              window: int | None = None, q_offset: int = 0,
                              scale: float | None = None, chunk: int = _BWD_CHUNK):
    """The plain backward, the reference's ``_flash_bwd`` per block of
    ``chunk`` q rows: ``delta = sum(dO O)``, the scores recomputed,
    ``p = exp(s - lse)`` with masked entries exactly 0, ``dv += p^T dO``,
    ``ds = p (dO v^T - delta)``, ``dq = scale ds k``, ``dk += ds^T (scale q)``.
    Returns ``(dq, dk, dv)`` in the input types."""
    b, sq, h, d, skv, kvh = _shapes(q, k, v, window)
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    delta = (d_out.float() * out.float()).sum(-1)                    # (B, Sq, H)
    kf, vf = k.float(), v.float()
    dk = torch.zeros((b, skv, kvh, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dqs = []
    for s0 in range(0, sq, chunk):
        qg = (q[:, s0:s0 + chunk].float() * scale)
        n = qg.shape[1]
        qg = qg.reshape(b, n, kvh, g, d)
        s = torch.einsum("bqcgd,bkcd->bcgqk", qg, kf)
        mask = _mask(n, skv, q_offset + s0, causal, window, dev)
        lse_g = lse[:, s0:s0 + n].reshape(b, n, kvh, g).permute(0, 2, 3, 1)
        p = torch.where(mask, torch.exp(s - lse_g[..., None]), 0.0)
        do_g = d_out[:, s0:s0 + n].float().reshape(b, n, kvh, g, d)
        dv += torch.einsum("bcgqk,bqcgd->bkcd", p, do_g)
        dp = torch.einsum("bqcgd,bkcd->bcgqk", do_g, vf)
        del_g = delta[:, s0:s0 + n].reshape(b, n, kvh, g).permute(0, 2, 3, 1)
        ds = p * (dp - del_g[..., None])
        dqs.append(scale * torch.einsum("bcgqk,bkcd->bqcgd", ds, kf).reshape(b, n, h, d))
        dk += torch.einsum("bcgqk,bqcgd->bkcd", ds, qg)
    dq = torch.cat(dqs, dim=1) if dqs else torch.zeros_like(q, dtype=torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _c_fn(dtype: torch.dtype):
    from . import _build

    fn = getattr(_build.load("flash_attention"), _FN_BY_DTYPE[dtype])
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, p, p, p] + [ll] * 9 + [i] * 9 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(q, k, v, causal, window, q_offset, scale, return_lse):
    b, sq, h, d, skv, kvh = _shapes(q, k, v, window)
    dev = q.device
    if q.dtype not in _FN_BY_DTYPE:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride along head_dim")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}: the kernel keeps at most "
                         f"{MAX_HEAD_DIM} accumulator columns per q row")
    if skv == 0:
        raise ValueError("k and v have no rows")
    if max(sq, skv, abs(q_offset) + sq + skv) > _INT32_MAX // 2:
        raise ValueError("sequence lengths and q_offset must fit the kernel's int32 positions")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel():
        fn = _c_fn(q.dtype)
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     b, sq, skv, h, kvh, d, int(causal),
                     0 if window is None else int(window), int(q_offset), float(scale),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


def _c_bwd_fn(dtype: torch.dtype):
    from . import _build

    fn = getattr(_build.load("flash_attention_bwd"), _BWD_FN_BY_DTYPE[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i] * 9 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd_cuda(q, k, v, out, lse, d_out, causal, window, q_offset, scale):
    b, sq, h, d, skv, kvh = _shapes(q, k, v, window)
    dev = q.device
    if q.dtype not in _BWD_FN_BY_DTYPE:
        raise TypeError(f"the flash-attention backward takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out), ("d_out", d_out)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out), ("lse", lse), ("d_out", d_out)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if out.shape != q.shape or d_out.shape != q.shape or tuple(lse.shape) != (b, sq, h):
        raise ValueError(f"out / d_out must be {tuple(q.shape)} and lse {(b, sq, h)}, got "
                         f"{tuple(out.shape)}, {tuple(d_out.shape)}, {tuple(lse.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    if skv == 0:
        raise ValueError("k and v have no rows")
    if max(sq, skv, abs(q_offset) + sq + skv) > _INT32_MAX // 2 or b > 65535 or h > 65535:
        raise ValueError("shape or q_offset exceeds the kernel's int32 positions / grid")
    # the kernel indexes dense (B, S, H, D) rows
    q, k, v, out, d_out = (t.contiguous() for t in (q, k, v, out, d_out))
    lse = lse.to(torch.float32).contiguous()
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        delta = torch.empty((b, sq, h), dtype=torch.float32, device=dev)
        part = torch.empty((2, b, skv, h, d), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _c_bwd_fn(q.dtype)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh, d,
                int(causal), 0 if window is None else int(window), int(q_offset),
                float(scale), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        scale: float | None = None):
    """``(dq, dk, dv)`` of attention from the forward's ``out`` and fp32
    ``lse`` and the output gradient ``d_out``: the CUDA kernel for CUDA
    tensors (asynchronous, on the current stream), the plain version for CPU
    tensors."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    return _backward(q, k, v, out, lse, d_out, causal, window, q_offset, scale,
                     q.device.type == "cpu")


flash_attention_bwd.launches = 0  # kernel launches made through this wrapper


def _forward(q, k, v, causal, window, q_offset, scale, plain: bool, return_lse: bool):
    """The forward on its one route: the custom op for a fake tensor
    (:mod:`.fake`), the plain version if ``plain``, else the kernel."""
    if is_fake(q):
        out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, window or 0, q_offset, scale)
        return (out, lse) if return_lse else out
    if plain:
        return flash_attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                     scale=scale, return_lse=return_lse)
    return _launch_cuda(q, k, v, causal, window, q_offset, scale, return_lse)


def _backward(q, k, v, out, lse, d_out, causal, window, q_offset, scale, plain: bool):
    """``(dq, dk, dv)`` on the forward's route (:func:`_forward`)."""
    if is_fake(q):
        return torch.ops.repro_torch.flash_bwd(q, k, v, out, lse, d_out, causal, window or 0,
                                               q_offset, scale)
    if plain:
        return flash_attention_bwd_torch(q, k, v, out, lse, d_out, causal=causal,
                                         window=window, q_offset=q_offset, scale=scale)
    return _launch_bwd_cuda(q, k, v, out, lse, d_out, causal, window, q_offset, scale)


class _Flash(torch.autograd.Function):
    """Attention with the hand-written backward (``plain``: the plain versions
    of both, on any device).  ``name`` is the output's activation class for a
    residency plan's keeper (:mod:`.replay`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, plain, name):
        keeper = replay.current() if name else None
        key = keeper.key(name) if keeper is not None else None
        held = keeper.lookup(key) if keeper is not None else None
        if held is not None:
            out, lse = held
        else:
            out, lse = _forward(q, k, v, causal, window, q_offset, scale, plain, True)
            if keeper is not None:
                keeper.keep(key, (out, lse))
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, scale, plain)
        ctx.keeper, ctx.key = keeper, key
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale, plain = ctx.args
        if ctx.keeper is not None:
            ctx.keeper.release(ctx.key)
        if d_out is None:
            return (None,) * 9
        dq, dk, dv = _backward(q, k, v, out, lse, d_out, causal, window, q_offset, scale, plain)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_torch_grad(q, k, v, *, causal: bool = True, window: int | None = None,
                               q_offset: int = 0, scale: float | None = None,
                               return_lse: bool = False, name: str | None = None):
    """The plain versions of the forward and of the backward as one
    differentiable function, on any device: what :func:`flash_attention`
    runs for CPU tensors.  The port routes no CUDA tensor here; a comparison
    of the kernels with their plain versions on the card does."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = _Flash.apply(q, k, v, causal, window, q_offset, scale, True, None)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0, bias=None, scale: float | None = None,
                    return_lse: bool = False, name: str | None = None):
    """Attention over ``q (B, Sq, H, D)``, ``k``/``v (B, Skv, KVH, D)``: the
    CUDA kernel for CUDA tensors (asynchronous, on the current stream), the
    plain version for CPU tensors.  ``scale`` defaults to ``D ** -0.5``.  The
    reference's learned ``bias`` is not ported (no architecture of the port
    uses it) and raises.  When q, k or v requires a gradient the call is
    differentiable, its backward :func:`flash_attention_bwd`; ``name`` is
    then the output's activation class for a residency plan."""
    if bias is not None:
        raise NotImplementedError("flash_attention: a learned bias is not ported")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _Flash.apply(q, k, v, causal, window, q_offset, scale,
                                q.device.type == "cpu", name)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, causal, window, q_offset, scale, q.device.type == "cpu",
                    return_lse)


flash_attention.launches = 0  # kernel launches made through this wrapper
