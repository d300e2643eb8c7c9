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

Layout (the reference's): ``q (B, Sq, H, D)``, ``k``/``v (B, Skv, KVH, D)``;
head ``h`` reads kv head ``h // (H / KVH)``.  Masking: causal keeps
``k_pos <= q_pos``, a window keeps ``k_pos > q_pos - window``, with
``q_pos = q_offset + row``.  A row that sees no key gives zeros (and lse
-1e30), as the TPU kernel does.  Returns the output in the input type and,
with ``return_lse``, the fp32 log-sum-exp ``(B, Sq, H)``.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention", "flash_attention_torch", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_NEG = -1e30
_Q_CHUNK = 1024   # q rows per dense score block of the plain version
_FN_BY_DTYPE = {torch.float32: "flash_attention_fwd_f32",
                torch.bfloat16: "flash_attention_fwd_bf16"}
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


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0, scale: float | None = None,
                          return_lse: bool = False):
    """The plain version: per block of ``_Q_CHUNK`` q rows, dense fp32 scores,
    masked, ``p = exp(s - max)`` with masked entries exactly 0, ``o = p v /
    max(sum p, 1e-30)``."""
    b, sq, h, d, skv, kvh = _shapes(q, k, v, window)
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(skv, device=dev)[None, :]
    outs, lses = [], []
    for s0 in range(0, sq, _Q_CHUNK):
        qc = q[:, s0:s0 + _Q_CHUNK].float() * scale
        n = qc.shape[1]
        logits = torch.einsum("bqcgd,bkcd->bcgqk", qc.reshape(b, n, kvh, g, d), kf)
        q_pos = q_offset + s0 + torch.arange(n, device=dev)[:, None]
        mask = torch.ones((n, skv), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
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


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0, bias=None, scale: float | None = None,
                    return_lse: bool = False):
    """Attention over ``q (B, Sq, H, D)``, ``k``/``v (B, Skv, KVH, D)``: the
    CUDA kernel for CUDA tensors (asynchronous, on the current stream), the
    plain version for CPU tensors.  ``scale`` defaults to ``D ** -0.5``.  The
    reference's learned ``bias`` is not ported (no architecture of the port
    uses it) and raises."""
    if bias is not None:
        raise NotImplementedError("flash_attention: a learned bias is not ported")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _launch_cuda(q, k, v, causal, window, q_offset, scale, return_lse)


flash_attention.launches = 0  # kernel launches made through this wrapper
