"""The MoE's sparse top-k dispatch: order the (token, slot) pairs by expert,
gather the rows, run each expert's products on its own rows, and combine.

None replaces a TPU kernel: the reference dispatches densely (every expert
on every token, ``src/repro/models/blocks.py`` ``moe``), which XLA lowers to
einsums.  On the card that dense dispatch computed ``E / k`` times the
routed work (4x for granite-moe-1b-a400m) and kept ``(B, S, E, .)``
activations; these kernels compute the routed pairs only.

* :func:`moe_order` — a stable sort of the flattened expert ids gives each
  permuted row its token (``token_of_row``), each pair its row
  (``row_of_pair``) and each expert its first row (``offsets``, ``E + 1``
  int32 on the device).  No value goes to the host: the kernels read the
  offsets on the device and the host sizes each grid from shapes alone.
* :func:`moe_permute` — ``xs[r] = x[token_of_row[r]]``; its backward
  (:func:`moe_permute_bwd`) sums each token's ``k`` rows in fp32 in slot
  order.
* :func:`grouped_mm` — ``out[rows of e] = a[rows of e] @ w[e]`` for ``w (E,
  K, N)`` read through its strides, or ``@ [w[e] | w2[e]]`` (the gate and
  up products as one, the two weights never joined in memory); its
  backward is the same product with ``w[e]^T`` (joined along the depth) for
  the rows and :func:`grouped_mm_wgrad` (``a_e^T g_e``, each expert's rows
  summed in order, zeros for an expert with none) for the weights.
* :func:`moe_swiglu` — ``silu(g) u`` of the gate and up products ``[g |
  u]``, in fp32, rounded once; its backward (:func:`moe_swiglu_bwd`) writes
  ``[dg | du]`` for that product's backward.
* :func:`moe_combine` — ``out[t] = sum_j gate[t, j] y[row_of_pair[t, j]]``
  in fp32 in slot order, stored in ``y``'s type; its backward
  (:func:`moe_combine_bwd`) gives the rows' gradients ``gate dout`` and the
  gates' ``<dout, y_row>``.

Each wrapper takes one route per device.  For CUDA tensors (bf16 rows and
weights, fp32 gates, int32 indices; any other type raises) it launches a
kernel and counts the launch in its ``launches``: the grouped products, the
order and the gather are CUDA C++ (``csrc/moe_dispatch.cu``, the products on
wgmma), the elementwise passes and the slot sums Triton
(:mod:`.moe_dispatch_tl`).  For CPU tensors it runs the plain version beside
it (``*_torch``), which repeats the arithmetic in the input type.  No kernel
uses atomics, so two runs give the same bits.  When an input requires a
gradient the forward wrappers run through autograd functions whose
backwards are the backward wrappers.  What bounds each kernel is in its
source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = ["Order", "moe_order", "moe_permute", "moe_permute_bwd", "grouped_mm",
           "grouped_mm_wgrad", "moe_swiglu", "moe_swiglu_bwd", "moe_combine", "moe_combine_bwd",
           "moe_order_torch", "moe_permute_torch", "moe_permute_bwd_torch", "grouped_mm_torch",
           "grouped_mm_wgrad_torch", "moe_swiglu_torch", "moe_swiglu_bwd_torch",
           "moe_combine_torch", "moe_combine_bwd_torch", "GEMM_TILES", "MM_TILE",
           "WGRAD_TILE"]

# the grouped products' tiles (``csrc/moe_dispatch.cu``): 128 rows by 128 or
# 256 columns, a ring of four 64-deep stages
GEMM_TILES = {0: "BN 128", 1: "BN 256"}
MM_TILE = 1      # grouped_gemm_kernel's
WGRAD_TILE = 1   # grouped_gemm_wgrad_kernel's
_ROWS_BLOCK, _COLS_BLOCK = 16, 256   # the Triton row kernels' (rows or tokens, columns) a step


class Order(NamedTuple):
    """The pairs in expert order: ``token_of_row (R,)``, ``row_of_pair (N, k)``
    and ``offsets (E + 1,)``, all int32 on the ids' device (R = N k)."""
    token_of_row: torch.Tensor
    row_of_pair: torch.Tensor
    offsets: torch.Tensor


def moe_order(top_i: torch.Tensor, n_experts: int) -> Order:
    """The :class:`Order` of ``top_i (N, k)`` expert ids: rows sorted by
    expert, the pairs of one expert in (token, slot) order (a stable sort).
    For CUDA ids a stable sort of the ids as int16, then one kernel writes
    the three index tensors; for CPU ids :func:`moe_order_torch`."""
    if _plain(top_i):
        return moe_order_torch(top_i, n_experts)
    return _launch_order(top_i, n_experts)


moe_order.launches = 0  # kernel launches made through this wrapper


# -- the plain versions ------------------------------------------------------


def moe_order_torch(top_i: torch.Tensor, n_experts: int) -> Order:
    """:func:`moe_order` in PyTorch ops (a stable sort of the ids, the
    experts' first rows by a search in the sorted ids, the pairs' rows by a
    scatter); no value read back to the host."""
    n, k = top_i.shape
    flat = top_i.reshape(-1)
    ids, perm = torch.sort(flat, stable=True)
    experts = torch.arange(n_experts + 1, device=flat.device, dtype=ids.dtype)
    offsets = torch.searchsorted(ids, experts).to(torch.int32)
    rows = torch.arange(n * k, device=flat.device, dtype=perm.dtype)
    row_of_pair = torch.empty_like(perm).scatter_(0, perm, rows)
    return Order(torch.div(perm, k, rounding_mode="floor").to(torch.int32),
                 row_of_pair.to(torch.int32).reshape(n, k), offsets)


def moe_permute_torch(x: torch.Tensor, token_of_row: torch.Tensor) -> torch.Tensor:
    """``x[token_of_row]``: the rows in expert order."""
    return x[token_of_row.long()]


def moe_permute_bwd_torch(dxs: torch.Tensor, row_of_pair: torch.Tensor) -> torch.Tensor:
    """Each token's ``k`` rows' gradients summed in fp32 in slot order."""
    idx = row_of_pair.long()
    acc = torch.zeros((idx.shape[0], dxs.shape[1]), dtype=torch.float32, device=dxs.device)
    for j in range(idx.shape[1]):
        acc += dxs[idx[:, j]].float()
    return acc.to(dxs.dtype)


def grouped_mm_torch(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                     w2: torch.Tensor | None = None) -> torch.Tensor:
    """``a[lo:hi] @ w[e]`` (``[w[e] | w2[e]]`` with ``w2``) for each
    expert's rows ``lo:hi`` (``offsets`` read on the host)."""
    if w2 is not None:
        w = torch.cat([w, w2], dim=2)
    out = a.new_zeros((a.shape[0], w.shape[2]))
    off = offsets.tolist()
    for e in range(w.shape[0]):
        if off[e + 1] > off[e]:
            out[off[e]:off[e + 1]] = a[off[e]:off[e + 1]] @ w[e]
    return out


def grouped_mm_wgrad_torch(a: torch.Tensor, g: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """``a[lo:hi]^T @ g[lo:hi]`` for each expert, ``(E, K, N)`` in ``a``'s
    type; zeros for an expert with no rows."""
    off = offsets.tolist()
    out = torch.zeros((len(off) - 1, a.shape[1], g.shape[1]), dtype=a.dtype, device=a.device)
    for e in range(len(off) - 1):
        if off[e + 1] > off[e]:
            out[e] = (a[off[e]:off[e + 1]].t() @ g[off[e]:off[e + 1]]).to(out.dtype)
    return out


def moe_swiglu_torch(gu: torch.Tensor) -> torch.Tensor:
    """``silu(g) u`` of ``gu = [g | u] (R, 2F)`` in fp32, rounded once to
    ``gu``'s type."""
    g, u = gu.float().chunk(2, dim=1)
    return (g * torch.sigmoid(g) * u).to(gu.dtype)


def moe_swiglu_bwd_torch(gu: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
    """``[dg | du]`` of :func:`moe_swiglu_torch` from ``dh (R, F)``, in fp32,
    rounded once to ``gu``'s type."""
    g, u = gu.float().chunk(2, dim=1)
    s, d = torch.sigmoid(g), dh.float()
    return torch.cat([d * u * (s + g * s * (1.0 - s)), d * g * s], dim=1).to(gu.dtype)


def moe_combine_torch(y: torch.Tensor, gate: torch.Tensor,
                      row_of_pair: torch.Tensor) -> torch.Tensor:
    """``sum_j gate[:, j] y[row_of_pair[:, j]]`` in fp32, in slot order."""
    idx = row_of_pair.long()
    acc = torch.zeros((idx.shape[0], y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(idx.shape[1]):
        acc += gate[:, j, None].float() * y[idx[:, j]].float()
    return acc.to(y.dtype)


def moe_combine_bwd_torch(dout: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                          row_of_pair: torch.Tensor):
    """``(dy, dgate)``: each row's gradient ``gate dout`` in ``y``'s type and
    each gate's ``<dout, y_row>`` in fp32."""
    idx = row_of_pair.long()
    dy = torch.zeros_like(y)
    dgate = torch.empty(idx.shape, dtype=torch.float32, device=y.device)
    do = dout.float()
    for j in range(idx.shape[1]):
        dy[idx[:, j]] = (gate[:, j, None].float() * do).to(y.dtype)
        dgate[:, j] = (do * y[idx[:, j]].float()).sum(-1)
    return dy, dgate


# -- the kernels' launchers --------------------------------------------------


def _tl():
    from . import moe_dispatch_tl

    return moe_dispatch_tl


_ARGTYPES = {
    "moe_grouped_gemm_bf16": "pLppLLLiipLpiiiiip",
    "moe_grouped_wgrad_bf16": "pLpLppLLipiiiip",
    "moe_order": "pppppiiip",
    "moe_permute_bf16": "pppiip",
}


@functools.cache
def _c_fn(name: str):
    """The library's entry ``name`` with its argument types (once a process)."""
    from . import _build

    fn = getattr(_build.load("moe_dispatch"), name)
    kinds = {"p": ctypes.c_void_p, "L": ctypes.c_longlong, "i": ctypes.c_int}
    fn.argtypes = [kinds[c] for c in _ARGTYPES[name]]
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = _c_fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int, dev) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on the card, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got shape {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _eights(**dims) -> None:
    odd = {k: v for k, v in dims.items() if v % 8}
    if odd:
        raise ValueError(f"the grouped products move 16-byte chunks: {odd} must be multiples of 8")


def _launch_order(top_i, n_experts):
    dev = top_i.device
    if top_i.dtype != torch.int64 or top_i.dim() != 2:
        raise TypeError(f"top_i must be (N, k) int64, got {top_i.dtype} {tuple(top_i.shape)}")
    if n_experts > torch.iinfo(torch.int16).max:
        raise ValueError(f"{n_experts} experts: the ids are sorted as int16")
    n, k = top_i.shape
    r = n * k
    ids, perm = torch.sort(top_i.reshape(-1).to(torch.int16), stable=True)
    tok = torch.empty(r, dtype=torch.int32, device=dev)
    rop = torch.empty(r, dtype=torch.int32, device=dev)
    off = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    if r:
        _call("moe_order", dev, ids.data_ptr(), perm.data_ptr(), tok.data_ptr(), rop.data_ptr(),
              off.data_ptr(), r, n_experts, k)
        moe_order.launches += 1
    else:
        off.zero_()
    return Order(tok, rop.reshape(n, k), off)


def _launch_permute(x, token_of_row):
    dev = x.device
    _check("x", x, torch.bfloat16, 2, dev)
    _check("token_of_row", token_of_row, torch.int32, 1, dev)
    _eights(d=x.shape[1])
    x, tok = x.contiguous(), token_of_row.contiguous()
    r, d = tok.shape[0], x.shape[1]
    out = torch.empty((r, d), dtype=x.dtype, device=dev)
    if out.numel():
        _call("moe_permute_bf16", dev, x.data_ptr(), tok.data_ptr(), out.data_ptr(), r, d)
        moe_permute.launches += 1
    return out


def _launch_grouped_mm(a, offsets, w, w2=None, along="n"):
    """``a @ B[e]`` per expert, ``B = w`` or ``w`` and ``w2`` joined
    ``along`` the columns ("n") or the depth ("k")."""
    dev = a.device
    _check("a", a, torch.bfloat16, 2, dev)
    _check("w", w, torch.bfloat16, 3, dev)
    _check("offsets", offsets, torch.int32, 1, dev)
    if w2 is not None:
        _check("w2", w2, torch.bfloat16, 3, dev)
        if w2.shape != w.shape or w2.stride() != w.stride():
            raise ValueError(f"w {tuple(w.shape)} {w.stride()} and w2 {tuple(w2.shape)} "
                             f"{w2.stride()} differ")
    if 1 not in w.stride()[1:]:
        w, w2 = w.contiguous(), None if w2 is None else w2.contiguous()
    e, k, n = w.shape
    split = k if along == "k" else n
    if w2 is not None:
        k, n = (2 * k, n) if along == "k" else (k, 2 * n)
    if a.shape[1] != k or offsets.shape[0] != e + 1:
        raise ValueError(f"a {tuple(a.shape)}, B ({e}, {k}, {n}) and offsets "
                         f"{tuple(offsets.shape)} do not fit (a: (R, K), offsets: (E + 1,))")
    _eights(k=k, n=n, split=split)
    a, offsets = a.contiguous(), offsets.contiguous()
    out = torch.empty((a.shape[0], n), dtype=a.dtype, device=dev)
    if out.numel():
        _call("moe_grouped_gemm_bf16", dev, a.data_ptr(), a.stride(0), w.data_ptr(),
              (w if w2 is None else w2).data_ptr(), *w.stride(), split, int(along == "k"),
              out.data_ptr(), out.stride(0), offsets.data_ptr(), a.shape[0], e, n, k, MM_TILE)
        grouped_mm.launches += 1
    return out


def _launch_wgrad(a, g, offsets, split=None):
    dev = a.device
    _check("a", a, torch.bfloat16, 2, dev)
    _check("g", g, torch.bfloat16, 2, dev)
    _check("offsets", offsets, torch.int32, 1, dev)
    if g.shape[0] != a.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and g {tuple(g.shape)} have other row counts")
    a, g, offsets = a.contiguous(), g.contiguous(), offsets.contiguous()
    e, m, n = offsets.shape[0] - 1, a.shape[1], g.shape[1]
    _eights(k=m, n=n, split=n if split is None else split)
    if split is None:
        w0 = w1 = torch.empty((e, m, n), dtype=a.dtype, device=dev)
        split = n
    else:
        if 2 * split != n:
            raise ValueError(f"split {split} does not halve g's {n} columns")
        w0 = torch.empty((e, m, split), dtype=a.dtype, device=dev)
        w1 = torch.empty((e, m, split), dtype=a.dtype, device=dev)
    if w0.numel():
        _call("moe_grouped_wgrad_bf16", dev, a.data_ptr(), a.stride(0), g.data_ptr(),
              g.stride(0), w0.data_ptr(), w1.data_ptr(), w0.stride(0), w0.stride(1), split,
              offsets.data_ptr(), e, m, n, WGRAD_TILE)
        grouped_mm_wgrad.launches += 1
    return w0 if w0 is w1 else (w0, w1)


def _launch_swiglu(gu):
    dev = gu.device
    _check("gu", gu, torch.bfloat16, 2, dev)
    if gu.shape[1] % 2:
        raise ValueError(f"gu must be [g | u] (R, 2F), got {tuple(gu.shape)}")
    gu = gu.contiguous()
    r, f = gu.shape[0], gu.shape[1] // 2
    h = torch.empty((r, f), dtype=gu.dtype, device=dev)
    if h.numel():
        _tl().swiglu_kernel[(-(-r // _ROWS_BLOCK),)](
            gu, h, r, F=f, BR=_ROWS_BLOCK, BF=min(_COLS_BLOCK, _pow2(f)))
        moe_swiglu.launches += 1
    return h


def _launch_swiglu_bwd(gu, dh):
    dev = gu.device
    _check("gu", gu, torch.bfloat16, 2, dev)
    _check("dh", dh, torch.bfloat16, 2, dev)
    if gu.shape != (dh.shape[0], 2 * dh.shape[1]):
        raise ValueError(f"gu {tuple(gu.shape)} is not [g | u] of dh {tuple(dh.shape)}")
    gu, dh = gu.contiguous(), dh.contiguous()
    r, f = dh.shape
    dgu = torch.empty_like(gu)
    if dgu.numel():
        _tl().swiglu_bwd_kernel[(-(-r // _ROWS_BLOCK),)](
            gu, dh, dgu, r, F=f, BR=_ROWS_BLOCK, BF=min(_COLS_BLOCK, _pow2(f)))
        moe_swiglu_bwd.launches += 1
    return dgu


def _launch_permute_bwd(dxs, row_of_pair):
    dev = dxs.device
    _check("dxs", dxs, torch.bfloat16, 2, dev)
    _check("row_of_pair", row_of_pair, torch.int32, 2, dev)
    dxs, idx = dxs.contiguous(), row_of_pair.contiguous()
    (t, k), d = idx.shape, dxs.shape[1]
    if dxs.shape[0] != t * k:
        raise ValueError(f"dxs has {dxs.shape[0]} rows, row_of_pair {t} x {k} pairs")
    out = torch.empty((t, d), dtype=dxs.dtype, device=dev)
    if out.numel():
        _tl().gather_sum_kernel[(-(-t // _ROWS_BLOCK),)](
            dxs, idx, out, t, D=d, KS=k, BT=_ROWS_BLOCK, BD=min(_COLS_BLOCK, _pow2(d)))
        moe_permute_bwd.launches += 1
    return out


def _launch_combine(y, gate, row_of_pair):
    dev = y.device
    _check("y", y, torch.bfloat16, 2, dev)
    _check("gate", gate, torch.float32, 2, dev)
    _check("row_of_pair", row_of_pair, torch.int32, 2, dev)
    if gate.shape != row_of_pair.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and row_of_pair "
                         f"{tuple(row_of_pair.shape)} differ")
    y, gate, idx = y.contiguous(), gate.contiguous(), row_of_pair.contiguous()
    (t, k), d = idx.shape, y.shape[1]
    if y.shape[0] != t * k:
        raise ValueError(f"y has {y.shape[0]} rows, row_of_pair {t} x {k} pairs")
    out = torch.empty((t, d), dtype=y.dtype, device=dev)
    if out.numel():
        _tl().combine_kernel[(-(-t // _ROWS_BLOCK),)](
            y, gate, idx, out, t, D=d, KS=k, BT=_ROWS_BLOCK, BD=min(_COLS_BLOCK, _pow2(d)))
        moe_combine.launches += 1
    return out


def _launch_combine_bwd(dout, y, gate, row_of_pair):
    dev = y.device
    _check("dout", dout, torch.bfloat16, 2, dev)
    _check("y", y, torch.bfloat16, 2, dev)
    _check("gate", gate, torch.float32, 2, dev)
    _check("row_of_pair", row_of_pair, torch.int32, 2, dev)
    dout, y, gate, idx = (t.contiguous() for t in (dout, y, gate, row_of_pair))
    (t, k), d = idx.shape, y.shape[1]
    if dout.shape != (t, d) or gate.shape != (t, k) or y.shape[0] != t * k:
        raise ValueError(f"dout {tuple(dout.shape)}, y {tuple(y.shape)} and gate "
                         f"{tuple(gate.shape)} do not fit row_of_pair {(t, k)}")
    dy = torch.empty_like(y)
    dgate = torch.empty((t, k), dtype=torch.float32, device=dev)
    if dy.numel():
        _tl().combine_bwd_kernel[(-(-t // _ROWS_BLOCK),)](
            dout, y, gate, idx, dy, dgate, t, D=d, KS=k, BT=_ROWS_BLOCK,
            BD=min(_COLS_BLOCK, _pow2(d)))
        moe_combine_bwd.launches += 1
    return dy, dgate


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# -- the wrappers ------------------------------------------------------------


def _plain(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the MoE dispatch runs on cuda or cpu tensors, got {t.device}")
    return t.device.type == "cpu"


def moe_permute_bwd(dxs: torch.Tensor, row_of_pair: torch.Tensor) -> torch.Tensor:
    """The gradient of the tokens from their rows' (:func:`moe_permute`)."""
    if _plain(dxs):
        return moe_permute_bwd_torch(dxs, row_of_pair)
    return _launch_permute_bwd(dxs, row_of_pair)


moe_permute_bwd.launches = 0  # kernel launches made through this wrapper


def grouped_mm_wgrad(a: torch.Tensor, g: torch.Tensor, offsets: torch.Tensor,
                     split: int | None = None):
    """``(E, K, N)``: each expert's ``a_e^T g_e`` in ``a``'s type; with
    ``split``, its columns below and from ``split`` (half of N) as two
    tensors."""
    if not _plain(a):
        return _launch_wgrad(a, g, offsets, split)
    w = grouped_mm_wgrad_torch(a, g, offsets)
    return w if split is None else (w[..., :split].contiguous(), w[..., split:].contiguous())


grouped_mm_wgrad.launches = 0  # kernel launches made through this wrapper


def moe_combine_bwd(dout: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                    row_of_pair: torch.Tensor):
    """``(dy, dgate)`` of :func:`moe_combine`."""
    if _plain(y):
        return moe_combine_bwd_torch(dout, y, gate, row_of_pair)
    return _launch_combine_bwd(dout, y, gate, row_of_pair)


moe_combine_bwd.launches = 0  # kernel launches made through this wrapper


def moe_swiglu_bwd(gu: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
    """``[dg | du]`` of :func:`moe_swiglu`."""
    if _plain(gu):
        return moe_swiglu_bwd_torch(gu, dh)
    return _launch_swiglu_bwd(gu, dh)


moe_swiglu_bwd.launches = 0  # kernel launches made through this wrapper


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gu):
        ctx.save_for_backward(gu)
        if _plain(gu):
            return moe_swiglu_torch(gu)
        return _launch_swiglu(gu)

    @staticmethod
    def backward(ctx, dh):
        (gu,) = ctx.saved_tensors
        return moe_swiglu_bwd(gu, dh)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token_of_row, row_of_pair):
        ctx.save_for_backward(row_of_pair)
        if _plain(x):
            return moe_permute_torch(x, token_of_row)
        return _launch_permute(x, token_of_row)

    @staticmethod
    def backward(ctx, dxs):
        (row_of_pair,) = ctx.saved_tensors
        return moe_permute_bwd(dxs, row_of_pair), None, None


def _rows(a, offsets, w, w2, along):
    """``a @ B[e]`` per expert, ``B = w`` or ``w`` and ``w2`` joined
    ``along`` the columns ("n") or the depth ("k")."""
    if not _plain(a):
        return _launch_grouped_mm(a, offsets, w, w2, along)
    if w2 is not None:
        w = torch.cat([w, w2], dim=2 if along == "n" else 1)
    return grouped_mm_torch(a, w, offsets)


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, offsets, w, w2):
        ctx.save_for_backward(a, offsets, w, w2)
        return _rows(a, offsets, w, w2, "n")

    @staticmethod
    def backward(ctx, g):
        a, offsets, w, w2 = ctx.saved_tensors
        da = dw = dw2 = None
        if ctx.needs_input_grad[0]:
            da = _rows(g, offsets, w.transpose(1, 2),
                       None if w2 is None else w2.transpose(1, 2), "k")
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            if w2 is None:
                dw = grouped_mm_wgrad(a, g, offsets)
            else:
                dw, dw2 = grouped_mm_wgrad(a, g, offsets, w.shape[2])
        return da, None, dw, dw2


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, gate, row_of_pair):
        ctx.save_for_backward(y, gate, row_of_pair)
        if _plain(y):
            return moe_combine_torch(y, gate, row_of_pair)
        return _launch_combine(y, gate, row_of_pair)

    @staticmethod
    def backward(ctx, dout):
        y, gate, row_of_pair = ctx.saved_tensors
        dy, dgate = moe_combine_bwd(dout, y, gate, row_of_pair)
        return dy, dgate, None


def moe_permute(x: torch.Tensor, order: Order) -> torch.Tensor:
    """``x (N, D)``'s rows in expert order, ``(N k, D)``."""
    return _Permute.apply(x, order.token_of_row, order.row_of_pair)


moe_permute.launches = 0  # kernel launches made through this wrapper


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
               w2: torch.Tensor | None = None) -> torch.Tensor:
    """``a (R, K)``, rows in expert order (``offsets (E + 1,)``: ``offsets[0]
    = 0``, ``offsets[E] = R``), times ``w (E, K, N)``: ``(R, N)``; with
    ``w2`` (``w``'s shape), times ``[w | w2]``: ``(R, 2N)``, neither weight
    copied.  The launches of its backward's row product count here too."""
    return _GroupedMM.apply(a, offsets, w, w2)


grouped_mm.launches = 0  # kernel launches made through this wrapper


def moe_swiglu(gu: torch.Tensor) -> torch.Tensor:
    """``silu(g) u`` of ``gu = [g | u] (R, 2F)``, the gate and up products of
    one launch: ``(R, F)``, computed in fp32 and rounded once."""
    return _SwiGLU.apply(gu)


moe_swiglu.launches = 0  # kernel launches made through this wrapper


def moe_combine(y: torch.Tensor, gate: torch.Tensor, order: Order) -> torch.Tensor:
    """``(N, D)``: each token's ``k`` rows of ``y (N k, D)`` weighted by its
    fp32 ``gate (N, k)``."""
    return _Combine.apply(y, gate, order.row_of_pair)


moe_combine.launches = 0  # kernel launches made through this wrapper
