"""The Triton kernels of the MoE's sparse dispatch (:mod:`.moe_dispatch`).

Imported only by :mod:`.moe_dispatch`'s launchers, at the first launch on a
CUDA tensor: this module imports ``triton``, which a machine without a card
need not have.  Triton's cache goes to ``triton/`` under the build directory
(:func:`._build.build_dir`) unless ``TRITON_CACHE_DIR`` names another.

The elementwise passes and the slot sums of the sparse dispatch; its
grouped products, order and gather are CUDA C++ (``csrc/moe_dispatch.cu``).
The rows of expert ``e`` are ``off[e] .. off[e + 1] - 1`` of the permuted
tensors.  No kernel uses atomics, and every sum runs in a fixed order, so
two runs give the same bits.

* :func:`swiglu_kernel` / :func:`swiglu_bwd_kernel` — ``H = silu(G) U`` of
  ``GU = [G | U]`` and its backward ``[dG | dU]``, in fp32, rounded once.
  Bound: bytes.
* :func:`gather_sum_kernel` — ``DX[t] = sum_j DY[idx[t, j]]`` in fp32, in
  slot order: the permutation's backward.  Bound: bytes.
* :func:`combine_kernel` — ``OUT[t] = sum_j gate[t, j] Y[idx[t, j]]`` in
  fp32, in slot order, stored in ``OUT``'s type.  Bound: bytes.
* :func:`combine_bwd_kernel` — the combine's backward: ``DY[idx[t, j]] =
  gate[t, j] DOUT[t]`` and ``DGATE[t, j] = <DOUT[t], Y[idx[t, j]]>`` (fp32,
  the row's blocks summed in order).  Bound: bytes.
"""
import os

from . import _build

os.environ.setdefault("TRITON_CACHE_DIR", str(_build.build_dir() / "triton"))

import triton  # noqa: E402
import triton.language as tl  # noqa: E402


@triton.jit
def gather_sum_kernel(DY, IDX, DX, T, D: tl.constexpr, KS: tl.constexpr,
                      BT: tl.constexpr, BD: tl.constexpr):
    toks = tl.program_id(0) * BT + tl.arange(0, BT)
    tmask = toks < T
    toks64 = toks.to(tl.int64)
    for d0 in tl.static_range(0, D, BD):
        cols = d0 + tl.arange(0, BD)
        m = tmask[:, None] & (cols[None, :] < D)
        acc = tl.zeros((BT, BD), dtype=tl.float32)
        for j in tl.static_range(KS):
            r = tl.load(IDX + toks64 * KS + j, mask=tmask, other=0).to(tl.int64)
            acc += tl.load(DY + r[:, None] * D + cols[None, :], mask=m, other=0.0).to(tl.float32)
        tl.store(DX + toks64[:, None] * D + cols[None, :], acc.to(DX.dtype.element_ty), mask=m)


@triton.jit
def combine_kernel(Y, GATE, IDX, OUT, T, D: tl.constexpr, KS: tl.constexpr,
                   BT: tl.constexpr, BD: tl.constexpr):
    toks = tl.program_id(0) * BT + tl.arange(0, BT)
    tmask = toks < T
    toks64 = toks.to(tl.int64)
    for d0 in tl.static_range(0, D, BD):
        cols = d0 + tl.arange(0, BD)
        m = tmask[:, None] & (cols[None, :] < D)
        acc = tl.zeros((BT, BD), dtype=tl.float32)
        for j in tl.static_range(KS):
            r = tl.load(IDX + toks64 * KS + j, mask=tmask, other=0).to(tl.int64)
            g = tl.load(GATE + toks64 * KS + j, mask=tmask, other=0.0)
            y = tl.load(Y + r[:, None] * D + cols[None, :], mask=m, other=0.0).to(tl.float32)
            acc += g[:, None] * y
        tl.store(OUT + toks64[:, None] * D + cols[None, :], acc.to(OUT.dtype.element_ty), mask=m)


@triton.jit
def combine_bwd_kernel(DOUT, Y, GATE, IDX, DY, DGATE, T, D: tl.constexpr, KS: tl.constexpr,
                       BT: tl.constexpr, BD: tl.constexpr):
    toks = tl.program_id(0) * BT + tl.arange(0, BT)
    tmask = toks < T
    toks64 = toks.to(tl.int64)
    for j in tl.static_range(KS):
        r = tl.load(IDX + toks64 * KS + j, mask=tmask, other=0).to(tl.int64)
        g = tl.load(GATE + toks64 * KS + j, mask=tmask, other=0.0)
        dg = tl.zeros((BT,), dtype=tl.float32)
        for d0 in tl.static_range(0, D, BD):
            cols = d0 + tl.arange(0, BD)
            m = tmask[:, None] & (cols[None, :] < D)
            dout = tl.load(DOUT + toks64[:, None] * D + cols[None, :], mask=m,
                           other=0.0).to(tl.float32)
            y = tl.load(Y + r[:, None] * D + cols[None, :], mask=m, other=0.0).to(tl.float32)
            dg += tl.sum(dout * y, axis=1)
            tl.store(DY + r[:, None] * D + cols[None, :],
                     (g[:, None] * dout).to(DY.dtype.element_ty), mask=m)
        tl.store(DGATE + toks64 * KS + j, dg, mask=tmask)


@triton.jit
def swiglu_kernel(GU, H, R, F: tl.constexpr, BR: tl.constexpr, BF: tl.constexpr):
    rows = (tl.program_id(0) * BR + tl.arange(0, BR)).to(tl.int64)
    rmask = rows < R
    for f0 in tl.static_range(0, F, BF):
        cols = f0 + tl.arange(0, BF)
        m = rmask[:, None] & (cols[None, :] < F)
        g = tl.load(GU + rows[:, None] * (2 * F) + cols[None, :], mask=m, other=0.0).to(tl.float32)
        u = tl.load(GU + rows[:, None] * (2 * F) + F + cols[None, :], mask=m,
                    other=0.0).to(tl.float32)
        h = g * tl.sigmoid(g) * u
        tl.store(H + rows[:, None] * F + cols[None, :], h.to(H.dtype.element_ty), mask=m)


@triton.jit
def swiglu_bwd_kernel(GU, DH, DGU, R, F: tl.constexpr, BR: tl.constexpr, BF: tl.constexpr):
    rows = (tl.program_id(0) * BR + tl.arange(0, BR)).to(tl.int64)
    rmask = rows < R
    for f0 in tl.static_range(0, F, BF):
        cols = f0 + tl.arange(0, BF)
        m = rmask[:, None] & (cols[None, :] < F)
        g = tl.load(GU + rows[:, None] * (2 * F) + cols[None, :], mask=m, other=0.0).to(tl.float32)
        u = tl.load(GU + rows[:, None] * (2 * F) + F + cols[None, :], mask=m,
                    other=0.0).to(tl.float32)
        dh = tl.load(DH + rows[:, None] * F + cols[None, :], mask=m, other=0.0).to(tl.float32)
        s = tl.sigmoid(g)
        dg = dh * u * (s + g * s * (1.0 - s))
        du = dh * g * s
        tl.store(DGU + rows[:, None] * (2 * F) + cols[None, :], dg.to(DGU.dtype.element_ty),
                 mask=m)
        tl.store(DGU + rows[:, None] * (2 * F) + F + cols[None, :],
                 du.to(DGU.dtype.element_ty), mask=m)
