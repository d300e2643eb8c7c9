"""Level-synchronous schedule-DP sweeps: the CUDA kernel and its plain version.

The batched evaluator (``repro_torch.core.eval_batch``) spends its
exact-evaluation time in one recursion: the longest-path DP over the combined
conjunctive (DAG) + disjunctive (machine-order) graph, forward for
start/finish times and backward for the tails Q (Eq. 28).  The NumPy engine
runs it as a dynamic frontier with ``np.maximum.at`` scatters.  This module
holds the *gather-side* form: a task's start is the max over its
(dense-padded) predecessor slots of their finish times, and a task is ready
exactly when all those slots are done.

* :func:`sweep` / :func:`backward_q` — the wrappers.  For CUDA tensors they
  launch the hand-written kernel ``csrc/schedule_dp.cu`` (one thread block
  per candidate row, the row's state in shared memory, two barrier-separated
  phases per level) and count the launch in ``sweep.launches``; a tensor the
  kernel does not take raises.  For CPU tensors they run the plain version.
* :func:`sweep_torch`, :func:`level_loop_torch`, :func:`backward_q_torch` —
  the plain PyTorch version (a Python ``while`` over levels of gathers,
  masked max-reduces and masked updates).  The CPU tests and the on-card
  comparison use it; nothing on the main path does when a GPU is present.

Both are **bit-exact** with the NumPy engine in float64 (every reduction is a
pure float max over the identical operand set, and ``finish = start + dur``
uses the identical operands).  Levels are identical too: the ready frontier at
loop step ``k`` is exactly the level-``k`` pop set of the Kahn sweep.  Rows
whose disjunctive graph is cyclic stall before completing and come back with
``n_done < n_valid`` — the ``feasible=False`` verdict — and their Q rows are
left at zero exactly like ``BatchEvaluator._backward_q``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

__all__ = [
    "DenseGraph",
    "dense_graph",
    "dense_from_csr",
    "sweep",
    "backward_q",
    "sweep_torch",
    "level_loop_torch",
    "backward_q_torch",
    "bucket",
    "MODE_FORWARD",
    "MODE_FORWARD_TAILS",
    "MODE_BACKWARD",
]

MODE_FORWARD, MODE_FORWARD_TAILS, MODE_BACKWARD = 0, 1, 2

# dynamic shared memory one thread block may ask for on sm_90
_MAX_SMEM = 232448


def bucket(n: int, quantum: int = 32) -> int:
    """Round ``n`` up to the next shape bucket."""
    return max(quantum, quantum * ((int(n) + quantum - 1) // quantum))


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense-padded adjacency of one instance's conjunctive DAG.

    ``pred_mat``/``succ_mat`` are ``(n_b, deg)`` int32 index matrices padded
    with -1 — NumPy arrays as built, ``torch`` tensors after :meth:`to`.
    ``n`` is the real task count, ``n_b`` the shape bucket it is padded to.
    """

    n: int
    n_b: int
    pred_mat: "np.ndarray | torch.Tensor"   # (n_b, max_indeg)  int32, -1 padded
    succ_mat: "np.ndarray | torch.Tensor"   # (n_b, max_outdeg) int32, -1 padded

    def to(self, device: torch.device | str) -> "DenseGraph":
        """The same graph with both index matrices as tensors on ``device``."""
        return dataclasses.replace(
            self,
            pred_mat=torch.as_tensor(self.pred_mat, device=device).contiguous(),
            succ_mat=torch.as_tensor(self.succ_mat, device=device).contiguous(),
        )


def dense_from_csr(n: int, n_b: int, indptr: np.ndarray, idx: np.ndarray,
                   min_width: int = 1) -> np.ndarray:
    """CSR rows as a -1-padded ``(n_b, width)`` index matrix (row order
    preserved)."""
    deg = np.diff(indptr)
    width = max(min_width, int(deg.max()) if len(deg) else 1, 1)
    mat = np.full((n_b, width), -1, dtype=np.int32)
    if len(idx):
        owner = np.repeat(np.arange(n), deg)
        pos = np.arange(len(idx)) - np.repeat(indptr[:-1], deg)
        mat[owner, pos] = idx
    return mat


def dense_graph(inst, n_bucket: int | None = None) -> DenseGraph:
    """Build the dense-padded adjacency for ``inst`` (a core.mdfg.Instance)."""
    n = inst.n_tasks
    n_b = n_bucket if n_bucket is not None else bucket(n)
    assert n_b >= n
    pred_mat = dense_from_csr(n, n_b, inst.pred_indptr, inst.pred_idx)
    succ_mat = dense_from_csr(n, n_b, inst.succ_indptr, inst.succ_idx)
    return DenseGraph(n=n, n_b=n_b, pred_mat=pred_mat, succ_mat=succ_mat)


# --------------------------------------------------------------------------- #
# plain PyTorch version (gather form)                                          #
# --------------------------------------------------------------------------- #
def level_loop_torch(link_mat, link_vec, node_add, n_valid: int, active_rows):
    """The masked level-synchronous recursion.

    ``value[i] = node_add[i] + max(0, linked values)`` where the links are
    the dense ``link_mat (n_b, deg)`` slots plus the per-row ``link_vec``
    link; a task is ready iff all its links are done.  ``active_rows``
    ``(B, 1)`` bool masks whole rows out (used to skip infeasible rows in the
    backward sweep).  Returns ``(val, level, done)``.
    """
    fdt, dev = node_add.dtype, node_add.device
    b, n_b = node_add.shape
    neg_inf = torch.tensor(-torch.inf, dtype=fdt, device=dev)
    zero = torch.zeros((), dtype=fdt, device=dev)
    valid = (torch.arange(n_b, device=dev) < n_valid)[None, :]     # (1, n_b)
    link_pad = torch.where(link_mat < 0, 0, link_mat).long()       # (n_b, deg)
    link_ok = link_mat >= 0
    lv_pad = torch.where(link_vec < 0, 0, link_vec).long()         # (b, n_b)
    lv_ok = link_vec >= 0

    def ready_of(done):
        link_done = (~link_ok[None]) | done[:, link_pad]
        mdone = (~lv_ok) | torch.take_along_dim(done, lv_pad, dim=1)
        return valid & active_rows & ~done & link_done.all(dim=2) & mdone

    val = torch.zeros((b, n_b), dtype=fdt, device=dev)
    level = torch.zeros((b, n_b), dtype=torch.int32, device=dev)
    done = torch.zeros((b, n_b), dtype=torch.bool, device=dev)
    ready = ready_of(done)
    lev = 0
    while lev <= n_valid and bool(ready.any()):
        gathered = val[:, link_pad]                                # (b, n_b, deg)
        gmax = torch.where(link_ok[None], gathered, neg_inf).amax(dim=2)
        mval = torch.where(lv_ok, torch.take_along_dim(val, lv_pad, dim=1), neg_inf)
        base = torch.maximum(torch.maximum(gmax, mval), zero)
        v = base + node_add
        val = torch.where(ready, v, val)
        level = torch.where(ready, torch.full_like(level, lev), level)
        done = done | ready
        ready = ready_of(done)
        lev += 1
    return val, level, done


def backward_q_torch(succ_mat, dur, msucc, n_valid: int, active_rows=None):
    """Tails Q alone (Eq. 28) for already-scheduled rows: one backward level
    loop, bit-exact with ``BatchEvaluator._backward_q`` in float64."""
    if active_rows is None:
        active_rows = torch.ones((dur.shape[0], 1), dtype=torch.bool, device=dur.device)
    q, _, done = level_loop_torch(succ_mat, msucc, dur, n_valid, active_rows)
    return torch.where(done, q, torch.zeros_like(q))


def sweep_torch(pred_mat, succ_mat, dur, mpred, msucc, n_valid: int,
                *, tails: bool = True):
    """Forward (+ optional backward) sweep in plain PyTorch.

    Shapes: ``pred_mat/succ_mat (n_b, deg)``, ``dur/mpred/msucc (B, n_b)``.
    Returns ``(start, finish, level, n_done, q)`` with ``q`` zeros when
    ``tails=False``.
    """
    fdt, dev = dur.dtype, dur.device
    b, n_b = dur.shape
    neg_inf = torch.tensor(-torch.inf, dtype=fdt, device=dev)
    zero = torch.zeros((), dtype=fdt, device=dev)
    valid = (torch.arange(n_b, device=dev) < n_valid)[None, :]     # (1, n_b)

    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    # forward: value = finish = max(preds' finish, 0) + dur
    finish, level, done = level_loop_torch(pred_mat, mpred, dur, n_valid, ones)
    # start is re-derived as the same masked max (NOT finish - dur, which
    # would not be bit-identical under rounding and breaks on inf durations)
    link_pad = torch.where(pred_mat < 0, 0, pred_mat).long()
    link_ok = pred_mat >= 0
    gmax = torch.where(link_ok[None], finish[:, link_pad], neg_inf).amax(dim=2)
    mp_pad = torch.where(mpred < 0, 0, mpred).long()
    mval = torch.where(mpred >= 0, torch.take_along_dim(finish, mp_pad, dim=1), neg_inf)
    start = torch.where(done, torch.maximum(torch.maximum(gmax, mval), zero), zero)
    finish = torch.where(done, finish, zero)
    n_done = (done & valid).sum(dim=1).to(torch.int32)
    if tails:
        feasible = (n_done == n_valid)[:, None]
        # mirror the scalar heads_tails operands (dur = finish - start):
        # (base + dur) - base can differ from dur in the last ulp, and the
        # bit-exactness contract is against the NumPy engine's Q
        q = backward_q_torch(succ_mat, finish - start, msucc, n_valid, feasible)
    else:
        q = torch.zeros((b, n_b), dtype=fdt, device=dev)
    return start, finish, level, n_done, q


# --------------------------------------------------------------------------- #
# CUDA kernel launch                                                           #
# --------------------------------------------------------------------------- #
_FN_BY_DTYPE = {torch.float64: "schedule_dp_sweep_f64",
                torch.float32: "schedule_dp_sweep_f32"}


def _c_fn(dtype: torch.dtype):
    """The C entry point for ``dtype`` (builds and loads the library at
    first use)."""
    from . import _build

    fn = getattr(_build.load("schedule_dp"), _FN_BY_DTYPE[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_cuda(graph: DenseGraph, node, mpred, msucc, active, mode: int):
    """Check the operands, allocate the outputs, launch the kernel on the
    current stream (no synchronisation) and count the launch."""
    dev = node.device
    if node.dtype not in _FN_BY_DTYPE:
        raise TypeError(f"dur must be float32 or float64, got {node.dtype}")
    if node.dim() != 2:
        raise ValueError(f"dur must be (B, n_b), got shape {tuple(node.shape)}")
    b, n_b = node.shape
    if n_b != graph.n_b:
        raise ValueError(f"dur has width {n_b}, the graph is padded to {graph.n_b}")
    smem = n_b * (3 * node.element_size() + 4 + 2)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"n_b={n_b} needs {smem} bytes of shared memory per row, "
            f"the kernel holds a row in at most {_MAX_SMEM}")
    pred_mat, succ_mat = graph.pred_mat, graph.succ_mat
    for nm, mat in (("graph.pred_mat", pred_mat), ("graph.succ_mat", succ_mat)):
        if not isinstance(mat, torch.Tensor) or mat.dim() != 2:
            raise TypeError(f"{nm} must be a 2-D torch.Tensor on {dev} "
                            "(DenseGraph.to(device))")
        _check(nm, mat, torch.int32, (n_b, mat.shape[1]), dev)
    _check("dur", node, node.dtype, (b, n_b), dev)
    if mode != MODE_BACKWARD:
        _check("mpred", mpred, torch.int32, (b, n_b), dev)
    if mode != MODE_FORWARD:
        _check("msucc", msucc, torch.int32, (b, n_b), dev)
    if active is not None:
        _check("active_rows", active, torch.uint8, (b,), dev)

    fdt = node.dtype
    # forward only has no tails: the kernel is handed no q and writes none
    q = None if mode == MODE_FORWARD else torch.empty((b, n_b), dtype=fdt, device=dev)
    if mode == MODE_BACKWARD:
        start = finish = level = n_done = None
    else:
        start = torch.empty((b, n_b), dtype=fdt, device=dev)
        finish = torch.empty((b, n_b), dtype=fdt, device=dev)
        level = torch.empty((b, n_b), dtype=torch.int32, device=dev)
        n_done = torch.empty((b,), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _c_fn(fdt)
    # The launch is asynchronous.  Operands a caller drops right after this
    # call stay valid for the kernel: PyTorch's allocator hands freed blocks
    # only to later work on the same stream.
    with torch.cuda.device(dev):
        err = fn(ptr(pred_mat), pred_mat.shape[1], ptr(succ_mat), succ_mat.shape[1],
                 ptr(node), ptr(mpred), ptr(msucc), ptr(active),
                 b, n_b, int(graph.n), mode,
                 ptr(start), ptr(finish), ptr(level), ptr(n_done), ptr(q),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"schedule_dp kernel launch failed: CUDA error {err}")
    sweep.launches += 1
    if q is None:
        q = torch.zeros((b, n_b), dtype=fdt, device=dev)
    return start, finish, level, n_done, q


def _pick_impl(impl: str | None, t: torch.Tensor) -> str:
    if impl is None:
        impl = "cuda" if t.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown schedule-DP impl {impl!r}; use 'cuda' or 'torch'")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def _as_i32(t):
    return t if t is None or t.dtype == torch.int32 else t.to(torch.int32)


def sweep(graph: DenseGraph, dur, mpred, msucc, *, tails: bool = True,
          impl: str | None = None):
    """Run the sweep on ``(B, n_b)`` tensors; ``graph`` carries the padded
    index matrices (:meth:`DenseGraph.to` puts them on the device once).

    ``impl=None`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"torch"`` forces the plain version,
    ``"cuda"`` the kernel.  int64 links are narrowed to int32.  Returns
    ``(start, finish, level, n_done, q)``; ``q`` is zeros when ``tails`` is
    false.  The kernel launch is asynchronous on the current stream.
    """
    impl = _pick_impl(impl, dur)
    mpred, msucc = _as_i32(mpred), _as_i32(msucc)
    if impl == "cuda":
        return _launch_cuda(graph, dur, mpred, msucc, None,
                            MODE_FORWARD_TAILS if tails else MODE_FORWARD)
    dev = dur.device
    return sweep_torch(torch.as_tensor(graph.pred_mat, device=dev),
                       torch.as_tensor(graph.succ_mat, device=dev),
                       dur, mpred, msucc, graph.n, tails=tails)


sweep.launches = 0  # kernel launches made through this module's wrappers


def backward_q(graph: DenseGraph, dur, msucc, active_rows=None,
               *, impl: str | None = None):
    """Tails Q alone for already-scheduled rows: ``dur`` is the node weight,
    ``active_rows`` an optional ``(B,)`` bool mask (inactive rows give zeros).
    Same dispatch as :func:`sweep`; a kernel launch counts in
    ``sweep.launches``."""
    impl = _pick_impl(impl, dur)
    msucc = _as_i32(msucc)
    if impl == "cuda":
        act = None if active_rows is None else \
            active_rows.reshape(-1).to(torch.uint8).contiguous()
        return _launch_cuda(graph, dur, None, msucc, act, MODE_BACKWARD)[4]
    act = None if active_rows is None else active_rows.reshape(-1, 1).bool()
    return backward_q_torch(torch.as_tensor(graph.succ_mat, device=dur.device),
                            dur, msucc, graph.n, act)
