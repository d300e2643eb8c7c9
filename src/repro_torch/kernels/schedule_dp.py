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
  per candidate row, the row's state and the graph's link lists as CSR in
  shared memory, a cursor per task over its links, two barrier-separated
  phases per level) and count the launch in ``sweep.launches``; a tensor the
  kernel does not take raises.  For CPU tensors they run the plain version.
* :class:`SweepLaunch` — one call site of the device-resident search round
  (``core/device_search.py``): graph, row count and mode fixed, operands
  checked at the first call and outputs allocated once, so that a call is
  the launch alone and a CUDA graph can record it.  The real task count is a
  one-element tensor the kernel reads on the device.
* :func:`seq_cumsum` — the same library's row prefix sum in float64, added
  strictly left to right (``np.cumsum``'s order; a parallel scan such as
  ``torch.cumsum`` on the card adds in another).  The round derives its
  candidates' durations from it.  No TPU kernel corresponds to it.
* :func:`sweep_torch`, :func:`level_loop_torch`, :func:`backward_q_torch`,
  :func:`seq_cumsum_torch` — the plain PyTorch versions (a Python ``while``
  over levels of gathers, masked max-reduces and masked updates; a CPU
  ``torch.cumsum``).  The CPU tests and the on-card comparison use them;
  nothing on the main path does when a GPU is present.

A launch counts one in its function's ``launches`` (``sweep.launches`` for
every K1 launch, ``seq_cumsum.launches``).  While a CUDA graph is being
captured nothing is launched: the call counts one in ``captured`` instead,
and the graph's owner adds its nodes to ``launches`` at every replay
(:func:`count_replays`).

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
import functools

import numpy as np
import torch

__all__ = [
    "DenseGraph",
    "dense_graph",
    "dense_from_csr",
    "csr_from_dense",
    "graph_from_pack",
    "sweep",
    "backward_q",
    "SweepLaunch",
    "seq_cumsum",
    "seq_cumsum_torch",
    "count_replays",
    "sweep_torch",
    "level_loop_torch",
    "backward_q_torch",
    "bucket",
    "MODE_FORWARD",
    "MODE_FORWARD_TAILS",
    "MODE_BACKWARD",
]

MODE_FORWARD, MODE_FORWARD_TAILS, MODE_BACKWARD = 0, 1, 2

# the kernel's thread block holds at most 1,024 threads of 8 tasks each
MAX_TASKS = 8192


def bucket(n: int, quantum: int = 32) -> int:
    """Round ``n`` up to the next shape bucket."""
    return max(quantum, quantum * ((int(n) + quantum - 1) // quantum))


def csr_from_dense(mat: np.ndarray):
    """``(indptr, idx)`` of a -1-padded ``(rows, width)`` index matrix: each
    row's real slots (``>= 0``, wherever they sit in the row) in slot order,
    as int32 NumPy arrays."""
    mat = np.asarray(mat)
    real = mat >= 0
    indptr = np.zeros(mat.shape[0] + 1, dtype=np.int32)
    np.cumsum(real.sum(axis=1), out=indptr[1:])
    return indptr, mat[real].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense-padded adjacency of one instance's conjunctive DAG.

    ``pred_mat``/``succ_mat`` are ``(n_b, deg)`` int32 index matrices padded
    with -1 — NumPy arrays as built, ``torch`` tensors after :meth:`to`.
    ``n`` is the real task count, ``n_b`` the shape bucket it is padded to.
    ``pred_csr``/``succ_csr`` are the same links in CSR form (what the CUDA
    kernel reads), built once per graph on first use and carried to the
    device by :meth:`to`.
    """

    n: int
    n_b: int
    pred_mat: "np.ndarray | torch.Tensor"   # (n_b, max_indeg)  int32, -1 padded
    succ_mat: "np.ndarray | torch.Tensor"   # (n_b, max_outdeg) int32, -1 padded

    @functools.cached_property
    def pred_csr(self):
        """``(indptr (n_b + 1,), idx (nnz,))`` of ``pred_mat``."""
        return csr_from_dense(self.pred_mat)

    @functools.cached_property
    def succ_csr(self):
        """``(indptr (n_b + 1,), idx (nnz,))`` of ``succ_mat``."""
        return csr_from_dense(self.succ_mat)

    def with_csr(self, pred_csr, succ_csr) -> "DenseGraph":
        """The same graph reading the given CSR tensors (``(indptr, idx)``
        each; ``idx`` may be longer than the links it holds, the offsets
        say where each task's links are)."""
        moved = dataclasses.replace(self)
        moved.__dict__["pred_csr"] = tuple(pred_csr)
        moved.__dict__["succ_csr"] = tuple(succ_csr)
        return moved

    def to(self, device: torch.device | str) -> "DenseGraph":
        """The same graph with both index matrices and both CSR forms as
        tensors on ``device`` (the CSR is built here once, not per launch)."""
        moved = dataclasses.replace(
            self,
            pred_mat=torch.as_tensor(self.pred_mat, device=device).contiguous(),
            succ_mat=torch.as_tensor(self.succ_mat, device=device).contiguous(),
        )
        for name in ("pred_csr", "succ_csr"):   # cached_property's own slot
            moved.__dict__[name] = tuple(torch.as_tensor(a, device=device).contiguous()
                                         for a in getattr(self, name))
        return moved


def graph_from_pack(inst, pack) -> DenseGraph:
    """A :class:`DenseGraph` that reuses an ``InstancePack``'s already-padded
    predecessor/successor matrices instead of re-walking the CSR (pack once,
    every sweep consumer reads the same arrays).  There is no mask form:
    the port's kernel reads the CSR."""
    if pack.n != inst.n_tasks:
        raise ValueError(f"the pack holds {pack.n} tasks, the instance {inst.n_tasks}")
    return DenseGraph(n=pack.n, n_b=pack.n_b, pred_mat=pack.pred_mat,
                      succ_mat=pack.succ_mat)


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


@functools.cache
def _c_fn(dtype: torch.dtype):
    """The C entry point for ``dtype`` (builds and loads the library at
    first use; typed once, not per launch)."""
    from . import _build

    fn = getattr(_build.load("schedule_dp"), _FN_BY_DTYPE[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, p, p, p, p, i, i, i, p, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _count(fn) -> None:
    """Count one launch of ``fn``'s kernel, or, while the current stream is
    capturing a CUDA graph (the kernel is recorded, not launched), one node
    of the graph: its owner counts the nodes at each replay."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def count_replays(k1_nodes: int, cumsum_nodes: int, replays: int) -> None:
    """A CUDA graph holding ``k1_nodes`` K1 launches and ``cumsum_nodes``
    :func:`seq_cumsum` launches was replayed ``replays`` times."""
    sweep.launches += k1_nodes * replays
    seq_cumsum.launches += cumsum_nodes * replays


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


def _graph_csr(graph: DenseGraph, dev) -> None:
    """Check the graph's two CSR forms to be tensors on ``dev`` with one
    offset per task + 1 (:meth:`DenseGraph.to` makes them int32 and
    contiguous, the offsets and links of a form on one device)."""
    for nm in ("pred_csr", "succ_csr"):
        indptr, _ = getattr(graph, nm)
        if not isinstance(indptr, torch.Tensor):
            raise TypeError(f"graph.{nm} must be tensors on {dev} (DenseGraph.to(device))")
        _check(f"graph.{nm} indptr", indptr, torch.int32, (graph.n_b + 1,), dev)


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
    if n_b > MAX_TASKS:
        raise ValueError(f"n_b={n_b}: the kernel holds at most {MAX_TASKS} tasks per row")
    _graph_csr(graph, dev)
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

    # The launch is asynchronous.  Operands a caller drops right after this
    # call stay valid for the kernel: PyTorch's allocator hands freed blocks
    # only to later work on the same stream.
    _launch(graph, node, mpred, msucc, active, mode, None,
            (start, finish, level, n_done, q))
    if q is None:
        q = torch.zeros((b, n_b), dtype=fdt, device=dev)
    return start, finish, level, n_done, q


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(graph: DenseGraph, node, mpred, msucc, active, mode: int, n_valid_dev,
            outs) -> None:
    """The ctypes call on the current stream, counted (operands checked by
    the caller)."""
    dev = node.device
    pred_ptr, pred_idx = graph.pred_csr
    succ_ptr, succ_idx = graph.succ_csr
    start, finish, level, n_done, q = outs
    with torch.cuda.device(dev):
        err = _c_fn(node.dtype)(
            _ptr(pred_ptr), _ptr(pred_idx), pred_idx.numel(),
            _ptr(succ_ptr), _ptr(succ_idx), succ_idx.numel(),
            _ptr(node), _ptr(mpred), _ptr(msucc), _ptr(active),
            node.shape[0], node.shape[1], int(graph.n), _ptr(n_valid_dev), mode,
            _ptr(start), _ptr(finish), _ptr(level), _ptr(n_done), _ptr(q),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"schedule_dp kernel launch failed: CUDA error {err}")
    _count(sweep)


def _as_i32(t):
    return t if t is None or t.dtype == torch.int32 else t.to(torch.int32)


def sweep(graph: DenseGraph, dur, mpred, msucc, *, tails: bool = True):
    """Run the sweep on ``(B, n_b)`` tensors; ``graph`` carries the padded
    index matrices (:meth:`DenseGraph.to` puts them on the device once).

    CUDA tensors launch the kernel (or raise where it cannot take them); CPU
    tensors run the plain version.  int64 links are narrowed to int32.
    Returns ``(start, finish, level, n_done, q)``; ``q`` is zeros when
    ``tails`` is false.  The kernel launch is asynchronous on the current
    stream.
    """
    mpred, msucc = _as_i32(mpred), _as_i32(msucc)
    if dur.is_cuda:
        return _launch_cuda(graph, dur, mpred, msucc, None,
                            MODE_FORWARD_TAILS if tails else MODE_FORWARD)
    dev = dur.device
    return sweep_torch(torch.as_tensor(graph.pred_mat, device=dev),
                       torch.as_tensor(graph.succ_mat, device=dev),
                       dur, mpred, msucc, graph.n, tails=tails)


sweep.launches = 0  # kernel launches made through this module's wrappers
sweep.captured = 0  # launches recorded into CUDA graphs (counted at replay)


def backward_q(graph: DenseGraph, dur, msucc, active_rows=None):
    """Tails Q alone for already-scheduled rows: ``dur`` is the node weight,
    ``active_rows`` an optional ``(B,)`` bool mask (inactive rows give zeros).
    Same dispatch as :func:`sweep`; a kernel launch counts in
    ``sweep.launches``."""
    msucc = _as_i32(msucc)
    if dur.is_cuda:
        act = None if active_rows is None else \
            active_rows.reshape(-1).to(torch.uint8).contiguous()
        return _launch_cuda(graph, dur, None, msucc, act, MODE_BACKWARD)[4]
    act = None if active_rows is None else active_rows.reshape(-1, 1).bool()
    return backward_q_torch(torch.as_tensor(graph.succ_mat, device=dur.device),
                            dur, msucc, graph.n, act)


class SweepLaunch:
    """One K1 call site of a round that a CUDA graph records.

    ``graph`` (its tensors on the device the round runs on) and ``rows``
    fix the launch shape; ``mode`` is :data:`MODE_FORWARD` (``__call__(dur,
    mpred)`` → ``(start, finish, n_done)``) or :data:`MODE_BACKWARD`
    (``__call__(dur, msucc, active)`` → ``q``, zeros on rows whose
    ``active`` is false).  ``n_valid`` is a one-element int32 tensor beside
    the graph holding the real task count: the kernel reads it on the
    device, so the recorded launch serves any instance whose arrays are
    copied into the same buffers.

    On the card the operands are checked at the first call and the outputs
    are allocated once; every call writes the same output tensors, which
    the caller consumes before its next call on the stream.  So a call is
    the ctypes launch alone, and a captured round pays no host work per
    replay.  On the CPU a call runs the plain version.
    """

    def __init__(self, graph: DenseGraph, rows: int, mode: int, n_valid,
                 dtype: torch.dtype = torch.float64):
        if mode not in (MODE_FORWARD, MODE_BACKWARD):
            raise ValueError(f"mode must be MODE_FORWARD or MODE_BACKWARD, got {mode}")
        dev = n_valid.device
        self.graph, self.rows, self.mode, self.n_valid = graph, int(rows), mode, n_valid
        self.dtype, self.device = dtype, dev
        self._checked = False
        if dev.type != "cuda":
            return
        if dtype not in _FN_BY_DTYPE:
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        if graph.n_b > MAX_TASKS:
            raise ValueError(f"n_b={graph.n_b}: the kernel holds at most {MAX_TASKS} tasks per row")
        _graph_csr(graph, dev)
        _check("n_valid", n_valid, torch.int32, (1,), dev)
        b, n_b = self.rows, graph.n_b
        if mode == MODE_FORWARD:
            self.outs = (torch.empty((b, n_b), dtype=dtype, device=dev),
                         torch.empty((b, n_b), dtype=dtype, device=dev),
                         torch.empty((b, n_b), dtype=torch.int32, device=dev),
                         torch.empty((b,), dtype=torch.int32, device=dev), None)
        else:
            self.outs = (None, None, None, None,
                         torch.empty((b, n_b), dtype=dtype, device=dev))

    def __call__(self, dur, links, active=None):
        g, fwd = self.graph, self.mode == MODE_FORWARD
        if self.device.type != "cuda":       # the plain versions, as sweep routes them
            g = dataclasses.replace(g, n=int(self.n_valid))
            if fwd:
                start, finish, _, n_done, _ = sweep(g, dur, links, None, tails=False)
                return start, finish, n_done
            return backward_q(g, dur, links, active)
        if links.dtype != torch.int32:
            links = links.to(torch.int32)
        act = None if active is None else active.to(torch.uint8)
        if not self._checked:
            shape = (self.rows, g.n_b)
            _check("dur", dur, self.dtype, shape, self.device)
            _check("mpred" if fwd else "msucc", links, torch.int32, shape, self.device)
            if act is not None:
                _check("active_rows", act, torch.uint8, (self.rows,), self.device)
            self._checked = True
        _launch(g, dur, links if fwd else None, None if fwd else links, act, self.mode,
                self.n_valid, self.outs)
        if fwd:
            start, finish, _, n_done, _ = self.outs
            return start, finish, n_done
        return self.outs[4]


# --------------------------------------------------------------------------- #
# sequential row prefix sums                                                   #
# --------------------------------------------------------------------------- #
def seq_cumsum_torch(v):
    """``(rows, e)`` → ``(rows, e + 1)``: a zero column, then each row's
    prefix sums.  On the CPU ``torch.cumsum`` adds left to right in the
    working type, as ``np.cumsum`` does (the tests hold them bit for bit)."""
    zero = torch.zeros((v.shape[0], 1), dtype=v.dtype, device=v.device)
    # lint: allow[RPR103] DESIGN §9: the plain version, taken for a CPU tensor
    # only (it adds left to right there); a CUDA tensor takes the kernel
    return torch.cat([zero, torch.cumsum(v, dim=1)], dim=1)


@functools.cache
def _cumsum_fn():
    from . import _build

    fn = _build.load("schedule_dp").schedule_dp_seq_cumsum_f64
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def seq_cumsum(v):
    """Row prefix sums of a float64 ``(rows, e)`` tensor, each row added
    strictly left to right, with a leading zero column: ``(rows, e + 1)``.
    A CUDA tensor launches the kernel (counted in ``seq_cumsum.launches``,
    or ``seq_cumsum.captured`` inside a CUDA graph capture); a CPU tensor
    runs :func:`seq_cumsum_torch`."""
    if not v.is_cuda:
        return seq_cumsum_torch(v)
    if v.dtype != torch.float64 or v.dim() != 2:
        raise TypeError(f"seq_cumsum takes a 2-d float64 tensor, got {v.dtype} {tuple(v.shape)}")
    v = v.contiguous()
    rows, e = v.shape
    out = torch.empty((rows, e + 1), dtype=v.dtype, device=v.device)
    with torch.cuda.device(v.device):
        err = _cumsum_fn()(v.data_ptr(), out.data_ptr(), rows, e,
                           torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seq_cumsum kernel launch failed: CUDA error {err}")
    _count(seq_cumsum)
    return out


seq_cumsum.launches = 0
seq_cumsum.captured = 0
