"""Batched array-level schedule evaluation — the §V-F hot path, vectorized.

The tabu search's mixed evaluation strategy exact-evaluates the top-K
approximate-ranked neighbors each iteration.  The scalar path
(``solution.exact_schedule`` et al.) runs one per-task Python DP per
candidate; this module evaluates all K candidates in one call over
``(K, n_tasks)`` arrays:

* ``BatchEvaluator.evaluate`` — level-synchronous batched longest-path DP
  over the conjunctive (DAG) + disjunctive (machine-order) graph, with
  per-candidate cycle detection (cyclic candidates get ``feasible=False``
  and are reported exactly like the scalar path's ``None``);
* vectorized ``heads_tails`` — backward sweep over the same level
  structure, producing R/Q/Slack and the critical mask per candidate;
* vectorized ``memory_peaks`` — the paper's discretized differential-array
  sweep over all (candidate, tier) event buckets at once: events are
  lexsorted per bucket, scattered into a padded per-bucket matrix, and
  cumsum'd row-wise (no per-tier Python loop).

The NumPy reference path is **bit-exact** with the scalar oracle: every
reduction is a float ``max`` (order-independent) or replays the scalar
code's exact summation order (the cumsum-difference segment sums, the
per-bucket event cumsum).  The default path (``backend="torch"``) runs the
forward/backward sweeps through ``repro_torch.kernels.schedule_dp`` on a
padded shape bucket in float64: the hand-written CUDA kernel when the
engine's device is a GPU, the plain PyTorch level loop when it is the CPU.
Both are bit-exact with the NumPy path.  The padded graph tensors are
uploaded once per ``(bucket, dtype, device)`` and kept in a bounded LRU
(``BatchEvaluator.cache_info()`` reports hits/misses/size).

Backend selection is a string flag (``"torch"`` | ``"numpy"`` |
``"scalar"``) carried by ``TSParams.backend`` and plumbed through
``repro_torch.solve``, with the torch device beside it
(``TSParams.torch_device``, ``"cuda"`` by default — asking for it on a
machine without a GPU raises).  ``"numpy"`` is the host reference and
``"scalar"`` wraps the original per-candidate functions; both are explicitly
selected oracles for parity tests.  The search takes one more value,
``"device"``: the whole round on the device (``core/device_search.py``),
which has no per-batch evaluator.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from .mdfg import Instance
from .solution import _EPS  # critical-slack tolerance, shared with heads_tails
from .solution import (
    Schedule,
    Solution,
    data_lifetimes,
    exact_schedule,
    heads_tails,
    memory_peaks,
)

__all__ = [
    "BACKENDS",
    "SEARCH_BACKENDS",
    "check_backend",
    "APPROX_WINDOW",
    "LRUCache",
    "BatchEval",
    "BatchEvaluator",
    "MoveBatch",
    "PackedSolutions",
    "approx_eval_moves",
    "pack_solutions",
    "batch_evaluate",
]

BACKENDS = ("torch", "numpy", "scalar")
SEARCH_BACKENDS = BACKENDS + ("device",)


def check_backend(backend: str) -> str:
    """``backend`` if the search has it (an evaluator backend, or
    ``"device"``: the device-resident round), else ``ValueError``."""
    if backend not in SEARCH_BACKENDS:
        raise ValueError(f"backend must be one of {SEARCH_BACKENDS}, got {backend!r}")
    return backend

APPROX_WINDOW = 12  # approximate-evaluation look-ahead window (ops)


class LRUCache:
    """Tiny bounded mapping for per-shape-bucket device state.

    Keyed on *shape buckets* upstream; evicts least-recently-used entries
    past ``maxsize`` and counts hits/misses so callers can report cache
    behavior.  Each operation holds the cache's lock, so threads that share
    a cache see every entry and count every lookup.
    """

    def __init__(self, maxsize: int = 16):
        self.maxsize = int(maxsize)
        self._d: "dict" = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            try:
                val = self._d.pop(key)
            except KeyError:
                self.misses += 1
                return None
            self._d[key] = val  # move to MRU position
            self.hits += 1
            return val

    def put(self, key, val) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = val
            while len(self._d) > self.maxsize:
                self._d.pop(next(iter(self._d)))
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def info(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "currsize": len(self._d), "maxsize": self.maxsize}


# --------------------------------------------------------------------------- #
# packing                                                                      #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MoveBatch:
    """M neighborhood moves in array form (struct-of-arrays ``tabu.Move``).

    ``cc[i]`` is True for change-core moves (different destination core) and
    False for N7 repositionings on the same core; ``dst_pos`` is the insertion
    index in the destination sequence *after* removal, as in ``tabu.Move``.
    """

    cc: np.ndarray        # (M,) bool
    task: np.ndarray      # (M,) int64
    src_proc: np.ndarray  # (M,) int64
    src_pos: np.ndarray   # (M,) int64
    dst_proc: np.ndarray  # (M,) int64
    dst_pos: np.ndarray   # (M,) int64

    def __len__(self) -> int:
        return len(self.task)

    def take(self, idx) -> "MoveBatch":
        return MoveBatch(self.cc[idx], self.task[idx], self.src_proc[idx],
                         self.src_pos[idx], self.dst_proc[idx], self.dst_pos[idx])

    @classmethod
    def concat(cls, batches: Sequence["MoveBatch"]) -> "MoveBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls.empty()
        return cls(*(np.concatenate([getattr(b, f.name) for b in batches])
                     for f in dataclasses.fields(cls)))

    @classmethod
    def empty(cls) -> "MoveBatch":
        z = np.zeros(0, dtype=np.int64)
        return cls(np.zeros(0, dtype=bool), z, z, z, z, z)


@dataclasses.dataclass
class PackedSolutions:
    """Array form of K solutions — and, with ``seq`` present, a first-class
    mutable array-native *search state*.

    ``mpred``/``msucc`` are the disjunctive (machine-order) predecessor and
    successor of each task (-1 = none), i.e. ``Solution.machine_pred_succ``
    stacked over candidates.  ``seq`` is the padded per-processor order
    ``(K, n_procs, n_tasks + 1)`` (-1 padded; the spare column keeps
    index arithmetic in bounds for end-of-sequence insertions) with
    ``seq_len`` the live prefix lengths.  Candidate generation
    (:meth:`apply_moves`) and move commits (:meth:`commit_move`) are pure
    gather/scatter — no Python list surgery, no per-candidate ``copy()``.
    """

    assign: np.ndarray   # (K, n_tasks) int64
    mem: np.ndarray      # (K, n_data) int64
    mpred: np.ndarray    # (K, n_tasks) int64
    msucc: np.ndarray    # (K, n_tasks) int64
    seq: np.ndarray | None = None      # (K, n_procs, n_tasks + 1) int64, -1 pad
    seq_len: np.ndarray | None = None  # (K, n_procs) int64

    @property
    def k(self) -> int:
        return self.assign.shape[0]

    # -- construction ------------------------------------------------------- #
    @classmethod
    def from_solutions(cls, inst: Instance, sols: Sequence[Solution]) -> "PackedSolutions":
        """Pack solutions *with* the padded machine-sequence state."""
        packed = pack_solutions(inst, sols)
        k, n, p = len(sols), inst.n_tasks, inst.n_procs
        seq = np.full((k, p, n + 1), -1, dtype=np.int64)
        seq_len = np.zeros((k, p), dtype=np.int64)
        for i, sol in enumerate(sols):
            for pp, s in enumerate(sol.proc_seq):
                seq_len[i, pp] = len(s)
                if s:
                    seq[i, pp, : len(s)] = s
        packed.seq = seq
        packed.seq_len = seq_len
        return packed

    def to_solution(self, i: int) -> Solution:
        """Materialize row ``i`` back into a scalar :class:`Solution`."""
        assert self.seq is not None, "to_solution needs the seq state"
        proc_seq = [
            [int(t) for t in self.seq[i, p, : self.seq_len[i, p]]]
            for p in range(self.seq.shape[1])
        ]
        return Solution(assign=self.assign[i].copy(), mem=self.mem[i].copy(),
                        proc_seq=proc_seq)

    def set_solution(self, i: int, sol: Solution) -> None:
        """Overwrite row ``i`` from a scalar solution (assign/mem/seq/links)."""
        assert self.seq is not None
        self.assign[i] = sol.assign
        self.mem[i] = sol.mem
        self.seq[i] = -1
        for p, s in enumerate(sol.proc_seq):
            self.seq_len[i, p] = len(s)
            if s:
                self.seq[i, p, : len(s)] = s
        self._refresh_links(i)

    # -- array-op views ----------------------------------------------------- #
    def positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(machine_of_task, position_in_sequence), both (K, n_tasks)."""
        assert self.seq is not None
        k, p, s = self.seq.shape
        n = self.assign.shape[1]
        mach = np.full((k, n), -1, dtype=np.int64)
        pos = np.full((k, n), -1, dtype=np.int64)
        kk, pp, ss = np.nonzero(self.seq >= 0)
        t = self.seq[kk, pp, ss]
        mach[kk, t] = pp
        pos[kk, t] = ss
        return mach, pos

    def _refresh_links(self, i: int) -> None:
        """Recompute row ``i``'s mpred/msucc from its seq state."""
        n = self.assign.shape[1]
        mp = np.full(n, -1, dtype=np.int64)
        ms = np.full(n, -1, dtype=np.int64)
        for p in range(self.seq.shape[1]):
            lp = int(self.seq_len[i, p])
            if lp >= 2:
                s = self.seq[i, p, :lp]
                mp[s[1:]] = s[:-1]
                ms[s[:-1]] = s[1:]
        self.mpred[i] = mp
        self.msucc[i] = ms

    # -- vectorized move application ---------------------------------------- #
    def apply_moves(self, rows: np.ndarray, mb: MoveBatch) -> "PackedSolutions":
        """Materialize M candidate solutions — ``rows[i]``'s state with
        ``mb``'s i-th move applied — as a new :class:`PackedSolutions`
        (without seq state; the batch engine only needs assign/mem/links).

        Pure gather/scatter: each candidate's ``mpred``/``msucc`` start as a
        copy of its source row and receive the O(1) local link edits of the
        remove + insert, exactly mirroring ``tabu.apply_move``'s list surgery.
        """
        assert self.seq is not None
        m = len(mb)
        u, k, b, j = mb.task, mb.src_pos, mb.dst_proc, mb.dst_pos
        same = ~mb.cc  # N7 moves stay on the source core
        assign = self.assign[rows]
        mem = self.mem[rows]
        mpred = self.mpred[rows]
        msucc = self.msucc[rows]
        ar = np.arange(m)
        # unlink u: machine-pred x and machine-succ y become adjacent
        x = self.mpred[rows, u]
        y = self.msucc[rows, u]
        sel = x >= 0
        msucc[ar[sel], x[sel]] = y[sel]
        sel = y >= 0
        mpred[ar[sel], y[sel]] = x[sel]
        # insertion neighbors in the destination sequence AFTER removal:
        # positions >= src_pos shift down by one on the source core
        dseq = self.seq[rows, b]                       # (M, S)
        len_dst = self.seq_len[rows, b] - same
        pi = j - 1
        pio = pi + (same & (pi >= k))
        pred_t = np.where(pi >= 0, dseq[ar, np.maximum(pio, 0)], -1)
        sio = j + (same & (j >= k))
        succ_t = np.where(j < len_dst, dseq[ar, np.minimum(sio, dseq.shape[1] - 1)], -1)
        mpred[ar, u] = pred_t
        msucc[ar, u] = succ_t
        sel = pred_t >= 0
        msucc[ar[sel], pred_t[sel]] = u[sel]
        sel = succ_t >= 0
        mpred[ar[sel], succ_t[sel]] = u[sel]
        assign[ar, u] = b
        return PackedSolutions(assign=assign, mem=mem, mpred=mpred, msucc=msucc)

    def commit_move(self, i: int, mv) -> None:
        """Apply one accepted move to walk row ``i`` in place (seq splice via
        slice scatter + link refresh) — the packed ``tabu.apply_move``."""
        assert self.seq is not None
        src = self.seq[i, mv.src_proc]
        if src[mv.src_pos] != mv.task:
            raise ValueError("move does not match the walk's current sequence")
        src[mv.src_pos:-1] = src[mv.src_pos + 1:].copy()
        src[-1] = -1
        self.seq_len[i, mv.src_proc] -= 1
        dst = self.seq[i, mv.dst_proc]
        dst[mv.dst_pos + 1:] = dst[mv.dst_pos:-1].copy()
        dst[mv.dst_pos] = mv.task
        self.seq_len[i, mv.dst_proc] += 1
        self.assign[i, mv.task] = mv.dst_proc
        self._refresh_links(i)


def pack_solutions(inst: Instance, sols: Sequence[Solution]) -> PackedSolutions:
    """Stack candidate solutions into the array form the batch engine eats."""
    k, n = len(sols), inst.n_tasks
    assign = np.empty((k, n), dtype=np.int64)
    mem = np.empty((k, inst.n_data), dtype=np.int64)
    mpred = np.full((k, n), -1, dtype=np.int64)
    msucc = np.full((k, n), -1, dtype=np.int64)
    for i, sol in enumerate(sols):
        assign[i] = sol.assign
        mem[i] = sol.mem
        mp, ms = mpred[i], msucc[i]
        for seq in sol.proc_seq:
            if len(seq) < 2:
                continue
            s = np.asarray(seq, dtype=np.int64)
            mp[s[1:]] = s[:-1]
            ms[s[:-1]] = s[1:]
    return PackedSolutions(assign=assign, mem=mem, mpred=mpred, msucc=msucc)


# --------------------------------------------------------------------------- #
# results                                                                      #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class BatchEval:
    """Per-candidate evaluation results.  Rows with ``feasible[i] == False``
    correspond to cyclic disjunctive graphs (the scalar path's ``None``);
    their ``start``/``finish``/``makespan`` entries are undefined."""

    start: np.ndarray        # (K, n_tasks)
    finish: np.ndarray       # (K, n_tasks)
    makespan: np.ndarray     # (K,) — np.inf on infeasible rows
    feasible: np.ndarray     # (K,) bool — acyclic combined graph
    level: np.ndarray        # (K, n_tasks) DP level (any stable argsort of a
                             # row is a valid topological order of that row)
    q: np.ndarray | None = None          # (K, n_tasks) tails, incl. own dur
    slack: np.ndarray | None = None      # (K, n_tasks)
    critical: np.ndarray | None = None   # (K, n_tasks) bool
    peaks: np.ndarray | None = None      # (K, n_mems)
    mem_ok: np.ndarray | None = None     # (K,) bool — peaks within capacity

    def schedule(self, i: int) -> Schedule | None:
        """Materialize row ``i`` as a scalar :class:`Schedule` (or ``None``
        for a cyclic candidate), interchangeable with ``exact_schedule``."""
        if not self.feasible[i]:
            return None
        topo = np.argsort(self.level[i], kind="stable")
        return Schedule(
            start=self.start[i].copy(),
            finish=self.finish[i].copy(),
            makespan=float(self.makespan[i]),
            topo=topo,
        )


# --------------------------------------------------------------------------- #
# the engine                                                                   #
# --------------------------------------------------------------------------- #
class BatchEvaluator:
    """Evaluates K candidate solutions per call on one :class:`Instance`.

    Instance-level structure (CSR adjacency, edge owner maps, base degrees)
    is precomputed once; ``evaluate`` then runs pure array code.
    """

    def __init__(self, inst: Instance, backend: str = "torch",
                 device: str = "cuda", cache_size: int = 16, pack=None):
        """``device`` is the torch device of the ``"torch"`` backend's sweeps
        (``"cuda"`` raises when there is no GPU; the numpy/scalar backends
        ignore it).  On a GPU the sweeps run the CUDA kernel, on the CPU its
        plain PyTorch version.  ``pack`` (a
        ``repro_torch.instances.InstancePack``) hands over the already-padded
        dense graph instead of this evaluator deriving its own; only the
        ``"torch"`` backend's sweeps use a padded graph."""
        if backend == "device":
            raise ValueError(
                "backend='device' runs the whole search round on the device "
                "(core/device_search.py) and has no per-batch evaluator; "
                f"BatchEvaluator takes one of {BACKENDS}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.inst = inst
        self.backend = backend
        self.device = None
        if backend == "torch":
            from .._device import resolve_device

            self.device = resolve_device(device)
        n = inst.n_tasks
        # conjunctive edge list (src, dst) and degrees
        self._edge_src = np.repeat(np.arange(n), np.diff(inst.succ_indptr))
        self._edge_dst = inst.succ_idx
        self._base_indeg = np.diff(inst.pred_indptr).astype(np.int64)
        self._base_outdeg = np.diff(inst.succ_indptr).astype(np.int64)
        # owner task of every input/output CSR slot (for batched durations)
        self._in_owner = np.repeat(np.arange(n), np.diff(inst.in_indptr))
        self._out_owner = np.repeat(np.arange(n), np.diff(inst.out_indptr))
        self._dev_graphs = LRUCache(maxsize=cache_size)
        self._pack = pack
        self._graph = None  # lazy schedule_dp.DenseGraph (host arrays)

    def cache_info(self) -> dict:
        """Uploaded-graph cache counters (`{hits, misses, currsize, maxsize}`)."""
        return self._dev_graphs.info()

    # -- public API -------------------------------------------------------- #
    def evaluate(
        self,
        sols: Sequence[Solution] | PackedSolutions,
        *,
        tails: bool = False,
        peaks: bool = False,
    ) -> BatchEval:
        """Batched ``exact_schedule`` (+ optional ``heads_tails`` and
        ``memory_peaks``) for all candidates in one call."""
        if self.backend == "scalar":
            if isinstance(sols, PackedSolutions):
                raise ValueError("backend='scalar' needs Solution objects, not PackedSolutions")
            return self._evaluate_scalar(sols, tails=tails, peaks=peaks)
        packed = sols if isinstance(sols, PackedSolutions) else pack_solutions(self.inst, sols)
        dur = self._durations(packed)
        if self.backend == "torch":
            start, finish, level, feasible, q = _torch_sweeps(self, packed, dur, tails)
        else:
            start, finish, level, feasible = self._forward_dp(packed, dur)
            # the scalar heads_tails derives durations as finish - start; use
            # the same operands so Q stays bit-exact
            q = self._backward_q(packed, finish - start, feasible) if tails else None
        makespan = np.where(feasible, finish.max(axis=1), np.inf)
        out = BatchEval(start=start, finish=finish, makespan=makespan,
                        feasible=feasible, level=level)
        if tails:
            out.q = q
            out.slack = makespan[:, None] - start - q
            out.critical = out.slack <= _EPS * np.maximum(1.0, makespan)[:, None]
        if peaks:
            out.peaks, out.mem_ok = self._memory_peaks(packed, start, finish, feasible)
        return out

    def backward_tails(self, packed: PackedSolutions, dur: np.ndarray,
                       feasible: np.ndarray | None = None) -> np.ndarray:
        """Tails Q (Eq. 28) for already-scheduled states: the batched
        backward sweep alone, given per-row durations.  Bit-exact with the
        scalar ``heads_tails`` Q (pure max reductions over the same
        operands) on every backend."""
        if feasible is None:
            feasible = np.ones(packed.k, dtype=bool)
        return self._backward_q(packed, dur, feasible)

    # -- scalar oracle ------------------------------------------------------ #
    def _evaluate_scalar(self, sols: Sequence[Solution], *, tails: bool, peaks: bool) -> BatchEval:
        inst = self.inst
        k, n = len(sols), inst.n_tasks
        start = np.zeros((k, n))
        finish = np.zeros((k, n))
        level = np.zeros((k, n), dtype=np.int64)
        makespan = np.full(k, np.inf)
        feasible = np.zeros(k, dtype=bool)
        q = np.zeros((k, n)) if tails else None
        slack = np.zeros((k, n)) if tails else None
        critical = np.zeros((k, n), dtype=bool) if tails else None
        pk = np.zeros((k, inst.n_mems)) if peaks else None
        mem_ok = np.zeros(k, dtype=bool) if peaks else None
        for i, sol in enumerate(sols):
            sched = exact_schedule(inst, sol)
            if sched is None:
                continue
            feasible[i] = True
            start[i], finish[i] = sched.start, sched.finish
            makespan[i] = sched.makespan
            # topo position doubles as a level key: stable argsort recovers it
            level[i, sched.topo] = np.arange(n)
            if tails:
                _, q[i], slack[i], critical[i] = heads_tails(inst, sol, sched)
            if peaks:
                pk[i] = memory_peaks(inst, sol, sched)
                mem_ok[i] = bool(np.all(pk[i] <= inst.mem_cap * (1 + 1e-6) + 1e-6))
        return BatchEval(start=start, finish=finish, makespan=makespan, feasible=feasible,
                         level=level, q=q, slack=slack, critical=critical,
                         peaks=pk, mem_ok=mem_ok)

    # -- batched durations -------------------------------------------------- #
    def _durations(self, packed: PackedSolutions) -> np.ndarray:
        """Replays ``solution.durations`` per row (same cumsum-difference
        segment sums ⇒ bit-exact)."""
        inst = self.inst
        at = inst.access_time
        t_in = _segment_sums_2d(
            inst.data_size[inst.in_idx][None, :]
            * at[packed.assign[:, self._in_owner], packed.mem[:, inst.in_idx]],
            inst.in_indptr,
        )
        t_out = _segment_sums_2d(
            inst.data_size[inst.out_idx][None, :]
            * at[packed.assign[:, self._out_owner], packed.mem[:, inst.out_idx]],
            inst.out_indptr,
        )
        pt = inst.proc_time[np.arange(inst.n_tasks)[None, :], packed.assign]
        return t_in + pt + t_out

    # -- forward DP ---------------------------------------------------------- #
    def _forward_dp(self, packed: PackedSolutions, dur: np.ndarray):
        """Level-synchronous Kahn over the combined graph, all rows at once.

        Each round pops every currently in-degree-0 unfinished task of every
        candidate, finalizes its finish time, and relaxes its conjunctive and
        disjunctive successors with scatter-max.  Rows that stall before
        completing all tasks are cyclic ⇒ infeasible.
        """
        n = self.inst.n_tasks
        k = packed.k
        indeg = (self._base_indeg[None, :] + (packed.mpred >= 0)).ravel()
        start = np.zeros(k * n)
        finish = np.zeros((k, n))
        level = np.zeros((k, n), dtype=np.int64)
        done = np.zeros((k, n), dtype=bool)
        ready = (indeg == 0).reshape(k, n)
        lev = 0
        while ready.any():
            rk, ru = np.nonzero(ready)
            flat_u = rk * n + ru
            f = start[flat_u] + dur[rk, ru]
            finish[rk, ru] = f
            level[rk, ru] = lev
            done[rk, ru] = True
            # conjunctive successors of every popped (row, task), plus the
            # disjunctive successor (at most one per popped task), relaxed in
            # one flat scatter-max + one bincount degree decrement
            rows, dsts, fvals = _expand_edges(
                self.inst.succ_indptr, self.inst.succ_idx, rk, ru, f
            )
            targets = rows * n + dsts
            ms = packed.msucc[rk, ru]
            has = ms >= 0
            if has.any():
                targets = np.concatenate([targets, rk[has] * n + ms[has]])
                fvals = np.concatenate([fvals, f[has]])
            if len(targets):
                np.maximum.at(start, targets, fvals)
                indeg -= np.bincount(targets, minlength=k * n)
            ready = (indeg == 0).reshape(k, n) & ~done
            lev += 1
        feasible = done.all(axis=1)
        return start.reshape(k, n), finish, level, feasible

    # -- backward sweep ------------------------------------------------------ #
    def _backward_q(self, packed: PackedSolutions, dur: np.ndarray,
                    feasible: np.ndarray) -> np.ndarray:
        """Q[i] = T[i] + max_{j∈succ} Q[j], level-synchronous from the sinks.
        Pure-max reduction over the same operands as the scalar sweep ⇒
        bit-exact.  Infeasible rows are left untouched (zeros)."""
        n = self.inst.n_tasks
        k = packed.k
        outdeg = self._base_outdeg[None, :] + (packed.msucc >= 0)
        # never pop tasks of infeasible rows: poison their out-degrees
        outdeg[~feasible] = -1
        outdeg = outdeg.ravel()
        q = np.zeros((k, n))
        qmax = np.zeros(k * n)  # running max over successors' Q
        done = np.zeros((k, n), dtype=bool)
        ready = (outdeg == 0).reshape(k, n)
        while ready.any():
            rk, ru = np.nonzero(ready)
            qv = dur[rk, ru] + qmax[rk * n + ru]
            q[rk, ru] = qv
            done[rk, ru] = True
            rows, dsts, qvals = _expand_edges(
                self.inst.pred_indptr, self.inst.pred_idx, rk, ru, qv
            )
            targets = rows * n + dsts
            mp = packed.mpred[rk, ru]
            has = mp >= 0
            if has.any():
                targets = np.concatenate([targets, rk[has] * n + mp[has]])
                qvals = np.concatenate([qvals, qv[has]])
            if len(targets):
                np.maximum.at(qmax, targets, qvals)
                outdeg -= np.bincount(targets, minlength=k * n)
            ready = (outdeg == 0).reshape(k, n) & ~done
        return q

    # -- memory peaks --------------------------------------------------------- #
    def _memory_peaks(self, packed: PackedSolutions, start: np.ndarray,
                      finish: np.ndarray, feasible: np.ndarray):
        """All (candidate, tier) differential-array sweeps at once.

        Events of every candidate are keyed by (row, tier, time, Δ) and
        lexsorted — stable, so within ties the scalar path's
        births-then-deaths block order is preserved — then scattered into a
        padded per-bucket matrix whose row-wise cumsum replays each bucket's
        scalar summation order exactly.
        """
        inst = self.inst
        k, n_mems = packed.k, inst.n_mems
        birth, death = self._lifetimes(packed, start, finish)
        sizes = np.broadcast_to(inst.data_size[None, :], (k, inst.n_data))
        # per row: [all births | all deaths], matching the scalar concat order
        times = np.concatenate([birth, death], axis=1)          # (K, 2D)
        deltas = np.concatenate([sizes, -sizes], axis=1)        # (K, 2D)
        tiers = np.concatenate([packed.mem, packed.mem], axis=1)
        rows = np.broadcast_to(np.arange(k)[:, None], times.shape)
        keys = np.lexsort((deltas.ravel(), times.ravel(), tiers.ravel(), rows.ravel()))
        bucket = (rows.ravel() * n_mems + tiers.ravel())[keys]  # sorted bucket ids
        # position of each sorted event inside its bucket
        counts = np.bincount(bucket, minlength=k * n_mems)
        bucket_start = np.zeros(k * n_mems + 1, dtype=np.int64)
        np.cumsum(counts, out=bucket_start[1:])
        pos = np.arange(len(bucket)) - bucket_start[bucket]
        width = int(counts.max()) if len(counts) else 0
        padded = np.zeros((k * n_mems, width))
        padded[bucket, pos] = deltas.ravel()[keys]
        run = np.cumsum(padded, axis=1)
        # trailing padding repeats each bucket's final prefix (itself a real
        # prefix) and empty buckets stay all-zero, so the row max IS the
        # scalar per-bucket run.max() / 0.0 — no clamping needed
        peaks = (run.max(axis=1) if width else np.zeros(k * n_mems)).reshape(k, n_mems)
        cap = inst.mem_cap
        mem_ok = np.all(peaks <= cap[None, :] * (1 + 1e-6) + 1e-6, axis=1) & feasible
        return peaks, mem_ok

    def _lifetimes(self, packed: PackedSolutions, start: np.ndarray, finish: np.ndarray):
        """Batched ``data_lifetimes``: birth = producer start (0 for initial
        inputs), death = max consumer finish (fallback: birth / producer
        finish).  Max reductions only ⇒ bit-exact."""
        inst = self.inst
        k = packed.k
        prod = inst.producer
        has_prod = prod >= 0
        birth = np.zeros((k, inst.n_data))
        birth[:, has_prod] = start[:, prod[has_prod]]
        n_cons = np.diff(inst.cons_indptr)
        has_cons = n_cons > 0
        death = np.where(has_prod[None, :], finish[:, np.where(has_prod, prod, 0)], birth)
        if inst.cons_idx.size:
            owner = np.repeat(np.arange(inst.n_data), n_cons)
            cons_fin = finish[:, inst.cons_idx]                  # (K, Ec)
            dmax = np.full((k, inst.n_data), -np.inf)
            rows = np.broadcast_to(np.arange(k)[:, None], cons_fin.shape)
            cols = np.broadcast_to(owner[None, :], cons_fin.shape)
            np.maximum.at(dmax, (rows.ravel(), cols.ravel()), cons_fin.ravel())
            death = np.where(has_cons[None, :], dmax, death)
        return birth, death


# --------------------------------------------------------------------------- #
# array helpers                                                                #
# --------------------------------------------------------------------------- #
def _segment_sums_2d(values: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Row-wise CSR segment sums via the cumsum-difference trick — the exact
    computation ``solution.segment_sums`` does, applied per row."""
    k = values.shape[0]
    c = np.zeros((k, values.shape[1] + 1), dtype=np.float64)
    np.cumsum(values, axis=1, out=c[:, 1:])
    return c[:, indptr[1:]] - c[:, indptr[:-1]]


def _expand_edges(indptr: np.ndarray, idx: np.ndarray, rk: np.ndarray,
                  ru: np.ndarray, vals: np.ndarray):
    """For popped nodes ``(rk[i], ru[i])`` with value ``vals[i]``, expand the
    CSR rows ``idx[indptr[u]:indptr[u+1]]`` into flat (row, dst, val) arrays."""
    counts = indptr[ru + 1] - indptr[ru]
    total = int(counts.sum())
    if total == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, np.zeros(0)
    cum = np.cumsum(counts)
    flat = np.arange(total) + np.repeat(indptr[ru] - (cum - counts), counts)
    return np.repeat(rk, counts), idx[flat], np.repeat(vals, counts)


# --------------------------------------------------------------------------- #
# batched approximate evaluation (mixed strategy §V-F, fast path)              #
# --------------------------------------------------------------------------- #
def _sequential_segment_sums(vals: np.ndarray, loc: np.ndarray, counts: np.ndarray,
                             m: int) -> np.ndarray:
    """Per-segment *sequential* sums: segment i's values (rows ``loc == i`` of
    ``vals``, in order) accumulated left-to-right via a padded row cumsum —
    the same float op order as ``np.cumsum(segment)[-1]`` (trailing zeros add
    exactly), so the scalar oracle can replay it bit-for-bit."""
    width = int(counts.max()) if len(counts) else 0
    if width == 0 or len(vals) == 0:
        return np.zeros(m)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(vals)) - np.repeat(starts, counts)
    padded = np.zeros((m, width))
    padded[loc, pos] = vals
    return np.cumsum(padded, axis=1)[:, -1]


def _reprice_io(inst: Instance, mem: np.ndarray, tasks: np.ndarray,
                procs: np.ndarray, indptr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Move-in/move-out time of ``tasks`` re-priced on ``procs`` under the
    current allocation ``mem`` — the vectorized AT lookup for change-core
    moves (sum of ``size(d) * AT(proc, Mem(d))`` over the task's CSR blocks)."""
    m = len(tasks)
    loc, blocks, _ = _expand_edges(indptr, idx, np.arange(m), tasks, np.zeros(m))
    vals = inst.data_size[blocks] * inst.access_time[procs[loc], mem[blocks]]
    counts = indptr[tasks + 1] - indptr[tasks]
    return _sequential_segment_sums(vals, loc, counts, m)


def _new_seq_at(seq_dst: np.ndarray, u: np.ndarray, j: np.ndarray, k: np.ndarray,
                cc: np.ndarray, i: np.ndarray) -> np.ndarray:
    """Element ``i`` of each move's post-move destination sequence.

    The post-move sequence is the destination order with ``u`` removed at
    ``k`` (same-core moves only) and re-inserted at ``j``; instead of
    materializing it, index arithmetic maps ``i`` back to the original
    padded row ``seq_dst`` (the spare pad column keeps gathers in bounds).
    """
    t = i - (i > j)
    orig = t + (~cc & (t >= k))
    return np.where(i == j, u, seq_dst[np.arange(len(i)), orig])


def approx_eval_moves(
    inst: Instance,
    packed: PackedSolutions,
    row: int,
    mb: MoveBatch,
    r: np.ndarray,
    q: np.ndarray,
    dur: np.ndarray,
) -> np.ndarray:
    """Head/tail window estimates for all M moves of one walk in one pass.

    Array-parallel replay of ``tabu._approx_eval``: heads are recomputed
    along the affected window of each move's destination sequence (old heads
    elsewhere) and ``C'max`` is estimated as ``max R'(x) + Q_old(x)`` over
    the recomputed ops.  Bit-exact with the scalar oracle (``array_equal``):
    every float op is a max / add over identical operands, and change-core
    duration re-pricing replays the scalar sequential summation order.
    Returns ``np.inf`` for moves onto incompatible cores.
    """
    m = len(mb)
    if m == 0:
        return np.zeros(0)
    u, k, b, j, cc = mb.task, mb.src_pos, mb.dst_proc, mb.dst_pos, mb.cc
    mem = packed.mem[row]
    seq_dst = packed.seq[row][b]                     # (M, S) destination rows
    # --- duration re-pricing for change-core moves (vectorized AT lookup) --- #
    dur_u = dur[u].copy()
    q_u = q[u].copy()
    if cc.any():
        ci = np.nonzero(cc)[0]
        t_in = _reprice_io(inst, mem, u[ci], b[ci], inst.in_indptr, inst.in_idx)
        t_out = _reprice_io(inst, mem, u[ci], b[ci], inst.out_indptr, inst.out_idx)
        d_cc = t_in + inst.proc_time[u[ci], b[ci]] + t_out
        dur_u[ci] = d_cc
        q_u[ci] = q[u[ci]] - dur[u[ci]] + d_cc
    finite = np.isfinite(dur_u)
    # --- window bounds ------------------------------------------------------ #
    new_len = packed.seq_len[row][b] + cc            # same length for N7, +1 for cc
    w_lo = np.where(cc, j, np.minimum(k, j))
    w_hi = np.minimum(new_len, w_lo + APPROX_WINDOW)
    est = np.zeros(m)
    prev_finish = np.zeros(m)
    has_prev = w_lo > 0
    if has_prev.any():
        xp = seq_dst[has_prev, w_lo[has_prev] - 1]   # before both splice points
        prev_finish[has_prev] = r[xp] + dur[xp]
    # window tasks recomputed so far and their new heads (the scalar new_r)
    win_tasks = np.full((m, APPROX_WINDOW), -1, dtype=np.int64)
    win_heads = np.zeros((m, APPROX_WINDOW))
    for s in range(APPROX_WINDOW):
        idx = w_lo + s
        active = idx < w_hi
        if not active.any():
            break
        am = np.nonzero(active)[0]
        x = _new_seq_at(seq_dst[am], u[am], j[am], k[am], cc[am], idx[am])
        head = prev_finish[am].copy()
        loc, pj, _ = _expand_edges(inst.pred_indptr, inst.pred_idx,
                                   np.arange(len(am)), x, np.zeros(len(am)))
        if len(pj):
            f = r[pj] + dur[pj]                      # default: old head + dur
            gm = am[loc]
            for t in range(s):                       # preds recomputed in-window
                hit = win_tasks[gm, t] == pj
                if hit.any():
                    hh = np.nonzero(hit)[0]
                    gmh, pjh = gm[hh], pj[hh]
                    f[hh] = win_heads[gmh, t] + np.where(
                        pjh == u[gmh], dur_u[gmh], dur[pjh])
            np.maximum.at(head, loc, f)
        win_tasks[am, s] = x
        win_heads[am, s] = head
        is_u = x == u[am]
        dx = np.where(is_u, dur_u[am], dur[x])
        qx = np.where(is_u, q_u[am], q[x])
        est[am] = np.maximum(est[am], head + qx)
        prev_finish[am] = head + dx
    # ops past the window keep old tails; account the window exit edge
    tail = w_hi < new_len
    if tail.any():
        tm = np.nonzero(tail)[0]
        x = _new_seq_at(seq_dst[tm], u[tm], j[tm], k[tm], cc[tm], w_hi[tm])
        est[tm] = np.maximum(est[tm], prev_finish[tm] + q[x])
    est[~finite] = np.inf
    return est


# --------------------------------------------------------------------------- #
# torch path                                                                   #
# --------------------------------------------------------------------------- #
def _torch_sweeps(engine: BatchEvaluator, packed: PackedSolutions, dur: np.ndarray,
                  tails: bool):
    """Forward DP (+ optional backward Q) via ``repro_torch.kernels.schedule_dp``.

    ``n`` is padded to the dense graph's bucket; K is taken as it comes
    (nothing is compiled per shape).  The working type is float64, so the
    result is bit-exact with the NumPy engine.  ``dur``/``mpred``/``msucc``
    go host → device, the outputs come back and are cut to ``[:k, :n]``.
    Padding tasks never fire (start = finish = 0) and never touch real
    tasks.  The padded graph's index matrices and their CSR form (what the
    kernel reads) are uploaded once per ``(n_b, dtype, device)`` and live in
    the engine's LRU.  Peaks/lifetimes
    stay on the shared NumPy sweep — they are sort-bound and off the hot
    path.
    """
    import torch

    from ..kernels import schedule_dp as sdp

    n = engine.inst.n_tasks
    k = packed.k
    dev = engine.device
    fdt = torch.float64
    if engine._graph is None:
        engine._graph = (sdp.graph_from_pack(engine.inst, engine._pack)
                         if engine._pack is not None else sdp.dense_graph(engine.inst))
    n_b = engine._graph.n_b
    key = (n_b, str(fdt), str(dev))
    graph = engine._dev_graphs.get(key)
    if graph is None:
        graph = engine._graph.to(dev)
        engine._dev_graphs.put(key, graph)

    def upload(a, fill, dt):
        out = np.full((k, n_b), fill, dtype=dt)
        out[:, :n] = a
        return torch.from_numpy(out).to(dev)

    start, finish, level, n_done, q = sdp.sweep(
        graph,
        upload(dur, 0.0, np.float64),
        upload(packed.mpred, -1, np.int32),
        upload(packed.msucc, -1, np.int32),
        tails=tails,
    )

    def download(t, dt):
        return t.cpu().numpy().astype(dt, copy=False)

    feasible = download(n_done, np.int64) == n
    qq = download(q, np.float64)[:, :n] if tails else None
    return (download(start, np.float64)[:, :n], download(finish, np.float64)[:, :n],
            download(level, np.int64)[:, :n], feasible, qq)


# --------------------------------------------------------------------------- #
# convenience                                                                  #
# --------------------------------------------------------------------------- #
def batch_evaluate(
    inst: Instance,
    sols: Sequence[Solution],
    *,
    backend: str = "torch",
    device: str = "cuda",
    tails: bool = False,
    peaks: bool = False,
) -> BatchEval:
    """One-shot helper: ``BatchEvaluator(inst, backend, device).evaluate(...)``."""
    return BatchEvaluator(inst, backend=backend, device=device).evaluate(
        sols, tails=tails, peaks=peaks)
