"""Memory-access data-flow graph (MDFG) — the HDATS problem instance.

Faithful to §III of the paper: a node-weighted DAG of *tasks* (V1) and *data
blocks* (D), heterogeneous processors P with per-(task, processor) processing
times PT, memory tiers M with capacities S(M_j) and NUMA access-time function
AT(P_i, M_j).  Memory-access operations (V2) are represented implicitly as the
move-in / move-out phases of each task (the ILP in ``ilp.py`` keeps them
explicit); each task's wall time on processor p under allocation Mem is::

    dur(i, p, Mem) = t_in(i, p, Mem) + PT(i, p) + t_out(i, p, Mem)
    t_in  = sum_{d in inputs(i)}  size(d) * AT(p, Mem(d))
    t_out = sum_{d in outputs(i)} size(d) * AT(p, Mem(d))

Everything is stored as flat numpy arrays + CSR-style adjacency for speed —
the tabu search evaluates thousands of schedules per second on instances with
hundreds of tasks (paper Table II scale).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "InfeasibleInstanceError",
    "Instance",
    "random_instance",
    "validate_instance",
]


class InfeasibleInstanceError(RuntimeError):
    """No feasible placement exists for a data block.

    Raised by the constructors when a block fits in none of its compatible
    memory tiers (typically an instance without an unbounded fallback tier —
    ``validate_instance`` would have rejected it up front).  Carries the
    offending block, the producing task (-1 for initial inputs), and the
    tiers that were tried, so callers can report *which* constraint broke.
    """

    def __init__(self, message: str, *, block: int, task: int,
                 tiers_tried: tuple[int, ...] = ()):
        super().__init__(message)
        self.block = int(block)
        self.task = int(task)
        self.tiers_tried = tuple(int(t) for t in tiers_tried)


def _csr(n_src: int, pairs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Build CSR (indptr, indices) from an (m, 2) array of (src, dst) pairs."""
    if len(pairs) == 0:
        return np.zeros(n_src + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    counts = np.bincount(pairs[:, 0], minlength=n_src)
    indptr = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, pairs[:, 1].astype(np.int64)


@dataclasses.dataclass
class Instance:
    """One HDATS problem instance (an MDFG + platform description).

    Graph:
      n_tasks, n_data        — |V1|, |D|
      task_edges             — (m, 2) direct task→task precedence pairs
      producer[d]            — task producing data block d (-1 = initial input,
                               present from t=0)
      cons_indptr/cons_idx   — CSR: data block d → consumer tasks
      in_indptr/in_idx       — CSR: task i → input data blocks
      out_indptr/out_idx     — CSR: task i → output data blocks

    Platform:
      proc_time[i, p]        — PT(v_i, P_j); np.inf = incompatible core
      data_size[d]           — block size (capacity units)
      mem_cap[m]             — S(M_j); np.inf for the unbounded slow tier
      access_time[p, m]      — AT(P_i, M_j) time per size-unit
      mem_level[m]           — greedy preference rank (0 = most preferred /
                               fastest tier; paper's highType2 < highType1 < low)
      data_mem_ok[d, m]      — compatibility mask (paper: candidate memories for
                               each block may be a subset)
    """

    n_tasks: int
    n_data: int
    task_edges: np.ndarray
    producer: np.ndarray
    cons_indptr: np.ndarray
    cons_idx: np.ndarray
    in_indptr: np.ndarray
    in_idx: np.ndarray
    out_indptr: np.ndarray
    out_idx: np.ndarray
    proc_time: np.ndarray
    data_size: np.ndarray
    mem_cap: np.ndarray
    access_time: np.ndarray
    mem_level: np.ndarray
    data_mem_ok: np.ndarray
    # Combined task→task precedence closure over data (producer → consumer),
    # deduplicated with task_edges.  CSR, built in __post_init__.
    pred_indptr: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    pred_idx: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    succ_indptr: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    succ_idx: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    name: str = "instance"

    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        self._topo_cache: np.ndarray | None = None
        pairs = [np.asarray(self.task_edges, dtype=np.int64).reshape(-1, 2)]
        # data-induced precedence: producer(d) → each consumer of d
        prod = self.producer
        for d in range(self.n_data):
            p = prod[d]
            if p < 0:
                continue
            cons = self.cons_idx[self.cons_indptr[d] : self.cons_indptr[d + 1]]
            if len(cons):
                pairs.append(np.stack([np.full(len(cons), p, dtype=np.int64), cons], axis=1))
        allp = np.concatenate(pairs, axis=0) if pairs else np.zeros((0, 2), np.int64)
        allp = allp[allp[:, 0] != allp[:, 1]]
        if len(allp):
            allp = np.unique(allp, axis=0)
        self.succ_indptr, self.succ_idx = _csr(self.n_tasks, allp)
        self.pred_indptr, self.pred_idx = _csr(self.n_tasks, allp[:, ::-1] if len(allp) else allp)

    # convenience accessors ------------------------------------------------
    @property
    def n_procs(self) -> int:
        return self.proc_time.shape[1]

    @property
    def n_mems(self) -> int:
        return len(self.mem_cap)

    def inputs(self, i: int) -> np.ndarray:
        return self.in_idx[self.in_indptr[i] : self.in_indptr[i + 1]]

    def outputs(self, i: int) -> np.ndarray:
        return self.out_idx[self.out_indptr[i] : self.out_indptr[i + 1]]

    def consumers(self, d: int) -> np.ndarray:
        return self.cons_idx[self.cons_indptr[d] : self.cons_indptr[d + 1]]

    def preds(self, i: int) -> np.ndarray:
        return self.pred_idx[self.pred_indptr[i] : self.pred_indptr[i + 1]]

    def succs(self, i: int) -> np.ndarray:
        return self.succ_idx[self.succ_indptr[i] : self.succ_indptr[i + 1]]

    def compatible_procs(self, i: int) -> np.ndarray:
        return np.nonzero(np.isfinite(self.proc_time[i]))[0]

    def compatible_mems(self, d: int) -> np.ndarray:
        return np.nonzero(self.data_mem_ok[d])[0]

    def topological_order(self) -> np.ndarray:
        """Kahn topological order over the task precedence DAG.

        Computed once and cached (instances are treated as immutable once
        built; bounds and sweep loops hit this per instance).  The cached
        array is returned read-only so an accidental in-place edit fails
        loudly instead of corrupting every later caller.
        """
        if self._topo_cache is not None:
            return self._topo_cache
        indeg = np.diff(self.pred_indptr).astype(np.int64)
        order = np.empty(self.n_tasks, dtype=np.int64)
        stack = list(np.nonzero(indeg == 0)[0])
        k = 0
        while stack:
            u = stack.pop()
            order[k] = u
            k += 1
            for v in self.succs(u):
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if k != self.n_tasks:
            raise ValueError("instance precedence graph is cyclic")
        order.setflags(write=False)
        self._topo_cache = order
        return order


def validate_instance(inst: Instance) -> None:
    """Sanity checks; raises ValueError on malformed instances."""
    if inst.proc_time.shape != (inst.n_tasks, inst.n_procs):
        raise ValueError("proc_time must be (n_tasks, n_procs)")
    if not (np.isfinite(inst.proc_time).any(axis=1)).all():
        raise ValueError("task with no compatible core")
    if not inst.data_mem_ok.any(axis=1).all():
        raise ValueError("data block with no compatible memory")
    if not (inst.data_size > 0).all():
        raise ValueError("data block sizes must be positive")
    if not np.isinf(inst.mem_cap).any():
        raise ValueError("need an unbounded fallback tier for feasibility")
    slow_ok = inst.data_mem_ok[:, np.isinf(inst.mem_cap)].any(axis=1)
    if not slow_ok.all():
        raise ValueError("every block must be storable in the unbounded tier")
    inst.topological_order()  # raises if cyclic


# ---------------------------------------------------------------------- #
# Random instance generator — paper Table II                             #
# ---------------------------------------------------------------------- #
def random_instance(
    rng: np.random.Generator | int = 0,
    *,
    n_tasks: int | None = None,
    n_data: int | None = None,
    n_fast_cores: int = 2,
    n_slow_cores: int = 8,
    edges_per_task: float = 8.0,
    tin_tproc_tout: Sequence[float] = (7.0, 15.0, 5.0),
    access_ratio: float = 1.2,          # S_high : S_low speed ⇒ slow-tier time ×1.2
    fast_mem_fraction: float = 0.2,     # capacity of fast tier / total data volume
    n_fast_tiers: int = 2,              # paper: highType2 (global) + highType1 (local)
    slow_core_factor: tuple[float, float] = (1.4, 2.2),
    core_restrict_prob: float = 0.1,    # fraction of tasks restricted to fast cores
    data_size_range: tuple[int, int] = (1, 15000),
    name: str = "random",
) -> Instance:
    """Generate an instance following the paper's benchmark recipe (Table II):

    tasks ∈ [200, 300], data blocks ∈ [500, 700], edges ≈ 8 × tasks,
    2 high-speed + 8 general cores, T_in : T_proc : T_out ≈ 7 : 15 : 5,
    fast : slow access-time 1 : 1.2, data sizes ∈ [1, 15000], slow tier ∞.

    Delegates to the registered ``random_layered`` family
    (``repro_torch.instances.generators``), whose DAG wiring is pure array ops.
    """
    from ..instances.generators import random_layered

    inst = random_layered(
        np.random.default_rng(rng),
        n_tasks=n_tasks,
        n_data=n_data,
        edges_per_task=edges_per_task,
        data_size_range=data_size_range,
        name=name,
        n_fast_cores=n_fast_cores,
        n_slow_cores=n_slow_cores,
        tin_tproc_tout=tin_tproc_tout,
        access_ratio=access_ratio,
        fast_mem_fraction=fast_mem_fraction,
        n_fast_tiers=n_fast_tiers,
        slow_core_factor=slow_core_factor,
        core_restrict_prob=core_restrict_prob,
    )
    validate_instance(inst)
    return inst
