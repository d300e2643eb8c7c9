"""Solution triple (Mem, AS, SC) and schedule evaluation for HDATS.

A solution is:
  * ``assign[i]``   — AS: processor executing task i
  * ``mem[d]``      — Mem: memory tier storing data block d
  * ``proc_seq[p]`` — SC: processing order on processor p (list of task ids);
                      together with the DAG this fixes all start times via
                      longest-path DP over the disjunctive graph.

``exact_schedule`` is the paper's *exact evaluation* (O(V+E) DP).
``heads_tails`` computes R, Q, Slack (Eqs. 27–29) and the critical set.
``memory_peaks`` is the paper's discretized differential-array feasibility
check (§IV-C): peak usage can only change at block move-in events.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mdfg import Instance

__all__ = [
    "Solution",
    "Schedule",
    "segment_sums",
    "durations",
    "exact_schedule",
    "heads_tails",
    "memory_peaks",
    "memory_feasible",
    "data_lifetimes",
]

_EPS = 1e-9


def segment_sums(values: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Sum ``values`` over CSR segments (handles empty segments)."""
    c = np.zeros(len(values) + 1, dtype=np.float64)
    np.cumsum(values, out=c[1:])
    return c[indptr[1:]] - c[indptr[:-1]]


@dataclasses.dataclass
class Solution:
    assign: np.ndarray                 # (n_tasks,) int
    mem: np.ndarray                    # (n_data,) int
    proc_seq: list[list[int]]          # per-processor task order

    def copy(self) -> "Solution":
        return Solution(
            assign=self.assign.copy(),
            mem=self.mem.copy(),
            proc_seq=[list(s) for s in self.proc_seq],
        )

    def positions(self, n_tasks: int) -> tuple[np.ndarray, np.ndarray]:
        """(machine_of_task, position_in_sequence) arrays."""
        mach = np.full(n_tasks, -1, dtype=np.int64)
        pos = np.full(n_tasks, -1, dtype=np.int64)
        for p, seq in enumerate(self.proc_seq):
            if seq:
                s = np.asarray(seq, dtype=np.int64)
                mach[s] = p
                pos[s] = np.arange(len(s))
        return mach, pos

    def machine_pred_succ(self, n_tasks: int) -> tuple[np.ndarray, np.ndarray]:
        mp = np.full(n_tasks, -1, dtype=np.int64)
        ms = np.full(n_tasks, -1, dtype=np.int64)
        for seq in self.proc_seq:
            if len(seq) < 2:
                continue
            s = np.asarray(seq, dtype=np.int64)
            mp[s[1:]] = s[:-1]
            ms[s[:-1]] = s[1:]
        return mp, ms


@dataclasses.dataclass
class Schedule:
    start: np.ndarray
    finish: np.ndarray
    makespan: float
    topo: np.ndarray                   # combined-graph topological order


def durations(inst: Instance, assign: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """dur(i) = t_in + PT + t_out for the given assignment/allocation."""
    at = inst.access_time  # (P, M)
    in_rate = at[assign[np.repeat(np.arange(inst.n_tasks), np.diff(inst.in_indptr))], mem[inst.in_idx]]
    t_in = segment_sums(inst.data_size[inst.in_idx] * in_rate, inst.in_indptr)
    out_rate = at[
        assign[np.repeat(np.arange(inst.n_tasks), np.diff(inst.out_indptr))], mem[inst.out_idx]
    ]
    t_out = segment_sums(inst.data_size[inst.out_idx] * out_rate, inst.out_indptr)
    pt = inst.proc_time[np.arange(inst.n_tasks), assign]
    return t_in + pt + t_out


def exact_schedule(inst: Instance, sol: Solution) -> Schedule | None:
    """Longest-path DP over conjunctive (DAG) + disjunctive (machine) edges.

    Returns None when the machine orders conflict with the precedence DAG
    (cyclic disjunctive graph ⇒ infeasible neighborhood move).
    """
    n = inst.n_tasks
    dur = durations(inst, sol.assign, sol.mem)
    mpred, msucc = sol.machine_pred_succ(n)

    indeg = np.diff(inst.pred_indptr).astype(np.int64)
    indeg += mpred >= 0
    stack = list(np.nonzero(indeg == 0)[0])
    topo = np.empty(n, dtype=np.int64)
    start = np.zeros(n)
    finish = np.zeros(n)
    k = 0
    succ_indptr, succ_idx = inst.succ_indptr, inst.succ_idx
    while stack:
        u = stack.pop()
        topo[k] = u
        k += 1
        s = start[u]
        f = s + dur[u]
        finish[u] = f
        for v in succ_idx[succ_indptr[u] : succ_indptr[u + 1]]:
            if f > start[v]:
                start[v] = f
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
        v = msucc[u]
        if v >= 0:
            if f > start[v]:
                start[v] = f
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    if k != n:
        return None
    return Schedule(start=start, finish=finish, makespan=float(finish.max()), topo=topo)


def heads_tails(
    inst: Instance, sol: Solution, sched: Schedule
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """R (heads = earliest starts), Q (tails incl. own duration), Slack, critical mask.

    R[i] = max_{j∈pred} R[j] + T[j]          (Eq. 27; = sched.start)
    Q[i] = T[i] + max_{j∈succ} Q[j]          (Eq. 28)
    Slack[i] = C_max − R[i] − Q[i]           (Eq. 29); critical ⇔ Slack == 0
    """
    n = inst.n_tasks
    dur = sched.finish - sched.start
    _, msucc = sol.machine_pred_succ(n)
    q = np.zeros(n)
    succ_indptr, succ_idx = inst.succ_indptr, inst.succ_idx
    for u in sched.topo[::-1]:
        best = 0.0
        for v in succ_idx[succ_indptr[u] : succ_indptr[u + 1]]:
            if q[v] > best:
                best = q[v]
        v = msucc[u]
        if v >= 0 and q[v] > best:
            best = q[v]
        q[u] = dur[u] + best
    r = sched.start
    slack = sched.makespan - r - q
    critical = slack <= _EPS * max(1.0, sched.makespan)
    return r, q, slack, critical


def data_lifetimes(inst: Instance, sched: Schedule) -> tuple[np.ndarray, np.ndarray]:
    """Block lifetime [birth, death): birth = producer start (move-in begins),
    death = last consumer finish (paper §IV-C); initial inputs live from t=0;
    producer finish if unconsumed."""
    prod = inst.producer
    has_prod = prod >= 0
    birth = np.zeros(inst.n_data)
    birth[has_prod] = sched.start[prod[has_prod]]
    death = np.where(has_prod, sched.finish[np.where(has_prod, prod, 0)], birth)
    if inst.cons_idx.size:
        n_cons = np.diff(inst.cons_indptr)
        dmax = np.full(inst.n_data, -np.inf)
        np.maximum.at(dmax, np.repeat(np.arange(inst.n_data), n_cons), sched.finish[inst.cons_idx])
        death = np.where(n_cons > 0, dmax, death)
    return birth, death


def memory_peaks(inst: Instance, sol: Solution, sched: Schedule) -> np.ndarray:
    """Peak concurrent usage per memory tier via the differential-array sweep."""
    birth, death = data_lifetimes(inst, sched)
    peaks = np.zeros(inst.n_mems)
    for m in range(inst.n_mems):
        sel = sol.mem == m
        if not sel.any():
            continue
        b, e, s = birth[sel], death[sel], inst.data_size[sel]
        # discretize: peaks only change at move-in events (paper's observation)
        events = np.concatenate([np.stack([b, s], 1), np.stack([e, -s], 1)], axis=0)
        # at equal time, apply releases (negative delta) first so back-to-back
        # reuse does not double count — lexsort key: time asc, then delta asc
        order = np.lexsort((events[:, 1], events[:, 0]))
        run = np.cumsum(events[order, 1])
        peaks[m] = run.max() if len(run) else 0.0
    return peaks


def memory_feasible(inst: Instance, sol: Solution, sched: Schedule, tol: float = 1e-6) -> bool:
    peaks = memory_peaks(inst, sol, sched)
    return bool(np.all(peaks <= inst.mem_cap * (1 + tol) + tol))
