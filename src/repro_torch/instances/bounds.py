"""Family-independent makespan lower bounds.

The paper reports TS-vs-LB improvement on one workload family, which says
nothing about how close either is to optimal on a *different* graph shape.
Papp et al. ("Multiprocessor Scheduling with Memory Constraints") compare
schedulers across families by normalizing against instance lower bounds;
this module provides three classical, always-valid bounds so the suite
sweep can report ``makespan / lower_bound`` comparably across every
registered family:

* :func:`cp_lower_bound` — critical path: the longest DAG path where every
  task takes its best-case duration (fastest compatible core, every block
  on its fastest allowed tier).  No schedule can beat its longest chain.
* :func:`work_lower_bound` — total work: the sum of best-case durations
  spread over all cores.  Even perfect load balance cannot beat it.
* :func:`mem_lower_bound` — memory spill: fast-tier capacity is finite, so
  at least ``total volume − fast capacity`` units of data must live on a
  slow tier; each spilled unit pays at least the *cheapest* fast→slow
  access-rate gap once.  Added on top of the work bound and spread over all
  cores (both minima ⇒ still a valid bound, deliberately loose).

``lower_bound`` is the max of the three; ``bounds`` returns all of them.
"""
from __future__ import annotations

import numpy as np

from ..core.mdfg import Instance

__all__ = [
    "best_case_durations",
    "cp_lower_bound",
    "work_lower_bound",
    "mem_lower_bound",
    "lower_bound",
    "bounds",
]


def best_case_durations(inst: Instance) -> np.ndarray:
    """Per-task duration lower bound: ``min_p (t_in + PT + t_out)`` with
    every block priced at its fastest compatible tier for that core."""
    # at_min[p, d] = min over allowed tiers of AT(p, m)
    at = np.where(inst.data_mem_ok[None, :, :].transpose(0, 2, 1),
                  inst.access_time[:, :, None], np.inf)     # (P, M, D)
    at_min = at.min(axis=1)                                 # (P, D)
    vals_in = inst.data_size[inst.in_idx][None, :] * at_min[:, inst.in_idx]
    vals_out = inst.data_size[inst.out_idx][None, :] * at_min[:, inst.out_idx]
    c_in = np.zeros((inst.n_procs, len(inst.in_idx) + 1))
    np.cumsum(vals_in, axis=1, out=c_in[:, 1:])
    c_out = np.zeros((inst.n_procs, len(inst.out_idx) + 1))
    np.cumsum(vals_out, axis=1, out=c_out[:, 1:])
    t_in = c_in[:, inst.in_indptr[1:]] - c_in[:, inst.in_indptr[:-1]]
    t_out = c_out[:, inst.out_indptr[1:]] - c_out[:, inst.out_indptr[:-1]]
    per_proc = t_in.T + inst.proc_time + t_out.T            # (n_tasks, P)
    return per_proc.min(axis=1)


def cp_lower_bound(inst: Instance, dur_lb: np.ndarray | None = None) -> float:
    """Longest best-case-duration path through the precedence DAG."""
    dur = best_case_durations(inst) if dur_lb is None else dur_lb
    finish = np.zeros(inst.n_tasks)
    for u in inst.topological_order():
        preds = inst.preds(u)
        head = finish[preds].max() if len(preds) else 0.0
        finish[u] = head + dur[u]
    return float(finish.max()) if inst.n_tasks else 0.0


def work_lower_bound(inst: Instance, dur_lb: np.ndarray | None = None) -> float:
    """Total best-case work spread perfectly over all cores."""
    dur = best_case_durations(inst) if dur_lb is None else dur_lb
    return float(dur.sum() / max(1, inst.n_procs))


def mem_lower_bound(inst: Instance, dur_lb: np.ndarray | None = None) -> float:
    """Work bound plus the unavoidable per-task spill surcharge.

    Capacity constrains *peak concurrent* usage (blocks have lifetimes and
    fast tiers are reused), so total volume over capacity proves nothing.
    What IS schedule-independent: all blocks a task touches (its inputs and
    outputs) are live simultaneously while it executes, and the allocation
    ``Mem`` is static per block — so whenever a task's touched fast-eligible
    volume exceeds the combined finite-tier capacity, the excess must sit on
    a slow tier *during that task's own accesses*.  Each such unit costs the
    task at least the cheapest per-core ``AT(slow) − AT(best)`` gap over the
    best-case pricing already counted in ``dur_lb``; summing per task never
    double-counts because each task's accesses are separate real work.
    """
    dur = best_case_durations(inst) if dur_lb is None else dur_lb
    finite = np.isfinite(inst.mem_cap)
    if finite.all() or not finite.any():
        return work_lower_bound(inst, dur)
    fast_cap = float(inst.mem_cap[finite].sum())
    # blocks forced to the slow tier already pay the slow rate in dur_lb
    fast_ok = inst.data_mem_ok[:, finite].any(axis=1)
    size_fastok = np.where(fast_ok, inst.data_size, 0.0)
    v_in = _segment_sums(size_fastok[inst.in_idx], inst.in_indptr)
    v_out = _segment_sums(size_fastok[inst.out_idx], inst.out_indptr)
    spill = float(np.maximum(0.0, v_in + v_out - fast_cap).sum())
    if spill <= 0.0:
        return work_lower_bound(inst, dur)
    gap = float((inst.access_time[:, ~finite].min(axis=1)
                 - inst.access_time.min(axis=1)).min())
    surcharge = spill * max(0.0, gap)
    return float((dur.sum() + surcharge) / max(1, inst.n_procs))


def _segment_sums(values: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    c = np.zeros(len(values) + 1)
    np.cumsum(values, out=c[1:])
    return c[indptr[1:]] - c[indptr[:-1]]


def lower_bound(inst: Instance) -> float:
    """``max`` of the critical-path, work, and memory-spill bounds."""
    dur = best_case_durations(inst)
    return max(cp_lower_bound(inst, dur), work_lower_bound(inst, dur),
               mem_lower_bound(inst, dur))


def bounds(inst: Instance) -> dict:
    """All bounds at once (the suite sweep reports these per instance)."""
    dur = best_case_durations(inst)
    out = {
        "cp": cp_lower_bound(inst, dur),
        "work": work_lower_bound(inst, dur),
        "mem": mem_lower_bound(inst, dur),
    }
    out["lb"] = max(out.values())
    return out
