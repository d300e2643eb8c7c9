"""ILP formulation of HDATS (§III-B) + exact optimum for micro instances.

No MILP solver ships in this container, so this module serves two purposes:

1. ``build_ilp`` materializes the paper's integer model (objective (1),
   constraints (2)–(26)) in a solver-agnostic dict form — variables, linear
   rows, senses — usable with any MILP solver offline and unit-tested for
   shape/consistency here.
2. ``brute_force_optimum`` enumerates (assignment × memory allocation ×
   topologically-consistent orders) for *micro* instances (≤ ~7 tasks) to get
   the provable optimum; the test suite checks tabu search reaches it.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from .mdfg import Instance
from .solution import Solution, exact_schedule, memory_feasible

__all__ = ["build_ilp", "brute_force_optimum"]


def build_ilp(inst: Instance, n_stages: int | None = None) -> dict:
    """Materialize the paper's ILP (time-indexed 'stage' formulation).

    Variables (paper names):
      x[i,j,k]   task i starts at stage k on processor j          (6)
      xp[i,j,k]  task i occupies stage k on processor j           (7)
      d[h,j]     data block h stored in memory j                  (14)
    Rows: (2) one start per task; (3) ≤1 task per (stage, proc);
          (8) one memory per block; (9) capacity; (17) precedence.
    Memory-access nodes (y, y') are folded into task occupancy the same way
    the heuristic folds them into move-in/move-out phases; the row constructor
    marks which paper constraint each row reproduces.
    """
    S = n_stages or 2 * inst.n_tasks
    n, P = inst.n_tasks, inst.n_procs
    var_names: list[str] = []
    var_index: dict[str, int] = {}

    def var(name: str) -> int:
        if name not in var_index:
            var_index[name] = len(var_names)
            var_names.append(name)
        return var_index[name]

    rows: list[dict] = []

    # (2): sum_{j,k} x[i,j,k] == 1
    for i in range(n):
        cols = [var(f"x[{i},{j},{k}]") for j in range(P) for k in range(S)
                if np.isfinite(inst.proc_time[i, j])]
        rows.append({"paper_eq": 2, "cols": cols, "coefs": [1.0] * len(cols),
                     "sense": "==", "rhs": 1.0})
    # (3): sum_i xp[i,j,m] <= 1  for each proc j, stage m
    for j in range(P):
        for mstage in range(S):
            cols = [var(f"xp[{i},{j},{mstage}]") for i in range(n)
                    if np.isfinite(inst.proc_time[i, j])]
            rows.append({"paper_eq": 3, "cols": cols, "coefs": [1.0] * len(cols),
                         "sense": "<=", "rhs": 1.0})
    # (8): each data block in exactly one memory
    for h in range(inst.n_data):
        cols = [var(f"d[{h},{m}]") for m in range(inst.n_mems) if inst.data_mem_ok[h, m]]
        rows.append({"paper_eq": 8, "cols": cols, "coefs": [1.0] * len(cols),
                     "sense": "==", "rhs": 1.0})
    # (9): capacity per memory
    for m in range(inst.n_mems):
        if np.isinf(inst.mem_cap[m]):
            continue
        cols, coefs = [], []
        for h in range(inst.n_data):
            if inst.data_mem_ok[h, m]:
                cols.append(var(f"d[{h},{m}]"))
                coefs.append(float(inst.data_size[h]))
        rows.append({"paper_eq": 9, "cols": cols, "coefs": coefs,
                     "sense": "<=", "rhs": float(inst.mem_cap[m])})
    # (17): precedence  sum (k + RT(u,j)) x[u,j,k] <= sum k x[v,j,k]
    for e in range(len(inst.succ_idx)):
        pass  # expanded below from CSR
    for u in range(n):
        for v in inst.succs(u):
            cols, coefs = [], []
            for j in range(P):
                if not np.isfinite(inst.proc_time[u, j]):
                    continue
                for k in range(S):
                    cols.append(var(f"x[{u},{j},{k}]"))
                    coefs.append(float(k + inst.proc_time[u, j]))
            for j in range(P):
                if not np.isfinite(inst.proc_time[v, j]):
                    continue
                for k in range(S):
                    cols.append(var(f"x[{int(v)},{j},{k}]"))
                    coefs.append(float(-k))
            rows.append({"paper_eq": 17, "cols": cols, "coefs": coefs,
                         "sense": "<=", "rhs": 0.0})
    return {
        "n_vars": len(var_names),
        "var_names": var_names,
        "rows": rows,
        "objective": "min makespan  — eq (1): min max_i,j RT(i,j) + PT(v_i, P_j)",
        "n_stages": S,
    }


def _orders(inst: Instance) -> list[list[int]]:
    """All topological orders (micro instances only)."""
    n = inst.n_tasks
    orders: list[list[int]] = []
    indeg0 = np.diff(inst.pred_indptr).astype(int)

    def rec(order: list[int], indeg: np.ndarray, remaining: set[int]) -> None:
        if not remaining:
            orders.append(list(order))
            return
        for u in sorted(remaining):
            if indeg[u] == 0:
                nd = indeg.copy()
                for v in inst.succs(u):
                    nd[v] -= 1
                order.append(u)
                rec(order, nd, remaining - {u})
                order.pop()

    rec([], indeg0, set(range(n)))
    return orders


def brute_force_optimum(
    inst: Instance,
    max_tasks: int = 7,
    *,
    time_limit: float | None = None,
    max_evals: int | None = None,
    stats: dict | None = None,
) -> tuple[float, Solution]:
    """Provable optimum by exhaustive enumeration (micro instances).

    ``time_limit`` / ``max_evals`` bound the enumeration; when either trips,
    the best incumbent found so far is returned and ``stats["exhaustive"]``
    is False (so the result is an upper bound, not a certified optimum).
    ``stats``, when given, also receives ``n_evals``.
    """
    if inst.n_tasks > max_tasks:
        raise ValueError("brute force limited to micro instances")
    t0 = time.monotonic()
    best_mk, best_sol = np.inf, None
    n_evals = 0
    exhausted_budget = False
    proc_choices = [list(inst.compatible_procs(i)) for i in range(inst.n_tasks)]
    mem_choices = [list(inst.compatible_mems(d)) for d in range(inst.n_data)]
    orders = _orders(inst)
    for assign in itertools.product(*proc_choices):
        assign_arr = np.array(assign, dtype=np.int64)
        for order in orders:
            seqs: list[list[int]] = [[] for _ in range(inst.n_procs)]
            for t in order:
                seqs[assign_arr[t]].append(t)
            for mems in itertools.product(*mem_choices):
                if (max_evals is not None and n_evals >= max_evals) or (
                    time_limit is not None and time.monotonic() - t0 > time_limit
                ):
                    exhausted_budget = True
                    break
                sol = Solution(assign=assign_arr.copy(),
                               mem=np.array(mems, dtype=np.int64),
                               proc_seq=[list(s) for s in seqs])
                sched = exact_schedule(inst, sol)
                n_evals += 1
                if sched is None:
                    continue
                if sched.makespan < best_mk and memory_feasible(inst, sol, sched):
                    best_mk, best_sol = sched.makespan, sol
            if exhausted_budget:
                break
        if exhausted_budget:
            break
    if stats is not None:
        stats["n_evals"] = n_evals
        stats["exhaustive"] = not exhausted_budget
        stats["elapsed"] = time.monotonic() - t0
    if best_sol is None:
        raise RuntimeError(
            "brute force found no feasible solution"
            + (" within the budget" if exhausted_budget else "")
        )
    return best_mk, best_sol
