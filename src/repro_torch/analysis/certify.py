"""Independent certificate checker for HDATS solutions (paper §III ILP).

Given an :class:`~repro_torch.core.mdfg.Instance` and a solution triple
``(assign, mem, proc_seq)`` — or a full :class:`SolveReport` — this module
verifies every ILP constraint class and returns a structured
:class:`Certificate` with per-constraint violation witnesses.

Deliberately written *from the paper*, not from the repo's evaluators:

* durations are recomputed per task with plain Python loops over the
  input/output CSR (eqs. (4)–(5): ``t_in + PT + t_out`` priced by
  ``AT(p, Mem(d))``), not via ``core.solution.durations``'s vectorized
  segment sums;
* start/finish times are re-derived by a **machine-head event
  simulation** — each processor keeps a head pointer into its sequence
  and a task is dispatched when its DAG predecessors have finished —
  which is a different algorithm from ``exact_schedule``'s Kahn
  longest-path DP (a deadlocked simulation is exactly a disjunctive
  cycle, reported as a ``precedence`` violation with stuck-task
  witnesses);
* precedence edges are re-derived from the *defining* fields
  (``task_edges`` plus producer→consumer pairs), bypassing the cached
  pred/succ CSR closure that all backends share;
* capacity is checked by an independent per-tier event sweep over block
  lifetimes (releases before acquires at ties, §IV-C).

Constraint kinds map onto the ILP rows built by ``core.ilp.build_ilp``
(see :data:`CONSTRAINT_EQS`); the adversarial tests in
``tests/test_analysis_certify.py`` corrupt a known-good solution along
each axis and assert the exact kind fires.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.mdfg import Instance
from ..core.solution import Solution

__all__ = [
    "CONSTRAINT_EQS",
    "Certificate",
    "Violation",
    "certify_report",
    "certify_schedule",
    "certify_solution",
    "simulate_schedule",
    "task_durations",
]

#: Constraint kind → the ILP row family it certifies (paper §III).
CONSTRAINT_EQS = {
    "assignment": "eq (2): each task runs exactly once, on one compatible processor",
    "overlap": "eq (3): at most one task per (processor, instant) — disjunctive non-overlap",
    "allocation": "eq (8): each data block resides in exactly one compatible memory tier",
    "capacity": "eq (9): instantaneous usage within S(M_j) on every tier",
    "precedence": "eq (17): every consumer starts no earlier than its producers finish",
    "residency": "§IV-C: a block is resident from its producer's start (move-out begins "
    "inside the producer window) through its last consumer's finish",
    "duration": "eqs (4)-(5): task window equals t_in + PT + t_out under (AS, Mem)",
    "makespan": "objective (1): the reported C_max equals the latest finish time",
    "feasibility": "reported memory-feasibility claim vs the independent capacity sweep",
}

_DEF_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Violation:
    """One certified constraint breach with its witnesses.

    ``task`` / ``datum`` / ``proc`` / ``tier`` are -1 when not applicable;
    ``time`` is NaN when the breach has no single witness instant.
    """

    kind: str
    message: str
    task: int = -1
    datum: int = -1
    proc: int = -1
    tier: int = -1
    time: float = float("nan")

    def as_json(self) -> dict:
        d = {"kind": self.kind, "message": self.message}
        for f in ("task", "datum", "proc", "tier"):
            v = getattr(self, f)
            if v >= 0:
                d[f] = v
        if not math.isnan(self.time):
            d["time"] = self.time
        return d


@dataclasses.dataclass
class Certificate:
    """Outcome of certifying one solution against the ILP constraints."""

    ok: bool
    makespan: float
    violations: list[Violation]
    checked: dict[str, int]

    def kinds(self) -> set[str]:
        return {v.kind for v in self.violations}

    def by_kind(self, kind: str) -> list[Violation]:
        return [v for v in self.violations if v.kind == kind]

    def summary(self) -> str:
        if self.ok and not self.violations:
            return f"certified: makespan={self.makespan:.6g}, all constraints hold"
        parts = []
        for kind in CONSTRAINT_EQS:
            vs = self.by_kind(kind)
            if vs:
                parts.append(f"{kind} x{len(vs)} (first: {vs[0].message})")
        status = "certified (with recorded infeasibilities)" if self.ok else "REJECTED"
        return f"{status}: " + "; ".join(parts)

    def as_json(self) -> dict:
        return {
            "ok": self.ok,
            "makespan": self.makespan,
            "checked": dict(self.checked),
            "violations": [v.as_json() for v in self.violations],
        }


# --------------------------------------------------------------------- #
# Independent re-derivations                                            #
# --------------------------------------------------------------------- #
def task_durations(inst: Instance, assign: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """Recompute dur(i) = t_in + PT + t_out with plain per-task loops.

    Pricing follows eqs. (4)-(5): every input/output block of task i moves
    at ``size(d) * AT(assign[i], mem[d])``.  Incompatible (task, proc)
    pairs yield inf — the caller reports those as assignment violations.
    """
    n = inst.n_tasks
    dur = np.empty(n, dtype=np.float64)
    at = inst.access_time
    size = inst.data_size
    for i in range(n):
        p = int(assign[i])
        t = float(inst.proc_time[i, p])
        for d in inst.in_idx[inst.in_indptr[i] : inst.in_indptr[i + 1]]:
            t += float(size[d]) * float(at[p, int(mem[d])])
        for d in inst.out_idx[inst.out_indptr[i] : inst.out_indptr[i + 1]]:
            t += float(size[d]) * float(at[p, int(mem[d])])
        dur[i] = t
    return dur


def _precedence_edges(inst: Instance) -> list[tuple[int, int]]:
    """Re-derive the conjunctive edge set from the defining fields only."""
    edges: set[tuple[int, int]] = set()
    for u, v in np.asarray(inst.task_edges, dtype=np.int64).reshape(-1, 2):
        if u != v:
            edges.add((int(u), int(v)))
    for d in range(inst.n_data):
        p = int(inst.producer[d])
        if p < 0:
            continue
        for c in inst.cons_idx[inst.cons_indptr[d] : inst.cons_indptr[d + 1]]:
            if int(c) != p:
                edges.add((p, int(c)))
    return sorted(edges)


def simulate_schedule(
    inst: Instance, sol: Solution, dur: np.ndarray
) -> tuple[np.ndarray, np.ndarray, list[Violation]]:
    """Machine-head event simulation of the disjunctive schedule.

    Each processor holds a head pointer into its sequence; in repeated
    passes, any head task whose DAG predecessors are all finished is
    dispatched at ``max(core_free, max pred finish)``.  A full pass with
    no progress means the machine orders conflict with the DAG — a
    disjunctive cycle — reported as ``precedence`` violations naming the
    stuck head tasks and their unfinished predecessors.
    """
    n = inst.n_tasks
    edges = _precedence_edges(inst)
    preds: list[list[int]] = [[] for _ in range(n)]
    for u, v in edges:
        preds[v].append(u)
    seqs = [list(map(int, s)) for s in sol.proc_seq]
    heads = [0] * len(seqs)
    core_free = [0.0] * len(seqs)
    done = np.zeros(n, dtype=bool)
    start = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    remaining = sum(len(s) for s in seqs)
    while remaining:
        progress = False
        for p, seq in enumerate(seqs):
            while heads[p] < len(seq):
                t = seq[heads[p]]
                if not all(done[u] for u in preds[t]):
                    break
                s = core_free[p]
                for u in preds[t]:
                    if finish[u] > s:
                        s = float(finish[u])
                start[t] = s
                finish[t] = s + float(dur[t])
                core_free[p] = finish[t]
                done[t] = True
                heads[p] += 1
                remaining -= 1
                progress = True
        if not progress:
            viols = []
            for p, seq in enumerate(seqs):
                if heads[p] < len(seq):
                    t = seq[heads[p]]
                    waiting = [u for u in preds[t] if not done[u]]
                    viols.append(
                        Violation(
                            "precedence",
                            f"task {t} at head of proc {p} deadlocked waiting on "
                            f"unfinished predecessors {waiting} — the machine orders "
                            "form a disjunctive cycle with the DAG",
                            task=t,
                            proc=p,
                        )
                    )
            return start, finish, viols
    return start, finish, []


# --------------------------------------------------------------------- #
# Constraint checks                                                     #
# --------------------------------------------------------------------- #
def _check_structure(inst: Instance, sol: Solution) -> tuple[list[Violation], dict]:
    """eq (2) assignment + sequencing consistency, eq (8) allocation."""
    viols: list[Violation] = []
    n = inst.n_tasks
    checked = {"assignment": n, "allocation": inst.n_data}
    assign = np.asarray(sol.assign)
    if len(assign) != n:
        viols.append(
            Violation("assignment", f"assign has {len(assign)} entries for {n} tasks")
        )
        return viols, checked
    for i in range(n):
        p = int(assign[i])
        if not (0 <= p < inst.n_procs):
            viols.append(
                Violation("assignment", f"task {i} assigned to invalid proc {p}", task=i)
            )
        elif not np.isfinite(inst.proc_time[i, p]):
            viols.append(
                Violation(
                    "assignment",
                    f"task {i} assigned to incompatible proc {p} (PT is inf)",
                    task=i,
                    proc=p,
                )
            )
    # each task appears exactly once across sequences, on its assigned core
    seen = np.zeros(n, dtype=np.int64)
    for p, seq in enumerate(sol.proc_seq):
        for t in seq:
            t = int(t)
            if not (0 <= t < n):
                viols.append(
                    Violation("assignment", f"proc {p} sequence holds unknown task {t}", proc=p)
                )
                continue
            seen[t] += 1
            if int(assign[t]) != p:
                viols.append(
                    Violation(
                        "assignment",
                        f"task {t} sequenced on proc {p} but assigned to proc "
                        f"{int(assign[t])}",
                        task=t,
                        proc=p,
                    )
                )
    for t in np.nonzero(seen != 1)[0]:
        word = "missing from" if seen[t] == 0 else f"sequenced {seen[t]} times in"
        viols.append(
            Violation("assignment", f"task {int(t)} {word} the processor sequences", task=int(t))
        )
    mem = np.asarray(sol.mem)
    if len(mem) != inst.n_data:
        viols.append(
            Violation("allocation", f"mem has {len(mem)} entries for {inst.n_data} blocks")
        )
        return viols, checked
    for d in range(inst.n_data):
        m = int(mem[d])
        if not (0 <= m < inst.n_mems):
            viols.append(
                Violation("allocation", f"block {d} allocated to invalid tier {m}", datum=d)
            )
        elif not inst.data_mem_ok[d, m]:
            viols.append(
                Violation(
                    "allocation",
                    f"block {d} allocated to incompatible tier {m}",
                    datum=d,
                    tier=m,
                )
            )
    return viols, checked


def _check_times(
    inst: Instance,
    sol: Solution,
    start: np.ndarray,
    finish: np.ndarray,
    dur: np.ndarray,
    *,
    tol_abs: float,
    check_durations: bool,
) -> tuple[list[Violation], dict]:
    """eq (17) precedence, eq (3) overlap, residency, durations."""
    viols: list[Violation] = []
    edges = _precedence_edges(inst)
    checked = {"precedence": len(edges), "overlap": 0, "residency": 0, "duration": 0}
    for u, v in edges:
        if finish[u] > start[v] + tol_abs:
            viols.append(
                Violation(
                    "precedence",
                    f"task {v} starts at {start[v]:.6g} before predecessor {u} "
                    f"finishes at {finish[u]:.6g}",
                    task=v,
                    time=float(start[v]),
                )
            )
    for p, seq in enumerate(sol.proc_seq):
        for a, b in zip(seq, seq[1:]):
            checked["overlap"] += 1
            if finish[a] > start[b] + tol_abs:
                viols.append(
                    Violation(
                        "overlap",
                        f"tasks {a} and {b} overlap on proc {p}: {a} runs until "
                        f"{finish[a]:.6g} but {b} starts at {start[b]:.6g}",
                        task=int(b),
                        proc=p,
                        time=float(start[b]),
                    )
                )
    # residency: no consumer may begin its move-in before the block exists
    for d in range(inst.n_data):
        prod = int(inst.producer[d])
        birth = 0.0 if prod < 0 else float(start[prod])
        for c in inst.cons_idx[inst.cons_indptr[d] : inst.cons_indptr[d + 1]]:
            checked["residency"] += 1
            if start[c] + tol_abs < birth:
                viols.append(
                    Violation(
                        "residency",
                        f"task {int(c)} consumes block {d} at {start[c]:.6g} before "
                        f"its producer {prod} starts moving it out at {birth:.6g}",
                        task=int(c),
                        datum=d,
                        time=float(start[c]),
                    )
                )
    if check_durations:
        checked["duration"] = inst.n_tasks
        for i in range(inst.n_tasks):
            if not np.isfinite(dur[i]):
                continue  # already an assignment violation
            if abs((finish[i] - start[i]) - dur[i]) > tol_abs:
                viols.append(
                    Violation(
                        "duration",
                        f"task {i} window {finish[i] - start[i]:.6g} != "
                        f"t_in+PT+t_out = {dur[i]:.6g}",
                        task=i,
                        time=float(start[i]),
                    )
                )
    return viols, checked


def _check_capacity(
    inst: Instance,
    mem: np.ndarray,
    start: np.ndarray,
    finish: np.ndarray,
    *,
    tol: float,
) -> tuple[list[Violation], dict]:
    """eq (9): per-tier event sweep over block lifetimes.

    Lifetime = [producer start, last consumer finish] (initial inputs from
    t=0; unconsumed blocks die at producer finish).  At equal instants
    releases apply before acquires so back-to-back reuse is not double
    counted — the same tie-break the paper's §IV-C sweep needs.
    """
    viols: list[Violation] = []
    checked = {"capacity": 0}
    for m in range(inst.n_mems):
        cap = float(inst.mem_cap[m])
        if not np.isfinite(cap):
            continue
        checked["capacity"] += 1
        events: list[tuple[float, float, int]] = []
        for d in range(inst.n_data):
            if int(mem[d]) != m:
                continue
            prod = int(inst.producer[d])
            birth = 0.0 if prod < 0 else float(start[prod])
            death = birth if prod < 0 else float(finish[prod])
            cons = inst.cons_idx[inst.cons_indptr[d] : inst.cons_indptr[d + 1]]
            for c in cons:
                death = max(death, float(finish[c]))
            sz = float(inst.data_size[d])
            events.append((birth, sz, d))
            events.append((death, -sz, d))
        events.sort(key=lambda e: (e[0], e[1]))  # releases first at ties
        usage = 0.0
        limit = cap * (1.0 + tol) + tol
        worst = None
        for t, delta, d in events:
            usage += delta
            if usage > limit and (worst is None or usage > worst[1]):
                worst = (t, usage, d)
        if worst is not None:
            viols.append(
                Violation(
                    "capacity",
                    f"tier {m} peaks at {worst[1]:.6g} > capacity {cap:.6g} "
                    f"(witness: block {worst[2]} moving in at t={worst[0]:.6g})",
                    datum=int(worst[2]),
                    tier=m,
                    time=float(worst[0]),
                )
            )
    return viols, checked


# --------------------------------------------------------------------- #
# Entry points                                                          #
# --------------------------------------------------------------------- #
def _unindexable(viols: list[Violation]) -> bool:
    """Wrong-length arrays or out-of-range ids: timing checks cannot index."""
    return any("entries" in v.message or "invalid" in v.message or "unknown" in v.message
               for v in viols)


def _finalize(
    viols: list[Violation],
    checked: dict[str, int],
    makespan: float,
    *,
    claimed_feasible: "bool | None",
    enforce_capacity: bool = True,
) -> Certificate:
    cap = [v for v in viols if v.kind == "capacity"]
    hard = [v for v in viols if v.kind not in ("capacity", "feasibility")]
    if not enforce_capacity:
        # in-loop incumbents between Alg-3 runs: capacity breaches are
        # recorded as information, every other constraint still rejects
        ok = not hard
    elif claimed_feasible is None:
        ok = not viols
    elif claimed_feasible:
        ok = not hard and not cap
    elif cap:
        # honest infeasibility: recorded, claim consistent, not a rejection
        ok = not hard
    else:
        viols.append(
            Violation(
                "feasibility",
                "solver reported memory-infeasible but the independent sweep "
                "finds every tier within capacity",
            )
        )
        ok = False
    return Certificate(ok=ok, makespan=makespan, violations=viols, checked=checked)


def certify_schedule(
    inst: Instance,
    sol: Solution,
    start: np.ndarray,
    finish: np.ndarray,
    *,
    reported_makespan: "float | None" = None,
    claimed_feasible: "bool | None" = None,
    enforce_capacity: bool = True,
    check_durations: bool = True,
    tol: float = _DEF_TOL,
) -> Certificate:
    """Certify explicit (start, finish) times against every ILP constraint.

    Use this when the times come from an external scheduler (or a test
    corrupting them); :func:`certify_solution` derives times itself.
    ``claimed_feasible`` switches capacity handling: ``None`` means any
    capacity breach rejects; ``True``/``False`` additionally cross-checks
    the solver's own feasibility claim (kind ``feasibility``).
    ``enforce_capacity=False`` records capacity breaches without rejecting
    (in-loop incumbents whose allocation Alg-3 has not yet repaired).
    """
    start = np.asarray(start, dtype=np.float64)
    finish = np.asarray(finish, dtype=np.float64)
    viols, checked = _check_structure(inst, sol)
    if _unindexable(viols):
        return _finalize(viols, checked, float("nan"), claimed_feasible=None)
    dur = task_durations(inst, sol.assign, sol.mem)
    mk = float(np.max(finish)) if len(finish) else 0.0
    tol_abs = tol * max(1.0, abs(mk))
    tv, tc = _check_times(
        inst, sol, start, finish, dur, tol_abs=tol_abs, check_durations=check_durations
    )
    viols += tv
    checked.update(tc)
    cv, cc = _check_capacity(inst, sol.mem, start, finish, tol=tol)
    viols += cv
    checked.update(cc)
    checked["makespan"] = 1
    # NaN-safe: `not (diff <= tol)` rejects a NaN reported makespan, where
    # `diff > tol` would silently accept it (every NaN comparison is False)
    if reported_makespan is not None and \
            not (abs(reported_makespan - mk) <= tol_abs):
        viols.append(
            Violation(
                "makespan",
                f"reported makespan {reported_makespan:.6g} != independent "
                f"max-finish {mk:.6g}",
                time=mk,
            )
        )
    return _finalize(viols, checked, mk, claimed_feasible=claimed_feasible,
                     enforce_capacity=enforce_capacity)


def certify_solution(
    inst: Instance,
    sol: Solution,
    *,
    reported_makespan: "float | None" = None,
    claimed_feasible: "bool | None" = None,
    enforce_capacity: bool = True,
    tol: float = _DEF_TOL,
) -> Certificate:
    """Derive start/finish independently, then certify every constraint.

    The derivation is the machine-head simulation of
    :func:`simulate_schedule`; a deadlock (disjunctive cycle) rejects with
    ``precedence`` witnesses before any timing check runs.
    """
    viols, checked = _check_structure(inst, sol)
    if _unindexable(viols):
        return _finalize(viols, checked, float("nan"), claimed_feasible=None)
    dur = task_durations(inst, sol.assign, sol.mem)
    start, finish, sim_viols = simulate_schedule(inst, sol, dur)
    if sim_viols:
        viols += sim_viols
        return _finalize(viols, checked, float("nan"), claimed_feasible=None)
    cert = certify_schedule(
        inst,
        sol,
        start,
        finish,
        reported_makespan=reported_makespan,
        claimed_feasible=claimed_feasible,
        enforce_capacity=enforce_capacity,
        check_durations=False,  # trivially true for simulated times
        tol=tol,
    )
    cert.violations = viols + cert.violations
    cert.checked.update(checked)
    if viols:
        cert.ok = False
    return cert


def certify_report(inst: Instance, report, *, tol: float = _DEF_TOL) -> Certificate:
    """Certify a :class:`~repro_torch.core.api.SolveReport` end to end.

    Checks the solution, the reported makespan, and cross-checks the
    report's ``feasible`` claim against the independent capacity sweep.
    """
    if report.solution is None:
        return Certificate(
            ok=False,
            makespan=float("nan"),
            violations=[Violation("assignment", "report carries no solution")],
            checked={},
        )
    return certify_solution(
        inst,
        report.solution,
        reported_makespan=float(report.makespan),
        claimed_feasible=bool(report.feasible),
        tol=tol,
    )
