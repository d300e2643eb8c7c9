"""Greedy initial-solution construction — Algorithm 1 of the paper.

Iteratively selects the most important frontier task (four selectable
priority strategies, §V-B), tries every compatible core, greedily allocates
memory for the data blocks the task produces (fast tiers first, capacity
checked over block lifetimes), and commits the (core, memory) choice with the
earliest task end time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .mdfg import InfeasibleInstanceError, Instance
from .solution import Solution

__all__ = ["construct_greedy", "GreedyState", "STRATEGIES"]

STRATEGIES = ("slack_first", "r_first", "random", "relax_r")


@dataclasses.dataclass
class GreedyState:
    """Mutable bookkeeping during construction."""

    finish: np.ndarray            # committed task finish times (nan = unscheduled)
    start: np.ndarray
    core_free: np.ndarray
    # per finite memory: committed intervals [birth, death, size]; death=inf
    # until every consumer of the block is scheduled (conservative).
    intervals: list[list[list[float]]]
    interval_of_block: dict[int, tuple[int, int]]  # d -> (mem, index in intervals[mem])


def _estimate_rq(
    inst: Instance,
    topo: np.ndarray,
    t_est: np.ndarray,
    finish: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """R/Q/Slack over the DAG.

    Preprocessing (§IV-A.1): uses execution-time estimates ``t_est`` only;
    as tasks commit, their actual ``finish`` replaces the estimate so that
    priorities stay fresh (the paper's ``freshRQSlack``).
    """
    n = inst.n_tasks
    r = np.zeros(n)
    scheduled = ~np.isnan(finish)
    for u in topo:
        if scheduled[u]:
            continue
        best = 0.0
        for j in inst.preds(u):
            f = finish[j] if scheduled[j] else r[j] + t_est[j]
            if f > best:
                best = f
        r[u] = best
    q = np.zeros(n)
    for u in topo[::-1]:
        best = 0.0
        for j in inst.succs(u):
            if q[j] > best:
                best = q[j]
        q[u] = t_est[u] + best
    cmax = float((r + q).max()) if n else 0.0
    slack = cmax - r - q
    return r, q, slack


def _peak_with(intervals: list[list[float]], birth: float, size: float) -> float:
    """Peak usage over [birth, ∞) if a block of ``size`` is added at ``birth``."""
    events: list[tuple[float, float]] = [(birth, size)]
    for b, e, s in intervals:
        if e <= birth:
            continue
        events.append((max(b, birth), s))
        if np.isfinite(e):
            events.append((e, -s))
    events.sort(key=lambda t: (t[0], t[1]))
    run = peak = 0.0
    for _, delta in events:
        run += delta
        peak = max(peak, run)
    return peak


def _try_alloc_outputs(
    inst: Instance,
    state: GreedyState,
    task: int,
    start: float,
    slack: np.ndarray,
    commit: bool,
) -> dict[int, int]:
    """Greedy fast-first memory choice for the blocks ``task`` produces.

    Blocks are sorted by the minimum Slack of their consumers (most urgent
    first — paper §IV-A.2); tiers tried in ``mem_level`` order.
    """
    outs = list(inst.outputs(task))
    outs.sort(key=lambda d: min([slack[c] for c in inst.consumers(d)], default=np.inf))
    choice: dict[int, int] = {}
    order = np.argsort(inst.mem_level)
    # tentative placements of this task's earlier outputs must count against
    # capacity even when not committing, else sibling blocks jointly overflow
    tentative: dict[int, list[list[float]]] = {}
    for d in outs:
        placed = None
        tried = []
        for m in order:
            if not inst.data_mem_ok[d, m]:
                continue
            tried.append(int(m))
            if np.isinf(inst.mem_cap[m]):
                placed = int(m)
                break
            pool = state.intervals[m] + tentative.get(int(m), [])
            if _peak_with(pool, start, inst.data_size[d]) <= inst.mem_cap[m]:
                placed = int(m)
                break
        if placed is None:
            raise InfeasibleInstanceError(
                f"no memory tier can hold block {d} (size {inst.data_size[d]:g}) "
                f"produced by task {task} at t={start:g}; compatible tiers tried: "
                f"{tried or 'none'}",
                block=d, task=task, tiers_tried=tuple(tried),
            )
        choice[d] = placed
        if commit:
            state.intervals[placed].append([start, np.inf, float(inst.data_size[d])])
            state.interval_of_block[d] = (placed, len(state.intervals[placed]) - 1)
        elif np.isfinite(inst.mem_cap[placed]):
            tentative.setdefault(placed, []).append([start, np.inf, float(inst.data_size[d])])
    return choice


def _close_consumed_blocks(inst: Instance, state: GreedyState, task: int, t_end: float) -> None:
    """Refine death times: a block is released once all consumers finished."""
    for d in inst.inputs(task):
        if d not in state.interval_of_block:
            continue
        cons = inst.consumers(d)
        fin = state.finish[cons]
        if np.isnan(fin).any():
            continue
        m, k = state.interval_of_block[d]
        state.intervals[m][k][1] = float(fin.max())


def construct_greedy(
    inst: Instance,
    strategy: str = "slack_first",
    rng: np.random.Generator | int = 0,
    relax_eps: float = 0.02,
) -> Solution:
    """Algorithm 1.  ``strategy`` ∈ {slack_first, r_first, random, relax_r}."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    rng = np.random.default_rng(rng)
    n = inst.n_tasks
    topo = inst.topological_order()
    t_est = np.where(
        np.isfinite(inst.proc_time), inst.proc_time, np.inf
    ).min(axis=1)

    assign = np.full(n, -1, dtype=np.int64)
    mem = np.full(inst.n_data, -1, dtype=np.int64)
    proc_seq: list[list[int]] = [[] for _ in range(inst.n_procs)]
    state = GreedyState(
        finish=np.full(n, np.nan),
        start=np.full(n, np.nan),
        core_free=np.zeros(inst.n_procs),
        intervals=[[] for _ in range(inst.n_mems)],
        interval_of_block={},
    )
    # initial input data (producer = -1): allocate up front, alive from t=0
    for d in np.nonzero(inst.producer < 0)[0]:
        order = np.argsort(inst.mem_level)
        tried = []
        for m in order:
            if not inst.data_mem_ok[d, m]:
                continue
            tried.append(int(m))
            if np.isinf(inst.mem_cap[m]) or _peak_with(
                state.intervals[m], 0.0, inst.data_size[d]
            ) <= inst.mem_cap[m]:
                mem[d] = m
                state.intervals[m].append([0.0, np.inf, float(inst.data_size[d])])
                state.interval_of_block[int(d)] = (int(m), len(state.intervals[m]) - 1)
                break
        else:
            raise InfeasibleInstanceError(
                f"no memory tier can hold initial-input block {d} "
                f"(size {inst.data_size[d]:g}, alive from t=0); compatible tiers "
                f"tried: {tried or 'none'}",
                block=int(d), task=-1, tiers_tried=tuple(tried),
            )

    n_sched_preds = np.zeros(n, dtype=np.int64)
    n_preds = np.diff(inst.pred_indptr)
    remaining = set(range(n))
    frontier = {int(i) for i in np.nonzero(n_preds == 0)[0]}

    r, q, slack = _estimate_rq(inst, topo, t_est, state.finish)
    rounds_since_refresh = 0

    while remaining:
        # ---- select task (§V-B strategies) --------------------------------
        cand = sorted(frontier)
        if strategy == "random":
            t = int(rng.choice(cand))
        else:
            def min_succ_slack(i: int) -> float:
                ss = inst.succs(i)
                return float(slack[ss].min()) if len(ss) else np.inf

            if strategy == "r_first":
                t = min(cand, key=lambda i: (r[i], slack[i], min_succ_slack(i)))
            elif strategy == "slack_first":
                t = min(cand, key=lambda i: (slack[i], r[i], min_succ_slack(i)))
            else:  # relax_r
                rmin = min(r[i] for i in cand)
                width = relax_eps * max(1.0, float(r.max()))
                close = [i for i in cand if r[i] <= rmin + width]
                t = min(close, key=lambda i: (slack[i], r[i]))

        # ---- evaluate every compatible core --------------------------------
        preds = inst.preds(t)
        ready = float(state.finish[preds].max()) if len(preds) else 0.0
        best = None
        for c in inst.compatible_procs(t):
            st = max(ready, state.core_free[c])
            out_choice = _try_alloc_outputs(inst, state, t, st, slack, commit=False)
            t_in = sum(
                inst.data_size[d] * inst.access_time[c, mem[d] if mem[d] >= 0 else inst.n_mems - 1]
                for d in inst.inputs(t)
            )
            t_out = sum(inst.data_size[d] * inst.access_time[c, m] for d, m in out_choice.items())
            end = st + t_in + inst.proc_time[t, c] + t_out
            if best is None or end < best[0]:
                best = (end, int(c), st, out_choice)
        end, c, st, out_choice = best  # type: ignore[misc]

        # ---- commit ---------------------------------------------------------
        assign[t] = c
        proc_seq[c].append(t)
        state.start[t] = st
        state.finish[t] = end
        state.core_free[c] = end
        for d, m in out_choice.items():
            mem[d] = m
            state.intervals[m].append([st, np.inf, float(inst.data_size[d])])
            state.interval_of_block[d] = (m, len(state.intervals[m]) - 1)
        _close_consumed_blocks(inst, state, t, end)

        remaining.discard(t)
        frontier.discard(t)
        for v in inst.succs(t):
            n_sched_preds[v] += 1
            if n_sched_preds[v] == n_preds[v] and v in remaining:
                frontier.add(int(v))

        rounds_since_refresh += 1
        if rounds_since_refresh >= 16 or not frontier:
            r, q, slack = _estimate_rq(inst, topo, t_est, state.finish)
            rounds_since_refresh = 0

    # unassigned blocks (no producer path) → slowest compatible tier
    for d in np.nonzero(mem < 0)[0]:
        mem[d] = int(inst.compatible_mems(d)[np.argmax(inst.mem_level[inst.compatible_mems(d)])])
    return Solution(assign=assign, mem=mem, proc_seq=proc_seq)
