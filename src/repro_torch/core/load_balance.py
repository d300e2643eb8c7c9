"""Load-balancing baseline (§V-C) — the comparator the paper beats by 5–25 %.

"It always selects the task that can start earliest, sorts them on the
machine according to the ascending order of the earliest time that can start
to move, and always selects the most idle core."  Memory is allocated with
the same greedy fast-first rule as the constructor.
"""
from __future__ import annotations

import numpy as np

from .greedy import GreedyState, _close_consumed_blocks, _peak_with, _try_alloc_outputs
from .mdfg import Instance
from .solution import Solution

__all__ = ["load_balance"]


def load_balance(inst: Instance, rng: np.random.Generator | int = 0) -> Solution:
    rng = np.random.default_rng(rng)
    n = inst.n_tasks
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
    for d in np.nonzero(inst.producer < 0)[0]:
        for m in np.argsort(inst.mem_level):
            if not inst.data_mem_ok[d, m]:
                continue
            if np.isinf(inst.mem_cap[m]) or _peak_with(
                state.intervals[m], 0.0, inst.data_size[d]
            ) <= inst.mem_cap[m]:
                mem[d] = m
                state.intervals[m].append([0.0, np.inf, float(inst.data_size[d])])
                state.interval_of_block[int(d)] = (int(m), len(state.intervals[m]) - 1)
                break

    n_preds = np.diff(inst.pred_indptr)
    n_sched = np.zeros(n, dtype=np.int64)
    frontier = {int(i) for i in np.nonzero(n_preds == 0)[0]}
    remaining = set(range(n))
    slack = np.zeros(n)  # LB ignores slack; reuse greedy mem allocator signature

    while remaining:
        # earliest-startable task first
        def est(i: int) -> float:
            p = inst.preds(i)
            return float(state.finish[p].max()) if len(p) else 0.0

        t = min(sorted(frontier), key=est)
        ready = est(t)
        # most idle compatible core (earliest free; ties → least busy)
        procs = inst.compatible_procs(t)
        c = int(min(procs, key=lambda p: (state.core_free[p], len(proc_seq[p]))))
        st = max(ready, state.core_free[c])
        out_choice = _try_alloc_outputs(inst, state, t, st, slack, commit=False)
        t_in = sum(
            inst.data_size[d] * inst.access_time[c, mem[d] if mem[d] >= 0 else inst.n_mems - 1]
            for d in inst.inputs(t)
        )
        t_out = sum(inst.data_size[d] * inst.access_time[c, m] for d, m in out_choice.items())
        end = st + t_in + inst.proc_time[t, c] + t_out

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
            n_sched[v] += 1
            if n_sched[v] == n_preds[v] and v in remaining:
                frontier.add(int(v))

    for d in np.nonzero(mem < 0)[0]:
        cm = inst.compatible_mems(d)
        mem[d] = int(cm[np.argmax(inst.mem_level[cm])])
    return Solution(assign=assign, mem=mem, proc_seq=proc_seq)
