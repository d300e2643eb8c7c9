"""Memory-update procedure — Algorithm 3 of the paper (§IV-C).

Given a solution whose machine sequences are fixed by local search, rebuild
the data allocation: start with every block in the slow tier, then repeatedly
move the *most critical* unplaced block (criticality = number of critical
tasks that produce or consume it) into the fastest tier whose capacity is
never exceeded over the block's lifetime (checked with the discretized
differential array).  The schedule / critical path is recomputed every
``refresh_every`` placements (=1 reproduces the paper exactly; >1 is the
amortized mode used inside the tabu loop).

Two implementations share these semantics:

* the **fast path** (default) — criticalities for *all* pending blocks come
  from one segment sum per refresh, the most-critical-first pop order is a
  single lexsort over ``(-uses, size, d)`` (valid because criticality only
  changes at refreshes), and the per-placement capacity probe is a
  lexsort + cumsum over the tier's event arrays;
* the **scalar oracle** (``scalar=True``) — the original per-block Python
  loops, kept as the parity reference.

Both produce the same allocation: the pop order replays the scalar argmin
key exactly, and the capacity probe accumulates the same event deltas in the
same sorted order (ties in ``(time, Δ)`` carry equal deltas, so any stable
order yields identical prefix sums).

Amortized refreshes (``refresh_every > 1``) probe capacity against *stale*
lifetimes, so the raw placement pass can overshoot a finite tier under the
true final schedule — a quiet violation of Alg-3's capacity invariant that
the seed tolerated.  Both paths therefore finish with a shared
**verify-and-evict epilogue**: peaks are recomputed under the exact final
schedule and, while any finite tier overflows, the least-critical resident
block (the reverse of the pop key) is demoted to its next slower compatible
tier.  Every returned allocation is capacity-feasible.  The verification
cannot be skipped for any ``refresh_every`` — even at 1, each probe uses
lifetimes from *before* the placement it is probing, and the placement
itself shifts durations — but it usually finds nothing and costs one extra
DP + peaks sweep against the ~``n_data/refresh_every`` DPs of the update
pass itself.
"""
from __future__ import annotations

import numpy as np

from .mdfg import InfeasibleInstanceError, Instance
from .solution import (
    Solution,
    data_lifetimes,
    exact_schedule,
    heads_tails,
    memory_peaks,
)

__all__ = ["memory_update"]


def _tier_events(
    inst: Instance, sol: Solution, birth: np.ndarray, death: np.ndarray
) -> list[list[tuple[float, float]]]:
    """Per-tier event lists [(time, +/-size)] for currently assigned blocks."""
    ev: list[list[tuple[float, float]]] = [[] for _ in range(inst.n_mems)]
    for d in range(inst.n_data):
        m = sol.mem[d]
        if np.isinf(inst.mem_cap[m]):
            continue
        s = float(inst.data_size[d])
        ev[m].append((birth[d], s))
        ev[m].append((death[d], -s))
    return ev


def _fits(events: list[tuple[float, float]], b: float, e: float, size: float, cap: float) -> bool:
    evs = events + [(b, size), (e, -size)]
    evs.sort(key=lambda t: (t[0], t[1]))
    run = 0.0
    for _, delta in evs:
        run += delta
        if run > cap + 1e-9:
            return False
    return True


def memory_update(
    inst: Instance,
    sol: Solution,
    refresh_every: int = 8,
    *,
    scalar: bool = False,
) -> Solution:
    """Returns a copy of ``sol`` with ``mem`` rebuilt (Alg. 3).

    ``scalar=True`` selects the original per-block Python implementation
    (the parity oracle); the default fast path computes
    the identical allocation with array sweeps.  Both finish with the shared
    verify-and-evict epilogue, so the returned allocation is always
    capacity-feasible under its exact schedule.
    """
    if scalar:
        out = _memory_update_scalar(inst, sol, refresh_every)
    else:
        out = _memory_update_fast(inst, sol, refresh_every)
    return _capacity_repair(inst, out)


def _capacity_repair(inst: Instance, sol: Solution) -> Solution:
    """Verify peaks under the exact schedule; demote least-critical blocks
    out of overflowing finite tiers until every capacity holds.  Mutates and
    returns ``sol`` (already a copy inside :func:`memory_update`)."""
    if not (~np.isinf(inst.mem_cap)).any():
        return sol
    level_order = np.argsort(inst.mem_level, kind="stable")
    while True:
        sched = exact_schedule(inst, sol)
        assert sched is not None, "memory repair requires an acyclic solution"
        peaks = memory_peaks(inst, sol, sched)
        over = np.nonzero(peaks > inst.mem_cap * (1 + 1e-6) + 1e-6)[0]
        if not len(over):
            return sol
        m = int(over[0])
        _, _, _, crit = heads_tails(inst, sol, sched)
        uses = _block_uses(inst, crit)
        resident = np.nonzero(sol.mem == m)[0]
        # least critical last in pop order ⇒ evict from the reversed key
        order = np.lexsort((resident, inst.data_size[resident], -uses[resident]))
        d = int(resident[order[-1]])
        slower = [int(t) for t in level_order
                  if inst.mem_level[t] > inst.mem_level[m] and inst.data_mem_ok[d, t]]
        if not slower:
            raise InfeasibleInstanceError(
                f"tier {m} overflows and block {d} has no slower compatible "
                "tier to evict to",
                block=d, task=int(inst.producer[d]),
                tiers_tried=tuple(int(t) for t in level_order
                                  if inst.data_mem_ok[d, t]))
        sol.mem[d] = slower[0]


# --------------------------------------------------------------------------- #
# fast path                                                                    #
# --------------------------------------------------------------------------- #
def _block_uses(inst: Instance, crit: np.ndarray) -> np.ndarray:
    """Criticality of every block: #critical producers + #critical consumers."""
    uses = np.zeros(inst.n_data, dtype=np.int64)
    prod = inst.producer
    has = prod >= 0
    uses[has] = crit[prod[has]].astype(np.int64)
    if inst.cons_idx.size:
        c = np.zeros(len(inst.cons_idx) + 1, dtype=np.int64)
        np.cumsum(crit[inst.cons_idx].astype(np.int64), out=c[1:])
        uses += c[inst.cons_indptr[1:]] - c[inst.cons_indptr[:-1]]
    return uses


def _tier_event_arrays(
    inst: Instance, sol: Solution, birth: np.ndarray, death: np.ndarray
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-tier (times, deltas) arrays in the scalar append order
    (d ascending, birth before death)."""
    times: list[np.ndarray] = []
    deltas: list[np.ndarray] = []
    finite = ~np.isinf(inst.mem_cap)
    for m in range(inst.n_mems):
        if not finite[m]:
            times.append(np.zeros(0))
            deltas.append(np.zeros(0))
            continue
        sel = np.nonzero(sol.mem == m)[0]
        t = np.empty(2 * len(sel))
        dl = np.empty(2 * len(sel))
        t[0::2] = birth[sel]
        t[1::2] = death[sel]
        dl[0::2] = inst.data_size[sel]
        dl[1::2] = -inst.data_size[sel]
        times.append(t)
        deltas.append(dl)
    return times, deltas


def _fits_fast(times: np.ndarray, deltas: np.ndarray, b: float, e: float,
               size: float, cap: float) -> bool:
    t = np.append(times, (b, e))
    dl = np.append(deltas, (size, -size))
    run = np.cumsum(dl[np.lexsort((dl, t))])
    return not bool((run > cap + 1e-9).any())


def _memory_update_fast(inst: Instance, sol: Solution, refresh_every: int) -> Solution:
    sol = sol.copy()
    # line 3: InitMemory — slowest compatible tier for every block
    slow_rank = np.argsort(-inst.mem_level)
    ok = inst.data_mem_ok[:, slow_rank]
    any_ok = ok.any(axis=1)
    sol.mem[any_ok] = slow_rank[np.argmax(ok[any_ok], axis=1)]

    fast_order = [int(m) for m in np.argsort(inst.mem_level) if not np.isinf(inst.mem_cap[m])]
    if not fast_order:
        return sol
    # only blocks that *can* live in a finite (fast) tier are candidates
    cand_mask = inst.data_mem_ok[:, fast_order].any(axis=1)

    sched = exact_schedule(inst, sol)
    assert sched is not None, "memory_update requires an acyclic solution"
    _, _, _, crit = heads_tails(inst, sol, sched)
    birth, death = data_lifetimes(inst, sched)
    times, deltas = _tier_event_arrays(inst, sol, birth, death)
    sizes = inst.data_size

    def pop_order(pending: np.ndarray, uses: np.ndarray) -> np.ndarray:
        # the scalar argmin key (-uses, size, d), replayed as one lexsort —
        # exact because uses/size are fixed between refreshes
        return pending[np.lexsort((pending, sizes[pending], -uses[pending]))]

    pending = np.nonzero(cand_mask)[0]
    order = pop_order(pending, _block_uses(inst, crit))
    cursor = 0
    placed_since_refresh = 0
    while cursor < len(order):
        d = int(order[cursor])
        cursor += 1
        for m in fast_order:
            if not inst.data_mem_ok[d, m]:
                continue
            if _fits_fast(times[m], deltas[m], birth[d], death[d],
                          float(sizes[d]), float(inst.mem_cap[m])):
                sol.mem[d] = m
                times[m] = np.append(times[m], (birth[d], death[d]))
                deltas[m] = np.append(deltas[m], (sizes[d], -sizes[d]))
                placed_since_refresh += 1
                break
        # else: stays in the slow tier (always feasible)

        if placed_since_refresh >= refresh_every and cursor < len(order):
            placed_since_refresh = 0
            sched = exact_schedule(inst, sol)
            assert sched is not None
            _, _, _, crit = heads_tails(inst, sol, sched)
            birth, death = data_lifetimes(inst, sched)
            times, deltas = _tier_event_arrays(inst, sol, birth, death)
            order = pop_order(order[cursor:], _block_uses(inst, crit))
            cursor = 0
    return sol


# --------------------------------------------------------------------------- #
# scalar oracle (the original implementation, kept verbatim)                   #
# --------------------------------------------------------------------------- #
def _memory_update_scalar(inst: Instance, sol: Solution, refresh_every: int) -> Solution:
    sol = sol.copy()
    # line 3: InitMemory — slowest compatible tier for every block
    slow_rank = np.argsort(-inst.mem_level)
    for d in range(inst.n_data):
        for m in slow_rank:
            if inst.data_mem_ok[d, m]:
                sol.mem[d] = m
                break

    fast_order = [int(m) for m in np.argsort(inst.mem_level) if not np.isinf(inst.mem_cap[m])]
    if not fast_order:
        return sol
    # only blocks that *can* live in a finite (fast) tier are candidates
    data_set = [d for d in range(inst.n_data) if inst.data_mem_ok[d, fast_order].any()]

    sched = exact_schedule(inst, sol)
    assert sched is not None, "memory_update requires an acyclic solution"
    _, _, _, crit = heads_tails(inst, sol, sched)
    birth, death = data_lifetimes(inst, sched)
    events = _tier_events(inst, sol, birth, death)

    placed_since_refresh = 0
    pending = set(data_set)
    while pending:
        # criticality of each pending block under the current critical path
        best_d, best_key = -1, None
        for d in pending:
            uses = 0
            p = inst.producer[d]
            if p >= 0 and crit[p]:
                uses += 1
            uses += int(crit[inst.consumers(d)].sum())
            key = (-uses, float(inst.data_size[d]), d)
            if best_key is None or key < best_key:
                best_key, best_d = key, d
        d = best_d
        pending.discard(d)

        for m in fast_order:
            if not inst.data_mem_ok[d, m]:
                continue
            if _fits(events[m], birth[d], death[d], float(inst.data_size[d]), float(inst.mem_cap[m])):
                sol.mem[d] = m
                events[m].append((birth[d], float(inst.data_size[d])))
                events[m].append((death[d], -float(inst.data_size[d])))
                placed_since_refresh += 1
                break
        # else: stays in the slow tier (always feasible)

        if placed_since_refresh >= refresh_every and pending:
            placed_since_refresh = 0
            sched = exact_schedule(inst, sol)
            assert sched is not None
            _, _, _, crit = heads_tails(inst, sol, sched)
            birth, death = data_lifetimes(inst, sched)
            events = _tier_events(inst, sol, birth, death)
    return sol
