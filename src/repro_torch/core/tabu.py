"""Tabu search for HDATS — Algorithm 2 of the paper.

Two-layer local search: the outer layer moves *critical* tasks with the
classic FJSP neighborhoods — **N7** (reposition inside a critical block on
the same machine) and **change-core** (k-insertion onto another compatible
core) — while the inner layer re-allocates memory with Algorithm 3 after each
accepted move.  Neighbors are ranked with a cheap *approximate evaluation*
(head/tail window estimate); only the top-K are *exactly* evaluated (full DP)
— the paper's mixed evaluation strategy (§V-F).  Move attributes are tabu for
θ1 = m + rand()%(2m) (change-core) / θ2 = n + rand()%n (N7) iterations, with
the standard aspiration criterion (a tabu move is admissible when it improves
the best known makespan).  The tenure "rand()" is a *counter-based* draw
(:func:`_tenure_draw`, a 32-bit avalanche over ``(seed, walk, iteration)``)
rather than a stateful RNG stream: the distribution is the paper's, but the
draw is a pure function of the trajectory position, so a device-resident
engine can reproduce it exactly with uint32 arithmetic — stateful PCG
streams cannot cross that boundary.
The perturbation path still uses the walk's ``numpy`` Generator stream.

Two search loops share these semantics:

* :func:`tabu_search` — the scalar-loop reference implementation (one walk,
  per-move Python objects, per-candidate ``Solution.copy``).  Its exact stage
  already runs on the batched engine; it remains the parity oracle.
* :func:`tabu_multiwalk` — the array-native engine: W independent walks
  advance in lock-step on one :class:`~.eval_batch.PackedSolutions` search
  state.  Neighborhoods are generated as :class:`~.eval_batch.MoveBatch`
  arrays, approximate evaluation runs as one ``(M,)`` array pass per walk
  (``eval_batch.approx_eval_moves``), candidates are materialized by
  gather/scatter ``apply_moves`` (no per-candidate copies), and all walks'
  top-K chunks share one ``(W·K, n_tasks)`` exact-evaluation batch per
  round.  Each walk keeps its own tabu table, aspiration, and RNG stream;
  with ``W=1`` the trajectory (history, incumbent, eval counts) reproduces
  :func:`tabu_search` exactly on every backend.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from .eval_batch import (
    APPROX_WINDOW,
    BatchEvaluator,
    MoveBatch,
    PackedSolutions,
    _expand_edges,
    approx_eval_moves,
)
from .mdfg import Instance
from .memory_update import memory_update
from .solution import _EPS  # critical-slack tolerance, shared with heads_tails
from .solution import Schedule, Solution, exact_schedule, heads_tails

__all__ = [
    "TSParams",
    "TSResult",
    "TSEvent",
    "MultiWalkResult",
    "tabu_search",
    "tabu_multiwalk",
    "critical_blocks",
    "Move",
]

_WINDOW = APPROX_WINDOW  # approximate-evaluation look-ahead window (ops)


def _maybe_sanitize(inst, sol, where: str, params, mk=None,
                    capacity: bool = True) -> None:
    """Certify an incumbent against the ILP constraints when sanitize mode
    is on (``params.sanitize`` / ``REPRO_SANITIZE``; DESIGN §12).

    The env check runs before any ``repro_torch.analysis`` import so disabled
    runs pay nothing; ``capacity=False`` skips capacity *rejection* for
    incumbents whose allocation Alg-3 has not repaired yet this period.
    """
    flag = params.sanitize
    if flag is None:
        flag = os.environ.get("REPRO_SANITIZE", "").strip().lower() \
            not in ("", "0", "false", "no", "off")
    if not flag:
        return
    from ..analysis.sanitize import maybe_sanitize

    maybe_sanitize(inst, sol, where=where, flag=True, reported_makespan=mk,
                   enforce_capacity=capacity)


def _mix32(*words: int) -> int:
    """Deterministic 32-bit avalanche over integer words (murmur3-style
    finalizer rounds).  Pure Python ints ⇒ portable; uint32 arithmetic on a
    device replays it bit-for-bit."""
    h = 0x811C9DC5
    for w in words:
        h ^= int(w) & 0xFFFFFFFF
        h = (h * 0x9E3779B1) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
    return h


def _tenure_draw(seed: int, walk: int, it: int, is_cc: bool,
                 n_procs: int, n_tasks: int) -> int:
    """Tabu tenure θ1/θ2: paper distribution, counter-based draw keyed on the
    trajectory position (one accepted move per walk per iteration)."""
    h = _mix32(seed, walk, it, 1 if is_cc else 0)
    if is_cc:
        return n_procs + h % (2 * n_procs)           # θ1 = m + rand() % 2m
    return n_tasks + h % max(1, n_tasks)             # θ2 = n + rand() % n


@dataclasses.dataclass
class TSParams:
    max_unimproved: int = 400          # λ
    time_limit: float = 60.0           # T̄ (paper: 600 s)
    top_k: int = 10                    # K̄ (paper K_max = 100)
    mem_refresh_every: int = 8         # Alg-3 amortization (1 = paper-exact)
    mem_update_period: int = 1         # run Alg-3 after every k-th accepted move
    n_change_core_positions: int = 5   # insertion positions probed per target core
    perturbation_size: int = 4
    seed: int = 0
    max_iters: int | None = None       # hard cap on outer iterations
    max_evals: int | None = None       # hard cap on exact schedule evaluations
    backend: str = "torch"             # exact-eval engine: torch | numpy | scalar
    torch_device: str = "cuda"         # where backend="torch" runs ("cpu" for tests)
    mem_update_scalar: bool = False    # Alg-3 scalar oracle (parity/benchmarks)
    # certify incumbents at commit/sync points against the ILP constraints
    # (repro_torch.analysis); None defers to the REPRO_SANITIZE env var
    sanitize: bool | None = None

    @classmethod
    def fast(cls, seed: int = 0) -> "TSParams":
        """Smoke-test profile: a small budget on Table-II-scale instances
        that still improves the greedy init."""
        return cls(max_unimproved=30, time_limit=2.0, top_k=4,
                   max_iters=400, seed=seed)


@dataclasses.dataclass
class TSResult:
    best: Solution
    best_makespan: float
    initial_makespan: float
    iterations: int
    elapsed: float
    history: list[tuple[int, float]]
    n_exact_evals: int = 0
    n_approx_evals: int = 0
    stop_reason: str = "converged"
    # rounds that entered the random-perturbation branch (Alg. 2 line 11)
    n_perturbations: int = 0


@dataclasses.dataclass
class WalkInfo:
    """Per-walk summary attached to :class:`MultiWalkResult`."""

    init_label: str
    initial_makespan: float
    best_makespan: float
    best: Solution
    history: list[tuple[int, float]]
    stop_reason: str


@dataclasses.dataclass
class MultiWalkResult(TSResult):
    walks: int = 1
    per_walk: list[WalkInfo] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class TSEvent:
    """Snapshot handed to ``on_iteration`` / ``on_improvement`` callbacks."""

    iteration: int
    best_makespan: float
    current_makespan: float
    elapsed: float
    n_exact_evals: int
    n_approx_evals: int
    improved: bool


@dataclasses.dataclass(frozen=True)
class Move:
    kind: str          # "n7" | "cc"
    task: int
    src_proc: int
    src_pos: int
    dst_proc: int
    dst_pos: int       # index in destination sequence AFTER removal


# --------------------------------------------------------------------------- #
# neighborhood construction (scalar reference)                                 #
# --------------------------------------------------------------------------- #
def critical_blocks(sol: Solution, critical: np.ndarray) -> list[tuple[int, int, int]]:
    """Maximal runs of consecutive critical ops per machine: (proc, lo, hi)."""
    blocks = []
    for p, seq in enumerate(sol.proc_seq):
        lo = None
        for k, t in enumerate(seq):
            if critical[t]:
                if lo is None:
                    lo = k
            else:
                if lo is not None and k - lo >= 2:
                    blocks.append((p, lo, k - 1))
                lo = None
        if lo is not None and len(seq) - lo >= 2:
            blocks.append((p, lo, len(seq) - 1))
    return blocks


def _n7_moves(sol: Solution, critical: np.ndarray) -> list[Move]:
    moves = []
    for p, lo, hi in critical_blocks(sol, critical):
        seq = sol.proc_seq[p]
        for k in range(lo, hi + 1):
            u = seq[k]
            if k != lo:  # move u to block head
                moves.append(Move("n7", u, p, k, p, lo))
            if k != hi:  # move u to block tail (index after removal = hi)
                moves.append(Move("n7", u, p, k, p, hi))
    return moves


def _cc_moves(
    inst: Instance,
    sol: Solution,
    critical: np.ndarray,
    r: np.ndarray,
    starts: np.ndarray,
    n_positions: int,
) -> list[Move]:
    """change-core (k-insertion): critical task → other compatible core,
    probing a few insertion positions around its head time."""
    mach, pos = sol.positions(inst.n_tasks)
    moves = []
    crit_tasks = np.nonzero(critical)[0]
    for u in crit_tasks:
        a = int(mach[u])
        for b in inst.compatible_procs(u):
            b = int(b)
            if b == a:
                continue
            seq = sol.proc_seq[b]
            seq_starts = starts[seq] if seq else np.zeros(0)
            anchor = int(np.searchsorted(seq_starts, r[u]))
            lo = max(0, anchor - n_positions // 2)
            hi = min(len(seq), lo + n_positions)
            for j in range(lo, hi + 1):
                moves.append(Move("cc", int(u), a, int(pos[u]), b, j))
    return moves


def apply_move(sol: Solution, move: Move) -> None:
    seq = sol.proc_seq[move.src_proc]
    if seq[move.src_pos] != move.task:
        raise ValueError("move does not match the current sequence")
    seq.pop(move.src_pos)
    sol.proc_seq[move.dst_proc].insert(move.dst_pos, move.task)
    sol.assign[move.task] = move.dst_proc


# --------------------------------------------------------------------------- #
# neighborhood construction (array-native)                                     #
# --------------------------------------------------------------------------- #
def _n7_move_batch(packed: PackedSolutions, row: int, crit: np.ndarray) -> MoveBatch:
    """Vectorized ``_n7_moves``: critical-block detection as a run-length
    sweep over the padded sequence matrix, emitting moves in the scalar
    enumeration order (machine asc, position asc, head-move before tail)."""
    seq = packed.seq[row]
    n_p, s_cap = seq.shape
    valid = np.arange(s_cap)[None, :] < packed.seq_len[row][:, None]
    c = np.zeros((n_p, s_cap), dtype=bool)
    c[valid] = crit[seq[valid]]
    prev = np.zeros_like(c)
    prev[:, 1:] = c[:, :-1]
    nxt = np.zeros_like(c)
    nxt[:, :-1] = c[:, 1:]
    starts_m = c & ~prev
    ends_m = c & ~nxt
    nb = int(starts_m.sum())
    if nb == 0:
        return MoveBatch.empty()
    bid = np.cumsum(starts_m.ravel()).reshape(n_p, s_cap) - 1
    lo = np.zeros(nb, dtype=np.int64)
    hi = np.zeros(nb, dtype=np.int64)
    pp, ss = np.nonzero(starts_m)
    lo[bid[pp, ss]] = ss
    pp, ss = np.nonzero(ends_m)
    hi[bid[pp, ss]] = ss
    keep = hi - lo >= 1  # maximal runs of length >= 2
    cp, cs = np.nonzero(c)  # row-major = the scalar (machine, position) scan
    cb = bid[cp, cs]
    ok = keep[cb]
    cp, cs, cb = cp[ok], cs[ok], cb[ok]
    if not len(cp):
        return MoveBatch.empty()
    u = seq[cp, cs]
    m = len(cp)
    task = np.repeat(u, 2)
    src_p = np.repeat(cp, 2)
    src_s = np.repeat(cs, 2)
    dst = np.empty(2 * m, dtype=np.int64)
    dst[0::2] = lo[cb]
    dst[1::2] = hi[cb]
    sel = np.empty(2 * m, dtype=bool)
    sel[0::2] = cs != lo[cb]
    sel[1::2] = cs != hi[cb]
    return MoveBatch(cc=np.zeros(int(sel.sum()), dtype=bool), task=task[sel],
                     src_proc=src_p[sel], src_pos=src_s[sel],
                     dst_proc=src_p[sel], dst_pos=dst[sel])


def _cc_move_batch(
    inst: Instance,
    compat_indptr: np.ndarray,
    compat_idx: np.ndarray,
    packed: PackedSolutions,
    row: int,
    crit: np.ndarray,
    r: np.ndarray,
    n_positions: int,
    mach: np.ndarray,
    pos: np.ndarray,
) -> MoveBatch:
    """Vectorized ``_cc_moves``: (critical task, compatible core) pairs by
    CSR expansion, insertion anchors by per-machine batched searchsorted.

    ``r`` (the heads, == schedule starts) serves both roles the scalar
    generator gives it: anchor keys along each destination sequence and the
    searchsorted query per critical task."""
    crit_tasks = np.nonzero(crit)[0]
    if not len(crit_tasks):
        return MoveBatch.empty()
    loc, b, _ = _expand_edges(compat_indptr, compat_idx,
                              np.arange(len(crit_tasks)), crit_tasks,
                              np.zeros(len(crit_tasks)))
    u = crit_tasks[loc]
    a = mach[u]
    keep = b != a
    u, b, a = u[keep], b[keep], a[keep]
    if not len(u):
        return MoveBatch.empty()
    seq = packed.seq[row]
    seq_len = packed.seq_len[row]
    anchor = np.empty(len(u), dtype=np.int64)
    for p in range(inst.n_procs):
        s = np.nonzero(b == p)[0]
        if not len(s):
            continue
        seq_starts = r[seq[p, : seq_len[p]]]
        anchor[s] = np.searchsorted(seq_starts, r[u[s]])
    lo = np.maximum(0, anchor - n_positions // 2)
    hi = np.minimum(seq_len[b], lo + n_positions)
    cnt = hi - lo + 1  # range(lo, hi + 1) is inclusive of hi
    tot = int(cnt.sum())
    jj = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt) + np.repeat(lo, cnt)
    return MoveBatch(cc=np.ones(tot, dtype=bool), task=np.repeat(u, cnt),
                     src_proc=np.repeat(a, cnt), src_pos=np.repeat(pos[u], cnt),
                     dst_proc=np.repeat(b, cnt), dst_pos=jj)


def _resulting_configs(packed: PackedSolutions, row: int, mb: MoveBatch):
    """The configuration each move creates — ``(task, dst_proc,
    machine-pred-after-move)`` with -2 for "head of sequence" — vectorized
    ``resulting_config`` for the tabu-table lookups."""
    seq_dst = packed.seq[row][mb.dst_proc]
    pi = mb.dst_pos - 1
    pio = pi + (~mb.cc & (pi >= mb.src_pos))
    pred = np.where(pi >= 0, seq_dst[np.arange(len(mb)), np.maximum(pio, 0)], -2)
    return mb.task, mb.dst_proc, pred


# --------------------------------------------------------------------------- #
# approximate evaluation (mixed strategy, fast path) — scalar oracle           #
# --------------------------------------------------------------------------- #
def _seq_sum(vals: np.ndarray) -> float:
    """Left-to-right sequential sum — the float op order the batched kernel
    (`eval_batch.approx_eval_moves`) replays, so parity is ``array_equal``."""
    return float(np.cumsum(vals)[-1]) if len(vals) else 0.0


def _approx_eval(
    inst: Instance,
    sol: Solution,
    move: Move,
    r: np.ndarray,
    q: np.ndarray,
    dur: np.ndarray,
) -> float:
    """Head/tail window estimate of the post-move makespan.

    Recomputes heads along the affected window of the destination sequence
    (old heads elsewhere), then estimates C'max = max over recomputed ops of
    R'(x) + Q_old(x).  O(window × mean-degree); deliberately inexact.
    """
    u = move.task
    dst = sol.proc_seq[move.dst_proc]
    if move.kind == "n7":
        new_seq = list(dst)
        new_seq.pop(move.src_pos)
        new_seq.insert(move.dst_pos, u)
        w_lo = min(move.src_pos, move.dst_pos)
        dur_u = dur[u]
        q_u = q[u]
    else:
        new_seq = list(dst)
        new_seq.insert(move.dst_pos, u)
        w_lo = move.dst_pos
        # duration changes with the core (t_in/t_out re-priced via AT)
        at = inst.access_time
        ins = inst.inputs(u)
        outs = inst.outputs(u)
        t_in = _seq_sum(inst.data_size[ins] * at[move.dst_proc, sol.mem[ins]])
        t_out = _seq_sum(inst.data_size[outs] * at[move.dst_proc, sol.mem[outs]])
        dur_u = t_in + inst.proc_time[u, move.dst_proc] + t_out
        if not np.isfinite(dur_u):
            return np.inf
        q_u = q[u] - dur[u] + dur_u

    w_hi = min(len(new_seq), w_lo + _WINDOW)
    new_r: dict[int, float] = {}
    est = 0.0
    prev_finish = 0.0
    if w_lo > 0:
        x_prev = new_seq[w_lo - 1]
        prev_finish = r[x_prev] + dur[x_prev]
    for k in range(w_lo, w_hi):
        x = new_seq[k]
        head = prev_finish
        for j in inst.preds(x):
            f = new_r[j] + (dur_u if j == u else dur[j]) if j in new_r else r[j] + dur[j]
            if f > head:
                head = f
        new_r[x] = head
        dx = dur_u if x == u else dur[x]
        qx = q_u if x == u else q[x]
        est = max(est, head + qx)
        prev_finish = head + dx
    # ops past the window keep old tails; account the window exit edge
    if w_hi < len(new_seq):
        x = new_seq[w_hi]
        est = max(est, prev_finish + q[x])
    return est


# --------------------------------------------------------------------------- #
# perturbation (Alg. 2 line 11) — shared by both search loops                  #
# --------------------------------------------------------------------------- #
def _perturb(
    inst: Instance,
    cur: Solution,
    sched: Schedule,
    crit: np.ndarray,
    rng: np.random.Generator,
    params: "TSParams",
) -> tuple[Solution, Schedule, int]:
    """Random perturbation applied when every admissible move is tabu or
    cyclic.  Returns the (possibly) perturbed solution, its schedule, and the
    number of exact evaluations spent.

    ``dst_pos`` is an index in the destination sequence *after removal*:
    same-core moves draw from ``[0, len-1]`` (u itself vacates a slot) and
    change-core moves from ``[0, len]`` (insertion at the end included).
    """
    n_evals = 0
    n_tasks = inst.n_tasks
    for _ in range(params.perturbation_size):
        crit_ids = np.nonzero(crit)[0]
        u = int(rng.choice(crit_ids)) if len(crit_ids) else int(rng.integers(n_tasks))
        procs = inst.compatible_procs(u)
        b = int(rng.choice(procs))
        mch, pos = cur.positions(n_tasks)
        same = b == int(mch[u])
        hi = len(cur.proc_seq[b]) + (0 if same else 1)  # >= 1 in both cases
        mv = Move("n7" if same else "cc", u, int(mch[u]), int(pos[u]), b,
                  int(rng.integers(0, hi)))
        cand = cur.copy()
        try:
            apply_move(cand, mv)
        except AssertionError:
            continue
        s = exact_schedule(inst, cand)
        n_evals += 1
        if s is not None:
            cur, sched = cand, s
    return cur, sched, n_evals


# --------------------------------------------------------------------------- #
# scalar-loop reference search                                                 #
# --------------------------------------------------------------------------- #
def tabu_search(
    inst: Instance,
    init: Solution,
    params: TSParams | None = None,
    *,
    on_iteration=None,
    on_improvement=None,
) -> TSResult:
    """Algorithm 2.  ``on_iteration(event)`` fires once per outer iteration and
    ``on_improvement(event)`` whenever the incumbent improves; either callback
    may return a truthy value to stop the search (``stop_reason="callback"``).
    """
    params = params or TSParams()
    rng = np.random.default_rng(params.seed)
    t0 = time.monotonic()
    engine = BatchEvaluator(inst, backend=params.backend,
                            device=params.torch_device)

    cur = memory_update(inst, init, refresh_every=params.mem_refresh_every,
                        scalar=params.mem_update_scalar)
    sched = exact_schedule(inst, cur)
    if sched is None:
        raise ValueError("initial solution must be acyclic")
    best = cur.copy()
    best_mk = sched.makespan
    init_mk = best_mk
    history: list[tuple[int, float]] = [(0, best_mk)]

    # tabu table: destroyed configuration (task, machine, machine-pred) → expiry iter
    tabu: dict[tuple[int, int, int], int] = {}
    n_procs, n_tasks = inst.n_procs, inst.n_tasks
    it = 0
    unimproved = 0
    n_exact = n_approx = 0
    n_perturbations = 0
    accepted = 0
    stop_reason = "converged"

    def _fire(cb, improved: bool, cur_mk: float) -> bool:
        if cb is None:
            return False
        event = TSEvent(
            iteration=it,
            best_makespan=best_mk,
            current_makespan=cur_mk,
            elapsed=time.monotonic() - t0,
            n_exact_evals=n_exact,
            n_approx_evals=n_approx,
            improved=improved,
        )
        return bool(cb(event))

    while unimproved < params.max_unimproved:
        if time.monotonic() - t0 > params.time_limit:
            stop_reason = "time_limit"
            break
        if params.max_iters is not None and it >= params.max_iters:
            stop_reason = "max_iters"
            break
        if params.max_evals is not None and n_exact >= params.max_evals:
            stop_reason = "max_evals"
            break
        it += 1
        r, q, _, crit = heads_tails(inst, cur, sched)
        dur = sched.finish - sched.start

        moves = _n7_moves(cur, crit)
        moves += _cc_moves(inst, cur, crit, r, sched.start, params.n_change_core_positions)
        if not moves:
            break

        def resulting_config(m: Move) -> tuple[int, int, int]:
            dst = cur.proc_seq[m.dst_proc]
            if m.kind == "n7":
                tmp = [t for t in dst if t != m.task]
                pred = tmp[m.dst_pos - 1] if m.dst_pos > 0 else -2
            else:
                pred = dst[m.dst_pos - 1] if m.dst_pos > 0 else -2
            return (m.task, m.dst_proc, pred)

        scored = []
        for m in moves:
            est = _approx_eval(inst, cur, m, r, q, dur)
            n_approx += 1
            if np.isfinite(est):
                scored.append((est, m))
        scored.sort(key=lambda t: t[0])

        # pre-filter by the tabu table (no evaluation spent on hopeless moves)
        admissible: list[tuple[Move, bool]] = []
        for est, m in scored:
            is_tabu = tabu.get(resulting_config(m), -1) >= it
            if is_tabu and est >= best_mk:
                continue
            admissible.append((m, is_tabu))

        # exact-evaluate the approximate top-K in batched chunks: one
        # (chunk, n_tasks) array DP per chunk instead of per-candidate loops.
        # Cyclic candidates come back feasible=False (the scalar path's None).
        chosen = None
        chosen_sched = None
        chosen_mk = np.inf
        examined = 0
        pos = 0
        while pos < len(admissible):
            if chosen is not None and examined >= params.top_k:
                break
            size = min(params.top_k, len(admissible) - pos)
            if params.max_evals is not None:
                # a round where nothing is accepted must not exact-evaluate
                # the whole neighborhood past the cap
                size = min(size, params.max_evals - n_exact)
                if size <= 0:
                    break
            chunk = admissible[pos : pos + size]
            pos += size
            cands = []
            for m, _ in chunk:
                cand = cur.copy()
                apply_move(cand, m)
                cands.append(cand)
            ev = engine.evaluate(cands)
            n_exact += size
            examined += size
            for j, (m, is_tabu) in enumerate(chunk):
                if not ev.feasible[j]:
                    continue
                mk_j = float(ev.makespan[j])
                if is_tabu and mk_j >= best_mk:
                    continue  # aspiration failed
                if mk_j < chosen_mk:
                    chosen, chosen_mk = (m, cands[j]), mk_j
                    chosen_sched = ev.schedule(j)

        if chosen is None and params.max_evals is not None and n_exact >= params.max_evals:
            stop_reason = "max_evals"
            break
        if chosen is None:
            # all admissible moves tabu/cyclic → random perturbation (line 11)
            cur, sched, n_pert = _perturb(inst, cur, sched, crit, rng, params)
            n_exact += n_pert
            n_perturbations += 1
            unimproved += 1
            if _fire(on_iteration, False, sched.makespan):
                stop_reason = "callback"
                break
            continue

        m, cand = chosen
        # tabu the configuration we are destroying (so we don't undo the move)
        mpred_before, _ = cur.machine_pred_succ(n_tasks)
        destroyed = (m.task, m.src_proc, int(mpred_before[m.task]) if mpred_before[m.task] >= 0 else -2)
        tenure = _tenure_draw(params.seed, 0, it, m.kind == "cc", n_procs, n_tasks)
        tabu[destroyed] = it + tenure

        cur = cand
        accepted += 1
        if accepted % params.mem_update_period == 0:
            cur = memory_update(inst, cur, refresh_every=params.mem_refresh_every,
                                scalar=params.mem_update_scalar)
            sched = exact_schedule(inst, cur)
            n_exact += 1
            if sched is None:
                raise RuntimeError("memory_update returned a cyclic solution")
        else:
            sched = chosen_sched  # cand unchanged since its candidate eval

        improved = sched.makespan < best_mk - 1e-9
        if improved:
            best = cur.copy()
            best_mk = sched.makespan
            history.append((it, best_mk))
            unimproved = 0
            _maybe_sanitize(inst, best, "tabu_search incumbent commit", params,
                            mk=best_mk,
                            capacity=accepted % params.mem_update_period == 0)
        else:
            unimproved += 1
        if improved and _fire(on_improvement, True, sched.makespan):
            stop_reason = "callback"
            break
        if _fire(on_iteration, improved, sched.makespan):
            stop_reason = "callback"
            break

    return TSResult(
        best=best,
        best_makespan=best_mk,
        initial_makespan=init_mk,
        iterations=it,
        elapsed=time.monotonic() - t0,
        history=history,
        n_exact_evals=n_exact,
        n_approx_evals=n_approx,
        stop_reason=stop_reason,
    )


# --------------------------------------------------------------------------- #
# array-native multi-walk search                                               #
# --------------------------------------------------------------------------- #
class _WalkRound:
    """Per-walk chunked top-K evaluation state within one iteration."""

    __slots__ = ("mb", "is_tabu", "pos", "examined", "done",
                 "chosen_i", "chosen_mk", "chosen_start", "chosen_finish",
                 "chosen_cand")

    def __init__(self, mb: MoveBatch, is_tabu: np.ndarray):
        self.mb = mb
        self.is_tabu = is_tabu
        self.pos = 0
        self.examined = 0
        self.done = False
        self.chosen_i: int | None = None
        self.chosen_mk = np.inf
        self.chosen_start = None
        self.chosen_finish = None
        self.chosen_cand = None  # Solution (scalar backend only)


def tabu_multiwalk(
    inst: Instance,
    inits: list[Solution],
    params: TSParams | None = None,
    *,
    init_labels: list[str] | None = None,
    on_iteration=None,
    on_improvement=None,
) -> MultiWalkResult:
    """Algorithm 2 as W lock-step walks on one packed array state.

    Every walk runs the full tabu semantics independently (own tabu table,
    aspiration, RNG stream, unimproved counter); the budget
    (``time_limit`` / ``max_iters`` / ``max_evals``) is shared globally.
    Walk 0 seeds its RNG with ``params.seed`` exactly like
    :func:`tabu_search`, so ``W=1`` reproduces the single-walk trajectory
    (identical history, incumbent, and eval counts).  Callbacks fire once
    per lock-step iteration with the cross-walk incumbent.
    """
    params = params or TSParams()
    w_count = len(inits)
    assert w_count >= 1, "tabu_multiwalk needs at least one init"
    labels = init_labels or [f"walk{w}" for w in range(w_count)]
    t0 = time.monotonic()
    engine = BatchEvaluator(inst, backend=params.backend,
                            device=params.torch_device)
    scalar = engine.backend == "scalar"
    n_procs, n_tasks = inst.n_procs, inst.n_tasks
    rngs = [np.random.default_rng(params.seed if w == 0 else [params.seed, w])
            for w in range(w_count)]
    # compatible-core CSR (task → cores), precomputed once
    finite_pt = np.isfinite(inst.proc_time)
    compat_indptr = np.zeros(n_tasks + 1, dtype=np.int64)
    np.cumsum(finite_pt.sum(axis=1), out=compat_indptr[1:])
    compat_idx = np.nonzero(finite_pt)[1]

    cur_sols: list[Solution] = [
        memory_update(inst, init, refresh_every=params.mem_refresh_every,
                      scalar=params.mem_update_scalar)
        for init in inits
    ]
    # init (and post-Alg-3) schedules come from the scalar DP like the legacy
    # search: bit-identical to the numpy and torch engines
    scheds0 = [exact_schedule(inst, s) for s in cur_sols]
    if not all(s is not None for s in scheds0):
        raise ValueError("initial solutions must be acyclic")
    packed = PackedSolutions.from_solutions(inst, cur_sols)
    start = np.stack([s.start for s in scheds0])
    finish = np.stack([s.finish for s in scheds0])
    cur_mk = np.array([s.makespan for s in scheds0])
    best_mk = cur_mk.copy()
    best_sols = [s.copy() for s in cur_sols]
    histories: list[list[tuple[int, float]]] = [[(0, float(best_mk[w]))]
                                                for w in range(w_count)]
    sol_cache: list[Solution | None] = list(cur_sols)

    def _sol(w: int) -> Solution:
        if sol_cache[w] is None:
            sol_cache[w] = packed.to_solution(w)
        return sol_cache[w]

    global_best = float(best_mk.min())
    g_hist: list[tuple[int, float]] = [(0, global_best)]
    init_mk_min = global_best
    tabu: list[dict[tuple[int, int, int], int]] = [{} for _ in range(w_count)]
    unimproved = np.zeros(w_count, dtype=np.int64)
    accepted = np.zeros(w_count, dtype=np.int64)
    active = np.ones(w_count, dtype=bool)
    it = 0
    n_exact = n_approx = 0
    n_perturbations = 0
    stop_reason = "converged"

    def _fire(cb, improved: bool, current: float) -> bool:
        if cb is None:
            return False
        event = TSEvent(
            iteration=it,
            best_makespan=global_best,
            current_makespan=current,
            elapsed=time.monotonic() - t0,
            n_exact_evals=n_exact,
            n_approx_evals=n_approx,
            improved=improved,
        )
        return bool(cb(event))

    while active.any():
        if time.monotonic() - t0 > params.time_limit:
            stop_reason = "time_limit"
            break
        if params.max_iters is not None and it >= params.max_iters:
            stop_reason = "max_iters"
            break
        if params.max_evals is not None and n_exact >= params.max_evals:
            stop_reason = "max_evals"
            break
        it += 1
        aw = [int(w) for w in np.nonzero(active)[0]]
        # tails (Q) for the active walks in one batched backward sweep —
        # bit-exact with the scalar heads_tails
        dur_all = finish - start
        sub = PackedSolutions(assign=packed.assign[aw], mem=packed.mem[aw],
                              mpred=packed.mpred[aw], msucc=packed.msucc[aw])
        q_sub = engine.backward_tails(sub, dur_all[aw])

        rounds: dict[int, _WalkRound] = {}
        crits: dict[int, np.ndarray] = {}
        mach_all, pos_all = packed.positions()
        for wi, w in enumerate(aw):
            r = start[w]
            q = q_sub[wi]
            dur = dur_all[w]
            mkw = float(cur_mk[w])
            slack = mkw - r - q
            crit = slack <= _EPS * max(1.0, mkw)
            crits[w] = crit
            mach, pos = mach_all[w], pos_all[w]
            mb = MoveBatch.concat([
                _n7_move_batch(packed, w, crit),
                _cc_move_batch(inst, compat_indptr, compat_idx, packed, w, crit,
                               r, params.n_change_core_positions, mach, pos),
            ])
            if len(mb) == 0:
                active[w] = False  # the scalar loop's `if not moves: break`
                continue
            est = approx_eval_moves(inst, packed, w, mb, r, q, dur)
            n_approx += len(mb)
            fi = np.nonzero(np.isfinite(est))[0]
            order = fi[np.argsort(est[fi], kind="stable")]
            mb_sorted = mb.take(order)
            est_sorted = est[order]
            tk, dp, pr = _resulting_configs(packed, w, mb_sorted)
            tab = tabu[w]
            is_tabu = np.fromiter(
                (tab.get((int(tk[i]), int(dp[i]), int(pr[i])), -1) >= it
                 for i in range(len(order))),
                dtype=bool, count=len(order))
            adm = ~(is_tabu & (est_sorted >= best_mk[w]))
            rounds[w] = _WalkRound(mb_sorted.take(adm), is_tabu[adm])

        if not rounds:
            # every active walk ran out of moves (the scalar loop breaks
            # without firing callbacks); the while-condition ends the search
            continue

        # chunked top-K exact evaluation: all unresolved walks share one
        # (Σ chunk, n_tasks) engine batch per round
        while True:
            plan: list[tuple[int, int, int]] = []  # (walk, lo, size)
            planned = n_exact
            for w in sorted(rounds):
                wr = rounds[w]
                if wr.done:
                    continue
                if wr.chosen_i is not None and wr.examined >= params.top_k:
                    wr.done = True
                    continue
                if wr.pos >= len(wr.mb):
                    wr.done = True
                    continue
                size = min(params.top_k, len(wr.mb) - wr.pos)
                if params.max_evals is not None:
                    size = min(size, params.max_evals - planned)
                    if size <= 0:
                        wr.done = True
                        continue
                plan.append((w, wr.pos, size))
                wr.pos += size
                planned += size
            if not plan:
                break
            if scalar:
                cands = []
                for w, lo, size in plan:
                    base = _sol(w)
                    for i in range(lo, lo + size):
                        c = base.copy()
                        apply_move(c, _move_at(rounds[w].mb, i))
                        cands.append(c)
                ev = engine.evaluate(cands)
            else:
                chunk_rows = np.concatenate(
                    [np.full(size, w, dtype=np.int64) for w, _, size in plan])
                chunk_mb = MoveBatch.concat(
                    [rounds[w].mb.take(slice(lo, lo + size)) for w, lo, size in plan])
                ev = engine.evaluate(packed.apply_moves(chunk_rows, chunk_mb))
                cands = None
            off = 0
            for w, lo, size in plan:
                wr = rounds[w]
                wr.examined += size
                for jj in range(size):
                    g = off + jj
                    if not ev.feasible[g]:
                        continue
                    mk_j = float(ev.makespan[g])
                    if wr.is_tabu[lo + jj] and mk_j >= best_mk[w]:
                        continue  # aspiration failed
                    if mk_j < wr.chosen_mk:
                        wr.chosen_i = lo + jj
                        wr.chosen_mk = mk_j
                        wr.chosen_start = ev.start[g].copy()
                        wr.chosen_finish = ev.finish[g].copy()
                        wr.chosen_cand = cands[g] if scalar else None
                off += size
            n_exact = planned

        # resolve every walk's iteration: accept, or perturb, or stop
        stop_all = False
        for w in sorted(rounds):
            wr = rounds[w]
            if wr.chosen_i is None and params.max_evals is not None \
                    and n_exact >= params.max_evals:
                # this walk exhausted the shared eval budget without a move;
                # still let the other walks commit their already-paid-for
                # chosen candidates before stopping
                stop_reason = "max_evals"
                stop_all = True
                continue
            if wr.chosen_i is None:
                # all admissible moves tabu/cyclic → random perturbation
                sol_w = _sol(w)
                sched_w = Schedule(start=start[w].copy(), finish=finish[w].copy(),
                                   makespan=float(cur_mk[w]), topo=None)
                sol_w, sched_w, n_pert = _perturb(inst, sol_w, sched_w, crits[w],
                                                  rngs[w], params)
                n_exact += n_pert
                n_perturbations += 1
                sol_cache[w] = sol_w
                packed.set_solution(w, sol_w)
                start[w] = sched_w.start
                finish[w] = sched_w.finish
                cur_mk[w] = sched_w.makespan
                unimproved[w] += 1
                continue

            mv = _move_at(wr.mb, wr.chosen_i)
            mp_before = int(packed.mpred[w, mv.task])
            destroyed = (mv.task, mv.src_proc, mp_before if mp_before >= 0 else -2)
            tenure = _tenure_draw(params.seed, w, it, mv.kind == "cc",
                                  n_procs, n_tasks)
            tabu[w][destroyed] = it + tenure

            if scalar:
                sol_cache[w] = wr.chosen_cand
                packed.set_solution(w, wr.chosen_cand)
            else:
                packed.commit_move(w, mv)
                sol_cache[w] = None
            accepted[w] += 1
            if accepted[w] % params.mem_update_period == 0:
                sol_w = memory_update(inst, _sol(w),
                                      refresh_every=params.mem_refresh_every,
                                      scalar=params.mem_update_scalar)
                sched_w = exact_schedule(inst, sol_w)
                n_exact += 1
                if sched_w is None:
                    raise RuntimeError("memory_update returned a cyclic solution")
                sol_cache[w] = sol_w
                packed.set_solution(w, sol_w)
                start[w] = sched_w.start
                finish[w] = sched_w.finish
                cur_mk[w] = sched_w.makespan
            else:
                start[w] = wr.chosen_start
                finish[w] = wr.chosen_finish
                cur_mk[w] = wr.chosen_mk

            if cur_mk[w] < best_mk[w] - 1e-9:
                best_sols[w] = _sol(w).copy()
                best_mk[w] = cur_mk[w]
                histories[w].append((it, float(best_mk[w])))
                unimproved[w] = 0
                _maybe_sanitize(
                    inst, best_sols[w], f"tabu_multiwalk walk {w} incumbent",
                    params, mk=float(best_mk[w]),
                    capacity=accepted[w] % params.mem_update_period == 0)
            else:
                unimproved[w] += 1

        new_gbest = float(best_mk.min())
        g_improved = new_gbest < global_best
        if g_improved:
            global_best = new_gbest
            g_hist.append((it, global_best))
        if stop_all:
            break
        current = float(cur_mk[active].min()) if active.any() else global_best
        if g_improved and _fire(on_improvement, True, current):
            stop_reason = "callback"
            break
        if _fire(on_iteration, g_improved, current):
            stop_reason = "callback"
            break
        active &= unimproved < params.max_unimproved

    gi = int(np.argmin(best_mk))
    # walks that deactivated on their own converged; walks still active when
    # the loop ended were cut short by whatever stopped the search globally
    per_walk = [
        WalkInfo(init_label=labels[w], initial_makespan=histories[w][0][1],
                 best_makespan=float(best_mk[w]), best=best_sols[w],
                 history=histories[w],
                 stop_reason=stop_reason if active[w] else "converged")
        for w in range(w_count)
    ]
    return MultiWalkResult(
        best=best_sols[gi],
        best_makespan=float(best_mk[gi]),
        initial_makespan=init_mk_min,
        iterations=it,
        elapsed=time.monotonic() - t0,
        history=g_hist,
        n_exact_evals=n_exact,
        n_approx_evals=n_approx,
        stop_reason=stop_reason,
        n_perturbations=n_perturbations,
        walks=w_count,
        per_walk=per_walk,
    )


def _move_at(mb: MoveBatch, i: int) -> Move:
    """Scalar :class:`Move` view of row ``i`` of a :class:`MoveBatch`."""
    return Move("cc" if mb.cc[i] else "n7", int(mb.task[i]), int(mb.src_proc[i]),
                int(mb.src_pos[i]), int(mb.dst_proc[i]), int(mb.dst_pos[i]))
