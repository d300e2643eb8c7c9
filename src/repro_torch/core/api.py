"""Unified HDATS solver surface — ``repro_torch.solve``.

The paper's four solvers (greedy construction, load balancing, tabu search,
brute-force ILP optimum) historically had four incompatible calling
conventions.  This module redesigns the surface around three pieces:

* a **solver registry** (`register_solver` / `get_solver` / `list_solvers`)
  whose entries all share one signature,
* a **uniform budget** (`Budget`: wall time, outer iterations, exact schedule
  evaluations) enforced by every solver, not just tabu search,
* a single entry point ``solve(instance, method=..., budget=..., seed=...,
  callbacks=...) -> SolveReport`` that planners, benchmarks, and examples all
  call, so adding a solver is one ``@register_solver`` away from every
  consumer.

The ``portfolio`` meta-solver splits a shared budget across the registered
base solvers and returns the best incumbent (cf. the common harness over
exact vs. heuristic schedulers in arXiv:2507.17411).

The exact-evaluation engine of the tabu solvers defaults to
``backend="torch"`` on ``torch_device="cuda"``; ``solve(...,
torch_device="cpu")`` or ``backend="numpy"`` keeps a run on the host.
``"tabu_device"`` (or ``"tabu_multiwalk"`` with ``backend="device"``) runs
the whole search round on the device (``core/device_search.py``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Protocol, Union

import numpy as np

from .eval_batch import BatchEvaluator, check_backend
from .greedy import STRATEGIES, construct_greedy
from .ilp import brute_force_optimum
from .load_balance import load_balance
from .mdfg import Instance
from .memory_update import memory_update
from .solution import Solution, exact_schedule, memory_feasible
from .tabu import TSEvent, TSParams, tabu_multiwalk, tabu_search

__all__ = [
    "Budget",
    "Callbacks",
    "SolveReport",
    "Solver",
    "solve",
    "register_solver",
    "get_solver",
    "list_solvers",
    "multiwalk_inits",
]


# --------------------------------------------------------------------------- #
# budget                                                                       #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Budget:
    """Uniform search budget.  ``None`` means unbounded along that axis.

    ``time_limit`` is wall-clock seconds, ``max_iters`` caps outer search
    iterations (tabu; single-pass constructors finish in one "iteration"),
    ``max_evals`` caps exact schedule evaluations (tabu's exact re-schedules,
    brute force's enumerated candidates).
    """

    time_limit: float | None = None
    max_iters: int | None = None
    max_evals: int | None = None

    @classmethod
    def smoke(cls) -> "Budget":
        """Tiny budget for tests/CI."""
        return cls(time_limit=2.0, max_iters=400)

    @classmethod
    def default(cls) -> "Budget":
        """Interactive budget."""
        return cls(time_limit=10.0)

    @classmethod
    def paper(cls) -> "Budget":
        """The paper's per-instance budget (T̄ = 600 s)."""
        return cls(time_limit=600.0)

    def split(self, n: int) -> "Budget":
        """An equal share of this budget across ``n`` sub-solves."""
        n = max(1, n)
        return Budget(
            time_limit=None if self.time_limit is None else self.time_limit / n,
            max_iters=None if self.max_iters is None else self.max_iters // n,
            max_evals=None if self.max_evals is None else self.max_evals // n,
        )

    def remaining(self, t0: float, *, iters_spent: int = 0, evals_spent: int = 0) -> "Budget":
        """This budget with wall time since ``t0`` and iteration/eval counts
        already spent deducted (exhausted axes clamp to 0, not None)."""
        return Budget(
            time_limit=None if self.time_limit is None
            else max(0.0, self.time_limit - (time.monotonic() - t0)),
            max_iters=None if self.max_iters is None
            else max(0, self.max_iters - iters_spent),
            max_evals=None if self.max_evals is None
            else max(0, self.max_evals - evals_spent),
        )


@dataclasses.dataclass
class Callbacks:
    """Observer hooks threaded into iterative solvers.

    ``on_iteration(event)`` fires once per outer iteration; ``on_improvement``
    fires when the incumbent improves.  Either may return a truthy value to
    stop the search early (the report's ``stop_reason`` becomes
    ``"callback"``).  Events are ``repro_torch.core.tabu.TSEvent`` instances.
    """

    on_iteration: Callable[[TSEvent], object] | None = None
    on_improvement: Callable[[TSEvent], object] | None = None


@dataclasses.dataclass
class SolveReport:
    """What every solver returns: the incumbent plus how it was found."""

    method: str
    solution: Solution
    makespan: float
    feasible: bool
    initial_makespan: float
    iterations: int
    n_exact_evals: int
    n_approx_evals: int
    wall_time: float
    history: list[tuple[int, float]]
    stop_reason: str = "completed"
    extras: dict = dataclasses.field(default_factory=dict)


class Solver(Protocol):
    """Registry entry contract: every solver speaks this one signature."""

    def __call__(
        self,
        inst: Instance,
        *,
        budget: Budget,
        seed: int,
        callbacks: Callbacks,
        **kwargs,
    ) -> SolveReport: ...


# --------------------------------------------------------------------------- #
# registry                                                                     #
# --------------------------------------------------------------------------- #
_REGISTRY: dict[str, Solver] = {}


def register_solver(name: str, fn: Solver | None = None):
    """Register ``fn`` under ``name``; usable as a decorator."""

    def _register(f: Solver) -> Solver:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = f
        return f

    return _register if fn is None else _register(fn)


def get_solver(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_REGISTRY))}"
        ) from None


def list_solvers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def solve(
    inst: Instance,
    method: str = "tabu",
    *,
    budget: Budget | None = None,
    seed: int | None = None,
    callbacks: Callbacks | None = None,
    **kwargs,
) -> SolveReport:
    """Solve one HDATS instance with a registered method.

    ``seed=None`` defers to the solver's own default (``params.seed`` for
    tabu, 0 otherwise); an explicit integer seeds both the initial
    construction and the search.

    >>> report = solve(inst, "tabu", budget=Budget(time_limit=10.0))
    >>> report.makespan, report.solution, report.history
    """
    solver = get_solver(method)
    return solver(
        inst,
        budget=budget or Budget(),
        seed=seed,
        callbacks=callbacks or Callbacks(),
        **kwargs,
    )


# --------------------------------------------------------------------------- #
# adapters for the paper's solvers                                             #
# --------------------------------------------------------------------------- #
def _sanitize_report(inst: Instance, report: SolveReport) -> SolveReport:
    """REPRO_SANITIZE boundary: certify every outgoing report against the
    ILP constraints (DESIGN.md §12).  The env check precedes the import so
    ``repro_torch.analysis`` stays off the hot path when the mode is off."""
    if os.environ.get("REPRO_SANITIZE", "").strip().lower() in ("", "0", "false", "no", "off"):
        return report
    from ..analysis.sanitize import maybe_sanitize

    cert = maybe_sanitize(
        inst,
        report.solution,
        where=f"solve report ({report.method})",
        flag=True,
        reported_makespan=report.makespan,
        claimed_feasible=report.feasible,
    )
    if cert is not None:
        report.extras["certified"] = True
    return report


def _report_from_solution(
    method: str,
    inst: Instance,
    sol: Solution,
    wall_time: float,
    *,
    n_exact_evals: int = 1,
    extras: dict | None = None,
) -> SolveReport:
    sched = exact_schedule(inst, sol)
    assert sched is not None, f"{method} produced a cyclic schedule"
    mk = sched.makespan
    return _sanitize_report(inst, SolveReport(
        method=method,
        solution=sol,
        makespan=mk,
        feasible=memory_feasible(inst, sol, sched),
        initial_makespan=mk,
        iterations=1,
        n_exact_evals=n_exact_evals,
        n_approx_evals=0,
        wall_time=wall_time,
        history=[(0, mk)],
        extras=extras or {},
    ))


def _make_greedy_solver(strategy: str) -> Solver:
    def _greedy(
        inst: Instance,
        *,
        budget: Budget,
        seed: int | None,
        callbacks: Callbacks,
        refine_memory: bool = False,
        relax_eps: float = 0.02,
        **_ignored,  # constructives tolerate other solvers' kwargs (e.g. params)
    ) -> SolveReport:
        t0 = time.monotonic()
        sol = construct_greedy(inst, strategy, rng=seed or 0, relax_eps=relax_eps)
        if refine_memory:
            sol = memory_update(inst, sol)
        return _report_from_solution(
            f"greedy:{strategy}", inst, sol, time.monotonic() - t0,
            extras={"strategy": strategy, "refine_memory": refine_memory},
        )

    return _greedy


for _s in STRATEGIES:
    register_solver(f"greedy:{_s}", _make_greedy_solver(_s))


@register_solver("load_balance")
def _solve_load_balance(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    **_ignored,
) -> SolveReport:
    t0 = time.monotonic()
    sol = load_balance(inst, rng=seed or 0)
    return _report_from_solution("load_balance", inst, sol, time.monotonic() - t0)


def _resolve_init(inst: Instance, init: Union[Solution, str, None], seed: int) -> Solution:
    if isinstance(init, Solution):
        return init
    strategy = init or "slack_first"
    if strategy.startswith("greedy:"):
        strategy = strategy[len("greedy:"):]
    if strategy == "load_balance":
        return load_balance(inst, rng=seed)
    return construct_greedy(inst, strategy, rng=seed)


def multiwalk_inits(
    inst: Instance,
    walks: int,
    seed: int,
    init: Union[Solution, str, None] = None,
) -> tuple[list[Solution], list[str]]:
    """Walk-start construction of the ``tabu_multiwalk`` solver: walk 0
    resolves ``init`` (default ``slack_first``) at ``seed``; walks 1..W-1
    cycle the §V-B strategies at per-walk seeds.  Kept in one place so every
    engine starts from the same walks."""
    if walks < 1:
        raise ValueError("walks must be >= 1")
    init_sols = [_resolve_init(inst, init, seed)]
    labels = [init if isinstance(init, str)
              else ("explicit" if isinstance(init, Solution) else "slack_first")]
    for w in range(1, walks):
        strategy = STRATEGIES[w % len(STRATEGIES)]
        init_sols.append(construct_greedy(inst, strategy, rng=seed + w))
        labels.append(f"{strategy}@{seed + w}")
    return init_sols, labels


def _budgeted_ts_params(params: TSParams, budget: Budget, seed: int,
                        backend: str | None = None,
                        torch_device: str | None = None) -> TSParams:
    over: dict = {"seed": seed}
    if backend is not None:
        over["backend"] = backend
    if torch_device is not None:
        over["torch_device"] = torch_device
    if budget.time_limit is not None:
        over["time_limit"] = budget.time_limit
    if budget.max_iters is not None:
        over["max_iters"] = budget.max_iters
    if budget.max_evals is not None:
        over["max_evals"] = budget.max_evals
    return dataclasses.replace(params, **over)


@register_solver("tabu")
def _solve_tabu(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    init: Union[Solution, str, None] = None,
    params: TSParams | None = None,
    backend: str | None = None,
    torch_device: str | None = None,
) -> SolveReport:
    """Tabu search from a greedy init (``init`` may name a greedy strategy,
    ``"load_balance"``, or be an explicit :class:`Solution`).  ``backend``
    overrides ``params.backend`` for the batched exact-evaluation engine
    (``"torch"`` default, ``"numpy"`` host reference, ``"scalar"`` oracle)
    and ``torch_device`` overrides ``params.torch_device``."""
    t0 = time.monotonic()
    params = params or TSParams()
    seed = params.seed if seed is None else seed  # None = respect params.seed
    ts = _budgeted_ts_params(params, budget, seed, backend, torch_device)
    check_backend(ts.backend)
    init_sol = _resolve_init(inst, init, seed)
    res = tabu_search(
        inst,
        init_sol,
        ts,
        on_iteration=callbacks.on_iteration,
        on_improvement=callbacks.on_improvement,
    )
    sched = exact_schedule(inst, res.best)
    assert sched is not None
    return _sanitize_report(inst, SolveReport(
        method="tabu",
        solution=res.best,
        makespan=res.best_makespan,
        feasible=memory_feasible(inst, res.best, sched),
        initial_makespan=res.initial_makespan,
        iterations=res.iterations,
        n_exact_evals=res.n_exact_evals,
        n_approx_evals=res.n_approx_evals,
        wall_time=time.monotonic() - t0,
        history=res.history,
        stop_reason=res.stop_reason,
        extras={"init": init if isinstance(init, str)
                else ("explicit" if isinstance(init, Solution) else "slack_first")},
    ))


@register_solver("tabu_multiwalk")
def _solve_tabu_multiwalk(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    walks: int = 8,
    init: Union[Solution, str, None] = None,
    inits: list[Solution] | None = None,
    params: TSParams | None = None,
    backend: str | None = None,
    torch_device: str | None = None,
    device: dict | None = None,
    _method: str = "tabu_multiwalk",
) -> SolveReport:
    """W independent tabu walks in lock-step on the packed array state
    (``tabu.tabu_multiwalk``), sharing one exact-evaluation batch per round
    and the whole budget.

    Walk 0 starts exactly like ``solve(inst, "tabu", init=..., seed=...)``
    (so ``walks=1`` reproduces that trajectory); walks 1..W-1 cycle through
    the §V-B construction strategies with per-walk seeds.  ``inits`` passes
    explicit start solutions instead (``walks`` is then ignored) — the
    portfolio uses this to continue from its best distinct incumbents.

    ``backend`` / ``torch_device`` override ``params.backend`` /
    ``params.torch_device`` (the exact-evaluation engine and the torch device
    its sweeps run on).  ``backend="device"`` (or ``params.backend=
    "device"``) routes the whole search through the device-resident engine
    (``device_search.device_multiwalk``): one captured round replayed
    ``sync_every`` times between host reads, on ``torch_device``.
    ``device`` passes :class:`~repro_torch.core.device_search.DeviceConfig`
    fields (``sync_every``, ``crit_cap``, ``perturb``).
    """
    t0 = time.monotonic()
    params = params or TSParams()
    seed = params.seed if seed is None else seed
    ts = _budgeted_ts_params(params, budget, seed, backend, torch_device)
    check_backend(ts.backend)
    if device is not None and ts.backend != "device":
        raise ValueError("device config requires backend='device'")
    if inits is not None:
        if not inits:
            raise ValueError("inits must be non-empty when given")
        init_sols = list(inits)
        labels = [f"explicit{i}" for i in range(len(init_sols))]
    else:
        init_sols, labels = multiwalk_inits(inst, walks, seed, init)
    if ts.backend == "device":
        from .device_search import DeviceConfig, device_multiwalk

        res = device_multiwalk(
            inst, init_sols, ts, config=DeviceConfig(**(device or {})),
            init_labels=labels, on_iteration=callbacks.on_iteration,
            on_improvement=callbacks.on_improvement)
    else:
        res = tabu_multiwalk(
            inst,
            init_sols,
            ts,
            init_labels=labels,
            on_iteration=callbacks.on_iteration,
            on_improvement=callbacks.on_improvement,
        )
    return _report_from_multiwalk(_method, inst, res, ts.backend,
                                  time.monotonic() - t0)


def _report_from_multiwalk(
    method: str,
    inst: Instance,
    res,
    backend: str,
    wall_time: float,
) -> SolveReport:
    """Build a :class:`SolveReport` from a ``MultiWalkResult`` (the
    ``tabu_multiwalk`` / ``tabu_device`` solvers); the device engine's
    capture time goes into ``extras["compile_seconds"]``."""
    sched = exact_schedule(inst, res.best)
    assert sched is not None
    extras: dict = {
        "walks": res.walks,
        "backend": backend,
        "per_walk": [
            {"init": wi.init_label,
             "initial_makespan": wi.initial_makespan,
             "best_makespan": wi.best_makespan,
             "solution": wi.best,
             "history": wi.history}
            for wi in res.per_walk
        ],
    }
    if hasattr(res, "compile_seconds"):
        extras["compile_seconds"] = res.compile_seconds
    if hasattr(res, "device_stats"):
        extras["device_stats"] = res.device_stats
        extras["n_perturbations"] = res.n_perturbations
    return _sanitize_report(inst, SolveReport(
        method=method,
        solution=res.best,
        makespan=res.best_makespan,
        feasible=memory_feasible(inst, res.best, sched),
        initial_makespan=res.initial_makespan,
        iterations=res.iterations,
        n_exact_evals=res.n_exact_evals,
        n_approx_evals=res.n_approx_evals,
        wall_time=wall_time,
        history=res.history,
        stop_reason=res.stop_reason,
        extras=extras,
    ))


@register_solver("tabu_device")
def _solve_tabu_device(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    walks: int = 8,
    init: Union[Solution, str, None] = None,
    inits: list[Solution] | None = None,
    params: TSParams | None = None,
    device: dict | None = None,
    backend: str | None = None,
    torch_device: str | None = None,
) -> SolveReport:
    """The device-resident multiwalk engine as a first-class solver:
    ``solve(inst, "tabu_device", walks=8, device={"sync_every": 64})``, on
    ``torch_device`` (``params.torch_device``, ``"cuda"`` by default, which
    raises without a GPU)."""
    if backend not in (None, "device"):
        raise ValueError(
            f"tabu_device always runs backend='device'; got backend={backend!r}"
            " — use solve(inst, 'tabu_multiwalk', backend=...) to pick one")
    return _solve_tabu_multiwalk(
        inst, budget=budget, seed=seed, callbacks=callbacks, walks=walks,
        init=init, inits=inits, params=params, backend="device",
        torch_device=torch_device, device=device, _method="tabu_device")


@register_solver("ilp_brute_force")
def _solve_brute_force(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    max_tasks: int = 7,
    **_ignored,
) -> SolveReport:
    """Exhaustive optimum on micro instances; the budget turns it into an
    anytime upper bound (``extras["exhaustive"]`` says which you got)."""
    t0 = time.monotonic()
    stats: dict = {}
    mk, sol = brute_force_optimum(
        inst,
        max_tasks=max_tasks,
        time_limit=budget.time_limit,
        max_evals=budget.max_evals,
        stats=stats,
    )
    report = _report_from_solution(
        "ilp_brute_force", inst, sol, time.monotonic() - t0,
        n_exact_evals=stats["n_evals"],
        extras={"exhaustive": stats["exhaustive"]},
    )
    report.stop_reason = "completed" if stats["exhaustive"] else "budget"
    return report


# --------------------------------------------------------------------------- #
# portfolio meta-solver                                                        #
# --------------------------------------------------------------------------- #
DEFAULT_PORTFOLIO = tuple(f"greedy:{s}" for s in STRATEGIES) + ("load_balance",)


@register_solver("portfolio")
def _solve_portfolio(
    inst: Instance,
    *,
    budget: Budget,
    seed: int | None,
    callbacks: Callbacks,
    methods: tuple[str, ...] | None = None,
    n_tabu_starts: int = 2,
    params: TSParams | None = None,
    backend: str | None = None,
    torch_device: str | None = None,
) -> SolveReport:
    """Anytime portfolio: run every constructive method, then spend the
    remaining budget on one ``tabu_multiwalk`` leg whose walks start from the
    best distinct incumbents (they advance in lock-step and share one exact
    evaluation batch per round, instead of running sequential split-budget
    legs).

    By construction the returned makespan is ≤ every constructive method it
    ran, and ≤ its own tabu walks' inits — the whole-budget answer to "which
    solver should I use for this scenario?".

    ``backend`` selects the tabu walks' batched evaluation engine; the final
    cross-leg verification always runs the batched NumPy reference path (one
    call over all incumbents, bit-exact with the scalar oracle).
    """
    t0 = time.monotonic()
    methods = DEFAULT_PORTFOLIO if methods is None else tuple(methods)
    if not methods:
        raise ValueError("portfolio needs at least one method")
    per_method: dict[str, float] = {}
    incumbents: list[tuple[float, str, Solution]] = []
    # anytime incumbent curve over a shared iteration counter across legs
    history: list[tuple[int, float]] = []
    iters = n_exact = n_approx = 0
    stop_reason = "completed"

    def _absorb(rep: SolveReport) -> None:
        nonlocal iters, n_exact, n_approx
        base = iters
        best_so_far = history[-1][1] if history else np.inf
        for i, v in rep.history:
            if v < best_so_far - 1e-12:
                best_so_far = v
                history.append((base + i, v))
        iters += rep.iterations
        n_exact += rep.n_exact_evals
        n_approx += rep.n_approx_evals

    for m in methods:
        if m == "portfolio":
            raise ValueError("portfolio cannot recurse into itself")
        rep = solve(inst, m, budget=budget.remaining(t0, iters_spent=iters,
                                                     evals_spent=n_exact),
                    seed=seed, callbacks=Callbacks())
        per_method[m] = rep.makespan
        incumbents.append((rep.makespan, m, rep.solution))
        _absorb(rep)
        if budget.time_limit is not None and time.monotonic() - t0 > budget.time_limit:
            stop_reason = "time_limit"
            break

    incumbents.sort(key=lambda t: t[0])
    initial_mk = incumbents[0][0] if incumbents else np.inf

    # tabu walks from the best distinct constructive incumbents, advancing in
    # lock-step on what is left of the budget (one multiwalk leg)
    if stop_reason == "completed" and n_tabu_starts > 0:
        seen_mks: set[float] = set()
        starts: list[tuple[str, Solution]] = []
        for mk, m, sol in incumbents:
            key = round(mk, 6)
            if key in seen_mks:
                continue
            seen_mks.add(key)
            starts.append((m, sol))
            if len(starts) >= n_tabu_starts:
                break
        leg_budget = budget.remaining(t0, iters_spent=iters, evals_spent=n_exact)
        rep = solve(inst, "tabu_multiwalk", budget=leg_budget, seed=seed,
                    callbacks=callbacks, inits=[sol for _, sol in starts],
                    params=params, backend=backend, torch_device=torch_device)
        for (m, _), wi in zip(starts, rep.extras["per_walk"]):
            per_method[f"tabu@{m}"] = wi["best_makespan"]
            incumbents.append((wi["best_makespan"], f"tabu@{m}", wi["solution"]))
        _absorb(rep)
        if rep.stop_reason == "callback":
            stop_reason = "callback"

    incumbents.sort(key=lambda t: t[0])
    best_mk, best_method, best_sol = incumbents[0]
    # one batched evaluation over every leg's incumbent re-derives all
    # makespans and memory feasibility (differential-array peaks) at once
    ev = BatchEvaluator(inst, backend="numpy").evaluate(
        [s for _, _, s in incumbents], peaks=True)
    assert bool(np.all(ev.feasible)), "a portfolio leg produced a cyclic schedule"
    assert np.allclose(ev.makespan, [mk for mk, _, _ in incumbents], rtol=1e-9), \
        "a leg's reported makespan disagrees with its re-evaluated schedule"
    return _sanitize_report(inst, SolveReport(
        method="portfolio",
        solution=best_sol,
        makespan=best_mk,
        feasible=bool(ev.mem_ok[0]),
        initial_makespan=initial_mk,
        iterations=iters,
        n_exact_evals=n_exact,
        n_approx_evals=n_approx,
        wall_time=time.monotonic() - t0,
        history=history or [(0, best_mk)],
        stop_reason=stop_reason,
        extras={"per_method": per_method, "winner": best_method},
    ))
