"""Named instance suites + the streaming sweep driver.

A *suite* is a named, deterministic list of ``(family, seed, params)``
items.  Building a suite yields validated instances; ``save_npz`` /
``load_npz`` round-trip them losslessly (solve results on a reloaded suite
are identical), and the files are the reference package's format, so a
suite saved by either package loads in the other.

``sweep(suite, solver=..., backend=...)`` runs a whole suite through one
solver: instances are grouped by shape bucket
(:func:`~repro_torch.instances.batch.group_by_bucket`) and, on the device
backend, each bucket group runs through ONE ``solve_instances`` call on one
launch — the launch-cache counters in the report prove the sweep captured
once per bucket, not once per instance.  Every row is normalized by the
instance's family-independent lower bound
(:mod:`repro_torch.instances.bounds`), so "TS lands within x% of LB" is
comparable across workload families.

The model-derived families (``residency``, ``pipeline``) need the planner,
which is not ported yet (ROADMAP A11): the suites that name them are
registered with the same items, and building such an item raises
``KeyError``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np

from ..core.mdfg import Instance, validate_instance
from .batch import InstanceBatch, group_by_bucket
from .bounds import bounds as instance_bounds
from .registry import generate

__all__ = [
    "SuiteItem",
    "Suite",
    "register_suite",
    "get_suite",
    "list_suites",
    "save_npz",
    "load_npz",
    "SweepReport",
    "sweep",
]


# --------------------------------------------------------------------------- #
# suite registry                                                               #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SuiteItem:
    family: str
    seed: int = 0
    params: tuple = ()              # sorted (key, value) pairs

    @classmethod
    def make(cls, family: str, seed: int = 0, **params) -> "SuiteItem":
        return cls(family=family, seed=seed,
                   params=tuple(sorted(params.items())))

    def build(self) -> Instance:
        if self.family in _AWAITING_PLANNER:
            raise KeyError(
                f"family {self.family!r} is extracted from a model config by the "
                "planner, which is not ported yet (ROADMAP A11)")
        inst = generate(self.family, self.seed, **dict(self.params))
        inst.name = f"{self.family}#{self.seed}[{inst.name}]"
        return inst


@dataclasses.dataclass(frozen=True)
class Suite:
    name: str
    items: tuple[SuiteItem, ...]
    description: str = ""

    def build(self) -> list[Instance]:
        return [it.build() for it in self.items]

    @property
    def families(self) -> tuple[str, ...]:
        return tuple(sorted({it.family for it in self.items}))


_SUITES: dict[str, Suite] = {}

# model-derived families of the reference, registered with the planner
_AWAITING_PLANNER = ("residency", "pipeline")


def register_suite(name: str, items: Sequence[SuiteItem], *,
                   description: str = "") -> Suite:
    if name in _SUITES:
        raise ValueError(f"suite {name!r} already registered")
    suite = Suite(name=name, items=tuple(items), description=description)
    _SUITES[name] = suite
    return suite


def get_suite(name: str) -> Suite:
    try:
        return _SUITES[name]
    except KeyError:
        raise KeyError(
            f"unknown suite {name!r}; registered: {', '.join(sorted(_SUITES))}"
        ) from None


def list_suites() -> tuple[str, ...]:
    return tuple(sorted(_SUITES))


_I = SuiteItem.make

register_suite("table2", [
    _I("random_layered", s, n_tasks=60 + 5 * s, n_data=150 + 10 * s,
       name=f"table2-{s}") for s in range(4)
], description="paper Table-II recipe at reduced scale (4 seeds)")

register_suite("trees_small", [
    _I("out_tree", 0, n_tasks=63, fanout=2, depth_profile="shrink"),
    _I("out_tree", 1, n_tasks=85, fanout=4, depth_profile="flat"),
    _I("in_tree", 0, n_tasks=63, fanout=2, depth_profile="grow"),
    _I("in_tree", 1, n_tasks=40, fanout=3, depth_profile="flat"),
], description="out/in-trees with varying fan-out and depth profiles")

register_suite("fft_wide", [
    _I("fft", 0, width=16),
    _I("fft", 1, width=32, stages=4),
], description="FFT butterflies, 16- and 32-wide")

register_suite("stencil_small", [
    _I("stencil", 0, width=16, steps=6),
    _I("stencil", 1, width=8, steps=10, radius=2),
], description="1-D stencil sweeps")

register_suite("model_derived", [
    _I("residency", 0, arch="mixtral-8x7b", scan_group=1),
    _I("pipeline", 0, arch="qwen2.5-14b", n_stages=4, n_microbatches=8),
], description="MDFGs extracted from model configs (smoke-sized)")

register_suite("smoke", [
    _I("random_layered", 0, n_tasks=40, n_data=100, name="smoke-random"),
    _I("out_tree", 0, n_tasks=31, fanout=2),
    _I("in_tree", 0, n_tasks=33, fanout=2),
    _I("fft", 0, width=8),
    _I("stencil", 0, width=8, steps=4),
    _I("residency", 0, scan_group=1),
    _I("pipeline", 0, n_stages=2, n_microbatches=4),
], description="one small instance per registered family (CI sweep leg)")


# --------------------------------------------------------------------------- #
# .npz round-trip                                                              #
# --------------------------------------------------------------------------- #
_NPZ_FIELDS = (
    "n_tasks", "n_data", "task_edges", "producer", "cons_indptr", "cons_idx",
    "in_indptr", "in_idx", "out_indptr", "out_idx", "proc_time", "data_size",
    "mem_cap", "access_time", "mem_level", "data_mem_ok",
)


def save_npz(path: str, instances: Sequence[Instance]) -> str:
    """Serialize instances to one compressed ``.npz`` (derived CSR state is
    rebuilt on load, so only the defining fields are stored).  Returns the
    path actually written (``np.savez`` appends ``.npz`` when missing)."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    arrays: dict = {
        "__count__": np.int64(len(instances)),
        "__names__": np.array([i.name for i in instances]),
        "__families__": np.array([_family_of(i) for i in instances]),
    }
    for ix, inst in enumerate(instances):
        for f in _NPZ_FIELDS:
            arrays[f"i{ix}/{f}"] = np.asarray(getattr(inst, f))
    np.savez_compressed(path, **arrays)
    return str(path)


def load_npz(path: str) -> list[Instance]:
    out = []
    with np.load(path, allow_pickle=False) as z:
        names = [str(s) for s in z["__names__"]]
        families = [str(s) for s in z["__families__"]]
        for ix in range(int(z["__count__"])):
            kw = {f: z[f"i{ix}/{f}"] for f in _NPZ_FIELDS}
            kw["n_tasks"] = int(kw["n_tasks"])
            kw["n_data"] = int(kw["n_data"])
            inst = Instance(name=names[ix], **kw)
            validate_instance(inst)
            inst.family = families[ix]
            out.append(inst)
    return out


def _family_of(inst: Instance) -> str:
    """Family provenance: the attribute stamped by ``registry.generate``,
    falling back to name heuristics for hand-built instances."""
    fam = getattr(inst, "family", None)
    if fam:
        return str(fam)
    name = inst.name
    if "#" in name:
        return name.split("#")[0]
    if "[" in name:
        return name.split("[")[0]
    return name or "unknown"


# --------------------------------------------------------------------------- #
# the sweep driver                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SweepReport:
    suite: str
    solver: str
    backend: str
    rows: list[dict]                 # per instance, suite order
    families: dict[str, dict]        # per-family aggregates
    buckets: int                     # shape-bucket groups in the suite
    compiles: int                    # device-launch cache misses (0 off-device;
                                     # on the card each is a capture)
    launch_cache: dict | None
    wall_time: float

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def _walk_inits(inst: Instance, walks: int, seed: int):
    """The ``tabu_multiwalk`` solver's own construction (one shared
    implementation — ``repro_torch.core.api.multiwalk_inits`` — so device sweep
    rows differ from numpy rows only by the engine, structurally)."""
    from ..core.api import multiwalk_inits

    sols, _labels = multiwalk_inits(inst, walks, seed)
    return sols


def _ts_params(budget, seed: int, backend: str, torch_device: str):
    """The solver path's own Budget→TSParams mapping
    (``api._budgeted_ts_params``), so sweep rows and ``solve()`` rows always
    run under identical effective budgets."""
    from ..core.api import _budgeted_ts_params
    from ..core.tabu import TSParams

    return _budgeted_ts_params(TSParams(), budget, seed, backend, torch_device)


def sweep(
    suite: str | Suite | Sequence[Instance],
    *,
    solver: str = "tabu_multiwalk",
    backend: str = "numpy",
    budget=None,
    walks: int = 4,
    seed: int = 0,
    device: dict | None = None,
    sanitize: "bool | None" = None,
    torch_device: str = "cuda",
    **solver_kwargs,
) -> SweepReport:
    """Run a whole suite through one solver, grouped by shape bucket.

    ``backend`` is ``"numpy"`` (the host engine), ``"torch"`` (the batched
    exact evaluation through K1 on ``torch_device``) or ``"device"``: every
    bucket group through one ``solve_instances`` call on ``torch_device``
    (one launch, captured once, per bucket — the report's
    ``compiles``/``buckets`` counters prove it); that engine IS the
    multiwalk tabu search, so ``solver`` must stay ``"tabu_multiwalk"`` /
    ``"tabu_device"`` and per-solver kwargs are rejected rather than
    silently dropped.  Other backends loop ``repro_torch.solve`` per
    instance with the same budget and walk inits.  ``suite`` may be a
    registered name, a :class:`Suite`, or a prebuilt instance list (e.g.
    from :func:`load_npz`).  ``torch_device`` is ``"cuda"`` by default
    (which raises without a GPU); ``"cpu"`` runs the same engines on the
    host.

    ``sanitize`` (default: the ``REPRO_SANITIZE`` env var) certifies every
    row's incumbent against the ILP constraints (DESIGN.md §12); rows then
    carry ``certified: True`` and a bad incumbent raises ``SanitizeError``
    instead of entering the report.
    """
    from ..core.api import Budget

    do_sanitize = sanitize
    if do_sanitize is None:
        do_sanitize = os.environ.get("REPRO_SANITIZE", "").strip().lower() \
            not in ("", "0", "false", "no", "off")

    def _certify(inst: Instance, sol, mk: float, feasible=None) -> bool:
        if not do_sanitize:
            return False
        from ..analysis.sanitize import maybe_sanitize

        maybe_sanitize(inst, sol, where=f"sweep row ({inst.name})",
                       flag=True, reported_makespan=mk,
                       claimed_feasible=feasible)
        return True

    budget = budget or Budget(time_limit=5.0, max_iters=400)
    if isinstance(suite, str):
        suite = get_suite(suite)
    if isinstance(suite, Suite):
        suite_name = suite.name
        items = suite.items
        instances = suite.build()
        fams = [it.family for it in items]
    else:
        instances = list(suite)
        suite_name = "<instances>"
        fams = [_family_of(i) for i in instances]

    t0 = time.monotonic()
    groups = group_by_bucket(instances)
    rows: list[dict | None] = [None] * len(instances)
    compiles = 0
    cache_after = None

    if backend == "device":
        from ..core.device_search import (DeviceConfig, launch_cache_info,
                                          solve_instances)

        if solver not in ("tabu_multiwalk", "tabu_device"):
            raise ValueError(
                f"backend='device' sweeps run the device multiwalk engine; "
                f"solver={solver!r} is not supported there")
        solver = "tabu_device"  # what actually produced the rows
        if solver_kwargs:
            raise ValueError(
                "backend='device' sweeps take no per-solver kwargs; got "
                + ", ".join(sorted(solver_kwargs)))
        params = _ts_params(budget, seed, "device", torch_device)
        cache_before = launch_cache_info()
        for grp in groups:
            batch = InstanceBatch.from_instances(
                [instances[i] for i in grp], validate=False)
            cfg_kw = dict(device or {})
            # full-capacity crit bucket: no overflow escalation mid-sweep,
            # so the capture count stays exactly one per bucket group
            cfg_kw.setdefault("crit_cap", batch.n_b)
            cfg = DeviceConfig(**cfg_kw)
            inits = [_walk_inits(inst, walks, seed) for inst in batch.instances]
            results = solve_instances(batch, inits, params, config=cfg)
            for ix, res in zip(grp, results):
                certified = _certify(instances[ix], res.best,
                                     float(res.best_makespan))
                rows[ix] = _row(instances[ix], fams[ix], res.best_makespan,
                                res.initial_makespan, res.iterations,
                                res.elapsed, certified=certified)
        cache_after = launch_cache_info()
        compiles = cache_after["misses"] - cache_before["misses"]
    else:
        from ..core.api import solve

        if device is not None:
            raise ValueError("device config requires backend='device'")
        if not solver.startswith("tabu") and backend != "numpy":
            raise ValueError(
                f"solver {solver!r} has no engine-backend selection; "
                "drop backend= or use a tabu solver")
        for grp in groups:
            for ix in grp:
                kw = dict(solver_kwargs)
                if solver in ("tabu_multiwalk", "tabu_device"):
                    kw.setdefault("walks", walks)
                if solver.startswith("tabu"):
                    kw.setdefault("backend", backend)
                    kw.setdefault("torch_device", torch_device)
                rep = solve(instances[ix], solver, budget=budget, seed=seed,
                            **kw)
                certified = rep.extras.get("certified") or _certify(
                    instances[ix], rep.solution, rep.makespan,
                    feasible=rep.feasible)
                rows[ix] = _row(instances[ix], fams[ix], rep.makespan,
                                rep.initial_makespan, rep.iterations,
                                rep.wall_time, certified=certified)

    families: dict[str, dict] = {}
    for row in rows:
        f = families.setdefault(row["family"], {"n": 0, "ratios": []})
        f["n"] += 1
        f["ratios"].append(row["ratio"])
    families = {
        k: {"n": v["n"], "mean_ratio": float(np.mean(v["ratios"])),
            "best_ratio": float(np.min(v["ratios"]))}
        for k, v in families.items()
    }
    return SweepReport(
        suite=suite_name, solver=solver, backend=backend,
        rows=[r for r in rows], families=families, buckets=len(groups),
        compiles=compiles, launch_cache=cache_after,
        wall_time=time.monotonic() - t0,
    )


def _row(inst: Instance, family: str, makespan: float, initial: float,
         iterations: int, wall: float, *, certified: bool = False) -> dict:
    lb = instance_bounds(inst)
    return {
        "certified": bool(certified),
        "name": inst.name,
        "family": family,
        "n_tasks": inst.n_tasks,
        "n_data": inst.n_data,
        "makespan": float(makespan),
        "initial_makespan": float(initial),
        "iterations": int(iterations),
        "wall": float(wall),
        "lb": lb["lb"],
        "lb_parts": {k: lb[k] for k in ("cp", "work", "mem")},
        "ratio": float(makespan / lb["lb"]) if lb["lb"] > 0 else float("inf"),
    }
