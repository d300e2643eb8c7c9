"""Warm-pool execution engine: cut batches → captured launches → reports.

The engine owns the backend-facing half of the service.  For the device
backend it turns a :class:`~repro_torch.serve.batcher.CutBatch` into an
:class:`~repro_torch.instances.InstanceBatch` whose widths/edge pads are
pinned to the cut's quantized signature (``assemble``, host-side, no tensor
on the card — overlappable with device compute), then runs
``device_search.solve_instances`` on it on ``EngineConfig.torch_device``
(``execute``) and fans the per-instance ``MultiWalkResult``s out as
:class:`~repro_torch.core.api.SolveReport`s built by the exact same helper
the solo ``tabu_device`` solver uses — a served request's report is
structurally identical to, and bit-identical in content with, a solo
``solve()`` at the same seed/budget/backend.

Batch sizes are quantized to ``EngineConfig.batch_sizes`` (pad lanes
repeat the last request and are dropped at fan-out; every lane's update is
masked by its own flag, so they cannot perturb real lanes), so a handful of
captured launches per signature covers every cut width.  ``warmup``
captures those launches from declared :class:`WarmSpec` traffic classes via
``device_search.warm_launches``, backed by the launch LRU.  The numpy
backend runs the NumPy engine per request (``backend="numpy"`` explicitly:
the port's ``TSParams`` default to the torch engine on the card).
"""
from __future__ import annotations

import dataclasses
import os
import time

from ..core.api import (
    Budget,
    Callbacks,
    SolveReport,
    _budgeted_ts_params,
    _report_from_multiwalk,
    multiwalk_inits,
    solve,
)
from ..core.mdfg import Instance
from ..core.tabu import TSParams
from ..faults import inject as _inject
from ..faults.errors import ReproError, wrap_error
from .batcher import CutBatch
from .compile_cache import enable_compilation_cache
from .queue import SolveRequest, launch_signature

__all__ = ["EngineConfig", "WarmSpec", "RequestResult", "RequestFailure",
           "AssembledBatch", "Engine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Backend and launch-shape knobs.

    ``sync_every`` is the device sync horizon — larger amortizes dispatch
    but coarsens anytime-incumbent granularity and budget precision (see
    DESIGN.md §11).  ``crit_cap=None`` means full capacity (``batch.n_b``:
    no overflow relaunches under traffic).  ``batch_sizes`` are the
    quantized batch widths the warm pool captures.  ``torch_device`` is
    where the device backend runs (``"cuda"``, which raises without a GPU;
    ``"cpu"`` runs the same round eagerly).  ``compilation_cache_dir`` keeps
    the kernels' ``nvcc`` builds there (``compile_cache``).
    """

    backend: str = "device"  # "device" | "numpy"
    sync_every: int = 16
    crit_cap: "int | None" = None
    batch_sizes: tuple = (1, 2, 4, 8)
    compilation_cache_dir: "str | None" = None
    torch_device: str = "cuda"
    validate: bool = True
    # None defers to REPRO_SANITIZE; True certifies every served report
    # against the ILP constraints before fan-out (DESIGN.md §12)
    sanitize: "bool | None" = None


@dataclasses.dataclass(frozen=True)
class WarmSpec:
    """A declared traffic class to pre-capture: a representative instance
    plus the walk count and budget its requests will arrive with."""

    instance: Instance
    walks: int
    budget: Budget


@dataclasses.dataclass
class RequestResult:
    """What the service hands back per request: the solo-identical report
    plus serving metrics (queue wait, batch shape, cut reason, cache
    deltas, the cut's own K1 / ``seq_cumsum`` launches on the device
    backend; the service adds end-to-end ``latency``)."""

    request: SolveRequest
    report: SolveReport
    metrics: dict


@dataclasses.dataclass
class RequestFailure:
    """Per-lane failure: one request's typed, attributable error.  The
    engine returns these *alongside* sibling successes, so one bad lane
    never takes a cut down (DESIGN.md §13)."""

    request: SolveRequest
    error: ReproError


@dataclasses.dataclass
class AssembledBatch:
    """Host-side prepared work for one cut (built while the device runs
    the previous launch).  ``requests`` are the lanes that survived
    assembly; ``failures`` carries per-request assembly errors (infeasible
    constructions) already attributed."""

    cut: CutBatch
    instances: list
    inits: list
    seeds: list
    params: TSParams
    batch: object  # InstanceBatch on the device backend, else None
    padded_to: int
    assemble_seconds: float
    requests: "list | None" = None      # None = every request in the cut
    failures: list = dataclasses.field(default_factory=list)
    backend: "str | None" = None        # None = the engine's configured one

    @property
    def live_requests(self) -> list:
        return self.cut.requests if self.requests is None else self.requests


class Engine:
    def __init__(self, config: "EngineConfig | None" = None, *,
                 params: "TSParams | None" = None):
        self.config = config or EngineConfig()
        self.params = params or TSParams()
        self.persistent_cache = False
        if self.config.compilation_cache_dir:
            self.persistent_cache = enable_compilation_cache(
                self.config.compilation_cache_dir)
        self.warm_info: dict = {}
        self.n_batches = 0
        self.n_requests = 0

    # -- signature → pinned shapes ----------------------------------------
    def _make_batch(self, instances, signature):
        from ..instances.batch import InstanceBatch

        n_b, p_b, d_b, _n_mems, widths, e_b = signature[:6]
        return InstanceBatch.from_instances(
            instances, n_b=n_b, p_b=p_b, d_b=d_b, widths=widths, e_b=e_b,
            validate=self.config.validate)

    def _quantized_size(self, n: int) -> int:
        for b in sorted(self.config.batch_sizes):
            if b >= n:
                return int(b)
        return n  # cut wider than every declared size: capture exact width

    def _ts_params(self, budget, seed: int, backend: str) -> TSParams:
        return _budgeted_ts_params(self.params, budget, seed, backend,
                                   self.config.torch_device)

    # -- warm pool ---------------------------------------------------------
    def warmup(self, specs) -> dict:
        """Capture every launch the declared traffic classes need (per
        signature × quantized batch size, at one exact-evaluation chunk and
        at two, the chunk-overflow relaunch's first rung: see
        ``warm_launches``).  No-op on the numpy backend.
        Returns capture seconds per signature (``compile_seconds``, the
        reference's name) — the cold-start cost of every process."""
        specs = list(specs)
        if self.config.backend != "device" or not specs:
            self.warm_info = {"compile_seconds": 0.0, "signatures": 0,
                              "per_signature": []}
            return self.warm_info
        from ..core.device_search import DeviceConfig, warm_launches

        total, per_sig, seen = 0.0, [], set()
        for spec in specs:
            sig = launch_signature(spec.instance, spec.walks, spec.budget)
            if sig in seen:
                continue
            seen.add(sig)
            _inject.fire("engine.warmup.compile", key=len(seen))
            batch = self._make_batch([spec.instance], sig)
            cap = self.config.crit_cap or batch.n_b
            ts = self._ts_params(spec.budget, self.params.seed, "device")
            info = warm_launches(
                batch, spec.walks, ts,
                config=DeviceConfig(sync_every=self.config.sync_every,
                                    crit_cap=cap),
                batch_sizes=tuple(self.config.batch_sizes))
            total += info["compile_seconds"]
            per_sig.append({"bucket_key": list(info["bucket_key"]),
                            "walks": spec.walks,
                            "compile_seconds": info["compile_seconds"],
                            "cache_delta": info["cache_delta"]})
        self.warm_info = {"compile_seconds": total,
                          "signatures": len(per_sig),
                          "persistent_cache": self.persistent_cache,
                          "per_signature": per_sig}
        return self.warm_info

    # -- per-cut pipeline --------------------------------------------------
    def assemble(self, cut: CutBatch,
                 backend: "str | None" = None) -> AssembledBatch:
        """Host-side batch prep: walk inits per request (exactly
        ``multiwalk_inits`` — the solo path's starts), quantized padding,
        and the pinned-shape ``InstanceBatch`` (NumPy only: nothing here
        touches the card).  Runs concurrently with the previous launch's
        device compute.

        A request whose construction fails (e.g. ``InfeasibleInstanceError``
        from the greedy init) is attributed into ``failures`` and the rest
        of the cut proceeds — one bad instance never takes a batch down.
        ``backend`` overrides the configured one (the service routes
        poisoned signatures to the numpy fallback)."""
        t0 = time.monotonic()
        backend = backend or self.config.backend
        reqs = cut.requests
        walks = reqs[0].walks
        ts = self._ts_params(reqs[0].budget, reqs[0].seed, backend)
        good: "list[SolveRequest]" = []
        failures: "list[RequestFailure]" = []
        instances, seeds, inits = [], [], []
        for r in reqs:
            try:
                ini = multiwalk_inits(r.instance, walks, r.seed)[0]
            except Exception as e:
                # typed per-lane attribution (wrap_error → InfeasibleRequest
                # etc.); siblings keep assembling — DESIGN §13 blast radius
                failures.append(RequestFailure(r, wrap_error(e, rid=r.rid)))
                continue
            good.append(r)
            instances.append(r.instance)
            seeds.append(r.seed)
            inits.append(ini)
        batch = None
        padded_to = len(good)
        if backend == "device" and good:
            padded_to = self._quantized_size(len(good))
            while len(instances) < padded_to:
                # pad lanes repeat the last request; per-lane masking keeps
                # them from touching real lanes, and fan-out drops them
                instances.append(good[-1].instance)
                inits.append([s.copy() for s in inits[len(good) - 1]])
                seeds.append(good[-1].seed)
            batch = self._make_batch(instances, cut.signature)
        return AssembledBatch(cut=cut, instances=instances, inits=inits,
                              seeds=seeds, params=ts, batch=batch,
                              padded_to=padded_to,
                              assemble_seconds=time.monotonic() - t0,
                              requests=good, failures=failures,
                              backend=backend)

    def execute(self, assembled: AssembledBatch,
                callbacks: "list | None" = None) -> "list":
        """Run one assembled batch and fan results out per request as a
        mixed list of :class:`RequestResult` / :class:`RequestFailure` —
        a failed lane is attributed, never contagious.  ``callbacks[i]``
        (``Callbacks``-shaped, optional) aligns with ``cut.requests`` and
        receives request ``i``'s anytime events at sync boundaries."""
        cut = assembled.cut
        reqs = assembled.live_requests
        backend = assembled.backend or self.config.backend
        cb_by_rid: dict = {}
        if callbacks is not None:
            cb_by_rid = {r.rid: cb
                         for r, cb in zip(cut.requests, callbacks)}
        t0 = time.monotonic()
        results: "list" = list(assembled.failures)
        if not reqs:
            self.n_batches += 1
            return results
        # chaos harness: a whole-launch fault is attributable only when the
        # cut has a single lane (key the decision on the head rid so the
        # schedule is stable under re-dispatch)
        _inject.fire("engine.execute.launch", key=reqs[0].rid,
                     rid=reqs[0].rid if len(reqs) == 1 else None)
        if backend == "device":
            from ..core.device_search import (
                DeviceConfig,
                launch_cache_info,
                solve_instances,
            )

            cache0 = launch_cache_info()
            cap = self.config.crit_cap or assembled.batch.n_b
            cbs = None
            if callbacks is not None:
                cbs = [cb_by_rid.get(r.rid) for r in reqs] + \
                    [None] * (assembled.padded_to - len(reqs))
            rs = solve_instances(
                assembled.batch, assembled.inits, assembled.params,
                config=DeviceConfig(sync_every=self.config.sync_every,
                                    crit_cap=cap),
                seeds=assembled.seeds, callbacks=cbs)
            wall = time.monotonic() - t0
            cache1 = launch_cache_info()
            delta = {k: cache1[k] - cache0[k]
                     for k in ("hits", "misses", "evictions",
                               "overflow_relaunches", "uncached")}
            # the cut's own launches (the kernels' counters are process-wide)
            st = rs[0].device_stats
            delta["k1_replayed"] = st["k1_replayed"]
            delta["seq_cumsum_replayed"] = st["seq_cumsum_replayed"]
            delta["rounds_replayed"] = st["rounds_replayed"]
            for i, r in enumerate(reqs):  # pad lanes i >= len(reqs) dropped
                rep = _report_from_multiwalk("tabu_device", r.instance,
                                             rs[i], "device", wall)
                results.append(self._lane_result(r, rep, assembled, wall,
                                                 delta))
        else:
            for r in reqs:
                cb = cb_by_rid.get(r.rid) or Callbacks()
                try:
                    rep = solve(r.instance, "tabu_multiwalk", walks=r.walks,
                                budget=r.budget, seed=r.seed, callbacks=cb,
                                params=self.params, backend="numpy")
                except Exception as e:
                    # per-lane attribution: this request fails typed
                    # (wrap_error), its siblings still get their results
                    results.append(RequestFailure(r, wrap_error(e,
                                                                rid=r.rid)))
                    continue
                results.append(self._lane_result(r, rep, assembled,
                                                 time.monotonic() - t0, {}))
        self.n_batches += 1
        self.n_requests += len(reqs)
        return results

    def _sanitize_flag(self) -> bool:
        if self.config.sanitize is not None:
            return bool(self.config.sanitize)
        return os.environ.get("REPRO_SANITIZE", "").strip().lower() not in (
            "", "0", "false", "no", "off")

    def _lane_result(self, req, report, assembled, wall, cache_delta):
        """Build one lane's result, converting a certification failure into
        that lane's typed :class:`RequestFailure` (CertifyFailure carrying
        the sanitizer's certificate as ``__cause__``)."""
        try:
            return self._result(req, report, assembled, wall, cache_delta)
        except Exception as e:
            return RequestFailure(req, wrap_error(e, rid=req.rid))

    def _result(self, req, report, assembled, wall, cache_delta):
        cut = assembled.cut
        # chaos harness: corrupt the served incumbent / NaN the reported
        # makespan *before* certification, so sanitize mode must catch it
        assign2 = _inject.corrupt("engine.result.incumbent",
                                  report.solution.assign, key=req.rid)
        mk2 = _inject.nan_value("engine.result.makespan",
                                float(report.makespan), key=req.rid)
        corrupted = assign2 is not report.solution.assign \
            or mk2 != float(report.makespan)
        if corrupted:
            report = dataclasses.replace(
                report,
                solution=dataclasses.replace(report.solution, assign=assign2),
                makespan=mk2,
                extras={**report.extras, "certified": False})
        certified = bool(report.extras.get("certified"))
        if not certified and self._sanitize_flag():
            # the report may have been built with the env flag off (e.g.
            # EngineConfig.sanitize=True alone) — certify it here so a bad
            # incumbent raises SanitizeError instead of being served
            from ..analysis.sanitize import maybe_sanitize

            maybe_sanitize(
                req.instance, report.solution,
                where=f"serve result (rid {req.rid})", flag=True,
                reported_makespan=report.makespan,
                claimed_feasible=report.feasible)
            certified = True
        return RequestResult(request=req, report=report, metrics={
            "certified": certified,
            "rid": req.rid,
            "backend": assembled.backend or self.config.backend,
            "cut_reason": cut.reason,
            "cut_at": cut.cut_at,
            "batch_size": len(cut.requests),
            "padded_to": assembled.padded_to,
            "queue_wait": cut.cut_at - req.submitted,
            "assemble_seconds": assembled.assemble_seconds,
            "solve_seconds": wall,
            "launch_cache": dict(cache_delta),
        })
