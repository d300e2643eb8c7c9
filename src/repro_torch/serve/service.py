"""Asyncio front-end of the scheduling-solve service.

``SolveService`` glues the pieces together: clients ``submit()`` requests
and ``await result(rid)`` / ``async for ev in stream_incumbents(rid)`` on
the event loop, while a dedicated dispatch thread runs the continuous
batching loop — cut (``Batcher``) → assemble (host) → execute (device) —
with a depth-2 pipeline: the next batch is assembled on the dispatch
thread while the previous launch runs on the single-lane device executor,
so host batch prep overlaps device compute.

Anytime incumbents cross threads via ``loop.call_soon_threadsafe`` into a
per-request ``asyncio.Queue``; final results resolve per-request futures
the same way.  ``shutdown()`` closes intake and by default drains the
queue — every accepted request still gets its full-budget answer.

Failures are typed and per-request (DESIGN.md §13): the engine returns
``RequestFailure`` lanes next to successes, the
:class:`~repro_torch.serve.resilience.ResilienceController` decides retry (with
backoff + budget carry-over) vs fail vs numpy fallback for poisoned
signatures, admission control sheds with ``QueueOverload`` when the queue
is at depth, a watchdog abandons launches exceeding their deadline, and
an unattributable batch failure re-dispatches lanes in isolation instead
of failing the cut wholesale.

An abandoned launch keeps running on its stale executor thread beside the
fresh one; the device engine gives each of the two runs its own launch
buffers (``core/device_search.py``), so the stale run cannot touch what
the fresh one reads.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import threading
import time

from ..core.tabu import TSParams
from ..faults import inject as _inject
from ..faults.errors import CompileTimeout, EngineCrashed, wrap_error
from .batcher import Batcher, BatchPolicy
from .engine import Engine, EngineConfig, RequestFailure, RequestResult, \
    WarmSpec
from .queue import RequestQueue, ServiceClosed
from .resilience import ResilienceController, ResiliencePolicy

__all__ = ["SolveService"]

_SENTINEL = object()


class _StreamCallback:
    """Bridges one request's sync-boundary events from the solver thread
    into its asyncio stream.  Never stops the search (returns ``None``)."""

    on_iteration = None

    def __init__(self, post, rid: int):
        self._post = post
        self._rid = rid

    def on_improvement(self, event):
        self._post(self._rid, event)
        return None


class SolveService:
    """Streaming solve server with continuous bucket batching.

    >>> service = await SolveService(warm=[WarmSpec(inst, 2, budget)]).start()
    >>> rid = await service.submit(inst, budget, seed=3)
    >>> async for ev in service.stream_incumbents(rid): ...
    >>> report = (await service.result(rid)).report
    >>> await service.shutdown()
    """

    def __init__(self, *, config: "EngineConfig | None" = None,
                 policy: "BatchPolicy | None" = None,
                 params: "TSParams | None" = None,
                 warm: "tuple | list" = (),
                 resilience: "ResiliencePolicy | None" = None,
                 clock=time.monotonic):
        self.engine = Engine(config or EngineConfig(), params=params)
        pol = policy or BatchPolicy()
        if self.engine.config.backend == "device":
            pol = dataclasses.replace(
                pol, max_batch=min(pol.max_batch,
                                   max(self.engine.config.batch_sizes)))
        self.queue = RequestQueue(clock=clock)
        self.batcher = Batcher(self.queue, pol)
        self.resilience = ResilienceController(resilience)
        self._warm_specs = tuple(warm)
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._thread: "threading.Thread | None" = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-solve")
        self._stale_pools: "list" = []  # abandoned by the watchdog
        self._lock = threading.Lock()
        self._futures: "dict[int, asyncio.Future]" = {}
        self._streams: "dict[int, asyncio.Queue]" = {}
        self._stream_cbs: "dict[int, _StreamCallback]" = {}
        self._done: "dict[int, RequestResult]" = {}
        self._failed: "dict[int, BaseException]" = {}
        self._completed = 0
        self._errors: "list[str]" = []
        self._engine_exc: "BaseException | None" = None
        self._clock_reads = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "SolveService":
        """Warm the launch pool (on the solve lane, before any traffic)
        and start the dispatch thread."""
        # lint: allow[RPR301] DESIGN §11 handoff: set on the event-loop thread
        # before the dispatch thread exists; read-only afterwards
        self._loop = asyncio.get_running_loop()
        if self._warm_specs:
            await self._loop.run_in_executor(
                self._pool, self.engine.warmup, self._warm_specs)
        # lint: allow[RPR301] DESIGN §11 handoff: assigned before the dispatch
        # thread starts; only start()/shutdown() (event-loop thread) touch it
        self._thread = threading.Thread(target=self._run,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()
        return self

    async def shutdown(self, *, drain: bool = True,
                       timeout: "float | None" = 60.0) -> None:
        """Close intake.  ``drain=True`` (default) finishes every queued
        request before returning; ``drain=False`` fails queued-but-unstarted
        requests with :class:`ServiceClosed`.

        The dispatch-thread join is bounded by ``timeout`` seconds: if the
        engine thread died mid-batch (or a launch hangs with no watchdog),
        residual requests fail with :class:`EngineCrashed` — carrying the
        engine's own exception as ``__cause__`` when one was captured —
        instead of hanging the caller forever (DESIGN §13)."""
        self.queue.close()
        if not drain:
            for sig, reqs in self.queue.groups().items():
                for r in self.queue.take(sig, len(reqs)):
                    self._fail_request(r, ServiceClosed(
                        "request dropped at shutdown"))
        if self._thread is not None:
            await self._loop.run_in_executor(None, self._thread.join, timeout)
            if self._thread.is_alive():
                exc = EngineCrashed(
                    f"dispatch thread failed to drain within {timeout}s")
                exc.__cause__ = self._engine_exc
                with self._lock:
                    self._errors.append(repr(exc))
                self._fail_all(exc)
                # lint: allow[RPR301] DESIGN §11 handoff: event-loop thread
                # abandons its handle; the stuck thread is daemon and never
                # touches _thread itself
                self._thread = None
                self._pool.shutdown(wait=False)
                for p in self._stale_pools:
                    p.shutdown(wait=False)
                return
            if self._engine_exc is not None:
                # the thread died abnormally: requests submitted after its
                # death (or registered but never seen) would dangle — fail
                # them typed, chaining the thread's own exception
                exc = EngineCrashed("engine thread died before draining")
                exc.__cause__ = self._engine_exc
                self._fail_all(exc)
            # lint: allow[RPR301] DESIGN §11 handoff: cleared after join() —
            # the dispatch thread is gone, only the event-loop thread remains
            self._thread = None
        self._pool.shutdown(wait=True)
        for p in self._stale_pools:
            p.shutdown(wait=False)

    # -- client surface ----------------------------------------------------
    async def submit(self, instance, budget=None, *, seed: int = 0,
                     walks: int = 2, deadline: "float | None" = None) -> int:
        """Enqueue one solve; returns its request id.  Result plumbing is
        registered before the dispatch thread can see the request, so a
        fast solve can never race its own bookkeeping.  Admission control
        may shed with :class:`~repro_torch.faults.errors.QueueOverload` (carrying
        ``retry_after``) when the queue is at depth or the deadline is
        already unmeetable."""
        req = self.queue.make_request(instance, budget, seed=seed,
                                      walks=walks, deadline=deadline)
        shed = self.resilience.admit(depth=len(self.queue),
                                     now=self.queue.clock(),
                                     deadline=req.deadline)
        if shed is not None:
            shed.rid = req.rid
            raise shed
        fut = self._loop.create_future()
        with self._lock:
            self._futures[req.rid] = fut
            self._streams[req.rid] = asyncio.Queue()
            self._stream_cbs[req.rid] = _StreamCallback(self._post_event,
                                                        req.rid)
        try:
            self.queue.put(req)
        except ServiceClosed:
            with self._lock:
                self._futures.pop(req.rid, None)
                self._streams.pop(req.rid, None)
                self._stream_cbs.pop(req.rid, None)
            raise
        return req.rid

    async def result(self, rid: int) -> RequestResult:
        """The final, solo-identical result of request ``rid``."""
        with self._lock:
            fut = self._futures.get(rid)
            if fut is None:
                rr = self._done.get(rid)
                if rr is not None:
                    return rr
                exc = self._failed.get(rid)
                if exc is not None:
                    raise exc
                raise KeyError(f"unknown request id {rid}")
        return await fut

    async def stream_incumbents(self, rid: int):
        """Async-iterate anytime incumbent :class:`TSEvent`s for one
        request; ends when its final result lands.  (After completion this
        yields nothing — use :meth:`result`.)"""
        with self._lock:
            q = self._streams.get(rid)
        if q is None:
            return
        while True:
            item = await q.get()
            if item is _SENTINEL:
                return
            yield item

    def metrics(self) -> dict:
        """Service-level counters plus the engine's launch-cache view."""
        with self._lock:
            lat = sorted(rr.metrics["latency"] for rr in self._done.values())
            errors = list(self._errors)
            n_failed = len(self._failed)
        info = {
            "submitted": self.queue.n_submitted,
            "completed": self._completed,
            "failed": n_failed,
            "pending": len(self.queue),
            "batches": self.engine.n_batches,
            "mean_batch_size": (self.engine.n_requests
                                / max(1, self.engine.n_batches)),
            "cuts_by_reason": dict(self.batcher.cuts_by_reason),
            "warmup": self.engine.warm_info,
            "resilience": self.resilience.metrics(),
            "errors": errors,
        }
        if lat:
            info["latency_p50"] = lat[len(lat) // 2]
            info["latency_p99"] = lat[min(len(lat) - 1,
                                          int(0.99 * len(lat)))]
        if self.engine.config.backend == "device":
            from ..core.device_search import launch_cache_info

            info["launch_cache"] = launch_cache_info()
        return info

    # -- dispatch thread ---------------------------------------------------
    def _clock(self) -> float:
        """Dispatch-thread clock reads, routed through the chaos harness's
        clock-skew point (a no-op with no active plan)."""
        with self._lock:
            self._clock_reads += 1
            key = self._clock_reads
        return _inject.skewed("service.clock", self.queue.clock(), key=key)

    def _run(self) -> None:
        inflight = None  # (future, CutBatch, started_at) on the device lane
        try:
            while True:
                inflight = self._poll_inflight(inflight, block=False)
                cut = self.batcher.cut(device_idle=inflight is None)
                if cut is not None:
                    backend = "numpy" \
                        if self.resilience.use_fallback(cut.signature) \
                        else None
                    assembled = self.engine.assemble(cut, backend)
                    now = self._clock()
                    for f in assembled.failures:
                        self._dispose_failure(f.request, f.error, now)
                    if not assembled.live_requests:
                        continue
                    with self._lock:
                        cbs = [self._stream_cbs.get(r.rid)
                               for r in cut.requests]
                    while inflight is not None:  # wait for the device lane
                        inflight = self._poll_inflight(inflight, block=True)
                    inflight = (self._pool.submit(self.engine.execute,
                                                  assembled, cbs),
                                cut, self._clock())
                    continue
                if self.queue.closed and len(self.queue) == 0:
                    if inflight is None:
                        break
                    # the harvest may requeue retries — loop, don't exit
                    inflight = self._poll_inflight(inflight, block=True)
                    continue
                if inflight is not None:
                    inflight = self._poll_inflight(inflight, block=True)
                    continue
                nxt = self.batcher.next_cut_time()
                timeout = 0.05 if nxt is None else \
                    min(0.05, max(0.0, nxt - self.queue.clock()))
                self.queue.wait_for_work(timeout=timeout)
        except Exception as e:  # defensive: keep clients unblocked, typed
            with self._lock:
                self._errors.append(repr(e))
                self._engine_exc = e
            self._fail_all(wrap_error(e))
            return
        self._fail_all(ServiceClosed("service shut down"))

    def _poll_inflight(self, inflight, *, block: bool):
        """Advance the in-flight launch: harvest when done, abandon when
        the watchdog deadline passes, else return it unchanged (or, with
        ``block=True``, keep waiting until one of those happens)."""
        if inflight is None:
            return None
        fut, cut, started = inflight
        wd = self.resilience.policy.watchdog_deadline
        while True:
            if fut.done():
                self._harvest(fut, cut, started)
                return None
            if wd is not None and self._clock() - started > wd:
                self._abandon(fut, cut, started)
                return None
            if not block:
                return inflight
            # wait (never .result(): no exception retrieval here) and
            # re-check done/watchdog
            concurrent.futures.wait([fut], timeout=0.01)

    def _abandon(self, fut, cut, started) -> None:
        """Watchdog: the launch exceeded its deadline.  A running launch
        cannot be cancelled, so the lane is abandoned — its future is never
        harvested (a late completion cannot resolve retried rids) and a
        fresh single-lane pool takes over — and the cut's requests go
        through the normal retry/fail decision as CompileTimeout."""
        self.resilience.on_watchdog()
        now = self._clock()
        wd = self.resilience.policy.watchdog_deadline
        fut.cancel()
        fut.add_done_callback(_swallow)
        with self._lock:
            self._errors.append(
                f"watchdog: launch exceeded {wd}s "
                f"(cut of {len(cut.requests)} abandoned)")
            old = self._pool
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-solve")
            self._stale_pools.append(old)
        old.shutdown(wait=False)
        for r in cut.requests:
            self._dispose_failure(
                r, CompileTimeout(
                    f"launch exceeded watchdog deadline {wd}s", rid=r.rid),
                now, elapsed=now - started)

    def _harvest(self, fut, cut, started) -> None:
        now = self._clock()
        elapsed = max(0.0, now - started)
        try:
            results = fut.result()
        except Exception as e:
            # whole-launch failure: attribute to one lane when the typed
            # error names a rid; otherwise isolate lanes so the offender is
            # identified on its own launch (DESIGN §13 blast radius)
            err = wrap_error(e)
            with self._lock:
                self._errors.append(repr(e))
            live = list(cut.requests)
            if err.rid is not None and len(live) > 1:
                for r in live:
                    if r.rid == err.rid:
                        self._dispose_failure(r, err, now, elapsed=elapsed)
                    else:
                        # innocent bystanders: re-dispatch, no attempt burned
                        r.spent += elapsed
                        self.queue.requeue(r)
            elif len(live) > 1:
                for r in live:
                    r.isolated = True
                    r.spent += elapsed
                    self.queue.requeue(r)
            else:
                self._dispose_failure(live[0], err, now, elapsed=elapsed)
            return
        for item in results:
            if isinstance(item, RequestFailure):
                self._dispose_failure(item.request, item.error, now,
                                      elapsed=elapsed)
            else:
                self.resilience.on_success(item.request.signature)
                self._finish(item)

    def _dispose_failure(self, req, exc, now: float, *,
                         elapsed: float = 0.0) -> None:
        """One failed attempt of one request: burn the attempt, carry the
        wall cost into the request's budget, and enact the controller's
        retry/fail decision."""
        req.attempts += 1
        req.spent += max(0.0, elapsed)
        time_left = req.time_left()
        if req.deadline is not None:
            dl = req.deadline - now
            time_left = dl if time_left is None else min(time_left, dl)
        d = self.resilience.on_failure(
            rid=req.rid, signature=req.signature, attempts=req.attempts,
            exc=exc, now=now, time_left=time_left)
        if d.action == "retry":
            req.not_before = d.not_before
            self.queue.requeue(req)
            return
        self._fail_request(req, d.error or wrap_error(exc, rid=req.rid))

    def _fail_request(self, req, exc: BaseException) -> None:
        with self._lock:
            fut = self._futures.pop(req.rid, None)
            q = self._streams.pop(req.rid, None)
            self._stream_cbs.pop(req.rid, None)
            self._failed[req.rid] = exc
        if self._loop is not None:
            if fut is not None:
                self._loop.call_soon_threadsafe(_set_exception, fut, exc)
            if q is not None:
                self._loop.call_soon_threadsafe(q.put_nowait, _SENTINEL)

    def _finish(self, rr: RequestResult) -> None:
        now = self.queue.clock()
        rr.metrics["latency"] = now - rr.request.submitted
        rr.metrics["attempts"] = rr.request.attempts + 1
        if rr.request.deadline is not None:
            rr.metrics["deadline_met"] = now <= rr.request.deadline
        with self._lock:
            fut = self._futures.pop(rr.request.rid, None)
            q = self._streams.pop(rr.request.rid, None)
            self._stream_cbs.pop(rr.request.rid, None)
            self._done[rr.request.rid] = rr
            self._completed += 1
        if self._loop is not None and fut is not None:
            self._loop.call_soon_threadsafe(_resolve, fut, rr, q)

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            futs = list(self._futures.values())
            for rid in self._futures:
                self._failed[rid] = exc
            self._futures.clear()
            qs = list(self._streams.values())
            self._streams.clear()
            self._stream_cbs.clear()
        if self._loop is None:
            return
        for f in futs:
            self._loop.call_soon_threadsafe(_set_exception, f, exc)
        for q in qs:
            self._loop.call_soon_threadsafe(q.put_nowait, _SENTINEL)

    def _post_event(self, rid: int, event) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        with self._lock:
            q = self._streams.get(rid)
        if q is not None:
            loop.call_soon_threadsafe(q.put_nowait, event)


def _resolve(fut: "asyncio.Future", rr: RequestResult, q) -> None:
    if not fut.done():
        fut.set_result(rr)
    if q is not None:
        q.put_nowait(_SENTINEL)


def _set_exception(fut: "asyncio.Future", exc: BaseException) -> None:
    if not fut.done():
        fut.set_exception(exc)
        # a client that calls result() after the bookkeeping pop reads the
        # exception from _failed, not from this future — mark it retrieved
        # so the orphan never warns at GC (runs on the event-loop thread)
        fut.exception()


def _swallow(fut: "concurrent.futures.Future") -> None:
    """Retrieve an abandoned launch's exception so it never warns."""
    if fut.cancelled():
        return
    fut.exception()
