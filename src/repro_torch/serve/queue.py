"""Request intake for the scheduling-solve service.

A :class:`SolveRequest` is one unit of traffic: an HDATS instance plus the
search shape it must be solved under (walk count, :class:`Budget`, seed)
and an optional completion deadline.  Requests group by
:func:`launch_signature` — the quantized launch-shape class that decides
which captured device launch can serve them — so the batcher only ever
coalesces requests that genuinely share one captured launch.

:class:`RequestQueue` is the thread-safe store between the asyncio
front-end (producers) and the dispatch thread (consumer).  Its clock is
injectable: the fake-clock tests drive age- and deadline-based batch
cutting deterministically, with no sleeps.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable

import numpy as np

from ..core.api import Budget
from ..core.mdfg import Instance

__all__ = ["SolveRequest", "RequestQueue", "ServiceClosed", "launch_signature"]


class ServiceClosed(RuntimeError):
    """Raised on submit after the service stopped accepting new requests."""


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def launch_signature(inst: Instance, walks: int, budget: Budget) -> tuple:
    """Quantized launch-shape class of one request.

    Two requests with equal signatures can ride one captured device
    launch.  The signature carries exactly the shape facts
    ``InstanceBatch`` / the launch LRU capture against — task/data buckets
    (32-quanta via ``kernels.schedule_dp.bucket``), processor and
    memory-tier counts, dense in-degree widths (pow2-quantized so
    near-miss instances coalesce into few classes), padded CSR edge
    lengths (128-quanta) — plus the capture-relevant search shape: the
    walk count and the (hashable) budget, whose ``max_iters``/``max_evals``
    are baked into the captured loop condition.  The engine pins the
    assembled batch's widths/edge pads to these quantized values, so every
    batch cut from one signature lands on the exact same ``bucket_key``
    and therefore the same warm launch.  The shape facts equal the
    reference package's for the same instance.
    """
    from ..instances.batch import _padded_edge_len
    from ..kernels import schedule_dp as sdp

    def width(indptr) -> int:
        deg = np.diff(indptr)
        return max(1, int(deg.max()) if len(deg) else 1)

    widths = tuple(max(8, _pow2ceil(width(getattr(inst, f))))
                   for f in ("pred_indptr", "succ_indptr",
                             "in_indptr", "out_indptr"))
    e_b = (_padded_edge_len(len(inst.in_idx)),
           _padded_edge_len(len(inst.out_idx)))
    return (sdp.bucket(inst.n_tasks), inst.n_procs, sdp.bucket(inst.n_data),
            inst.n_mems, widths, e_b, int(walks), budget)


@dataclasses.dataclass(eq=False)
class SolveRequest:
    """One queued solve: instance + budget + seed (+ optional deadline).

    ``submitted`` and ``deadline`` are absolute timestamps on the owning
    queue's clock; ``signature`` is the request's launch-shape class.
    """

    rid: int
    instance: Instance
    budget: Budget
    seed: int
    walks: int
    submitted: float
    deadline: "float | None"
    signature: tuple = dataclasses.field(repr=False)
    # resilience bookkeeping (DESIGN.md §13): failed attempts so far, wall
    # seconds burned across them (budget carry-over), earliest re-dispatch
    # time after backoff, and whether blast-radius isolation demands this
    # request be cut alone on its next launch
    attempts: int = 0
    spent: float = 0.0
    not_before: float = 0.0
    isolated: bool = False

    def age(self, now: float) -> float:
        return now - self.submitted

    def time_left(self) -> "float | None":
        """Remaining wall budget after prior failed attempts (None =
        unbounded ``Budget.time_limit``)."""
        if self.budget.time_limit is None:
            return None
        return float(self.budget.time_limit) - self.spent


class RequestQueue:
    """Thread-safe request store, FIFO per launch-shape signature."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._cond = threading.Condition()
        self._groups: "dict[tuple, list[SolveRequest]]" = {}
        self._rid = itertools.count()
        self._closed = False
        self.n_submitted = 0

    # -- producers ---------------------------------------------------------
    def make_request(self, instance: Instance, budget: "Budget | None" = None,
                     *, seed: int = 0, walks: int = 2,
                     deadline: "float | None" = None) -> SolveRequest:
        """Construct (but do not enqueue) a request.  Lets the service
        register result plumbing against ``rid`` before the dispatch thread
        can possibly see the request (:meth:`put`).  ``deadline`` is
        seconds from now on this queue's clock."""
        budget = budget or Budget.smoke()
        now = self.clock()
        return SolveRequest(
            rid=next(self._rid), instance=instance, budget=budget,
            seed=int(seed), walks=int(walks), submitted=now,
            deadline=None if deadline is None else now + float(deadline),
            signature=launch_signature(instance, walks, budget))

    def put(self, req: SolveRequest) -> SolveRequest:
        with self._cond:
            if self._closed:
                raise ServiceClosed("queue is closed to new requests")
            self._groups.setdefault(req.signature, []).append(req)
            self.n_submitted += 1
            self._cond.notify_all()
        return req

    def submit(self, instance: Instance, budget: "Budget | None" = None,
               *, seed: int = 0, walks: int = 2,
               deadline: "float | None" = None) -> SolveRequest:
        """Construct and enqueue in one step."""
        return self.put(self.make_request(instance, budget, seed=seed,
                                          walks=walks, deadline=deadline))

    def requeue(self, req: SolveRequest) -> SolveRequest:
        """Re-enqueue an already-admitted request (retry / blast-radius
        re-dispatch).  Bypasses the closed check — the request was accepted
        before intake closed, and drain owes it an answer — and does not
        recount it in ``n_submitted``."""
        with self._cond:
            self._groups.setdefault(req.signature, []).append(req)
            self._cond.notify_all()
        return req

    def close(self) -> None:
        """Stop accepting new requests (pending ones stay queued)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- consumer ----------------------------------------------------------
    def __len__(self) -> int:
        with self._cond:
            return sum(len(g) for g in self._groups.values())

    def groups(self) -> "dict[tuple, tuple[SolveRequest, ...]]":
        """Snapshot of pending requests per signature (oldest first)."""
        with self._cond:
            return {k: tuple(v) for k, v in self._groups.items() if v}

    def take(self, signature: tuple, n: int) -> "list[SolveRequest]":
        """Pop up to ``n`` oldest pending requests of one signature."""
        with self._cond:
            g = self._groups.get(signature, [])
            out, rest = g[:n], g[n:]
            if rest:
                self._groups[signature] = rest
            elif signature in self._groups:
                del self._groups[signature]
            return out

    def take_ready(self, signature: tuple, n: int,
                   now: float) -> "list[SolveRequest]":
        """Pop up to ``n`` *dispatchable* requests of one signature: skips
        requests still backing off (``not_before > now``), and cuts an
        ``isolated`` request alone (blast-radius re-dispatch must identify
        the offender, so it may not share a launch)."""
        with self._cond:
            g = self._groups.get(signature, [])
            out: "list[SolveRequest]" = []
            rest: "list[SolveRequest]" = []
            for r in g:
                if r.not_before > now or len(out) >= n \
                        or (r.isolated and out):
                    rest.append(r)
                elif r.isolated:
                    out.append(r)
                    n = 1  # nothing else joins this cut
                else:
                    out.append(r)
            if rest:
                self._groups[signature] = rest
            elif signature in self._groups:
                del self._groups[signature]
            return out

    def wait_for_work(self, timeout: "float | None" = None) -> bool:
        """Block until a request is pending or the queue closes; returns
        whether anything is pending now."""
        with self._cond:
            if any(self._groups.values()) or self._closed:
                return any(self._groups.values())
            self._cond.wait(timeout)
            return any(self._groups.values())
