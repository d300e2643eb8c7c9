"""Recovery policies for the solve service (DESIGN.md §13).

The decision logic — retry or fail, back off how long, shed at the door,
fall back to the numpy backend — lives in a **pure-ish controller** whose
inputs are explicit (attempt counts, clock readings, typed errors) and
whose only state is small counters.  The dispatch thread feeds it events;
tests drive it with fault/clock interleavings directly, no threads
involved.

Policy knobs:

* :class:`RetryPolicy` — per-request retry with exponential backoff and
  **budget carry-over**: a request's wall-seconds across failed attempts
  accumulate in ``SolveRequest.spent``, and a retry is refused once they
  exhaust the request's ``Budget.time_limit`` (the paper's anytime framing
  means a retried search re-earns its incumbents; it must not re-earn its
  clock).
* signature **poisoning** — repeated launch-class failures on one launch
  signature route that class to the numpy fallback backend, whose results
  are produced and certified independently of the device path.
* :class:`AdmissionPolicy` — bounded queue depth and deadline-aware load
  shedding: a request that cannot possibly meet its deadline is refused at
  the door with :class:`~repro_torch.faults.errors.QueueOverload` (carrying
  ``retry_after``) instead of wasting a launch.
* ``watchdog_deadline`` — the dispatch loop abandons a launch exceeding
  it (:class:`~repro_torch.faults.errors.CompileTimeout`), swaps in a fresh
  solve lane, and lets retry/fallback handle the requests.
"""
from __future__ import annotations

import collections
import dataclasses

from ..faults.errors import QueueOverload, ReproError, wrap_error

__all__ = ["RetryPolicy", "AdmissionPolicy", "ResiliencePolicy", "Decision",
           "ResilienceController"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts total tries (1 = never retry).  Backoff for
    attempt k (1-based failures) is ``min(backoff_max, backoff_base *
    backoff_factor**(k-1))`` seconds on the service clock.  After
    ``poison_after`` launch-class failures on one signature, that
    signature falls back to the numpy backend."""

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 2.0
    poison_after: int = 2


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """``max_queue_depth`` bounds pending requests (0 disables depth
    shedding); ``shed_hopeless_deadlines`` refuses requests whose deadline
    already passed at submission; ``retry_after`` is the backpressure hint
    carried on the :class:`QueueOverload`."""

    max_queue_depth: int = 256
    shed_hopeless_deadlines: bool = True
    retry_after: float = 0.5


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    retry: RetryPolicy = RetryPolicy()
    admission: AdmissionPolicy = AdmissionPolicy()
    # seconds one launch may run before the dispatch loop abandons it and
    # fails/retries its requests with CompileTimeout; None = no watchdog
    watchdog_deadline: "float | None" = None


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of :meth:`ResilienceController.on_failure`."""

    action: str                      # "retry" | "fail"
    not_before: float = 0.0          # earliest re-dispatch (service clock)
    error: "ReproError | None" = None  # the error to fail with


class ResilienceController:
    """Small-state decision engine shared by the dispatch thread (which
    serializes all calls) and the property tests (single-threaded)."""

    def __init__(self, policy: "ResiliencePolicy | None" = None):
        self.policy = policy or ResiliencePolicy()
        self.sig_failures: "collections.Counter" = collections.Counter()
        self.poisoned: "set" = set()
        self.n_shed = 0
        self.n_retries = 0
        self.n_failed = 0
        self.n_watchdog = 0

    # -- admission ---------------------------------------------------------
    def admit(self, *, depth: int, now: float,
              deadline: "float | None" = None) -> "QueueOverload | None":
        """Returns the :class:`QueueOverload` to shed with, or None to
        admit.  Raising is the caller's job (the controller stays pure)."""
        adm = self.policy.admission
        if adm.max_queue_depth and depth >= adm.max_queue_depth:
            self.n_shed += 1
            return QueueOverload(
                f"queue depth {depth} at bound {adm.max_queue_depth}",
                retry_after=adm.retry_after)
        if adm.shed_hopeless_deadlines and deadline is not None \
                and deadline <= now:
            self.n_shed += 1
            return QueueOverload(
                "deadline unmeetable at admission",
                retry_after=adm.retry_after)
        return None

    # -- backend fallback --------------------------------------------------
    def use_fallback(self, signature) -> bool:
        return signature in self.poisoned

    # -- terminal/retry decisions ------------------------------------------
    def on_failure(self, *, rid: int, signature, attempts: int,
                   exc: BaseException, now: float,
                   time_left: "float | None" = None) -> Decision:
        """Decide one failed attempt.  ``attempts`` counts failures so far
        *including this one*; ``time_left`` is the request's remaining
        wall budget (None = unbounded)."""
        err = wrap_error(exc, rid=rid)
        pol = self.policy.retry
        if isinstance(err, ReproError) and err.retryable \
                and not self.use_fallback(signature):
            self.sig_failures[signature] += 1
            if self.sig_failures[signature] >= pol.poison_after:
                self.poisoned.add(signature)
        if not err.retryable:
            self.n_failed += 1
            return Decision("fail", error=err)
        if attempts >= pol.max_attempts:
            self.n_failed += 1
            return Decision("fail", error=err)
        backoff = min(pol.backoff_max,
                      pol.backoff_base * pol.backoff_factor ** (attempts - 1))
        if time_left is not None and time_left <= backoff:
            # budget carry-over: the retry could not finish inside what is
            # left of the request's own clock
            self.n_failed += 1
            return Decision("fail", error=err)
        self.n_retries += 1
        return Decision("retry", not_before=now + backoff)

    def on_success(self, signature) -> None:
        """A healthy launch resets the signature's failure streak (but a
        poisoned signature stays on the fallback backend — a device that
        lost a launch class does not heal by accident)."""
        if signature not in self.poisoned:
            self.sig_failures.pop(signature, None)

    def on_watchdog(self) -> None:
        self.n_watchdog += 1

    def metrics(self) -> dict:
        return {
            "retries": self.n_retries,
            "failed": self.n_failed,
            "shed": self.n_shed,
            "watchdog_kills": self.n_watchdog,
            "poisoned_signatures": len(self.poisoned),
        }
