"""Deadline/budget-aware continuous batch cutting.

The batcher watches the request queue's per-signature groups and decides
*when* to cut a batch and *which* group to cut.  A group becomes cuttable
when it fills (``max_batch``), when its oldest request has waited
``max_wait``, when any member's deadline is within ``deadline_slack`` of
now, when the device is idle anyway (``eager_when_idle`` — batching only
pays when there is something to overlap with), or when the queue closed
and we are draining.  Groups are served oldest-head-first across
signatures, so no shape class starves behind a hot one.

All timing runs on the queue's injectable clock — the fake-clock tests
step time explicitly.
"""
from __future__ import annotations

import collections
import dataclasses

from .queue import RequestQueue, SolveRequest

__all__ = ["BatchPolicy", "CutBatch", "Batcher"]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Cut thresholds.  ``max_wait``/``deadline_slack`` are seconds on the
    queue clock; ``max_batch`` is clamped by the service to the engine's
    largest quantized batch size."""

    max_batch: int = 8
    max_wait: float = 0.05
    deadline_slack: float = 0.25
    eager_when_idle: bool = True


@dataclasses.dataclass
class CutBatch:
    """One cut: same-signature requests headed for a single launch."""

    signature: tuple
    requests: "list[SolveRequest]"
    cut_at: float
    reason: str  # "full" | "deadline" | "age" | "idle" | "drain"

    def __len__(self) -> int:
        return len(self.requests)


class Batcher:
    def __init__(self, queue: RequestQueue,
                 policy: "BatchPolicy | None" = None):
        self.queue = queue
        self.policy = policy or BatchPolicy()
        self.cuts_by_reason: "collections.Counter[str]" = collections.Counter()

    def cut(self, *, device_idle: bool = False) -> "CutBatch | None":
        """Non-blocking: cut and return the most urgent ready batch, or
        ``None`` when no group meets a cut condition yet."""
        pol = self.policy
        now = self.queue.clock()
        groups = self.queue.groups()
        # oldest head first: the signature whose head request has waited
        # longest gets first claim, so shape classes can't starve
        for sig in sorted(groups, key=lambda s: groups[s][0].submitted):
            # requests still backing off after a failed attempt are not
            # dispatchable yet and must not trigger (or join) a cut
            reqs = tuple(r for r in groups[sig] if r.not_before <= now)
            if not reqs:
                continue
            if len(reqs) >= pol.max_batch:
                reason = "full"
            elif self.queue.closed:
                reason = "drain"
            elif any(r.deadline is not None
                     and r.deadline - now <= pol.deadline_slack
                     for r in reqs):
                reason = "deadline"
            elif now - reqs[0].submitted >= pol.max_wait:
                reason = "age"
            elif device_idle and pol.eager_when_idle:
                reason = "idle"
            else:
                continue
            taken = self.queue.take_ready(sig, pol.max_batch, now)
            if not taken:
                continue  # raced with another consumer
            self.cuts_by_reason[reason] += 1
            return CutBatch(signature=sig, requests=taken, cut_at=now,
                            reason=reason)
        return None

    def next_cut_time(self) -> "float | None":
        """Earliest queue-clock time a currently-pending group becomes
        cuttable with no new arrivals (``None`` when nothing is pending) —
        the dispatch loop sleeps until then instead of polling."""
        pol = self.policy
        t = None
        for reqs in self.queue.groups().values():
            # a backing-off request becomes cuttable at its not_before (its
            # age threshold has long passed by then)
            cands = [max(r.not_before, reqs[0].submitted + pol.max_wait)
                     for r in reqs]
            cands += [max(r.not_before, r.deadline - pol.deadline_slack)
                      for r in reqs if r.deadline is not None]
            g = min(cands)
            t = g if t is None else min(t, g)
        return t
