"""Structured failure taxonomy for the serving/search stack (DESIGN.md §13).

Every boundary in ``repro_torch.serve`` and the device engine raises a typed,
per-request-attributable :class:`ReproError` instead of failing a whole
batch: the ``rid`` attribute names the offending request (``None`` when the
failure cannot be pinned to one lane), and ``retryable`` tells the
resilience controller whether re-dispatching the same request can possibly
succeed.  Wrapping preserves the original exception as ``__cause__`` — a
:class:`CertifyFailure` still carries the sanitizer's
:class:`~repro_torch.analysis.sanitize.Certificate` via its cause, and an
:class:`InfeasibleRequest` carries the construction heuristic's
:class:`~repro_torch.core.mdfg.InfeasibleInstanceError` diagnosis.
"""
from __future__ import annotations

__all__ = [
    "ReproError",
    "CompileTimeout",
    "LaunchFailure",
    "DeviceLost",
    "CertifyFailure",
    "InfeasibleRequest",
    "QueueOverload",
    "EngineCrashed",
    "wrap_error",
]


class ReproError(RuntimeError):
    """Base of the serving failure taxonomy.

    ``rid`` attributes the failure to one request (None = unattributable,
    e.g. a whole batched launch raising); ``retryable`` is the class-level
    default the resilience controller consults; ``injected`` marks errors
    raised by the deterministic fault harness (``repro_torch.faults.inject``).
    """

    retryable = False

    def __init__(self, message: str, *, rid: "int | None" = None,
                 injected: bool = False):
        super().__init__(message)
        self.rid = rid
        self.injected = injected


class CompileTimeout(ReproError):
    """A compile/execute launch exceeded the watchdog deadline.  Retryable:
    the warm launch LRU usually has the program by the next attempt, and a
    hung lane is abandoned rather than joined."""

    retryable = True


class LaunchFailure(ReproError):
    """A device launch raised mid-batch (CUDA runtime error, bad buffer,
    injected fault).  Retryable — and repeated failures on one launch
    signature poison it toward the numpy fallback backend."""

    retryable = True


class DeviceLost(ReproError):
    """The accelerator disappeared under the launch (reset, OOM kill).
    Retryable on the fallback backend; the poisoning counter makes sure a
    dead device stops receiving traffic."""

    retryable = True


class CertifyFailure(ReproError):
    """A served incumbent failed ILP certification (DESIGN.md §12) — the
    result was *wrong*, not merely late.  Retryable: certification failures
    under faults are corruption (bit flips, bad readback), and a clean
    re-run certifies; systematic failures poison the signature toward the
    numpy backend, whose results certify independently."""

    retryable = True


class InfeasibleRequest(ReproError):
    """The request's instance admits no feasible construction (greedy init
    exhausted every memory tier).  NOT retryable — infeasibility is a
    property of the instance, not of the attempt (arXiv 2507.17411 shows
    such instances are normal traffic at the feasibility edge)."""

    retryable = False


class QueueOverload(ReproError):
    """Admission control shed this request: queue depth at bound or the
    deadline cannot be met.  Carries ``retry_after`` (seconds) — the
    client-visible backpressure signal."""

    retryable = False

    def __init__(self, message: str, *, rid: "int | None" = None,
                 retry_after: float = 0.5):
        super().__init__(message, rid=rid)
        self.retry_after = float(retry_after)


class EngineCrashed(ReproError):
    """The dispatch/engine thread died (or failed to drain in time) with
    requests still resident.  The thread's own exception, when captured, is
    chained as ``__cause__``.  Not retryable within this service instance."""

    retryable = False


def wrap_error(exc: BaseException, *, rid: "int | None" = None) -> ReproError:
    """Coerce an arbitrary exception into the taxonomy, preserving it as
    ``__cause__``.  Already-typed errors pass through (adopting ``rid`` if
    they lack one)."""
    if isinstance(exc, ReproError):
        if exc.rid is None and rid is not None:
            exc.rid = rid
        return exc
    from ..analysis.sanitize import SanitizeError
    from ..core.mdfg import InfeasibleInstanceError

    if isinstance(exc, SanitizeError):
        err: ReproError = CertifyFailure(str(exc), rid=rid)
    elif isinstance(exc, InfeasibleInstanceError):
        err = InfeasibleRequest(str(exc), rid=rid)
    else:
        err = LaunchFailure(f"{type(exc).__name__}: {exc}", rid=rid)
    err.__cause__ = exc
    return err
