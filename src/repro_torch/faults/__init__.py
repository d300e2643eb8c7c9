"""Fault tolerance: failure taxonomy and deterministic injection
(DESIGN.md §13).

:mod:`~repro_torch.faults.errors` types every failure the serving stack can
produce (per-request-attributable, retryability encoded on the class);
:mod:`~repro_torch.faults.inject` is the seed-keyed deterministic fault
harness the tests drive (env-gated, zero overhead off).  Crash-surviving
search state (checkpointing the device engine's walks at sync boundaries)
is not ported yet (ROADMAP A6): ``device_multiwalk(on_checkpoint=...,
resume_from=...)`` raises ``NotImplementedError``.
"""
from .errors import (
    CertifyFailure,
    CompileTimeout,
    DeviceLost,
    EngineCrashed,
    InfeasibleRequest,
    LaunchFailure,
    QueueOverload,
    ReproError,
    wrap_error,
)
from .inject import FAULT_KINDS, FaultPlan, plan_context, would_fire

__all__ = [
    "CertifyFailure",
    "CompileTimeout",
    "DeviceLost",
    "EngineCrashed",
    "FAULT_KINDS",
    "FaultPlan",
    "InfeasibleRequest",
    "LaunchFailure",
    "QueueOverload",
    "ReproError",
    "plan_context",
    "would_fire",
    "wrap_error",
]
