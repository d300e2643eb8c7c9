"""Fault tolerance: failure taxonomy, deterministic injection, and
crash-surviving search state (DESIGN.md §13).

Three pieces: :mod:`~repro_torch.faults.errors` types every failure the
serving stack can produce (per-request-attributable, retryability encoded on
the class); :mod:`~repro_torch.faults.inject` is the seed-keyed deterministic
fault harness the tests drive (env-gated, zero overhead off);
:mod:`~repro_torch.faults.checkpoint` snapshots / restores the device
engine's walk state at sync boundaries, so a ``device_multiwalk`` run
survives a crash (``on_checkpoint=``, ``resume_from=``).
"""
from .checkpoint import (
    CheckpointMismatch,
    SearchCheckpoint,
    instance_fingerprint,
    params_fingerprint,
)
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
    "CheckpointMismatch",
    "CompileTimeout",
    "DeviceLost",
    "EngineCrashed",
    "FAULT_KINDS",
    "FaultPlan",
    "InfeasibleRequest",
    "LaunchFailure",
    "QueueOverload",
    "ReproError",
    "SearchCheckpoint",
    "instance_fingerprint",
    "params_fingerprint",
    "plan_context",
    "would_fire",
    "wrap_error",
]
