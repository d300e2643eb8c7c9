"""Scheduling-as-a-service: streaming solve server with continuous bucket
batching.

The pipeline (DESIGN.md §11): an asyncio front-end
(:class:`~repro_torch.serve.service.SolveService`) enqueues
:class:`~repro_torch.serve.queue.SolveRequest`s grouped by quantized
launch-shape signature; a deadline/budget-aware
:class:`~repro_torch.serve.batcher.Batcher` cuts same-signature batches; a
warm-pool :class:`~repro_torch.serve.engine.Engine` runs them through
``device_search.solve_instances`` (one captured round per sync period,
launching the schedule-DP kernel) or per-request NumPy solves, overlapping
host batch assembly with device compute, and streams anytime incumbents
back per request.  Every served result is bit-identical to a solo
``repro_torch.solve()`` at the same seed/budget/backend.

(The LLM token-serving driver lives at ``repro_torch.launch.model_serve`` —
this package is the *scheduling* service.)
"""
from .batcher import Batcher, BatchPolicy, CutBatch
from .compile_cache import enable_compilation_cache
from .engine import (
    Engine,
    EngineConfig,
    RequestFailure,
    RequestResult,
    WarmSpec,
)
from .queue import RequestQueue, ServiceClosed, SolveRequest, launch_signature
from .resilience import (
    AdmissionPolicy,
    ResilienceController,
    ResiliencePolicy,
    RetryPolicy,
)
from .service import SolveService

__all__ = [
    "AdmissionPolicy",
    "Batcher",
    "BatchPolicy",
    "CutBatch",
    "Engine",
    "EngineConfig",
    "RequestFailure",
    "RequestResult",
    "RequestQueue",
    "ResilienceController",
    "ResiliencePolicy",
    "RetryPolicy",
    "ServiceClosed",
    "SolveRequest",
    "SolveService",
    "WarmSpec",
    "enable_compilation_cache",
    "launch_signature",
]
