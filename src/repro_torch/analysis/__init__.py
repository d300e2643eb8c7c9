"""Correctness tooling: the ILP certificate checker (DESIGN.md §12).

:mod:`repro_torch.analysis.certify` is an independent schedule/allocation
certificate checker written directly from the paper's ILP constraints
(§III).  It shares *no* evaluation code with ``core.solution`` /
``core.eval_batch`` / ``kernels.schedule_dp``: durations are recomputed
with plain loops from eqs. (4)–(5), start times are re-derived by a
machine-head event simulation (not a Kahn DP), and capacity is checked
by its own event sweep.  A shared formulation bug in the evaluation
backends therefore cannot hide from it.

``sanitize.py`` wires the certifier into the engines behind
``REPRO_SANITIZE=1`` / ``TSParams.sanitize``.
"""
from .certify import (  # noqa: F401
    CONSTRAINT_EQS,
    Certificate,
    Violation,
    certify_report,
    certify_schedule,
    certify_solution,
)
from .sanitize import SanitizeError, maybe_sanitize, sanitize_enabled  # noqa: F401

__all__ = [
    "CONSTRAINT_EQS",
    "Certificate",
    "Violation",
    "certify_report",
    "certify_schedule",
    "certify_solution",
    "SanitizeError",
    "maybe_sanitize",
    "sanitize_enabled",
]
