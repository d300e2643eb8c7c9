"""Correctness tooling: ILP certificate checker + repo-discipline linter.

Two prongs (DESIGN.md §12):

* :mod:`repro_torch.analysis.certify` — an independent schedule/allocation
  certificate checker written directly from the paper's ILP constraints
  (§III).  It shares *no* evaluation code with ``core.solution`` /
  ``core.eval_batch`` / ``kernels.schedule_dp``: durations are recomputed
  with plain loops from eqs. (4)–(5), start times are re-derived by a
  machine-head event simulation (not a Kahn DP), and capacity is checked
  by its own event sweep.  A shared formulation bug in the evaluation
  backends therefore cannot hide from it.
* :mod:`repro_torch.analysis.lint` — an AST linter whose rules encode the
  DESIGN §§7–11 discipline as the port meets it (Python branches and host
  syncs inside a captured CUDA-graph round, torch cumsum in parity-critical
  modules, launch-cache key coverage, buffers rebound after a capture,
  assert-based validation, serve thread-safety, fault-point registration),
  with justification-comment suppressions and a ratchet baseline
  (``.lint-ratchet-torch.json``).

``python -m repro_torch.analysis`` exposes both as a CLI (``lint``,
``certify``, ``selftest``); ``sanitize.py`` wires the certifier into the
engines behind ``REPRO_SANITIZE=1`` / ``TSParams.sanitize``.
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
