"""Sanitize mode: certify solutions at engine boundaries (DESIGN.md §12).

Enabled globally by ``REPRO_SANITIZE=1`` or per-run by
``TSParams.sanitize=True``.  Engines call :func:`maybe_sanitize` at
their commit points (tabu incumbent commits, ``SolveReport``
construction); when the mode
is off the call is a cheap no-op, when on a failing certificate raises
:class:`SanitizeError` carrying the full :class:`Certificate` so the
broken incumbent never propagates.

The hooks import this module lazily (function-local imports) so the
analysis package stays off the hot import path of ``repro_torch.core``.
"""
from __future__ import annotations

import os

from .certify import Certificate, certify_solution

__all__ = ["SanitizeError", "maybe_sanitize", "sanitize_enabled"]

_ENV = "REPRO_SANITIZE"
_OFF = ("", "0", "false", "no", "off")


class SanitizeError(RuntimeError):
    """A certified constraint violation at an engine boundary."""

    def __init__(self, message: str, certificate: Certificate):
        super().__init__(message)
        self.certificate = certificate


def sanitize_enabled(flag: "bool | None" = None) -> bool:
    """Resolve the effective mode: explicit flag wins, else the env var."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(_ENV, "").strip().lower() not in _OFF


def maybe_sanitize(
    inst,
    sol,
    *,
    where: str,
    flag: "bool | None" = None,
    reported_makespan: "float | None" = None,
    claimed_feasible: "bool | None" = None,
    enforce_capacity: bool = True,
) -> "Certificate | None":
    """Certify ``sol`` if sanitize mode is on; raise on a bad certificate.

    Returns the certificate when certification ran (so callers can record
    ``certified: true``), ``None`` when the mode is off.  ``where`` names
    the engine boundary in the raised error message.
    """
    if sol is None or not sanitize_enabled(flag):
        return None
    cert = certify_solution(
        inst,
        sol,
        reported_makespan=reported_makespan,
        claimed_feasible=claimed_feasible,
        enforce_capacity=enforce_capacity,
    )
    if not cert.ok:
        raise SanitizeError(f"certificate failed at {where}: {cert.summary()}", cert)
    return cert
