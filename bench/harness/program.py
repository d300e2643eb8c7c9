"""The program's own spans and counters (``repro_torch.tracing``), read after
a run.

The program records them only while a ``torch.profiler`` session records,
which a ``--trace 1`` run's profiled stretch is; the tracer keeps the last
session until the next one starts.  A reader takes them from here, and
finds nothing where the run profiled nothing, where the program has no
tracer, or where the tracer's units (steps or requests) are not the run's
profiled ones.
"""
from __future__ import annotations


def summary(rec, unit: str) -> dict | None:
    """``tracing.summary()`` of the run's profiled stretch, whose units are
    spans named ``unit``; None where there is none to read."""
    if rec.trace is None or not rec.profiled:
        return None
    try:
        from repro_torch import tracing
    except ImportError:               # a program without the tracer
        return None
    s = tracing.summary()
    return s if s["units"].get(unit) == rec.profiled else None


def device_ms_per_unit(rec, unit: str, spans: tuple) -> float | None:
    """The device milliseconds of the spans named ``spans``, forward and
    backward, per profiled unit."""
    s = summary(rec, unit)
    if s is None or not any(n in s["spans"] for n in spans):
        return None
    return sum(part["device_ms"] for n in spans for part in s["spans"].get(n, {}).values()) \
        / rec.profiled


def count_per_unit(rec, unit: str, name: str) -> float | None:
    """Counter ``name`` per profiled unit."""
    s = summary(rec, unit)
    if s is None or name not in s["counts"]:
        return None
    return s["counts"][name] / rec.profiled
