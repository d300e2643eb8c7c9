"""Deterministic fault injection for the serving/search stack.

A :class:`FaultPlan` decides faults as a **pure function** of
``(plan.seed, helper, point, key)`` — no RNG state, no ordering
dependence — so a chaos run is exactly reproducible and a test can
predict, host-side via :func:`would_fire`, which sync boundary a crash
lands on before running anything.

Injection sites are *named points* registered below; an active plan
rejects a ``fire``/``corrupt``/``nan_value``/``skewed`` call whose point
is not registered here, so the set of places faults can enter the system
is closed and documented (DESIGN.md §13).  The points, their names and the
decision function are the reference package's, so a chaos seed fires at
the same point and key in both.

Gating follows the ``REPRO_SANITIZE`` pattern: with no active plan the
helpers return after one global load and ``None`` check — measured-zero
overhead on the serve fast path.  Activate programmatically
(:func:`activate` / :func:`plan_context`) or via the ``REPRO_FAULTS``
env var, e.g. ``REPRO_FAULTS="seed=7,rate=0.1,kinds=launch_error+clock_skew"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import zlib

import numpy as np

from .errors import DeviceLost, LaunchFailure

__all__ = [
    "FAULT_KINDS",
    "FaultPlan",
    "activate",
    "deactivate",
    "active",
    "plan_context",
    "plan_from_env",
    "register_point",
    "registered_points",
    "would_fire",
    "fire",
    "corrupt",
    "nan_value",
    "skewed",
]

#: every fault kind the harness can inject, and which helper delivers it
FAULT_KINDS = (
    "launch_error",       # fire(): LaunchFailure raised at the point
    "device_lost",        # fire(): DeviceLost raised at the point
    "compile_hang",       # fire(): stall plan.hang_seconds (watchdog bait)
    "corrupt_incumbent",  # corrupt(): flip an entry of an incumbent array
    "nan_duration",       # nan_value(): replace a float (makespan) with NaN
    "clock_skew",         # skewed(): shift a clock read by plan.skew_seconds
)

_FIRE_KINDS = ("launch_error", "device_lost", "compile_hang")

_POINTS: "set[str]" = set()


def register_point(name: str) -> str:
    """Declare a named injection site.  All sites are registered in this
    module — call sites elsewhere only reference."""
    _POINTS.add(name)
    return name


def registered_points() -> frozenset:
    return frozenset(_POINTS)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-keyed fault schedule.  ``rate`` is the per-decision fire
    probability (uniform over the hash space); ``kinds`` restricts which
    fault types may fire; ``points=None`` means every registered point."""

    seed: int = 0
    rate: float = 0.1
    kinds: tuple = FAULT_KINDS
    points: "tuple | None" = None
    hang_seconds: float = 0.05
    skew_seconds: float = 5.0


_UNSET = object()
_ACTIVE: "FaultPlan | None | object" = _UNSET

_OFF = ("", "0", "false", "no", "off")


def plan_from_env() -> "FaultPlan | None":
    """Parse ``REPRO_FAULTS`` (``key=value`` pairs joined by ``,``; kinds
    and points are ``+``-joined).  Off-values per the sanitize gate."""
    raw = os.environ.get("REPRO_FAULTS", "").strip()
    if raw.lower() in _OFF:
        return None
    if raw.lower() in ("1", "true", "yes", "on"):
        return FaultPlan()
    kw: dict = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        if k == "seed":
            kw["seed"] = int(v)
        elif k == "rate":
            kw["rate"] = float(v)
        elif k in ("hang_seconds", "skew_seconds"):
            kw[k] = float(v)
        elif k == "kinds":
            kw["kinds"] = tuple(v.split("+"))
        elif k == "points":
            kw["points"] = tuple(v.split("+"))
        else:
            raise ValueError(f"REPRO_FAULTS: unknown key {k!r}")
    return FaultPlan(**kw)


def active() -> "FaultPlan | None":
    """The effective plan: an explicit :func:`activate`, else the env."""
    global _ACTIVE
    if _ACTIVE is _UNSET:
        _ACTIVE = plan_from_env()
    return _ACTIVE  # type: ignore[return-value]


def activate(plan: "FaultPlan | None") -> None:
    global _ACTIVE
    _ACTIVE = plan


def deactivate() -> None:
    activate(None)


@contextlib.contextmanager
def plan_context(plan: "FaultPlan | None"):
    """Scope a plan to a with-block (restores the previous gate state)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


# --------------------------------------------------------------------------- #
# the decision function — pure in (plan, helper, point, key)                   #
# --------------------------------------------------------------------------- #
def _decide(plan: FaultPlan, helper: str, point: str,
            key: int, applicable: tuple) -> "str | None":
    if plan.points is not None and point not in plan.points:
        return None
    kinds = [k for k in plan.kinds if k in applicable]
    if not kinds:
        return None
    h = zlib.crc32(f"{plan.seed}|{helper}|{point}|{int(key)}".encode())
    if (h % 1_000_000) >= int(plan.rate * 1_000_000):
        return None
    return kinds[(h // 1_000_000) % len(kinds)]


def would_fire(plan: FaultPlan, helper: str, point: str,
               key: int = 0) -> "str | None":
    """Host-side replay of the decision: the fault kind that WOULD fire at
    ``(helper, point, key)`` under ``plan``, or None.  Lets a test or the
    chaos bench locate, e.g., the exact sync index a crash lands on."""
    applicable = {"fire": _FIRE_KINDS, "corrupt": ("corrupt_incumbent",),
                  "nan_value": ("nan_duration",),
                  "skewed": ("clock_skew",)}[helper]
    return _decide(plan, helper, point, key, applicable)


def _check_point(point: str) -> None:
    if point not in _POINTS:
        raise ValueError(f"unregistered injection point {point!r} "
                         f"(registered: {sorted(_POINTS)})")


# --------------------------------------------------------------------------- #
# call-site helpers (fast no-op path when no plan is active)                   #
# --------------------------------------------------------------------------- #
def fire(point: str, key: int = 0, *, rid: "int | None" = None) -> None:
    """Maybe raise (launch_error/device_lost) or stall (compile_hang)."""
    plan = _ACTIVE
    if plan is _UNSET:
        plan = active()
    if plan is None:
        return
    _check_point(point)
    kind = _decide(plan, "fire", point, key, _FIRE_KINDS)
    if kind is None:
        return
    if kind == "compile_hang":
        time.sleep(plan.hang_seconds)
        return
    cls = LaunchFailure if kind == "launch_error" else DeviceLost
    raise cls(f"injected {kind} at {point} (key {key})",
              rid=rid, injected=True)


def corrupt(point: str, arr, key: int = 0):
    """Maybe return a corrupted copy of ``arr`` (one entry flipped — a NaN
    for float arrays, a negated+shifted value for integer arrays).  The
    input is never mutated; the no-fault path returns it unchanged."""
    plan = _ACTIVE
    if plan is _UNSET:
        plan = active()
    if plan is None:
        return arr
    _check_point(point)
    if _decide(plan, "corrupt", point, key, ("corrupt_incumbent",)) is None:
        return arr
    out = np.array(arr, copy=True)
    if out.size == 0:
        return out
    flat = out.reshape(-1)
    idx = zlib.crc32(f"{plan.seed}|idx|{point}|{int(key)}".encode()) % flat.size
    if np.issubdtype(out.dtype, np.floating):
        flat[idx] = np.nan
    else:
        flat[idx] = -flat[idx] - 1
    return out


def nan_value(point: str, value: float, key: int = 0) -> float:
    """Maybe replace a float (a reported duration/makespan) with NaN."""
    plan = _ACTIVE
    if plan is _UNSET:
        plan = active()
    if plan is None:
        return value
    _check_point(point)
    if _decide(plan, "nan_value", point, key, ("nan_duration",)) is None:
        return value
    return float("nan")


def skewed(point: str, now: float, key: int = 0) -> float:
    """Maybe shift a clock reading forward by ``plan.skew_seconds``."""
    plan = _ACTIVE
    if plan is _UNSET:
        plan = active()
    if plan is None:
        return now
    _check_point(point)
    if _decide(plan, "skewed", point, key, ("clock_skew",)) is None:
        return now
    return now + plan.skew_seconds


# --------------------------------------------------------------------------- #
# the registry: every injection site in the tree, by name                      #
# --------------------------------------------------------------------------- #
register_point("engine.warmup.compile")      # fire: hang during warm compile
register_point("engine.execute.launch")      # fire: launch raises / hangs
register_point("engine.result.incumbent")    # corrupt: served assign array
register_point("engine.result.makespan")     # nan_value: reported makespan
register_point("service.clock")              # skewed: dispatch clock reads
register_point("device_search.sync")         # fire: device lost at a sync
