"""What one run of a cell leaves for the metric readers and the judge.

A kind of traffic (``bench/kinds/<kind>.py``) fills a :class:`Record`: the
set-up time, the benchmark's spans around calls into the program, every unit
of work of the window (a training step, a request) with its host times, the
profiled stretch (``--trace 1``), the device, and the numbers compared for
``correct`` beside their limits.  The readers (``bench/metrics/<name>.py``)
take their metric from it.
"""
from __future__ import annotations

import dataclasses

from .arch import Arch
from .trace import Trace


@dataclasses.dataclass
class Unit:
    """One step or request of the window: when it was due and when its
    result reached the host (``time.perf_counter`` seconds), its tokens, and
    its shape (``batch`` rows of ``seq`` tokens)."""
    due: float
    done: float
    tokens: int
    batch: int
    seq: int
    ok: bool = True


@dataclasses.dataclass
class Record:
    name: str                  # the cell
    config: dict
    traffic: dict
    arch: Arch
    limits: dict
    setup_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    units: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0      # the window's start to its last unit's end
    profiled: int = 0          # the window's first units, profiled (--trace 1)
    steady_from: float = 0.0   # when the units after the profiled ones began
    trace: Trace | None = None
    device: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)   # name -> (value, limit)
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def steady(self) -> tuple[list, float]:
        """The units after the profiled ones, and their seconds (the whole
        window in a run that profiles nothing)."""
        rest = self.units[self.profiled:]
        return rest, (rest[-1].done - self.steady_from) if rest else 0.0

    @property
    def profiled_units(self) -> list:
        return self.units[:self.profiled]

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.units) and all(u.ok for u in self.units) and bool(self.checks) \
            and all(v <= lim for v, lim in self.checks.values())
