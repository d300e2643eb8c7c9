"""The port's tracer: named spans at the program's layer boundaries and host
counters, recorded only while a ``torch.profiler`` session records.

    with tracing.unit("train.step", device):      # a unit: a step, a request
        with tracing.span("train.forward"):       # the span repro.train.forward
            ...
    tracing.count("moe.pairs_routed", n)
    tracing.summary()     # per-name totals of what the session recorded

Off (no profiler recording) :func:`span` returns one shared null span after a
single read of the profiler's own flag: no CUDA event, no profiler range, no
autograd node, no allocation.  On, a span records its name
(prefixed ``repro.``), its parent (the innermost span open on its thread; on
a thread with none open, such as autograd's device thread, the innermost one
open on the thread that opened the unit), the unit it belongs to, its host
start and end (``time.perf_counter_ns``), its device time (a pair of CUDA
events on the current stream where the unit runs on a CUDA device, else the
host time) and whether autograd was running a backward when it opened (a
recompute is backward work, not forward).  It also opens a profiler range
of its name (``_RecordFunctionFast``, an op-scope range), so the span lies
in the profiler's trace, on its clock, above the ops and kernels it
launched.  Not a ``record_function`` range: the profiler mirrors those onto
the device's timeline as device events (``gpu_user_annotation``), which a
reader of the trace's device operations would count as the device's work.

A block's backward is a span too: ``sp.grad_input(x)`` on the block's input
and ``sp.grad_output(y, witness)`` on its output put identity autograd
functions there (only while on) whose backwards open and close a span of the
block's name.  ``witness``, a tensor the block computed, is read back first:
where the block runs in a recompute region, the region's replay then runs
before the span opens, not inside it.

A session is what was recorded since tracing last came on: a unit run with
nothing recording, or :func:`summary` read with nothing recording, ends it,
and the next span recorded drops its spans and counters.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "Span", "span", "unit", "count", "summary", "records"]

PREFIX = "repro."


class Span(NamedTuple):
    """A closed span, its device time resolved."""
    name: str
    parent: str | None
    unit: int | None       # the unit's index in the session
    backward: bool         # opened while autograd ran a backward
    host_ms: float
    device_ms: float


class _Off:
    """The shared null span of tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def grad_input(self, x):
        return x

    def grad_output(self, y, witness=None):
        return y


OFF = _Off()


class _Session:
    def __init__(self):
        self.spans: list = []                       # _Span, in the order they opened
        self.counts = collections.Counter()
        self.units = collections.Counter()          # unit name -> units recorded
        self.n_units = 0
        self.unit: int | None = None                # the open unit's index
        self.unit_stack: list | None = None         # the stack of its thread
        self.cuda = False                           # the open unit runs on a CUDA device
        self.ended = True


_session = _Session()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _begin() -> _Session:
    """The current session; a new one where the last has ended."""
    global _session
    if _session.ended:
        _session = _Session()
        _session.ended = False
    return _session


class _Span:
    __slots__ = ("name", "parent", "unit", "backward", "t0", "t1", "events", "rf", "stack",
                 "grad", "ms")

    def __init__(self, name: str):
        self.name = PREFIX + name
        self.t1 = self.grad = self.ms = None

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def open(self) -> None:
        s = _begin()
        stack = _stack()
        top = stack[-1] if stack else (s.unit_stack[-1] if s.unit_stack else None)
        self.parent = None if top is None else top.name
        self.unit = s.unit
        self.backward = torch._C._current_graph_task_id() != -1
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.events = None
        if s.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.stack = stack
        stack.append(self)
        s.spans.append(self)
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(None, None, None)
        if self.stack and self.stack[-1] is self:
            self.stack.pop()
        elif self in self.stack:
            self.stack.remove(self)

    def grad_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` through the node that closes this block's backward span."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        self.grad = [self.name[len(PREFIX):], None]      # name, the open backward span
        return _GradEnd.apply(x, self.grad)

    def grad_output(self, y: torch.Tensor, witness: torch.Tensor | None = None):
        """``y`` through the node that opens this block's backward span."""
        if self.grad is None or not y.requires_grad:
            return y
        return _GradBegin.apply(y, self.grad, witness)

    def device_ms(self) -> float:
        if self.ms is None:
            if self.events is None:
                self.ms = (self.t1 - self.t0) / 1e6
            else:
                self.events[1].synchronize()
                self.ms = self.events[0].elapsed_time(self.events[1])
                self.events = None
        return self.ms


class _Unit(_Span):
    __slots__ = ("device", "allocs")

    def __init__(self, name: str, device):
        super().__init__(name)
        self.device, self.allocs = device, None

    def open(self) -> None:
        s = _begin()
        s.units[self.name] += 1
        s.unit, s.n_units = s.n_units, s.n_units + 1
        s.cuda = self.device.type == "cuda"
        s.unit_stack = _stack()
        if s.cuda:
            self.allocs = torch.cuda.memory_stats(self.device).get("num_device_alloc")
        super().open()

    def close(self) -> None:
        super().close()
        s = _session
        if self.allocs is not None:
            s.counts["alloc.device_allocs"] += \
                torch.cuda.memory_stats(self.device)["num_device_alloc"] - self.allocs
        s.unit = s.unit_stack = None


class _GradBegin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, grad, witness):
        ctx.grad = grad
        if witness is not None:
            ctx.save_for_backward(witness)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors                  # a recompute region replays here, before the span
        sp = _Span(ctx.grad[0])
        sp.open()
        ctx.grad[1] = sp
        return g, None, None


class _GradEnd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad):
        ctx.grad = grad
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        sp, ctx.grad[1] = ctx.grad[1], None
        if sp is not None:
            sp.close()
        return g, None


def span(name: str):
    """A span ``repro.<name>`` while a profiler records; else the null span."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


def unit(name: str, device):
    """A span ``repro.<name>`` that is a unit of work (a training step, a
    request) on ``device``: the spans it holds carry its index and time the
    device with CUDA events where it is a CUDA device; on such a device it
    also counts the allocator's ``cudaMalloc`` calls (``alloc.device_allocs``).
    With nothing recording it ends the session."""
    if not _profiler._is_profiler_enabled:
        _session.ended = True
        return OFF
    return _Unit(name, torch.device(device))


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _begin().counts[name] += int(n)


def records() -> list:
    """Every span the session closed, in the order they opened."""
    return [Span(s.name, s.parent, s.unit, s.backward, (s.t1 - s.t0) / 1e6, s.device_ms())
            for s in _session.spans if s.t1 is not None]


def summary() -> dict:
    """What the session recorded: ``units`` (unit name -> units), ``spans``
    (name -> ``forward`` / ``backward`` -> calls, host ms, device ms) and
    ``counts`` (counter -> total)."""
    if not _profiler._is_profiler_enabled:
        _session.ended = True
    spans: dict = {}
    for s in records():
        part = spans.setdefault(s.name, {k: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
                                         for k in ("forward", "backward")})
        part = part["backward" if s.backward else "forward"]
        part["calls"] += 1
        part["host_ms"] += s.host_ms
        part["device_ms"] += s.device_ms
    return {"units": dict(_session.units), "spans": spans, "counts": dict(_session.counts)}
