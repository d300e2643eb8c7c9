"""The readers of the program's own spans and counters (``bench/harness/
program.py`` and the metrics that use it), on records of smoke runs on the
CPU: 3 training steps and 3 requests under the CPU profiler, through the
benchmark's own doors into the program (``harness/port.py``)."""
from __future__ import annotations

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench.harness import port, spec
from bench.harness.arch import arch_of
from bench.harness.record import Record, Unit
from bench.harness.trace import Trace
from bench.kinds import prefill as prefill_kind
from bench.kinds import train as train_kind
from bench.tests import smoke
from repro_torch import tracing

torch.set_num_threads(1)
TRAIN = "granite-moe-1b-a400m.train.2x4096"
PREFILL = "qwen2.5-14b.prefill.longdoc"
SEED = 2 ** 31 + 91
TRAIN_METRICS = ("forward_ms_per_step.train", "backward_ms_per_step.train",
                 "optimizer_ms_per_step.train", "moe_ms_per_step.train",
                 "moe_useful_share.train")
PREFILL_METRICS = ("norm_rope_ms_per_request.prefill", "device_allocs_per_request.prefill")
UNITS = 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def _record(root, name) -> Record:
    cell = spec.cell(name, root)
    return Record(name=name, config=cell.config, traffic=cell.traffic,
                  arch=arch_of(cell.config), limits=cell.limits)


def _profiled(rec: Record, units: int) -> Record:
    rec.units = [Unit(0.0, 1.0, 1, 1, 1) for _ in range(units)]
    rec.profiled = units
    rec.trace = Trace(kernels=[], window_s=1.0, busy_s=0.0, gaps=[])
    return rec


def _train(root) -> Record:
    rec = _record(root, TRAIN)
    tr = port.build_trainer(rec.config, rec.traffic, rec.arch, SEED, "cpu", {})
    state = tr.state
    state, _ = tr.step_fn(state, train_kind.batch(rec, SEED, 1, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        for step in range(2, 2 + UNITS):
            state, _ = tr.step_fn(state, train_kind.batch(rec, SEED, step, "cpu"))
    return _profiled(rec, UNITS)


def _prefill(root) -> Record:
    rec = _record(root, PREFILL)
    cfg, model = port.build_server(rec.config, rec.arch, SEED, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for r in range(UNITS):
            port.first_tokens(cfg, model, prefill_kind.prompt(rec, SEED, r, 48, "cpu"), "cpu")
    return _profiled(rec, UNITS)


def _read(root, name, rec):
    return spec.metric_reader(name, root)(rec)


@pytest.mark.parametrize("name", TRAIN_METRICS)
def test_a_train_reader_reads_the_profiled_steps(root, name):
    rec = _train(root)
    value = _read(root, name, rec)
    assert value is not None and value > 0
    if name == "moe_useful_share.train":
        assert value == 100.0 * rec.arch.top_k / rec.arch.experts


def test_the_phases_hold_the_step(root):
    rec = _train(root)
    phases = sum(_read(root, f"{p}_ms_per_step.train", rec)
                 for p in ("forward", "backward", "optimizer"))
    step = tracing.summary()["spans"]["repro.train.step"]["forward"]["device_ms"] / UNITS
    assert 0.5 * step < phases <= step
    assert _read(root, "moe_ms_per_step.train", rec) < phases


def test_the_prefill_readers_read_the_profiled_requests(root):
    rec = _prefill(root)
    assert _read(root, "norm_rope_ms_per_request.prefill", rec) > 0
    # the CPU has no CUDA caching allocator: nothing is counted, nothing read
    assert _read(root, "device_allocs_per_request.prefill", rec) is None


@pytest.mark.parametrize("name", TRAIN_METRICS + PREFILL_METRICS)
def test_a_reader_finds_nothing_without_a_profile_or_with_other_units(root, name):
    kind = TRAIN if name.endswith(".train") else PREFILL
    rec = _train(root) if kind == TRAIN else _prefill(root)
    rec.trace, rec.profiled = None, 0
    assert _read(root, name, rec) is None
    rec = _profiled(_record(root, kind), UNITS + 1)        # a capture of another run
    assert _read(root, name, rec) is None
    rec = _profiled(rec, UNITS)
    assert _read(root, name, rec) is not None or name == "device_allocs_per_request.prefill"
    if kind == TRAIN:                                      # a later session of other units
        _prefill(root)
    else:
        _train(root)
    assert _read(root, name, rec) is None


def test_the_readers_find_nothing_in_a_program_without_the_tracer(root, monkeypatch):
    """The parent of this benchmark's program has no ``repro_torch.tracing``:
    the readers then leave their metrics out and do not raise."""
    import repro_torch

    rec = _train(root)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    for name in TRAIN_METRICS:
        assert _read(root, name, rec) is None
