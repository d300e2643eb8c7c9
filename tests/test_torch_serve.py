"""The port's solve service (``repro_torch.serve``) against the reference's
(``repro.serve``): launch signatures with the same shape facts, the same
fake-clock batch cuts (reasons and request ids) on the same request stream,
engine batch assembly, and end-to-end service behaviour.  Served results
equal solo ``solve()`` results on both backends: the numpy backend (also
equal to the reference's served results) and the device backend, whose
round runs eagerly on the CPU here."""
import asyncio
import warnings

import numpy as np
import pytest
from torch_port_helpers import port_instance

from repro.core import Budget as RefBudget
from repro.core import TSParams as RefTSParams
from repro.core import random_instance as ref_random_instance
from repro.instances import generate as ref_generate
from repro.serve import Batcher as RefBatcher
from repro.serve import BatchPolicy as RefBatchPolicy
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import RequestQueue as RefRequestQueue
from repro.serve import SolveService as RefSolveService
from repro.serve import launch_signature as ref_launch_signature

import repro_torch.serve as serve
from repro_torch.core import Budget, TSParams, solve
from repro_torch.core.device_search import MEM_UPDATE_DISABLED
from repro_torch.serve import (
    Batcher,
    BatchPolicy,
    Engine,
    EngineConfig,
    RequestQueue,
    ServiceClosed,
    SolveService,
    WarmSpec,
    launch_signature,
)


class FakeClock:
    """Deterministic queue clock: time moves only via ``advance``."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def ref_small(seed=0, **kw):
    kw.setdefault("n_tasks", 24)
    kw.setdefault("n_data", 60)
    return ref_random_instance(seed, **kw)


def small_instance(seed=0, **kw):
    return port_instance(ref_small(seed, **kw))


INST = small_instance()
BUDGET = Budget(max_iters=4)


def test_exports_equal_the_reference():
    import repro.serve

    assert set(serve.__all__) == set(repro.serve.__all__)


# --------------------------------------------------------------------------- #
# launch signatures                                                           #
# --------------------------------------------------------------------------- #
SIG_CASES = [("random_layered", s, dict(n_tasks=70, n_data=160)) for s in range(4)] + [
    ("out_tree", 1, dict(n_tasks=70)), ("fft", 2, dict(width=16, stages=4)),
    ("in_tree", 3, dict(n_tasks=33)), ("stencil", 0, dict(width=8, steps=4)),
    ("random_layered", 9, dict(n_tasks=24, n_data=60))]


@pytest.mark.parametrize("case", SIG_CASES, ids=[f"{c[0]}-{c[1]}" for c in SIG_CASES])
def test_signature_shape_facts_equal_the_reference(case):
    family, seed, kw = case
    ref = ref_generate(family, seed, **kw)
    for walks, iters in ((2, 4), (4, 20)):
        got = launch_signature(port_instance(ref), walks, Budget(max_iters=iters))
        want = ref_launch_signature(ref, walks, RefBudget(max_iters=iters))
        assert got[:-1] == want[:-1]
        assert (got[-1].time_limit, got[-1].max_iters, got[-1].max_evals) == \
            (want[-1].time_limit, want[-1].max_iters, want[-1].max_evals)


def test_signature_equal_for_identical_request_shape():
    assert launch_signature(INST, 2, BUDGET) == launch_signature(INST, 2, BUDGET)


def test_signature_splits_on_walks_and_budget():
    base = launch_signature(INST, 2, BUDGET)
    assert launch_signature(INST, 4, BUDGET) != base
    assert launch_signature(INST, 2, Budget(max_iters=99)) != base


def test_signature_splits_on_instance_shape_class():
    big = small_instance(1, n_tasks=80, n_data=200)
    assert launch_signature(big, 2, BUDGET) != launch_signature(INST, 2, BUDGET)


# --------------------------------------------------------------------------- #
# queue                                                                       #
# --------------------------------------------------------------------------- #
def test_queue_fifo_take_and_absolute_deadline():
    clk = FakeClock(10.0)
    q = RequestQueue(clock=clk)
    r0 = q.submit(INST, BUDGET, seed=0, deadline=3.0)
    clk.advance(1.0)
    r1 = q.submit(INST, BUDGET, seed=1)
    assert r0.deadline == pytest.approx(13.0) and r1.deadline is None
    assert r0.submitted == 10.0 and r1.submitted == 11.0
    sig = r0.signature
    assert r1.signature == sig and len(q) == 2
    assert [r.rid for r in q.take(sig, 1)] == [r0.rid]
    assert [r.rid for r in q.take(sig, 5)] == [r1.rid]
    assert len(q) == 0 and q.take(sig, 1) == []


def test_queue_submit_after_close_raises():
    q = RequestQueue(clock=FakeClock())
    q.submit(INST, BUDGET)
    q.close()
    assert q.closed
    with pytest.raises(ServiceClosed):
        q.submit(INST, BUDGET)
    assert len(q) == 1


def test_take_ready_skips_backoff_and_cuts_an_isolated_request_alone():
    clk = FakeClock()
    q = RequestQueue(clock=clk)
    reqs = [q.submit(INST, BUDGET, seed=s) for s in range(4)]
    reqs[0].not_before = 5.0
    reqs[2].isolated = True
    sig = reqs[0].signature
    assert [r.rid for r in q.take_ready(sig, 8, now=0.0)] == [reqs[1].rid, reqs[3].rid]
    assert [r.rid for r in q.take_ready(sig, 8, now=0.0)] == [reqs[2].rid]
    assert q.take_ready(sig, 8, now=0.0) == []
    assert [r.rid for r in q.take_ready(sig, 8, now=6.0)] == [reqs[0].rid]


# --------------------------------------------------------------------------- #
# batcher: fake-clock cut conditions, and the reference's cut sequence         #
# --------------------------------------------------------------------------- #
def make_batcher(clk, **policy_kw):
    q = RequestQueue(clock=clk)
    policy_kw.setdefault("max_batch", 4)
    policy_kw.setdefault("max_wait", 0.5)
    policy_kw.setdefault("deadline_slack", 0.25)
    return q, Batcher(q, BatchPolicy(**policy_kw))


def test_cut_on_full():
    clk = FakeClock()
    q, b = make_batcher(clk, max_batch=3)
    for s in range(3):
        q.submit(INST, BUDGET, seed=s)
    cut = b.cut()
    assert cut is not None and cut.reason == "full" and len(cut) == 3
    assert b.cut() is None and b.cuts_by_reason == {"full": 1}


def test_cut_on_age_after_max_wait():
    clk = FakeClock()
    q, b = make_batcher(clk, max_wait=0.5)
    q.submit(INST, BUDGET, seed=0)
    assert b.cut() is None
    clk.advance(0.49)
    assert b.cut() is None
    clk.advance(0.02)
    cut = b.cut()
    assert cut is not None and cut.reason == "age" and len(cut) == 1


def test_cut_on_deadline_within_slack():
    clk = FakeClock()
    q, b = make_batcher(clk, max_wait=1e9, deadline_slack=0.25)
    q.submit(INST, BUDGET, seed=0, deadline=2.0)
    assert b.cut() is None
    clk.advance(1.74)
    assert b.cut() is None
    clk.advance(0.02)
    cut = b.cut()
    assert cut is not None and cut.reason == "deadline"


def test_cut_when_device_idle_respects_eagerness():
    clk = FakeClock()
    q, b = make_batcher(clk, max_wait=1e9)
    q.submit(INST, BUDGET, seed=0)
    assert b.cut(device_idle=False) is None
    cut = b.cut(device_idle=True)
    assert cut is not None and cut.reason == "idle"
    q2, b2 = make_batcher(clk, max_wait=1e9, eager_when_idle=False)
    q2.submit(INST, BUDGET, seed=0)
    assert b2.cut(device_idle=True) is None


def test_cut_drains_after_close():
    clk = FakeClock()
    q, b = make_batcher(clk, max_wait=1e9)
    q.submit(INST, BUDGET, seed=0)
    q.close()
    cut = b.cut()
    assert cut is not None and cut.reason == "drain"
    assert b.cut() is None and len(q) == 0


def test_cut_never_mixes_signatures_and_serves_oldest_head_first():
    clk = FakeClock()
    q, b = make_batcher(clk, max_batch=8, max_wait=0.1)
    a0 = q.submit(INST, BUDGET, seed=0, walks=2)
    clk.advance(0.01)
    b0 = q.submit(INST, BUDGET, seed=1, walks=4)
    clk.advance(0.01)
    a1 = q.submit(INST, BUDGET, seed=2, walks=2)
    clk.advance(0.2)
    first = b.cut()
    assert first.reason == "age"
    assert [r.rid for r in first.requests] == [a0.rid, a1.rid]
    second = b.cut()
    assert [r.rid for r in second.requests] == [b0.rid]
    assert second.signature != first.signature


def test_next_cut_time_is_min_of_age_and_deadline_horizons():
    clk = FakeClock()
    q, b = make_batcher(clk, max_wait=0.5, deadline_slack=0.25)
    assert b.next_cut_time() is None
    q.submit(INST, BUDGET, seed=0)
    assert b.next_cut_time() == pytest.approx(0.5)
    q.submit(INST, BUDGET, seed=1, deadline=0.6)
    assert b.next_cut_time() == pytest.approx(0.35)


def cut_sequence(pkg: str, stream_seed: int) -> list:
    """A seeded stream of arrivals (three shape classes, walks, budgets,
    deadlines, clock steps, idle flags) through one package's queue and
    batcher: the cuts as (reason, rids, size), then the drain."""
    rng = np.random.default_rng(stream_seed)
    refs = [ref_small(s, n_tasks=n, n_data=2 * n) for s, n in ((0, 16), (1, 16), (2, 48))]
    if pkg == "ref":
        insts, budgets = refs, [RefBudget(max_iters=2), RefBudget(max_iters=5)]
        Queue, Cutter, Policy = RefRequestQueue, RefBatcher, RefBatchPolicy
    else:
        insts, budgets = [port_instance(r) for r in refs], [Budget(max_iters=2),
                                                            Budget(max_iters=5)]
        Queue, Cutter, Policy = RequestQueue, Batcher, BatchPolicy
    clk = FakeClock()
    q = Queue(clock=clk)
    b = Cutter(q, Policy(max_batch=int(rng.integers(1, 6)), max_wait=float(rng.uniform(0, 0.4)),
                         deadline_slack=0.25))
    cuts = []
    for _ in range(30):
        clk.advance(float(rng.uniform(0, 0.2)))
        dl = float(rng.uniform(0.1, 1.0)) if rng.random() < 0.3 else None
        q.submit(insts[int(rng.integers(3))], budgets[int(rng.integers(2))],
                 walks=int(rng.choice([1, 2, 4])), seed=0, deadline=dl)
        cut = b.cut(device_idle=bool(rng.random() < 0.3))
        if cut is not None:
            cuts.append((cut.reason, [r.rid for r in cut.requests], cut.cut_at))
        cuts.append(("next", b.next_cut_time()))
    q.close()
    while (cut := b.cut()) is not None:
        cuts.append((cut.reason, [r.rid for r in cut.requests], cut.cut_at))
    return cuts


@pytest.mark.parametrize("stream_seed", range(6))
def test_cut_sequence_equals_the_reference(stream_seed):
    got, want = cut_sequence("port", stream_seed), cut_sequence("ref", stream_seed)
    assert got == want
    assert any(c[0] not in ("next", "drain") for c in got)


# --------------------------------------------------------------------------- #
# engine: batch assembly (host-side) and the backends                         #
# --------------------------------------------------------------------------- #
def test_assemble_pads_to_quantized_size_and_pins_bucket_key():
    clk = FakeClock()
    q = RequestQueue(clock=clk)
    b = Batcher(q, BatchPolicy(max_batch=3, max_wait=0.0))
    eng = Engine(EngineConfig(backend="device", batch_sizes=(4,)), params=TSParams())
    for s in range(3):
        q.submit(INST, BUDGET, seed=s)
    asm3 = eng.assemble(b.cut())
    assert asm3.padded_to == 4 and len(asm3.instances) == 4
    assert asm3.instances[3] is asm3.instances[2]
    assert asm3.seeds[3] == asm3.seeds[2]
    np.testing.assert_array_equal(asm3.inits[3][0].assign, asm3.inits[2][0].assign)
    q.submit(INST, BUDGET, seed=9)
    asm1 = eng.assemble(b.cut(device_idle=True))
    assert asm1.padded_to == 4
    assert asm1.batch.bucket_key == asm3.batch.bucket_key
    # host work only: no tensor anywhere in the assembled batch
    assert asm1.params.backend == "device" and asm1.params.torch_device == "cuda"


def test_assemble_budget_seeds_match_solo_inits():
    from repro_torch.core.api import multiwalk_inits

    q = RequestQueue(clock=FakeClock())
    b = Batcher(q, BatchPolicy(max_batch=2, max_wait=0.0))
    eng = Engine(EngineConfig(backend="numpy"), params=TSParams())
    q.submit(INST, BUDGET, seed=7, walks=3)
    asm = eng.assemble(b.cut(device_idle=True))
    assert asm.seeds == [7] and asm.padded_to == 1 and asm.batch is None
    sols, _ = multiwalk_inits(INST, 3, 7)
    for got, want in zip(asm.inits[0], sols):
        np.testing.assert_array_equal(got.assign, want.assign)


def test_numpy_backend_runs_the_numpy_engine_with_the_ports_default_params():
    """The port's ``TSParams()`` default to the torch engine on the card;
    the numpy backend (and the fallback of a poisoned signature) must not
    reach it: on a machine without a GPU that would raise."""
    import torch

    q = RequestQueue(clock=FakeClock())
    b = Batcher(q, BatchPolicy(max_batch=2, max_wait=0.0))
    eng = Engine(EngineConfig(backend="device", torch_device="cuda"), params=TSParams())
    q.submit(INST, BUDGET, seed=1, walks=2)
    cut = b.cut(device_idle=True)
    (rr,) = eng.execute(eng.assemble(cut, backend="numpy"))
    assert rr.metrics["backend"] == "numpy" and rr.report.extras["backend"] == "numpy"
    solo = solve(INST, "tabu_multiwalk", walks=2, budget=BUDGET, seed=1, backend="numpy")
    assert (rr.report.makespan, rr.report.history) == (solo.makespan, solo.history)
    if not torch.cuda.is_available():         # the device backend itself goes to the card
        q.submit(INST, BUDGET, seed=1, walks=2)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            eng.execute(eng.assemble(b.cut(device_idle=True)))


def test_compile_cache_points_the_kernel_builds_at_the_directory(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    target = tmp_path / "builds"
    assert serve.enable_compilation_cache(target) is True
    assert target.is_dir() and _build.build_dir() == target
    eng = Engine(EngineConfig(backend="numpy", compilation_cache_dir=str(tmp_path / "b2")))
    assert eng.persistent_cache and _build.build_dir() == tmp_path / "b2"


def test_the_deprecated_launch_serve_alias_warns_and_points_at_model_serve():
    import importlib
    import sys

    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module("repro_torch.launch.serve")
    from repro_torch.launch.model_serve import serve_main

    assert mod.serve_main is serve_main
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)


# --------------------------------------------------------------------------- #
# the service end to end                                                      #
# --------------------------------------------------------------------------- #
NUMPY_CFG = EngineConfig(backend="numpy")
PARAMS = TSParams(top_k=4)


def run(coro):
    return asyncio.run(coro)


async def serve_all(svc, insts, budget, seeds, walks=2):
    await svc.start()
    rids = [await svc.submit(inst, budget, seed=s, walks=walks) for inst, s in zip(insts, seeds)]
    events = {rid: [ev async for ev in svc.stream_incumbents(rid)] for rid in rids}
    results = [await svc.result(rid) for rid in rids]
    metrics = svc.metrics()
    await svc.shutdown()
    return rids, events, results, metrics


def test_service_numpy_parity_with_solo_and_with_the_reference():
    refs = [ref_small(s) for s in range(3)]
    insts = [port_instance(r) for r in refs]
    rids, events, results, metrics = run(serve_all(
        SolveService(config=NUMPY_CFG, policy=BatchPolicy(max_batch=3, max_wait=0.01),
                     params=PARAMS), insts, BUDGET, [10 + k for k in range(3)]))
    _, _, ref_results, _ = run(serve_all(
        RefSolveService(config=RefEngineConfig(backend="numpy"),
                        policy=RefBatchPolicy(max_batch=3, max_wait=0.01),
                        params=RefTSParams(top_k=4)), refs, RefBudget(max_iters=4),
        [10 + k for k in range(3)]))
    total = 0
    for k, (rid, rr, ref_rr) in enumerate(zip(rids, results, ref_results)):
        solo = solve(insts[k], "tabu_multiwalk", walks=2, budget=BUDGET, seed=10 + k,
                     params=PARAMS, backend="numpy")
        for want in (solo, ref_rr.report):
            assert rr.report.makespan == want.makespan
            assert rr.report.history == want.history
            assert rr.report.n_exact_evals == want.n_exact_evals
            np.testing.assert_array_equal(rr.report.solution.assign, want.solution.assign)
        assert rr.metrics["rid"] == rid and rr.metrics["latency"] >= 0.0
        for ev in events[rid]:
            assert ev.best_makespan >= rr.report.makespan
        total += len(events[rid])
    assert total >= 1
    assert metrics["completed"] == 3 and metrics["pending"] == 0
    for key in ("submitted", "batches", "mean_batch_size", "cuts_by_reason", "latency_p50",
                "latency_p99"):
        assert key in metrics
    assert not metrics["errors"]


DEVICE_PARAMS = TSParams(max_unimproved=10**9, time_limit=1e9, top_k=5,
                         mem_update_period=MEM_UPDATE_DISABLED)


def test_service_device_backend_on_the_cpu_equals_solo_tabu_device():
    insts = [small_instance(s, n_tasks=30, n_data=70) for s in range(3)]
    budget = Budget(max_iters=6)
    cfg = EngineConfig(backend="device", sync_every=4, crit_cap=32, batch_sizes=(2, 4),
                       torch_device="cpu")
    warm = [WarmSpec(i, 2, budget) for i in insts]
    rids, events, results, metrics = run(serve_all(
        SolveService(config=cfg, policy=BatchPolicy(max_batch=4, max_wait=0.01),
                     params=DEVICE_PARAMS, warm=warm), insts, budget, (3, 9, 4)))
    assert metrics["warmup"]["signatures"] >= 1 and not metrics["errors"]
    assert metrics["launch_cache"]["currsize"] >= 1
    for seed, inst, rr in zip((3, 9, 4), insts, results):
        solo = solve(inst, "tabu_device", walks=2, budget=budget, seed=seed,
                     params=DEVICE_PARAMS, torch_device="cpu",
                     device={"sync_every": 4, "crit_cap": 32})
        assert rr.metrics["backend"] == "device"
        assert rr.report.makespan == solo.makespan
        assert rr.report.history == solo.history
        assert rr.report.iterations == solo.iterations
        assert rr.report.n_exact_evals == solo.n_exact_evals
        np.testing.assert_array_equal(rr.report.solution.assign, solo.solution.assign)
        np.testing.assert_array_equal(rr.report.solution.mem, solo.solution.mem)
        assert rr.report.solution.proc_seq == solo.solution.proc_seq
        lc = rr.metrics["launch_cache"]
        assert lc["misses"] == lc["uncached"] == lc["overflow_relaunches"] == 0


def test_poisoned_signature_falls_back_to_the_numpy_engine():
    """Two launch failures poison a signature; its requests then run the
    NumPy engine, equal to solo NumPy solves."""
    from repro_torch.faults import inject as finj
    from repro_torch.serve import ResiliencePolicy, RetryPolicy

    insts = [small_instance(s) for s in range(2)]
    plan = finj.FaultPlan(seed=0, rate=1.0, kinds=("device_lost",),
                          points=("device_search.sync",))
    cfg = EngineConfig(backend="device", sync_every=2, crit_cap=32, batch_sizes=(1, 2),
                       torch_device="cpu")

    async def go():
        svc = SolveService(config=cfg, policy=BatchPolicy(max_batch=2, max_wait=0.01),
                           params=DEVICE_PARAMS,
                           resilience=ResiliencePolicy(retry=RetryPolicy(
                               max_attempts=4, backoff_base=0.0, poison_after=2)))
        with finj.plan_context(plan):
            out = await serve_all(svc, insts, BUDGET, (1, 2))
        return out, svc

    (rids, _, results, metrics), svc = run(go())
    assert metrics["resilience"]["poisoned_signatures"] >= 1
    for inst, seed, rr in zip(insts, (1, 2), results):
        assert rr.metrics["backend"] == "numpy" and rr.metrics["attempts"] >= 2
        solo = solve(inst, "tabu_multiwalk", walks=2, budget=BUDGET, seed=seed,
                     params=DEVICE_PARAMS, backend="numpy")
        assert (rr.report.makespan, rr.report.history) == (solo.makespan, solo.history)


def test_service_shutdown_drains_queue():
    never = BatchPolicy(max_batch=10**6, max_wait=1e9, eager_when_idle=False)

    async def main():
        svc = SolveService(config=NUMPY_CFG, policy=never, params=PARAMS)
        await svc.start()
        rids = [await svc.submit(INST, BUDGET, seed=s) for s in range(3)]
        await asyncio.sleep(0.05)
        assert svc.metrics()["completed"] == 0
        await svc.shutdown(drain=True)
        results = [await svc.result(rid) for rid in rids]
        return results, svc.batcher.cuts_by_reason

    results, reasons = run(main())
    assert len(results) == 3 and all(rr.report.makespan > 0 for rr in results)
    assert set(reasons) == {"drain"}


def test_service_shutdown_without_drain_fails_pending():
    never = BatchPolicy(max_batch=10**6, max_wait=1e9, eager_when_idle=False)

    async def main():
        svc = SolveService(config=NUMPY_CFG, policy=never, params=PARAMS)
        await svc.start()
        rid = await svc.submit(INST, BUDGET, seed=0)
        await svc.shutdown(drain=False)
        with pytest.raises(ServiceClosed):
            await svc.result(rid)
        with pytest.raises(ServiceClosed):
            await svc.submit(INST, BUDGET, seed=1)
        return [ev async for ev in svc.stream_incumbents(rid)]

    assert run(main()) == []


def test_service_unknown_rid_raises_keyerror():
    async def main():
        svc = SolveService(config=NUMPY_CFG, params=PARAMS)
        await svc.start()
        with pytest.raises(KeyError):
            await svc.result(999)
        await svc.shutdown()

    run(main())


def test_admission_sheds_at_depth_with_retry_after():
    from repro_torch.faults.errors import QueueOverload
    from repro_torch.serve import AdmissionPolicy, ResiliencePolicy

    never = BatchPolicy(max_batch=10**6, max_wait=1e9, eager_when_idle=False)

    async def main():
        svc = SolveService(config=NUMPY_CFG, policy=never, params=PARAMS,
                           resilience=ResiliencePolicy(admission=AdmissionPolicy(
                               max_queue_depth=2, retry_after=0.75)))
        await svc.start()
        for s in range(2):
            await svc.submit(INST, BUDGET, seed=s)
        with pytest.raises(QueueOverload) as ei:
            await svc.submit(INST, BUDGET, seed=2)
        await svc.shutdown(drain=True)
        return ei.value, svc.metrics()

    err, metrics = run(main())
    assert err.retry_after == 0.75 and err.rid is not None
    assert metrics["resilience"]["shed"] == 1 and metrics["completed"] == 2
