"""The port's fault layer (``repro_torch.faults``: the failure taxonomy and
deterministic injection) against the reference's (``repro.faults``): the
same classes with the same retryability, the same error mapping, and the
same decision at every registered point and key, so a chaos seed fires at
the same place in both; then the numpy-backend service under a plan,
every request ending in exactly one terminal state.  Checkpointing is not
ported yet (ROADMAP A6)."""
import asyncio

import numpy as np
import pytest
from torch_port_helpers import port_instance

from repro.core import random_instance as ref_random_instance
from repro.faults import errors as ref_errors
from repro.faults import inject as ref_inject

import repro_torch.faults as faults
from repro_torch.analysis.sanitize import SanitizeError
from repro_torch.core import Budget, solve
from repro_torch.core.mdfg import InfeasibleInstanceError
from repro_torch.faults import inject as finj
from repro_torch.faults.errors import (
    CertifyFailure,
    CompileTimeout,
    DeviceLost,
    EngineCrashed,
    InfeasibleRequest,
    LaunchFailure,
    QueueOverload,
    ReproError,
    wrap_error,
)

CLASSES = ("ReproError", "CompileTimeout", "LaunchFailure", "DeviceLost", "CertifyFailure",
           "InfeasibleRequest", "QueueOverload", "EngineCrashed")


# --------------------------------------------------------------------------- #
# taxonomy                                                                    #
# --------------------------------------------------------------------------- #
def test_exports_are_the_references_without_checkpointing():
    import repro.faults

    ckpt = {"CheckpointMismatch", "SearchCheckpoint", "instance_fingerprint",
            "params_fingerprint"}
    assert set(faults.__all__) == set(repro.faults.__all__) - ckpt
    assert set(faults.errors.__all__) == set(ref_errors.__all__)
    assert set(finj.__all__) == set(ref_inject.__all__)


@pytest.mark.parametrize("name", CLASSES)
def test_retryability_equals_the_reference(name):
    mine, ref = getattr(faults.errors, name), getattr(ref_errors, name)
    assert mine.retryable == ref.retryable
    assert [c.__name__ for c in mine.__mro__[:-3]] == [c.__name__ for c in ref.__mro__[:-3]]


def test_retryability_encoded_on_the_class():
    assert CompileTimeout.retryable
    assert LaunchFailure.retryable
    assert DeviceLost.retryable
    assert CertifyFailure.retryable
    assert not InfeasibleRequest.retryable
    assert not QueueOverload.retryable
    assert not EngineCrashed.retryable
    assert not ReproError.retryable


def test_errors_carry_rid_and_injected():
    e = LaunchFailure("boom", rid=7, injected=True)
    assert e.rid == 7 and e.injected and isinstance(e, ReproError)
    assert QueueOverload("full", retry_after=0.25).retry_after == 0.25


def test_wrap_error_passthrough_adopts_rid():
    e = DeviceLost("gone")
    w = wrap_error(e, rid=3)
    assert w is e and w.rid == 3
    assert wrap_error(DeviceLost("gone", rid=1), rid=9).rid == 1


def test_wrap_error_maps_the_ports_own_causes():
    cert = wrap_error(SanitizeError("bad certificate", None), rid=2)
    assert isinstance(cert, CertifyFailure) and cert.rid == 2
    assert isinstance(cert.__cause__, SanitizeError)
    infeas = wrap_error(InfeasibleInstanceError("no fit", block=0, task=-1), rid=4)
    assert isinstance(infeas, InfeasibleRequest) and not infeas.retryable
    other = wrap_error(RuntimeError("CUDA error: an illegal memory access"), rid=5)
    assert isinstance(other, LaunchFailure) and not other.injected
    assert isinstance(other.__cause__, RuntimeError)
    assert str(other) == "RuntimeError: CUDA error: an illegal memory access"


# --------------------------------------------------------------------------- #
# deterministic injection: the reference's decisions                          #
# --------------------------------------------------------------------------- #
HELPERS = {"fire": ref_inject._FIRE_KINDS, "corrupt": ("corrupt_incumbent",),
           "nan_value": ("nan_duration",), "skewed": ("clock_skew",)}
PLANS = [dict(seed=5, rate=0.3), dict(seed=0, rate=0.1), dict(seed=7, rate=0.9),
         dict(seed=11, rate=0.5, kinds=("device_lost", "clock_skew")),
         dict(seed=3, rate=1.0, points=("device_search.sync",))]


def test_registered_points_equal_the_reference():
    assert finj.registered_points() == ref_inject.registered_points()
    assert len(finj.registered_points()) == 6
    assert finj.FAULT_KINDS == ref_inject.FAULT_KINDS


@pytest.mark.parametrize("point", sorted(ref_inject.registered_points()))
def test_every_decision_equals_the_reference(point):
    """Keys 0-999 under five plans and every helper: the same kind or none."""
    fired = 0
    for kw in PLANS:
        mine, ref = finj.FaultPlan(**kw), ref_inject.FaultPlan(**kw)
        for helper in HELPERS:
            got = [finj.would_fire(mine, helper, point, k) for k in range(1000)]
            want = [ref_inject.would_fire(ref, helper, point, k) for k in range(1000)]
            assert got == want, (kw, helper)
            fired += sum(g is not None for g in got)
    assert fired > 0


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_fire_and_the_value_helpers_act_as_the_reference(seed):
    kw = dict(seed=seed, rate=0.4, kinds=("launch_error", "device_lost", "corrupt_incumbent",
                                          "nan_duration", "clock_skew"))
    mine, ref = finj.FaultPlan(**kw), ref_inject.FaultPlan(**kw)
    arr_i, arr_f = np.arange(7), np.linspace(1.0, 2.0, 5)
    for k in range(200):
        outs = []
        for mod, plan in ((finj, mine), (ref_inject, ref)):
            with mod.plan_context(plan):
                try:
                    mod.fire("engine.execute.launch", key=k, rid=k)
                    raised = None
                except Exception as e:  # noqa: BLE001 — compared below
                    raised = (type(e).__name__, str(e), e.rid, e.injected)
                outs.append((raised,
                             mod.corrupt("engine.result.incumbent", arr_i, key=k).tolist(),
                             np.isnan(mod.corrupt("engine.result.incumbent", arr_f,
                                                  key=k)).tolist(),
                             str(mod.nan_value("engine.result.makespan", 1.5, key=k)),
                             mod.skewed("service.clock", 10.0, key=k)))
        assert outs[0] == outs[1], k


def test_helpers_are_noops_without_a_plan():
    with finj.plan_context(None):
        finj.fire("engine.execute.launch", key=1)
        arr = np.arange(5)
        assert finj.corrupt("engine.result.incumbent", arr, key=1) is arr
        assert finj.nan_value("engine.result.makespan", 3.5, key=1) == 3.5
        assert finj.skewed("service.clock", 10.0, key=1) == 10.0
        finj.fire("not.registered", key=1)


def test_decisions_are_pure_and_order_independent():
    plan = finj.FaultPlan(seed=11, rate=0.5)
    keys = list(range(40))
    first = [finj.would_fire(plan, "fire", "engine.execute.launch", k) for k in keys]
    second = [finj.would_fire(plan, "fire", "engine.execute.launch", k)
              for k in reversed(keys)][::-1]
    assert first == second
    assert any(first) and not all(first)
    other = [finj.would_fire(finj.FaultPlan(seed=12, rate=0.5), "fire",
                             "engine.execute.launch", k) for k in keys]
    assert other != first


def test_fire_matches_would_fire_prediction():
    plan = finj.FaultPlan(seed=3, rate=0.6, kinds=("launch_error", "device_lost"))
    with finj.plan_context(plan):
        for k in range(30):
            kind = finj.would_fire(plan, "fire", "engine.execute.launch", k)
            if kind is None:
                finj.fire("engine.execute.launch", key=k)
            else:
                cls = LaunchFailure if kind == "launch_error" else DeviceLost
                with pytest.raises(cls) as ei:
                    finj.fire("engine.execute.launch", key=k, rid=k)
                assert ei.value.injected and ei.value.rid == k


def test_compile_hang_stalls_for_the_plans_seconds():
    import time

    plan = finj.FaultPlan(seed=0, rate=1.0, kinds=("compile_hang",), hang_seconds=0.05)
    with finj.plan_context(plan):
        t0 = time.monotonic()
        finj.fire("device_search.sync", key=1)
        assert time.monotonic() - t0 >= 0.05


def test_rate_zero_plan_never_fires_and_rate_one_always():
    zero = finj.FaultPlan(seed=0, rate=0.0)
    one = finj.FaultPlan(seed=0, rate=1.0, kinds=("launch_error",))
    for k in range(20):
        assert finj.would_fire(zero, "fire", "engine.execute.launch", k) is None
        assert finj.would_fire(one, "fire", "engine.execute.launch", k) == "launch_error"


def test_corrupt_copies_never_mutates():
    plan = finj.FaultPlan(seed=0, rate=1.0, kinds=("corrupt_incumbent",))
    with finj.plan_context(plan):
        ints = np.arange(6)
        out = finj.corrupt("engine.result.incumbent", ints, key=2)
        assert out is not ints
        assert np.array_equal(ints, np.arange(6))
        assert (out != ints).sum() == 1
        assert np.isnan(finj.corrupt("engine.result.incumbent", np.ones(4), key=2)).sum() == 1
    with finj.plan_context(finj.FaultPlan(seed=0, rate=1.0, kinds=("nan_duration",))):
        assert np.isnan(finj.nan_value("engine.result.makespan", 1.0, key=2))
        arr = np.arange(3)
        assert finj.corrupt("engine.result.incumbent", arr, key=2) is arr
    skew_plan = finj.FaultPlan(seed=0, rate=1.0, kinds=("clock_skew",))
    with finj.plan_context(skew_plan):
        assert finj.skewed("service.clock", 10.0, key=2) == 10.0 + skew_plan.skew_seconds


def test_active_plan_rejects_unregistered_point():
    with finj.plan_context(finj.FaultPlan(rate=1.0)):
        with pytest.raises(ValueError, match="unregistered injection point"):
            finj.fire("engine.execute.lunch", key=0)


@pytest.mark.parametrize("raw", ["", "0", "false", "no", "off"])
def test_env_off_values(monkeypatch, raw):
    monkeypatch.setenv("REPRO_FAULTS", raw)
    assert finj.plan_from_env() is None


@pytest.mark.parametrize("raw", [
    "1", "seed=7, rate=0.25, kinds=launch_error+clock_skew, points=service.clock, "
         "skew_seconds=0.5", "seed=5,rate=0.3,hang_seconds=2"])
def test_env_parsing_equals_the_reference(monkeypatch, raw):
    monkeypatch.setenv("REPRO_FAULTS", raw)
    mine, ref = finj.plan_from_env(), ref_inject.plan_from_env()
    assert mine.__dict__ == ref.__dict__


def test_env_parsing_rejects_unknown_keys(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "bogus=1")
    with pytest.raises(ValueError, match="unknown key"):
        finj.plan_from_env()


def test_checkpointing_is_not_ported_yet():
    from repro_torch.core import device_search as ds
    from repro_torch.core.tabu import TSParams

    inst = port_instance(ref_random_instance(0, n_tasks=12, n_data=30))
    from repro_torch.core.greedy import construct_greedy

    init = construct_greedy(inst, "slack_first", rng=0)
    for kw in ({"on_checkpoint": print}, {"resume_from": object()}):
        with pytest.raises(NotImplementedError, match="A6"):
            ds.device_multiwalk(inst, [init], TSParams(torch_device="cpu"), **kw)


# --------------------------------------------------------------------------- #
# the service under an active plan                                            #
# --------------------------------------------------------------------------- #
def test_service_accounts_every_request_under_faults(monkeypatch):
    """Numpy-backend service under a 4-kind plan: every submitted request
    reaches exactly one terminal state — a certified result or a typed
    ReproError — and survivors are bit-identical to solo solves."""
    from repro_torch.serve import BatchPolicy, EngineConfig, SolveService

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    insts = [port_instance(ref_random_instance(s, n_tasks=24, n_data=60)) for s in range(8)]
    budget = Budget(max_iters=4)
    solo = [solve(inst, "tabu_multiwalk", walks=2, budget=budget, seed=i, backend="numpy")
            for i, inst in enumerate(insts)]
    plan = finj.FaultPlan(seed=5, rate=0.3,
                          kinds=("launch_error", "corrupt_incumbent", "nan_duration",
                                 "clock_skew"))

    async def run():
        svc = SolveService(config=EngineConfig(backend="numpy", batch_sizes=(4,)),
                           policy=BatchPolicy(max_batch=4, max_wait=0.01))
        await svc.start()
        rids = [await svc.submit(inst, budget, seed=i, walks=2)
                for i, inst in enumerate(insts)]
        outs = {}
        for rid in rids:
            try:
                outs[rid] = await asyncio.wait_for(svc.result(rid), timeout=60.0)
            except ReproError as e:
                outs[rid] = e
        await svc.shutdown()
        return rids, outs, svc.metrics()

    with finj.plan_context(plan):
        rids, outs, metrics = asyncio.run(run())

    assert len(rids) == len(set(rids)) == 8
    assert set(outs) == set(rids)
    for i, rid in enumerate(rids):
        out = outs[rid]
        if isinstance(out, ReproError):
            continue
        assert out.metrics.get("certified") is True
        assert out.report.makespan == solo[i].makespan
        assert np.array_equal(out.report.solution.assign, solo[i].solution.assign)
    n_failed = sum(isinstance(o, ReproError) for o in outs.values())
    assert metrics["failed"] == n_failed
