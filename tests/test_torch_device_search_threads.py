"""The port's device engine driven from more than one thread, and its fault
point, on the CPU (where the round runs eagerly with the plain K1).

A launch owns the buffers every batch of its shape reuses, so two
``solve_instances`` of one launch shape running at once must not share
them: each result must equal the same call run alone.  The
``device_search.sync`` fault point fires at the end of a sync period's host
work with the reference package's keying, so ``repro``'s ``would_fire``
predicts the sync a plan loses the device at."""
import threading

import pytest
from torch_port_helpers import port_instance

from repro.core import random_instance as ref_random_instance
from repro.faults import inject as ref_inject

from repro_torch.core import device_search as ds
from repro_torch.core.api import multiwalk_inits
from repro_torch.core.tabu import TSParams
from repro_torch.faults import inject as finj
from repro_torch.faults.errors import DeviceLost

PARAMS = TSParams(max_unimproved=10**9, time_limit=1e9, top_k=5, max_iters=12,
                  mem_update_period=ds.MEM_UPDATE_DISABLED, torch_device="cpu")
CFG = ds.DeviceConfig(sync_every=4, crit_cap=32)


def same_shape_pair():
    """Two different instances that pad to one launch shape."""
    a, b = (port_instance(ref_random_instance(s, n_tasks=30, n_data=70)) for s in (0, 1))
    batch_a = ds.InstanceBatch.from_instances([a])
    batch_b = ds.InstanceBatch.from_instances([b], n_b=batch_a.n_b, p_b=batch_a.p_b,
                                              d_b=batch_a.d_b, widths=batch_a.widths,
                                              e_b=batch_a.e_b)
    if batch_b.bucket_key != batch_a.bucket_key:
        batch_a = ds.InstanceBatch.from_instances([a], n_b=batch_b.n_b, p_b=batch_b.p_b,
                                                  d_b=batch_b.d_b, widths=batch_b.widths,
                                                  e_b=batch_b.e_b)
    assert batch_a.bucket_key == batch_b.bucket_key
    return (a, batch_a), (b, batch_b)


def run(batch, inst, seed, callbacks=None):
    inits = [multiwalk_inits(inst, 3, seed)[0]]
    return ds.solve_instances(batch, inits, PARAMS, config=CFG, seeds=[seed],
                              callbacks=callbacks)[0]


def outcome(res):
    return (res.best_makespan, res.history, res.iterations, res.n_exact_evals,
            res.n_approx_evals, res.best.assign.tolist(), res.best.mem.tolist(),
            res.best.proc_seq, [w.history for w in res.per_walk])


class _Meet:
    """A sync-boundary callback that holds its thread at the first sync until
    the other thread reaches its own: both drives are then inside the run at
    once, on whatever launches they hold."""

    def __init__(self, barrier):
        self.barrier = barrier
        self.met = False

    def on_iteration(self, ev):
        if not self.met:
            self.met = True
            self.barrier.wait(timeout=60)
        return None

    on_improvement = None


def test_two_threads_on_one_launch_shape_equal_the_sequential_runs():
    (a, batch_a), (b, batch_b) = same_shape_pair()
    want = [outcome(run(batch_a, a, 3)), outcome(run(batch_b, b, 5))]
    assert want[0] != want[1]
    barrier = threading.Barrier(2)
    got, errors = [None, None], []

    def worker(k, batch, inst, seed):
        try:
            got[k] = outcome(run(batch, inst, seed, [_Meet(barrier)]))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(0, batch_a, a, 3)),
               threading.Thread(target=worker, args=(1, batch_b, b, 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert got == want


def test_a_busy_launch_shape_gets_a_launch_of_its_own():
    (a, batch_a), _ = same_shape_pair()
    inits = [multiwalk_inits(a, 3, 3)[0]]
    cur, scheds = ds._start_walks(batch_a.instances, inits, PARAMS)
    first, _ = ds._get_launch(batch_a, 3, PARAMS, 32, 1, CFG, ds.resolve_device("cpu"),
                              owner={})
    try:
        before = ds.launch_cache_info()
        res = ds._drive(batch_a, cur, scheds, [3], PARAMS, CFG, None, ["w0", "w1", "w2"],
                        solo=False)[0]
        after = ds.launch_cache_info()
    finally:
        ds._release(first)
    assert after["uncached"] == before["uncached"] + 1
    assert outcome(res) == outcome(run(batch_a, a, 3))
    again, fresh = ds._get_launch(batch_a, 3, PARAMS, 32, 1, CFG, ds.resolve_device("cpu"))
    assert again is first and not fresh and first.owner is None


def sync_plan():
    """A plan that loses the device at a sync of the run below (keys 1..2)."""
    for seed in range(200):
        plan = dict(seed=seed, rate=0.5, kinds=("device_lost",),
                    points=("device_search.sync",))
        keys = [k for k in range(1, 4)
                if ref_inject.would_fire(ref_inject.FaultPlan(**plan), "fire",
                                         "device_search.sync", k)]
        if keys and keys[0] == 2:
            return plan, keys[0]
    raise AssertionError("no seed below 200 fires first at sync 2")


def test_sync_fault_point_loses_the_device_where_the_reference_predicts():
    (a, batch_a), _ = same_shape_pair()
    plan, key = sync_plan()
    syncs = []

    class Count:
        on_improvement = None

        def on_iteration(self, ev):
            syncs.append(ev.iteration)

    with finj.plan_context(finj.FaultPlan(**plan)):
        with pytest.raises(DeviceLost, match=rf"device_search\.sync \(key {key}\)") as err:
            run(batch_a, a, 3, [Count()])
    assert err.value.injected
    # callbacks fire before the fault point: the device is lost at the end
    # of the key-th sync period's host work
    assert len(syncs) == key
    assert syncs == [4 * (k + 1) for k in range(key)]
    # no plan: the same run goes to its end
    assert run(batch_a, a, 3).iterations == PARAMS.max_iters


@pytest.mark.parametrize("method", ["load_state", "load_instances"])
def test_a_load_that_raises_leaves_its_launch_free(monkeypatch, method):
    """A run whose copy into a fetched launch raises lets the launch go: the
    next run of its shape takes it from the cache, not an uncached one."""
    (a, batch_a), _ = same_shape_pair()
    want = outcome(run(batch_a, a, 3))           # the launch is cached from here
    real = getattr(ds._Launch, method)
    calls = []

    def once(self, *args):
        calls.append(method)
        if len(calls) == 1:
            raise RuntimeError(f"{method} failed")
        return real(self, *args)

    monkeypatch.setattr(ds._Launch, method, once)
    if method == "load_instances":
        batch_a = ds.InstanceBatch.from_instances(  # a new batch object: a real copy
            [a], n_b=batch_a.n_b, p_b=batch_a.p_b, d_b=batch_a.d_b, widths=batch_a.widths,
            e_b=batch_a.e_b)
    with pytest.raises(RuntimeError, match="failed"):
        run(batch_a, a, 3)
    before = ds.launch_cache_info()
    assert outcome(run(batch_a, a, 3)) == want
    after = ds.launch_cache_info()
    assert after["uncached"] == before["uncached"]
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
