"""The device-resident search's surroundings on the CPU: the ``tabu_device``
solver and ``backend="device"`` routing, Algorithm 3 at sync boundaries,
the launch cache (two instances of one bucket through one launch, reuse
across runs, ``warm_launches``), the perturbation branch, the state packing
against the reference's, and the round's helpers bit for bit: the
sequential prefix sum's plain version against ``np.cumsum``, ``_mix32``
against ``repro_torch.core.tabu._mix32`` and the perturbation draw as a pure
function of (seed, walk, iteration)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import port_instance, port_solution

from repro.core import random_instance as ref_random_instance
from repro.core.device_search import pack_state as ref_pack_state
from repro.core.greedy import construct_greedy
from repro.core.solution import exact_schedule as ref_exact_schedule
from repro.core.tabu import TSParams as RefTSParams
from repro.core.tabu import tabu_search as ref_tabu_search
from repro.instances.batch import pack_instance as ref_pack_instance

import repro_torch
from repro_torch.analysis.certify import certify_solution
from repro_torch.core import device_search as ds
from repro_torch.core import random_instance
from repro_torch.core import tabu as port_tabu
from repro_torch.core.greedy import construct_greedy as port_greedy
from repro_torch.core.solution import exact_schedule
from repro_torch.core.tabu import TSParams
from repro_torch.instances import pack_instance
from repro_torch.kernels import schedule_dp as sdp

PARITY = dict(max_unimproved=15, time_limit=1e9, top_k=5, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
CFG = ds.DeviceConfig(sync_every=16, crit_cap=32)
DEV = {"sync_every": 16, "crit_cap": 32}


def small_instance(seed=0, **kw):
    kw.setdefault("n_tasks", 40)
    kw.setdefault("n_data", 100)
    return ref_random_instance(seed, **kw)


# --------------------------------------------------------------------------- #
# solver registration and routing                                              #
# --------------------------------------------------------------------------- #
def test_registered_solver_and_backend_routing():
    assert "tabu_device" in repro_torch.list_solvers()
    inst = random_instance(7, n_tasks=40, n_data=100)
    params = TSParams(max_unimproved=8, time_limit=30.0, top_k=4, max_iters=15)
    rep = repro_torch.solve(inst, "tabu_device", walks=2, params=params, seed=0,
                            device=DEV, torch_device="cpu")
    assert rep.method == "tabu_device"
    assert rep.extras["backend"] == "device"
    assert rep.extras["walks"] == 2
    assert rep.extras["compile_seconds"] == 0.0      # nothing is captured on the CPU
    assert rep.feasible
    assert np.isclose(exact_schedule(inst, rep.solution).makespan, rep.makespan, rtol=1e-9)
    # the same engine through the multiwalk solver's backend switch
    rep2 = repro_torch.solve(inst, "tabu_multiwalk", walks=2, params=params, seed=0,
                             backend="device", device=DEV, torch_device="cpu")
    assert rep2.makespan == rep.makespan and rep2.history == rep.history
    assert rep2.extras["backend"] == "device"


@pytest.mark.parametrize("how", ["solver", "backend"])
def test_device_engine_defaults_to_the_card(how):
    inst = random_instance(0, n_tasks=31, n_data=60)
    kw = dict(walks=2, budget=repro_torch.Budget(max_iters=2))
    method = "tabu_device" if how == "solver" else "tabu_multiwalk"
    if how == "backend":
        kw["backend"] = "device"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.solve(inst, method, **kw)


def test_device_options_need_the_device_engine():
    inst = random_instance(0, n_tasks=31, n_data=60)
    with pytest.raises(ValueError, match="requires backend='device'"):
        repro_torch.solve(inst, "tabu_multiwalk", device={"sync_every": 8},
                          torch_device="cpu")
    with pytest.raises(ValueError, match="always runs backend='device'"):
        repro_torch.solve(inst, "tabu_device", backend="numpy", torch_device="cpu")
    with pytest.raises(ValueError, match="no per-batch evaluator"):
        repro_torch.solve(inst, "tabu", backend="device", torch_device="cpu")


def test_device_config_has_no_donate_field():
    """The launch's buffers are always updated in place: the reference's
    ``donate`` is not a field, and passing it raises."""
    assert [f.name for f in dataclasses.fields(ds.DeviceConfig)] == \
        ["sync_every", "crit_cap", "perturb"]
    inst = random_instance(0, n_tasks=31, n_data=60)
    with pytest.raises(TypeError, match="donate"):
        repro_torch.solve(inst, "tabu_device", device={"donate": False}, walks=1,
                          budget=repro_torch.Budget(max_iters=1), torch_device="cpu")


def test_checkpoint_hooks_are_not_ported_yet():
    inst = random_instance(0, n_tasks=31, n_data=60)
    init = port_greedy(inst, "slack_first", rng=0)
    params = TSParams(torch_device="cpu", max_iters=2)
    for kw in ({"on_checkpoint": print}, {"resume_from": object()}):
        with pytest.raises(NotImplementedError, match="A6"):
            ds.device_multiwalk(inst, [init], params, **kw)


# --------------------------------------------------------------------------- #
# Algorithm 3 at syncs, the perturbation branch                                #
# --------------------------------------------------------------------------- #
def test_mem_updates_at_sync_keep_the_solution_consistent_and_certified():
    """Default params (Alg-3 enabled) run memory_update at sync boundaries;
    the returned incumbent is schedulable, capacity-feasible, certified."""
    inst = random_instance(11, n_tasks=40, n_data=100)
    params = TSParams(max_unimproved=12, time_limit=30.0, top_k=4, max_iters=24, seed=2,
                      torch_device="cpu")
    init = port_greedy(inst, "slack_first", rng=2)
    res = ds.device_multiwalk(inst, [init], params,
                              config=ds.DeviceConfig(sync_every=8, crit_cap=32))
    sched = exact_schedule(inst, res.best)
    assert sched is not None
    assert np.isclose(sched.makespan, res.best_makespan, rtol=1e-9)
    assert res.iterations >= 8
    cert = certify_solution(inst, res.best, reported_makespan=res.best_makespan,
                            claimed_feasible=True)
    assert cert.ok, cert.summary()


def test_perturbation_fires_on_stalled_walks_and_keeps_the_state_consistent():
    """Four tasks on two cores: the tabu table saturates, walks stall and
    take one random move each (the port's draw, ``perturbation_pick``)."""
    inst = random_instance(0, n_tasks=4, n_data=8, n_fast_cores=1, n_slow_cores=1)
    inits = [port_greedy(inst, s, rng=3) for s in ("slack_first", "r_first")]
    params = TSParams(seed=3, max_unimproved=10**6, time_limit=1e9, top_k=4, max_iters=40,
                      mem_update_period=ds.MEM_UPDATE_DISABLED, torch_device="cpu")
    res = ds.device_multiwalk(inst, inits, params, config=CFG)
    assert res.n_perturbations > 0 and res.iterations == 40
    for wi in res.per_walk:
        sched = exact_schedule(inst, wi.best)
        assert sched is not None and sched.makespan == wi.best_makespan
    again = ds.device_multiwalk(inst, [port_greedy(inst, s, rng=3)
                                       for s in ("slack_first", "r_first")], params, config=CFG)
    assert again.history == res.history and again.n_perturbations == res.n_perturbations


# --------------------------------------------------------------------------- #
# the launch cache                                                             #
# --------------------------------------------------------------------------- #
def test_launch_cache_hit_uses_each_instances_own_arrays():
    """Two DIFFERENT instances sharing every shape bucket must not
    cross-contaminate through the launch cache (the launch's instance
    buffers are refilled on every use)."""
    results = {}
    for seed in (0, 4):  # same n_tasks/n_data → same bucket key
        inst = small_instance(seed)
        init = construct_greedy(inst, "slack_first", rng=3)
        legacy = ref_tabu_search(inst, init.copy(), RefTSParams(seed=3, **PARITY))
        hits = ds.launch_cache_info()["hits"]
        dev = ds.device_multiwalk(port_instance(inst), [port_solution(init)],
                                  TSParams(seed=3, torch_device="cpu", **PARITY), config=CFG)
        assert dev.history == legacy.history, f"seed {seed} (cache collision?)"
        assert ds.launch_cache_info()["hits"] > hits
        results[seed] = dev.best_makespan
    assert results[0] != results[4]  # genuinely different instances


def test_launch_cache_reuse_across_same_bucket_runs():
    info0 = ds.launch_cache_info()
    inst = port_instance(small_instance(0))
    params = TSParams(seed=5, torch_device="cpu", **PARITY)
    init = port_greedy(inst, "slack_first", rng=5)
    ds.device_multiwalk(inst, [init.copy()], params, config=CFG)
    misses_after_first = ds.launch_cache_info()["misses"]
    ds.device_multiwalk(inst, [init.copy()], params, config=CFG)
    info2 = ds.launch_cache_info()
    assert info2["misses"] == misses_after_first  # second run: cache hit
    assert info2["hits"] > info0["hits"]


def test_warm_launches_allocates_each_batch_size_once():
    inst = random_instance(3, n_tasks=44, n_data=100)
    params = TSParams(seed=0, torch_device="cpu", **PARITY)
    cfg = ds.DeviceConfig(sync_every=8, crit_cap=32)
    first = ds.warm_launches([inst], 2, params, config=cfg, batch_sizes=(1, 2))
    assert sorted(first["per_size"]) == [1, 2]
    again = ds.warm_launches([inst], 2, params, config=cfg, batch_sizes=(2,))
    assert again["per_size"][2]["fresh"] is False
    # one launch at one exact-evaluation chunk, one at two (the relaunch's rung)
    assert first["cache_delta"]["misses"] == 4
    assert again["cache_delta"]["misses"] == 0 and again["cache_delta"]["hits"] == 2
    with pytest.raises(ValueError, match="positive"):
        ds.warm_launches([inst], 2, params, config=cfg, batch_sizes=(0,))


# --------------------------------------------------------------------------- #
# state packing and the round's helpers                                        #
# --------------------------------------------------------------------------- #
def test_pack_state_equals_the_references_but_for_the_threefry_key():
    ref_inst = small_instance(2)
    inst = port_instance(ref_inst)
    sols = [construct_greedy(ref_inst, s, rng=1) for s in ("slack_first", "r_first")]
    ref = ref_pack_state(ref_pack_instance(ref_inst), sols,
                         [ref_exact_schedule(ref_inst, s) for s in sols], 7)
    got = ds.pack_state(pack_instance(inst), [port_solution(s) for s in sols],
                        [exact_schedule(inst, port_solution(s)) for s in sols], 7)
    assert set(ref) - set(got) == {"key"}
    assert set(got) - set(ref) == {"chunk_overflow"}
    for k in ref.keys() - {"key", "seed"}:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        assert np.array_equal(got[k], ref[k]), k
    assert int(got["seed"]) == int(ref["seed"]) == 7
    sol = ds.unpack_solution(pack_instance(inst), got["seq"], got["seq_len"],
                             got["assign"], got["mem"], 1)
    assert sol.proc_seq == [list(map(int, s)) for s in sols[1].proc_seq]


@pytest.mark.parametrize("width", [1, 128, 256, 1280, 3072])
def test_seq_cumsum_plain_version_equals_numpy_cumsum(width):
    rng = np.random.default_rng(width)
    v = rng.random((7, width)) * rng.integers(1, 15000, (7, width))
    v[:, ::5] = 0.0
    launches = sdp.seq_cumsum.launches
    got = sdp.seq_cumsum(torch.from_numpy(v))
    want = np.concatenate([np.zeros((7, 1)), np.cumsum(v, axis=1)], axis=1)
    assert np.array_equal(got.numpy(), want)
    assert sdp.seq_cumsum.launches == launches   # the CPU path launches nothing


def test_mix32_words_equal_the_tabu_draws():
    rng = np.random.default_rng(0)
    seeds = [0, 3, 0xFFFFFFFF, int(rng.integers(0, 2**32))]
    walks = torch.arange(9)
    for seed in seeds:
        for it in (1, 2, 77, 123456):
            for kind in (0, 1, 2):
                got = ds._mix32(torch.tensor(seed & 0xFFFFFFFF), walks, torch.tensor(it), kind)
                want = [port_tabu._mix32(seed, w, it, kind) for w in range(9)]
                assert got.tolist() == want
    # the tenure of tabu._tenure_draw, from the same words
    n, p = torch.tensor(40), torch.tensor(10)
    h1, h0 = ds._mix32(torch.tensor(5), walks, torch.tensor(9), 1), \
        ds._mix32(torch.tensor(5), walks, torch.tensor(9), 0)
    assert (p + h1 % (2 * p)).tolist() == [port_tabu._tenure_draw(5, w, 9, True, 10, 40)
                                           for w in range(9)]
    assert (n + h0 % n).tolist() == [port_tabu._tenure_draw(5, w, 9, False, 10, 40)
                                     for w in range(9)]


def test_perturbation_draw_is_a_pure_function_of_seed_walk_and_iteration():
    walks = torch.arange(6)
    n_moves = torch.tensor([0, 1, 5, 17, 400, 3])
    a = ds.perturbation_pick(torch.tensor(11), walks, torch.tensor(30), n_moves)
    b = ds.perturbation_pick(torch.tensor(11), walks, torch.tensor(30), n_moves.clone())
    assert torch.equal(a, b)
    want = [port_tabu._mix32(11, w, 30, 2) % max(int(m), 1) for w, m in enumerate(n_moves)]
    assert a.tolist() == want
    assert a[0] == 0 and a[1] == 0 and bool((a < torch.clamp(n_moves, min=1)).all())
    other = ds.perturbation_pick(torch.tensor(11), walks, torch.tensor(31), n_moves)
    assert not torch.equal(a, other)
