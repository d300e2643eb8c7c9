"""The port's device-resident search (``repro_torch.core.device_search``) on
the CPU, where its round runs eagerly with the plain K1, against the
reference's NumPy search loops (``repro.core.tabu.tabu_search`` /
``tabu_multiwalk``): W=1 and W=3 trajectories bit for bit (history,
incumbent, iteration and eval counts, final solution), the eval budget, the
critical-set and chunk overflow escalations leaving the trajectory as it
is, and the instance batch against per-instance runs.  Parity holds in the
profile where Algorithm 3 never fires inside the horizon and no walk enters
the perturbation branch, as the reference documents."""
import numpy as np
import pytest
from torch_port_helpers import port_instance, port_solution

from repro.core import random_instance as ref_random_instance
from repro.core.greedy import STRATEGIES, construct_greedy
from repro.core.tabu import TSParams as RefTSParams
from repro.core.tabu import tabu_multiwalk as ref_tabu_multiwalk
from repro.core.tabu import tabu_search as ref_tabu_search

from repro_torch.core import device_search as ds
from repro_torch.core.solution import exact_schedule
from repro_torch.core.tabu import TSParams

# the reference's parity parameters (tests/test_device_search.py)
PARITY = dict(max_unimproved=15, time_limit=1e9, top_k=5, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)
CFG = ds.DeviceConfig(sync_every=16, crit_cap=32)


def small_instance(seed=0, **kw):
    kw.setdefault("n_tasks", 40)
    kw.setdefault("n_data", 100)
    return ref_random_instance(seed, **kw)


def port_run(inst, inits, seed, cfg=CFG, **over):
    params = TSParams(seed=seed, torch_device="cpu", **{**PARITY, **over})
    return ds.device_multiwalk(port_instance(inst), [port_solution(s) for s in inits],
                               params, config=cfg)


def assert_same_trajectory(dev, ref):
    assert dev.history == ref.history
    assert dev.best_makespan == ref.best_makespan
    assert dev.iterations == ref.iterations
    assert dev.n_exact_evals == ref.n_exact_evals
    assert dev.n_approx_evals == ref.n_approx_evals
    assert dev.stop_reason == ref.stop_reason
    assert dev.n_perturbations == ref.n_perturbations == 0
    assert np.array_equal(dev.best.assign, ref.best.assign)
    assert np.array_equal(dev.best.mem, ref.best.mem)
    assert dev.best.proc_seq == [list(map(int, s)) for s in ref.best.proc_seq]


@pytest.mark.parametrize("seed", [0, 4])
def test_w1_reproduces_numpy_tabu_search(seed):
    """Seed 4 is where the reference's own JAX engine misses NumPy's last bit
    (ROADMAP Queue C, F2); the port does not."""
    inst = small_instance(seed)
    init = construct_greedy(inst, "slack_first", rng=3)
    ref = ref_tabu_search(inst, init.copy(), RefTSParams(seed=3, **PARITY))
    assert_same_trajectory(port_run(inst, [init], 3), ref)


def test_w3_reproduces_numpy_tabu_multiwalk():
    inst = small_instance(2, n_tasks=45, n_data=110)
    inits = [construct_greedy(inst, STRATEGIES[w % 4], rng=7 + w) for w in range(3)]
    ref = ref_tabu_multiwalk(inst, [s.copy() for s in inits], RefTSParams(seed=7, **PARITY))
    dev = port_run(inst, inits, 7)
    assert_same_trajectory(dev, ref)
    for a, b in zip(ref.per_walk, dev.per_walk):
        assert a.history == b.history
        assert a.best_makespan == b.best_makespan


def test_eval_budget_stops_where_numpy_stops():
    inst = small_instance(9)
    init = construct_greedy(inst, "slack_first", rng=0)
    over = dict(max_unimproved=10**9, max_iters=None, max_evals=60)
    ref = ref_tabu_multiwalk(inst, [init.copy()], RefTSParams(seed=0, **{**PARITY, **over}))
    dev = port_run(inst, [init], 0, **over)
    assert dev.stop_reason == "max_evals"
    assert_same_trajectory(dev, ref)


def test_crit_cap_overflow_escalates_and_keeps_the_trajectory():
    """A tiny crit_cap forces the overflow→relaunch path; the overflowing
    round is never committed, so the trajectory is NumPy's."""
    inst = small_instance(0)
    init = construct_greedy(inst, "slack_first", rng=3)
    ref = ref_tabu_search(inst, init.copy(), RefTSParams(seed=3, **PARITY))
    before = ds.launch_cache_info()["overflow_relaunches"]
    tiny = port_run(inst, [init], 3, cfg=ds.DeviceConfig(sync_every=16, crit_cap=4))
    assert tiny.device_stats["crit_cap"] > 4
    assert ds.launch_cache_info()["overflow_relaunches"] > before
    assert_same_trajectory(tiny, ref)


def test_chunk_overflow_escalates_and_keeps_the_trajectory():
    """With K̄ = 2 this walk reaches a round whose first chunk holds no
    eligible candidate: the round needs a second chunk, overflows J = 1,
    is not committed, and is run again with J = 2."""
    inst = small_instance(11)
    init = construct_greedy(inst, "slack_first", rng=3)
    over = dict(top_k=2, max_unimproved=60, max_iters=70)
    ref = ref_tabu_search(inst, init.copy(), RefTSParams(seed=3, **{**PARITY, **over}))
    before = ds.launch_cache_info()["overflow_relaunches"]
    dev = port_run(inst, [init], 3, **over)
    assert dev.device_stats["chunk_cap"] > 1
    assert ds.launch_cache_info()["overflow_relaunches"] > before
    assert_same_trajectory(dev, ref)


def test_solve_instances_matches_per_instance_runs():
    insts = [small_instance(s, n_tasks=40 + 2 * s) for s in range(3)]
    all_inits = [[construct_greedy(i, STRATEGIES[w % 4], rng=1 + w) for w in range(2)]
                 for i in insts]
    params = TSParams(seed=1, torch_device="cpu", **PARITY)
    batch = ds.solve_instances([port_instance(i) for i in insts],
                               [[port_solution(s) for s in il] for il in all_inits],
                               params, config=CFG)
    for i, inst in enumerate(insts):
        solo = port_run(inst, all_inits[i], 1)
        assert batch[i].history == solo.history
        assert batch[i].best_makespan == solo.best_makespan
        assert batch[i].iterations == solo.iterations
        assert batch[i].n_exact_evals == solo.n_exact_evals
        sched = exact_schedule(port_instance(inst), batch[i].best)
        assert np.isclose(sched.makespan, batch[i].best_makespan, rtol=1e-12)
    ref = ref_tabu_multiwalk(insts[2], [s.copy() for s in all_inits[2]],
                             RefTSParams(seed=1, **PARITY))
    assert batch[2].history == ref.history


def test_solve_instances_takes_a_seed_and_a_callback_per_instance():
    insts = [small_instance(s) for s in (0, 4)]
    inits = [[construct_greedy(i, "slack_first", rng=3)] for i in insts]
    events = []

    class StopAtFirstSync:
        def on_iteration(self, ev):
            events.append(ev.iteration)
            return True

    params = TSParams(seed=0, torch_device="cpu", **PARITY)
    res = ds.solve_instances([port_instance(i) for i in insts],
                             [[port_solution(s) for s in il] for il in inits], params,
                             config=CFG, seeds=[3, 5], callbacks=[None, StopAtFirstSync()])
    solo = port_run(insts[0], inits[0], 3)
    assert res[0].history == solo.history and res[0].n_exact_evals == solo.n_exact_evals
    assert res[1].stop_reason == "callback" and events == [CFG.sync_every]
    assert res[1].iterations == CFG.sync_every
    with pytest.raises(ValueError, match="one seed per instance"):
        ds.solve_instances([port_instance(insts[0])], [[port_solution(inits[0][0])]],
                           params, seeds=[1, 2])
