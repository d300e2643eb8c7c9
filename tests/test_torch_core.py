"""Host modules of the port against the reference package on identical
data: instance generation, the constructors, Alg. 3, the scalar schedule
evaluation and the certificate checker.  Everything is ``array_equal``
(tolerance 0): both sides run the same NumPy operations in the same order."""
import numpy as np
import pytest

import repro.core.greedy as ref_greedy
import repro.core.load_balance as ref_lb
import repro.core.solution as ref_solution
from repro.analysis.certify import certify_solution as ref_certify
from repro.core import random_instance as ref_random_instance
from repro.core.memory_update import memory_update as ref_memory_update
from repro.instances import generate as ref_generate

import repro_torch.core.greedy as greedy
import repro_torch.core.load_balance as lb
import repro_torch.core.solution as solution
from repro_torch.analysis.certify import certify_solution
from repro_torch.core import random_instance
from repro_torch.core.memory_update import memory_update
from repro_torch.instances import generate, list_families

from torch_port_helpers import port_instance, port_solution, same_instance, same_solution

SIZES = [(0, 31, 70), (1, 48, 110), (2, 65, 150)]


@pytest.mark.parametrize("seed,n_tasks,n_data", SIZES)
def test_random_instance_same_seed_same_arrays(seed, n_tasks, n_data):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    inst = random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    assert same_instance(ref, inst)


@pytest.mark.parametrize("family", ["random_layered", "out_tree", "in_tree", "fft", "stencil"])
def test_numpy_families_generate_identically(family):
    assert family in list_families()
    assert same_instance(ref_generate(family, 5), generate(family, 5))


def test_model_derived_families_wait_for_their_modules():
    """The model-derived families are registered now that the planner is
    ported; each generates the reference's instance for its defaults."""
    for family in ("residency", "pipeline"):
        assert family in list_families()
        assert same_instance(ref_generate(family, 0), generate(family, 0))


@pytest.mark.parametrize("strategy", ref_greedy.STRATEGIES)
@pytest.mark.parametrize("seed,n_tasks,n_data", SIZES[:2])
def test_construct_greedy_parity(strategy, seed, n_tasks, n_data):
    assert greedy.STRATEGIES == ref_greedy.STRATEGIES
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    a = ref_greedy.construct_greedy(ref, strategy, rng=seed)
    b = greedy.construct_greedy(port_instance(ref), strategy, rng=seed)
    assert same_solution(a, b)


@pytest.mark.parametrize("seed,n_tasks,n_data", SIZES)
def test_load_balance_parity(seed, n_tasks, n_data):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    assert same_solution(ref_lb.load_balance(ref, rng=seed),
                         lb.load_balance(port_instance(ref), rng=seed))


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("refresh_every", [1, 8])
def test_memory_update_parity(scalar, refresh_every):
    ref = ref_random_instance(4, n_tasks=40, n_data=100)
    start = ref_greedy.construct_greedy(ref, "r_first", rng=4)
    a = ref_memory_update(ref, start, refresh_every=refresh_every, scalar=scalar)
    b = memory_update(port_instance(ref), port_solution(start),
                         refresh_every=refresh_every, scalar=scalar)
    assert same_solution(a, b)


@pytest.mark.parametrize("seed,n_tasks,n_data", SIZES)
def test_exact_schedule_heads_tails_peaks_parity(seed, n_tasks, n_data):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    inst = port_instance(ref)
    ref_sol = ref_greedy.construct_greedy(ref, "slack_first", rng=seed)
    sol = port_solution(ref_sol)
    sa, sb = ref_solution.exact_schedule(ref, ref_sol), solution.exact_schedule(inst, sol)
    for f in ("start", "finish", "topo"):
        assert np.array_equal(getattr(sa, f), getattr(sb, f))
    assert sa.makespan == sb.makespan
    for x, y in zip(ref_solution.heads_tails(ref, ref_sol, sa),
                    solution.heads_tails(inst, sol, sb)):
        assert np.array_equal(x, y)
    assert np.array_equal(ref_solution.durations(ref, ref_sol.assign, ref_sol.mem),
                          solution.durations(inst, sol.assign, sol.mem))
    assert np.array_equal(ref_solution.memory_peaks(ref, ref_sol, sa),
                          solution.memory_peaks(inst, sol, sb))
    assert ref_solution.memory_feasible(ref, ref_sol, sa) == \
        solution.memory_feasible(inst, sol, sb)
    assert solution._EPS == ref_solution._EPS


def test_exact_schedule_reports_cycles_alike():
    ref = ref_random_instance(0, n_tasks=31, n_data=70)
    ref_sol = ref_greedy.construct_greedy(ref, "slack_first", rng=0)
    # reversing a machine order that holds a precedence pair makes a cycle
    for p, seq in enumerate(ref_sol.proc_seq):
        if len(seq) >= 2:
            ref_sol.proc_seq[p] = list(reversed(seq))
    a = ref_solution.exact_schedule(ref, ref_sol)
    b = solution.exact_schedule(port_instance(ref), port_solution(ref_sol))
    assert (a is None) == (b is None)


@pytest.mark.parametrize("seed,n_tasks,n_data", SIZES)
def test_certify_solution_parity(seed, n_tasks, n_data):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    ref_sol = ref_memory_update(ref, ref_greedy.construct_greedy(ref, "slack_first", rng=seed))
    mk = ref_solution.exact_schedule(ref, ref_sol).makespan
    a = ref_certify(ref, ref_sol, reported_makespan=mk)
    b = certify_solution(port_instance(ref), port_solution(ref_sol), reported_makespan=mk)
    assert a.ok and b.ok
    # the checker re-derives times by its own simulation, so its makespan
    # meets the DP's only to rounding; the two checkers meet each other exactly
    assert a.makespan == b.makespan
    assert b.makespan == pytest.approx(mk, rel=1e-12)
    assert a.checked == b.checked
    # and a wrong claim is rejected by both, for the same reason
    a = ref_certify(ref, ref_sol, reported_makespan=mk * 0.5)
    b = certify_solution(port_instance(ref), port_solution(ref_sol), reported_makespan=mk * 0.5)
    assert not a.ok and not b.ok and a.kinds() == b.kinds()
