"""State carried across packages: Instance/Solution round trips through
plain NumPy field dicts."""
import numpy as np
import pytest

from repro.core import random_instance as ref_random_instance
from repro.core.greedy import construct_greedy as ref_construct_greedy

from repro_torch import convert
from repro_torch.core.mdfg import Instance, validate_instance
from repro_torch.core.solution import Solution, exact_schedule

from torch_port_helpers import (
    instance_fields,
    port_instance,
    port_solution,
    same_instance,
    same_solution,
    solution_fields,
)


@pytest.mark.parametrize("seed,n_tasks", [(0, 31), (1, 40), (2, 65)])
def test_instance_crosses_and_round_trips(seed, n_tasks):
    ref = ref_random_instance(seed, n_tasks=n_tasks, n_data=90)
    inst = port_instance(ref)
    assert isinstance(inst, Instance)
    validate_instance(inst)
    assert same_instance(ref, inst)
    back = convert.instance_from_arrays(convert.instance_to_arrays(inst))
    assert same_instance(inst, back)
    assert back.name == ref.name


def test_instance_arrays_are_copies():
    ref = ref_random_instance(0, n_tasks=31, n_data=60)
    inst = port_instance(ref)
    inst.proc_time[0, 0] += 1.0
    assert ref.proc_time[0, 0] != inst.proc_time[0, 0]
    arrs = convert.instance_to_arrays(inst)
    arrs["data_size"][0] += 1
    assert inst.data_size[0] != arrs["data_size"][0]


def test_instance_missing_field_raises():
    ref = ref_random_instance(0, n_tasks=31, n_data=60)
    fields = instance_fields(ref)
    del fields["proc_time"]
    with pytest.raises(KeyError, match="proc_time"):
        convert.instance_from_arrays(fields)


@pytest.mark.parametrize("strategy", ["slack_first", "relax_r"])
def test_solution_crosses_and_round_trips(strategy):
    ref = ref_random_instance(3, n_tasks=40, n_data=90)
    ref_sol = ref_construct_greedy(ref, strategy, rng=3)
    sol = port_solution(ref_sol)
    assert isinstance(sol, Solution)
    assert same_solution(ref_sol, sol)
    back = convert.solution_from_arrays(convert.solution_to_arrays(sol))
    assert same_solution(sol, back)
    fields = solution_fields(ref_sol)
    again = convert.solution_to_arrays(sol)
    assert all(np.array_equal(fields[k], again[k]) for k in convert.SOLUTION_FIELDS)
    assert exact_schedule(port_instance(ref), back) is not None
