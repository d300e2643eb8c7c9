"""``repro_torch.instances`` bounds and suites against ``repro.instances``:
every lower bound equal (``==``), the same suites with the same items
building the same instance arrays, ``.npz`` files of either package loading
in the other and solving identically, the NumPy ``sweep`` rows equal, and
the device-engine sweep (run eagerly on the CPU) capturing at most once per
bucket and starting where the NumPy sweep starts."""
import importlib

import numpy as np
import pytest
from torch_port_helpers import instance_fields, port_instance

import repro.instances as ref_instances
from repro.core import Budget as RefBudget
from repro.core import solve as ref_solve
from repro.instances import suites as ref_suites

import repro_torch.instances as instances
from repro_torch.core import Budget, solve
from repro_torch.instances import suites

# the modules (each package's ``bounds`` attribute is the function)
ref_bounds = importlib.import_module("repro.instances.bounds")
port_bounds = importlib.import_module("repro_torch.instances.bounds")

SMALL = {
    "random_layered": dict(n_tasks=30, n_data=80),
    "out_tree": dict(n_tasks=31, fanout=2),
    "in_tree": dict(n_tasks=33, fanout=2),
    "fft": dict(width=8),
    "stencil": dict(width=8, steps=4),
}
FAMILIES = sorted(SMALL)
PLANNER_SUITES = ("model_derived", "smoke")


def pair(family, seed=0, **kw):
    """The same instance made by each package's own generator."""
    kw = {**SMALL[family], **kw}
    return (ref_instances.generate(family, seed, **kw), instances.generate(family, seed, **kw))


def same_arrays(a, b) -> bool:
    fa, fb = instance_fields(a), instance_fields(b)
    return all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def test_exports_equal_the_reference():
    assert set(instances.__all__) == set(ref_instances.__all__)


# --------------------------------------------------------------------------- #
# bounds                                                                       #
# --------------------------------------------------------------------------- #
def tight_memory(inst, scale=0.02):
    """The instance with its finite tiers shrunk, so the spill surcharge of
    ``mem_lower_bound`` applies."""
    inst.mem_cap = np.where(np.isfinite(inst.mem_cap), inst.mem_cap * scale, inst.mem_cap)
    return inst


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("tight", [False, True])
def test_bounds_equal_the_reference(family, seed, tight):
    ref, mine = pair(family, seed)
    if tight:
        ref, mine = tight_memory(ref), tight_memory(mine)
    assert same_arrays(ref, mine)
    assert np.array_equal(port_bounds.best_case_durations(mine),
                          ref_bounds.best_case_durations(ref))
    got, want = port_bounds.bounds(mine), ref_bounds.bounds(ref)
    assert got == want
    assert port_bounds.lower_bound(mine) == ref_bounds.lower_bound(ref) == want["lb"]
    for name in ("cp_lower_bound", "work_lower_bound", "mem_lower_bound"):
        assert getattr(port_bounds, name)(mine) == getattr(ref_bounds, name)(ref), name
    if tight and family == "random_layered":
        assert want["mem"] > want["work"]        # the spill branch ran


def test_bounds_of_every_table2_instance_equal_the_reference():
    for ref, mine in zip(ref_suites.get_suite("table2").build(),
                         suites.get_suite("table2").build()):
        assert port_bounds.bounds(mine) == ref_bounds.bounds(ref)
        assert port_bounds.bounds(port_instance(ref)) == ref_bounds.bounds(ref)


# --------------------------------------------------------------------------- #
# suites                                                                       #
# --------------------------------------------------------------------------- #
def test_the_same_suites_with_the_same_items():
    assert suites.list_suites() == ref_suites.list_suites()
    for name in ref_suites.list_suites():
        mine, ref = suites.get_suite(name), ref_suites.get_suite(name)
        assert (mine.name, mine.description, mine.families) == \
            (ref.name, ref.description, ref.families)
        assert [(i.family, i.seed, i.params) for i in mine.items] == \
            [(i.family, i.seed, i.params) for i in ref.items]


@pytest.mark.parametrize("name", sorted(set(ref_suites.list_suites()) - set(PLANNER_SUITES)))
def test_suites_build_the_reference_instances(name):
    mine, ref = suites.get_suite(name).build(), ref_suites.get_suite(name).build()
    assert [i.name for i in mine] == [i.name for i in ref]
    assert [i.family for i in mine] == [i.family for i in ref]
    for a, b in zip(ref, mine):
        assert same_arrays(a, b), a.name
        assert np.array_equal(a.pred_idx, b.pred_idx)


@pytest.mark.parametrize("name", PLANNER_SUITES)
def test_planner_families_raise_naming_what_they_wait_for(name):
    """The suites with model-derived items build now that the planner is
    ported (tests/test_torch_plan.py holds them against the reference's)
    and sweep on the host engine."""
    built = suites.get_suite(name).build()
    assert {"residency", "pipeline"} <= {i.family for i in built}
    report = suites.sweep(name, backend="numpy", budget=Budget(max_iters=2))
    assert len(report.rows) == len(built)


def test_unknown_and_duplicate_suites_raise():
    with pytest.raises(KeyError, match="unknown suite"):
        suites.get_suite("nope")
    with pytest.raises(ValueError, match="already registered"):
        suites.register_suite("table2", [])


# --------------------------------------------------------------------------- #
# .npz round trip, both directions                                            #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_npz_files_cross_packages_and_solve_identically(tmp_path, family, direction):
    ref, mine = pair(family)
    if direction == "reference_to_port":
        path = ref_suites.save_npz(str(tmp_path / "suite"), [ref])
        (back,) = suites.load_npz(path)
    else:
        path = suites.save_npz(str(tmp_path / "suite"), [mine])
        (back,) = ref_suites.load_npz(path)
    assert path.endswith(".npz")
    assert back.name == ref.name and back.family == family
    assert same_arrays(back, ref) and np.array_equal(back.pred_idx, ref.pred_idx)
    a = ref_solve(ref, "tabu", budget=RefBudget(max_iters=10), seed=0)
    if direction == "reference_to_port":
        b = solve(back, "tabu", budget=Budget(max_iters=10), seed=0, backend="numpy")
    else:
        b = ref_solve(back, "tabu", budget=RefBudget(max_iters=10), seed=0)
    assert (a.makespan, a.history, a.n_exact_evals) == (b.makespan, b.history, b.n_exact_evals)
    assert np.array_equal(a.solution.assign, b.solution.assign)


# --------------------------------------------------------------------------- #
# sweep                                                                        #
# --------------------------------------------------------------------------- #
ROW_KEYS = ("name", "family", "n_tasks", "n_data", "makespan", "initial_makespan",
            "iterations", "lb", "lb_parts", "ratio", "certified")


@pytest.mark.parametrize("name", ["trees_small", "stencil_small"])
def test_numpy_sweep_rows_equal_the_reference(name):
    budget = dict(max_iters=6, time_limit=60.0)
    mine = suites.sweep(name, backend="numpy", walks=2, budget=Budget(**budget))
    ref = ref_suites.sweep(name, backend="numpy", walks=2, budget=RefBudget(**budget))
    assert [{k: r[k] for k in ROW_KEYS} for r in mine.rows] == \
        [{k: r[k] for k in ROW_KEYS} for r in ref.rows]
    assert mine.families == ref.families
    assert (mine.suite, mine.solver, mine.backend, mine.buckets, mine.compiles) == \
        (ref.suite, ref.solver, ref.backend, ref.buckets, ref.compiles)
    for row in mine.rows:
        assert row["makespan"] >= row["lb"] - 1e-6 and row["ratio"] >= 1.0 - 1e-9


def test_torch_sweep_on_the_cpu_equals_the_numpy_sweep():
    budget = Budget(max_iters=5, time_limit=60.0)
    a = suites.sweep("trees_small", backend="torch", torch_device="cpu", walks=2, budget=budget)
    b = suites.sweep("trees_small", backend="numpy", walks=2, budget=budget)
    assert [(r["makespan"], r["initial_makespan"], r["iterations"]) for r in a.rows] == \
        [(r["makespan"], r["initial_makespan"], r["iterations"]) for r in b.rows]


def test_device_sweep_captures_once_per_bucket_and_starts_where_numpy_does():
    budget = Budget(max_iters=4, time_limit=120.0)
    dev = suites.sweep("trees_small", backend="device", torch_device="cpu", walks=2,
                       budget=budget, device={"sync_every": 4}, sanitize=True)
    ref = suites.sweep("trees_small", backend="numpy", walks=2, budget=budget)
    assert dev.solver == "tabu_device" and len(dev.rows) == 4
    assert dev.compiles <= dev.buckets and dev.launch_cache is not None
    for r, n in zip(dev.rows, ref.rows):
        assert r["certified"] and r["makespan"] >= r["lb"] - 1e-6
        assert r["initial_makespan"] == n["initial_makespan"]
    again = suites.sweep("trees_small", backend="device", torch_device="cpu", walks=2,
                         budget=budget, device={"sync_every": 4})
    assert again.compiles == 0
    assert [r["makespan"] for r in again.rows] == [r["makespan"] for r in dev.rows]


def test_sweep_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="device config requires"):
        suites.sweep("trees_small", backend="numpy", device={"sync_every": 8})
    with pytest.raises(ValueError, match="not supported"):
        suites.sweep("trees_small", solver="greedy:slack_first", backend="device")
    with pytest.raises(ValueError, match="no per-solver kwargs"):
        suites.sweep("trees_small", backend="device", torch_device="cpu", init="r_first")
    # the port's DeviceConfig has three fields: no donate
    with pytest.raises(TypeError):
        suites.sweep("fft_wide", backend="device", torch_device="cpu",
                     device={"donate": True}, budget=Budget(max_iters=1))


def test_device_sweep_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        suites.sweep("fft_wide", backend="device", budget=Budget(max_iters=1))


def test_walk_inits_match_solver_construction():
    from repro_torch.core.api import multiwalk_inits

    _, inst = pair("fft")
    sols, labels = multiwalk_inits(inst, 3, seed=5)
    assert labels[0] == "slack_first" and len(sols) == 3
    for a, b in zip(sols, suites._walk_inits(inst, 3, seed=5)):
        assert np.array_equal(a.assign, b.assign) and np.array_equal(a.mem, b.mem)
        assert a.proc_seq == b.proc_seq


def test_sweep_accepts_prebuilt_instances_and_aggregates_by_family():
    insts = [instances.generate("fft", 0, width=8), instances.generate("out_tree", 1, n_tasks=31)]
    rep = suites.sweep(insts, solver="greedy:slack_first", backend="numpy")
    ref = ref_suites.sweep([ref_instances.generate("fft", 0, width=8),
                            ref_instances.generate("out_tree", 1, n_tasks=31)],
                           solver="greedy:slack_first", backend="numpy")
    assert rep.suite == "<instances>" and set(rep.families) == {"fft", "out_tree"}
    assert [r["makespan"] for r in rep.rows] == [r["makespan"] for r in ref.rows]
