"""The slice as a whole: ``repro_torch.solve`` (torch backend on the CPU)
against ``repro.solve`` (NumPy backend) on the same instance.  Budgets are
iteration/evaluation counts with an unreachable time limit, so trajectories
are deterministic; everything compared is identical (tolerance 0)."""
import numpy as np
import pytest

import repro
from repro.core import TSParams as RefParams
from repro.core import random_instance as ref_random_instance

import repro_torch
from repro_torch.analysis.certify import certify_solution
from repro_torch.core import TSParams

from torch_port_helpers import port_instance, same_solution

KW = dict(top_k=4, max_unimproved=10**9, time_limit=1e9)
SCALARS = ("makespan", "initial_makespan", "iterations", "n_exact_evals",
           "n_approx_evals", "stop_reason", "feasible", "method")


def run_both(method, seed, n_tasks, budget, **kw):
    ref_inst = ref_random_instance(seed, n_tasks=n_tasks, n_data=2 * n_tasks)
    ref = repro.solve(ref_inst, method, seed=seed,
                      params=RefParams(**KW, **budget), backend="numpy", **kw)
    got = repro_torch.solve(port_instance(ref_inst), method, seed=seed,
                            params=TSParams(**KW, **budget), torch_device="cpu", **kw)
    return ref_inst, ref, got


def assert_same_report(ref, got):
    for f in SCALARS:
        assert getattr(ref, f) == getattr(got, f), f
    assert ref.history == got.history
    assert same_solution(ref.solution, got.solution)


@pytest.mark.parametrize("budget", [{"max_iters": 25}, {"max_evals": 90}])
@pytest.mark.parametrize("seed,n_tasks", [(0, 33), (1, 50)])
def test_tabu_trajectory_identical(seed, n_tasks, budget):
    _, ref, got = run_both("tabu", seed, n_tasks, budget)
    assert_same_report(ref, got)
    assert got.stop_reason in ("max_iters", "max_evals")


@pytest.mark.parametrize("budget", [{"max_iters": 20}, {"max_evals": 150}])
@pytest.mark.parametrize("walks", [1, 3])
@pytest.mark.parametrize("seed,n_tasks", [(0, 33), (2, 65)])
def test_tabu_multiwalk_trajectory_identical(seed, n_tasks, walks, budget):
    _, ref, got = run_both("tabu_multiwalk", seed, n_tasks, budget, walks=walks)
    assert_same_report(ref, got)
    assert got.extras["backend"] == "torch" and got.extras["walks"] == walks
    for a, b in zip(ref.extras["per_walk"], got.extras["per_walk"]):
        assert a["init"] == b["init"] and a["history"] == b["history"]
        assert same_solution(a["solution"], b["solution"])
    assert len(got.history) > 1  # the search moved


@pytest.mark.parametrize("method", ["load_balance", "greedy:slack_first", "greedy:relax_r"])
def test_constructive_solvers_identical(method):
    ref_inst = ref_random_instance(3, n_tasks=48, n_data=100)
    ref = repro.solve(ref_inst, method, seed=3)
    got = repro_torch.solve(port_instance(ref_inst), method, seed=3, torch_device="cpu")
    assert_same_report(ref, got)


def test_w1_multiwalk_reproduces_single_walk_on_torch_backend():
    inst = repro_torch.core.random_instance(1, n_tasks=40, n_data=90)
    p = TSParams(**KW, max_iters=15)
    a = repro_torch.solve(inst, "tabu", seed=1, params=p, torch_device="cpu")
    b = repro_torch.solve(inst, "tabu_multiwalk", walks=1, seed=1, params=p,
                          torch_device="cpu")
    assert a.history == b.history and a.n_exact_evals == b.n_exact_evals
    assert same_solution(a.solution, b.solution)


@pytest.mark.parametrize("backend", ["numpy", "scalar"])
def test_host_oracle_backends_agree_with_torch(backend):
    inst = repro_torch.core.random_instance(2, n_tasks=36, n_data=80)
    p = TSParams(**KW, max_iters=10)
    a = repro_torch.solve(inst, "tabu_multiwalk", walks=2, seed=2, params=p,
                          torch_device="cpu")
    b = repro_torch.solve(inst, "tabu_multiwalk", walks=2, seed=2, params=p,
                          backend=backend)
    assert a.history == b.history and a.makespan == b.makespan
    assert a.n_exact_evals == b.n_exact_evals
    assert same_solution(a.solution, b.solution)


def test_sanitize_mode_certifies_reports(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    inst = repro_torch.core.random_instance(0, n_tasks=33, n_data=70)
    rep = repro_torch.solve(inst, "tabu_multiwalk", walks=2, seed=0,
                            params=TSParams(**KW, max_iters=8), torch_device="cpu")
    assert rep.extras["certified"] is True
    cert = certify_solution(inst, rep.solution, reported_makespan=rep.makespan,
                            claimed_feasible=rep.feasible)
    # independent derivation (event simulation, not the DP): equal to rounding
    assert cert.ok and cert.makespan == pytest.approx(rep.makespan, rel=1e-12)


def test_portfolio_runs_on_the_cpu_device():
    inst = repro_torch.core.random_instance(4, n_tasks=33, n_data=70)
    rep = repro_torch.solve(inst, "portfolio", seed=4,
                            budget=repro_torch.Budget(max_iters=30, time_limit=1e9),
                            torch_device="cpu")
    assert rep.makespan <= min(v for k, v in rep.extras["per_method"].items()
                               if not k.startswith("tabu@"))


def test_default_device_is_the_gpu_and_its_absence_raises():
    import torch

    assert TSParams().backend == "torch" and TSParams().torch_device == "cuda"
    if torch.cuda.is_available():
        return
    inst = repro_torch.core.random_instance(0, n_tasks=31, n_data=60)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.solve(inst, "tabu_multiwalk", walks=2,
                          budget=repro_torch.Budget(max_iters=2))


def test_unported_engine_names_raise():
    """The device engine routes now (``backend="device"``, ``"tabu_device"``);
    what of its surface the port still lacks raises, naming its ROADMAP
    item, and its options need the engine."""
    from repro_torch.core.device_search import DeviceConfig, device_multiwalk
    from repro_torch.core.greedy import construct_greedy

    inst = repro_torch.core.random_instance(0, n_tasks=31, n_data=60)
    budget = repro_torch.Budget(max_iters=3)
    rep = repro_torch.solve(inst, "tabu_multiwalk", backend="device", walks=2,
                            budget=budget, torch_device="cpu")
    assert rep.extras["backend"] == "device" and rep.iterations <= 3
    assert repro_torch.solve(inst, "tabu_device", walks=2, budget=budget,
                             torch_device="cpu").makespan == rep.makespan
    with pytest.raises(ValueError, match="requires backend='device'"):
        repro_torch.solve(inst, "tabu_multiwalk", device={"sync_every": 8},
                          torch_device="cpu")
    # the checkpoint hooks are in (faults.checkpoint): a sync hands one over
    ckpts = []
    device_multiwalk(inst, [construct_greedy(inst, "slack_first", rng=0)],
                     TSParams(torch_device="cpu", max_iters=3),
                     config=DeviceConfig(sync_every=1), on_checkpoint=ckpts.append)
    assert [c.sync_index for c in ckpts] == [1, 2]
