"""The plumbing of ``chip_smoke.py`` that needs no GPU: its refusal to run
without one, the candidate batches it builds, the byte/operation bound it
computes and the host-phase timers it wraps around the search round."""
import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import solve
from repro_torch.core import TSParams, random_instance
from repro_torch.core import tabu as port_tabu
from repro_torch.core.eval_batch import BatchEvaluator, PackedSolutions
from repro_torch.kernels import schedule_dp as sdp

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU refusal")
def test_without_a_gpu_it_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr


@pytest.fixture(scope="module")
def operands(smoke):
    inst, cands = smoke.candidate_batch(3, 33, 90, 12)
    assert len(cands) == 12
    return smoke.sweep_operands(inst, cands, np.float64, torch.device("cpu"))


def test_operands_are_what_the_evaluator_hands_the_sweep(operands):
    eng, packed, graph, dur, mpred, msucc = operands
    assert dur.shape == mpred.shape == msucc.shape == (12, 64)
    assert dur.dtype == torch.float64 and mpred.dtype == torch.int32
    ev = eng.evaluate(packed, tails=True)
    start, finish, level, n_done, q = sdp.sweep(graph, dur, mpred, msucc, tails=True)
    feas = (n_done == graph.n).numpy()
    assert np.array_equal(feas, ev.feasible)
    assert 0 < feas.sum() < len(feas)          # mixed cyclic / acyclic rows
    assert np.array_equal(finish.numpy()[feas][:, :graph.n], ev.finish[feas])
    assert np.array_equal(q.numpy()[feas][:, :graph.n], ev.q[feas])


@pytest.mark.parametrize("tails", [False, True])
def test_bound_counts_each_operand_once(smoke, operands, tails):
    _, _, graph, dur, mpred, msucc = operands
    _, finish, _, n_done, _ = sdp.sweep(graph, dur, mpred, msucc, tails=tails)
    b, n_b = dur.shape
    bound = smoke.sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails)
    # forward only: dur 8 + mpred 4 in, start 8 + finish 8 + level 4 out per
    # task, n_done per row, the shared predecessor matrix once; no q
    want = 32 * b * n_b + 4 * b + 4 * graph.pred_mat.numel()
    if tails:                                  # msucc in, q out, successor matrix
        want += (4 + 8) * b * n_b + 4 * graph.succ_mat.numel()
    assert bound["bytes"] == want
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])
    assert bound["bytes_ms"] == want / smoke.HBM_BYTES_PER_S * 1e3
    assert bound["operations"] > 0
    assert bound["bound_by"] in ("bytes", "operations")


def test_bound_operations_follow_the_data(smoke, operands):
    """A cyclic row fires fewer tasks, so it needs fewer operations."""
    _, _, graph, dur, mpred, msucc = operands
    _, finish, _, n_done, _ = sdp.sweep(graph, dur, mpred, msucc, tails=False)
    feas = n_done == graph.n

    def ops(rows):
        return smoke.sweep_bound(graph, dur[rows], mpred[rows], msucc[rows],
                                 finish[rows], n_done[rows], False)["operations"]

    per_feasible = ops(feas) / int(feas.sum())
    per_cyclic = ops(~feas) / int((~feas).sum())
    assert per_cyclic < per_feasible


def test_host_timers_cover_the_round_and_restore_what_they_wrap(smoke):
    before = (BatchEvaluator.evaluate, PackedSolutions.apply_moves,
              port_tabu.memory_update, port_tabu.exact_schedule)
    inst = random_instance(0, n_tasks=40, n_data=90)
    kw = dict(walks=3, seed=0, torch_device="cpu",
              params=TSParams(top_k=10, max_unimproved=10**9, time_limit=10**9, max_iters=5))
    plain = solve(inst, "tabu_multiwalk", **kw)
    with smoke.HostTimers() as log:
        t0 = time.perf_counter()
        rep = solve(inst, "tabu_multiwalk", **kw)
        wall = time.perf_counter() - t0
        host = log.breakdown(wall)
    assert (rep.makespan, rep.history) == (plain.makespan, plain.history)
    assert before == (BatchEvaluator.evaluate, PackedSolutions.apply_moves,
                      port_tabu.memory_update, port_tabu.exact_schedule)
    assert set(host) == set(log.targets) | {"other"}
    for phase in ("evaluate", "backward_tails", "approx_ranking", "memory_update",
                  "exact_schedule", "n7_moves", "change_core_moves"):
        assert host[phase]["calls"] > 0 and host[phase]["s"] > 0, phase
    assert host["other"]["s"] >= 0                 # the phases do not nest
    assert abs(sum(v["s"] for v in host.values()) - wall) < 1e-9
    assert log.max_rows > 0 and log.max_levels > 0
    log.reset()
    assert log.calls["evaluate"] == 0 and log.max_rows == 0
