"""Tests of the port that need an NVIDIA GPU and ``nvcc``: the CUDA
schedule-DP kernel against its plain PyTorch version, bit for bit, and the
evaluator on the card against the NumPy engine.  They import the port only
(no JAX, no reference package), skip with a reason where there is no GPU,
and run on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import random_instance
from repro_torch.core.eval_batch import BatchEvaluator, pack_solutions
from repro_torch.core.greedy import construct_greedy
from repro_torch.core.solution import exact_schedule, heads_tails
from repro_torch.core.tabu import _cc_moves, _n7_moves, apply_move
from repro_torch.kernels import schedule_dp as sdp

pytestmark = pytest.mark.gpu

EDGES = [31, 32, 33, 63, 64, 65]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: torch.cuda.is_available() is False")
    return torch.device("cuda")


def candidate_batch(seed, n_tasks, n_data=90, max_k=24):
    inst = random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    sol = construct_greedy(inst, "slack_first", rng=seed)
    sched = exact_schedule(inst, sol)
    r, _, _, crit = heads_tails(inst, sol, sched)
    moves = _n7_moves(sol, crit) + _cc_moves(inst, sol, crit, r, sched.start, 5)
    cands = [sol]
    for m in moves[:: max(1, len(moves) // (max_k - 1))][: max_k - 1]:
        c = sol.copy()
        apply_move(c, m)
        cands.append(c)
    return inst, cands


def operands(inst, cands, dtype, device):
    eng = BatchEvaluator(inst, backend="numpy")
    packed = pack_solutions(inst, cands)
    dur = eng._durations(packed)
    g = sdp.dense_graph(inst)

    def up(a, fill, dt):
        out = np.full((packed.k, g.n_b), fill, dtype=dt)
        out[:, : inst.n_tasks] = a
        return torch.from_numpy(out).to(device)

    return g.to(device), up(dur, 0.0, dtype), up(packed.mpred, -1, np.int32), \
        up(packed.msucc, -1, np.int32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_tasks", EDGES)
def test_cuda_kernel_equals_plain_version(cuda_device, n_tasks, dtype):
    inst, cands = candidate_batch(n_tasks % 7, n_tasks)
    g, dur, mpred, msucc = operands(inst, cands, dtype, cuda_device)
    for tails in (False, True):
        before = sdp.sweep.launches
        got = sdp.sweep(g, dur, mpred, msucc, tails=tails)
        torch.cuda.synchronize()
        assert sdp.sweep.launches == before + 1
        want = sdp.sweep_torch(g.pred_mat, g.succ_mat, dur, mpred, msucc, g.n, tails=tails)
        for a, b in zip(got, want):
            assert torch.equal(a, b)                    # tolerance 0


def test_cuda_backward_only_with_active_rows(cuda_device):
    inst, cands = candidate_batch(3, 65)
    g, dur, mpred, msucc = operands(inst, cands, np.float64, cuda_device)
    start, finish, _, n_done, q = sdp.sweep(g, dur, mpred, msucc, tails=True)
    active = n_done == g.n
    active[::3] = False
    got = sdp.backward_q(g, finish - start, msucc, active)
    torch.cuda.synchronize()
    want = sdp.backward_q_torch(g.succ_mat, finish - start, msucc, g.n, active[:, None])
    assert torch.equal(got, want)
    assert torch.equal(got[active], q[active]) and not got[~active].any()


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    inst, cands = candidate_batch(0, 31)
    g, dur, mpred, msucc = operands(inst, cands, np.float64, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        sdp.sweep(g, dur.to(torch.float16), mpred, msucc)
    with pytest.raises(ValueError, match="contiguous"):
        sdp.sweep(g, dur.t().contiguous().t(), mpred, msucc)
    with pytest.raises(ValueError, match="expected"):
        sdp.sweep(g, dur, mpred.cpu(), msucc)
    with pytest.raises(TypeError, match="DenseGraph.to"):
        sdp.sweep(sdp.dense_graph(inst), dur, mpred, msucc)
    with pytest.raises(ValueError, match="padded to"):
        sdp.sweep(g, dur[:, :16].contiguous(), mpred[:, :16].contiguous(),
                  msucc[:, :16].contiguous())


def test_evaluator_on_the_card_equals_numpy_engine(cuda_device):
    inst, cands = candidate_batch(2, 64)
    ref = BatchEvaluator(inst, backend="numpy").evaluate(cands, tails=True, peaks=True)
    before = sdp.sweep.launches
    ev = BatchEvaluator(inst).evaluate(cands, tails=True, peaks=True)   # torch on cuda
    assert sdp.sweep.launches == before + 1
    f = ref.feasible
    assert np.array_equal(ev.feasible, f) and np.array_equal(ev.makespan, ref.makespan)
    for name in ("start", "finish", "level", "slack", "critical", "peaks"):
        assert np.array_equal(getattr(ev, name)[f], getattr(ref, name)[f]), name
    assert np.array_equal(ev.q, ref.q) and np.array_equal(ev.mem_ok, ref.mem_ok)
