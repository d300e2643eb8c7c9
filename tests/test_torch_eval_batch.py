"""``BatchEvaluator(backend="torch", device="cpu")`` against the reference
package's NumPy engine: every output equal (tolerance 0), the uploaded-graph
cache counters, and the device/backend rules."""
import numpy as np
import pytest
import torch

from repro.core.eval_batch import BatchEvaluator as RefEvaluator
from repro.core.eval_batch import PackedSolutions as RefPacked

import repro_torch.core.eval_batch as eb
from repro_torch._device import resolve_device
from repro_torch.core.eval_batch import BatchEvaluator, PackedSolutions

from torch_port_helpers import candidate_batch, port_instance, port_solution

FIELDS = ("start", "finish", "level", "feasible", "makespan", "q", "slack",
          "critical", "peaks", "mem_ok")


def both(seed, n_tasks, **kw):
    inst, cands = candidate_batch(seed, n_tasks, **kw)
    return inst, cands, port_instance(inst), [port_solution(c) for c in cands]


@pytest.mark.parametrize("backend", ["torch", "numpy", "scalar"])
@pytest.mark.parametrize("seed,n_tasks", [(0, 31), (1, 33), (2, 64), (3, 65)])
def test_evaluate_equals_reference_numpy_engine(backend, seed, n_tasks):
    inst, cands, pinst, pcands = both(seed, n_tasks)
    ref = RefEvaluator(inst, backend="numpy").evaluate(cands, tails=True, peaks=True)
    ev = BatchEvaluator(pinst, backend=backend, device="cpu").evaluate(
        pcands, tails=True, peaks=True)
    f = ref.feasible
    assert np.array_equal(ev.feasible, f) and (~f).any()
    for name in FIELDS:
        a, b = getattr(ev, name), getattr(ref, name)
        if name == "level" and backend == "scalar":
            continue  # the scalar oracle reports topo positions, not levels
        if name in ("start", "finish", "level", "slack", "critical", "peaks"):
            assert np.array_equal(a[f], b[f]), name     # undefined on cyclic rows
        else:
            assert np.array_equal(a, b), name


def test_forward_only_has_no_tails():
    inst, cands, pinst, pcands = both(4, 40)
    ref = RefEvaluator(inst, backend="numpy").evaluate(cands)
    ev = BatchEvaluator(pinst, backend="torch", device="cpu").evaluate(pcands)
    assert ev.q is None and ev.slack is None and ev.peaks is None
    assert np.array_equal(ev.makespan, ref.makespan)
    assert ev.start.dtype == np.float64 and ev.level.dtype == np.int64
    for i in np.nonzero(ref.feasible)[0][:3]:
        a, b = ev.schedule(int(i)), ref.schedule(int(i))
        assert np.array_equal(a.topo, b.topo) and a.makespan == b.makespan
    assert ev.schedule(int(np.nonzero(~ref.feasible)[0][0])) is None


def test_packed_state_moves_evaluate_alike():
    """The search's own call shape: apply_moves on the packed state."""
    from repro.core.eval_batch import MoveBatch as RefMoveBatch
    from repro.core.solution import exact_schedule, heads_tails
    from repro.core.tabu import _n7_move_batch

    inst, cands, pinst, pcands = both(5, 48, max_k=2)
    packed = RefPacked.from_solutions(inst, cands[:1])
    sched = exact_schedule(inst, cands[0])
    crit = heads_tails(inst, cands[0], sched)[3]
    mb = _n7_move_batch(packed, 0, crit)
    assert len(mb) > 0
    rows = np.zeros(len(mb), dtype=np.int64)
    ref = RefEvaluator(inst, backend="numpy").evaluate(packed.apply_moves(rows, mb))
    ppacked = PackedSolutions.from_solutions(pinst, pcands[:1])
    pmb = eb.MoveBatch(**{f: getattr(mb, f).copy() for f in
                          ("cc", "task", "src_proc", "src_pos", "dst_proc", "dst_pos")})
    assert isinstance(mb, RefMoveBatch)
    ev = BatchEvaluator(pinst, backend="torch", device="cpu").evaluate(
        ppacked.apply_moves(rows, pmb))
    assert np.array_equal(ev.feasible, ref.feasible)
    assert np.array_equal(ev.makespan, ref.makespan)


def test_cache_info_counts_graph_uploads():
    inst, cands, pinst, pcands = both(2, 40)
    eng = BatchEvaluator(pinst, backend="torch", device="cpu")
    assert set(eng.cache_info()) >= {"hits", "misses", "currsize", "maxsize"}
    eng.evaluate(pcands)
    info = eng.cache_info()
    assert info["misses"] == 1 and info["currsize"] == 1 and info["hits"] == 0
    eng.evaluate(pcands[:5], tails=True)     # another K, same bucket: a hit
    info = eng.cache_info()
    assert info["hits"] == 1 and info["currsize"] == 1
    assert BatchEvaluator(pinst, backend="numpy").cache_info()["currsize"] == 0


def test_backward_tails_runs_on_the_host_sweep():
    inst, cands, pinst, pcands = both(1, 40)
    eng = BatchEvaluator(pinst, backend="torch", device="cpu")
    ev = eng.evaluate(pcands, tails=True)
    packed = eb.pack_solutions(pinst, pcands)
    q = eng.backward_tails(packed, ev.finish - ev.start, ev.feasible)
    assert np.array_equal(q, ev.q)


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    _, _, pinst, pcands = both(0, 31)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchEvaluator(pinst)                      # defaults: torch on cuda
    with pytest.raises(RuntimeError, match="cuda"):
        BatchEvaluator(pinst, backend="torch", device="cuda:0")
    with pytest.raises(RuntimeError, match="cuda"):
        eb.batch_evaluate(pinst, pcands)
    # host oracles never touch the device argument
    BatchEvaluator(pinst, backend="numpy").evaluate(pcands)


def test_backend_and_device_names_are_checked():
    _, _, pinst, _ = both(0, 31)
    assert eb.BACKENDS == ("torch", "numpy", "scalar")
    with pytest.raises(ValueError, match="backend must be one of"):
        BatchEvaluator(pinst, backend="jax", device="cpu")
    assert eb.check_backend("device") == "device"      # the search's own engine
    with pytest.raises(ValueError, match="no per-batch evaluator"):
        BatchEvaluator(pinst, backend="device", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        eb.check_backend("jax")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        BatchEvaluator(pinst, backend="torch", device="meta")
    assert resolve_device("cpu") == torch.device("cpu")
