"""The port's schedule-DP sweeps against the reference package's three
implementations (NumPy engine, XLA gather lowering, the Pallas kernel in
interpret mode) on the same candidate batches, at bucket-edge task counts
with mixed cyclic/acyclic rows.

Tolerances: float64 is **bit-equal** (tolerance 0) — every reduction is a
float max over the same operands and ``finish = start + dur`` adds the same
two numbers.  float32 is held to the reference's own bar for its f32 path:
``rtol=1e-5`` on the makespan, verdicts equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.eval_batch import BatchEvaluator as RefEvaluator
from repro.core.eval_batch import pack_solutions as ref_pack
from repro.kernels import schedule_dp as ref_sdp

from repro_torch.kernels import schedule_dp as sdp

from torch_port_helpers import candidate_batch, padded, port_instance

EDGES = [31, 32, 33, 63, 64, 65]


def reference(inst, cands):
    eng = RefEvaluator(inst, backend="numpy")
    packed = ref_pack(inst, cands)
    ev = eng.evaluate(packed, tails=True)
    return packed, eng._durations(packed), ev


def operands(inst, packed, dur, dtype=np.float64):
    """(host graph of the port, padded dur/mpred/msucc as numpy)."""
    g = sdp.dense_graph(port_instance(inst))
    return g, (padded(dur, 0.0, dtype, g.n_b),
               padded(packed.mpred, -1, np.int64, g.n_b),
               padded(packed.msucc, -1, np.int64, g.n_b))


def port_sweep(g, ops, tails=True):
    out = sdp.sweep(g, *(torch.from_numpy(a) for a in ops), tails=tails)
    return [t.numpy() for t in out]


def ref_sweep(inst, ops, impl, tails=True):
    g = ref_sdp.dense_graph(inst)
    with jax.enable_x64():
        out = ref_sdp.sweep(g, *(jnp.asarray(a) for a in ops), tails=tails, impl=impl)
        return [np.asarray(a) for a in out]


@pytest.mark.parametrize("n_tasks", EDGES)
def test_sweep_f64_bit_equal_to_numpy_engine(n_tasks):
    inst, cands = candidate_batch(n_tasks % 7, n_tasks)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    start, finish, level, n_done, q = port_sweep(g, ops)
    n = inst.n_tasks
    feasible = n_done == n
    assert np.array_equal(feasible, ev.feasible)
    assert (~feasible).sum() > 0 or n_tasks < 40  # batches usually mix in cycles
    f = ev.feasible
    assert np.array_equal(start[f, :n], ev.start[f])
    assert np.array_equal(finish[f, :n], ev.finish[f])
    assert np.array_equal(level[f, :n], ev.level[f])
    assert np.array_equal(q[:, :n], ev.q)
    # padding tasks never fire
    assert not start[:, n:].any() and not finish[:, n:].any() and not q[:, n:].any()
    assert start.dtype == np.float64 and level.dtype == np.int32 and n_done.dtype == np.int32


@pytest.mark.parametrize("n_tasks", EDGES)
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_sweep_f64_bit_equal_to_reference_kernels(n_tasks, impl):
    inst, cands = candidate_batch(n_tasks % 7, n_tasks)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    ours = port_sweep(g, ops)
    theirs = ref_sweep(inst, ops, impl)
    f = ev.feasible
    assert np.array_equal(ours[3], theirs[3])                  # n_done
    for a, b in zip(ours[:3], theirs[:3]):                     # start, finish, level
        assert np.array_equal(a[f], b[f])
    assert np.array_equal(ours[4], theirs[4])                  # q, every row
    if impl == "xla":  # same formulation: cyclic rows agree entry for entry too
        for a, b in zip(ours[:3], theirs[:3]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n_tasks", [33, 64])
def test_forward_only_shape(n_tasks):
    inst, cands = candidate_batch(1, n_tasks)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    with_tails = port_sweep(g, ops, tails=True)
    fwd = port_sweep(g, ops, tails=False)
    theirs = ref_sweep(inst, ops, "xla", tails=False)
    for a, b, c in zip(fwd[:4], with_tails[:4], theirs[:4]):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert fwd[4].shape == ops[0].shape and not fwd[4].any()


@pytest.mark.parametrize("n_tasks", [31, 65])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_only_shape_with_active_rows(n_tasks, masked):
    inst, cands = candidate_batch(3, n_tasks)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    node = padded(ev.finish - ev.start, 0.0, np.float64, g.n_b)
    node[~ev.feasible] = 0.0
    active = ev.feasible.copy()
    if masked:
        active[::3] = False
    rg = ref_sdp.dense_graph(inst)
    with jax.enable_x64():
        theirs = np.asarray(ref_sdp.backward_q_xla(
            jnp.asarray(rg.succ_mat), jnp.asarray(node), jnp.asarray(ops[2]),
            inst.n_tasks, jnp.asarray(active)[:, None]))
    ours = sdp.backward_q(g, torch.from_numpy(node), torch.from_numpy(ops[2]),
                          torch.from_numpy(active)).numpy()
    assert np.array_equal(ours, theirs)
    assert not ours[~active].any()
    n = inst.n_tasks
    keep = active & ev.feasible
    assert np.array_equal(ours[keep, :n], ev.q[keep])
    # the building block itself, called as the reference's is
    direct = sdp.backward_q_torch(
        torch.from_numpy(g.succ_mat), torch.from_numpy(node),
        torch.from_numpy(ops[2]), n, torch.from_numpy(active)[:, None]).numpy()
    assert np.array_equal(direct, theirs)


@pytest.mark.parametrize("n_tasks", [32, 63])
def test_sweep_f32_meets_reference_f32_bar(n_tasks):
    inst, cands = candidate_batch(2, n_tasks)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur, dtype=np.float32)
    start, finish, level, n_done, q = port_sweep(g, ops)
    assert finish.dtype == np.float32
    feasible = n_done == inst.n_tasks
    assert np.array_equal(feasible, ev.feasible)
    f = ev.feasible
    assert np.allclose(finish[f].max(axis=1), ev.makespan[f], rtol=1e-5)
    assert np.array_equal(level[f, : inst.n_tasks], ev.level[f])


def test_level_loop_matches_reference_level_loop():
    inst, cands = candidate_batch(5, 40)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    rg = ref_sdp.dense_graph(inst)
    b = packed.k
    with jax.enable_x64():
        theirs = ref_sdp.level_loop_xla(
            jnp.asarray(rg.pred_mat), jnp.asarray(ops[1]), jnp.asarray(ops[0]),
            inst.n_tasks, jnp.ones((b, 1), bool))
        theirs = [np.asarray(a) for a in theirs]
    ours = sdp.level_loop_torch(
        torch.from_numpy(g.pred_mat), torch.from_numpy(ops[1]).to(torch.int32),
        torch.from_numpy(ops[0]), inst.n_tasks, torch.ones((b, 1), dtype=torch.bool))
    for a, b_ in zip(ours, theirs):
        assert np.array_equal(a.numpy(), b_)


def test_bucket_rounds_up_to_quantum():
    for n in (1, 31, 32, 33, 64, 65, 250):
        assert sdp.bucket(n) == ref_sdp.bucket(n)
    assert sdp.bucket(1) == 32 and sdp.bucket(33) == 64 and sdp.bucket(250) == 256


def test_dense_graph_matches_csr_and_reference():
    inst, _ = candidate_batch(3, 40)
    g = sdp.dense_graph(port_instance(inst))
    rg = ref_sdp.dense_graph(inst)
    assert (g.n, g.n_b) == (rg.n, rg.n_b)
    assert np.array_equal(g.pred_mat, rg.pred_mat)
    assert np.array_equal(g.succ_mat, rg.succ_mat)
    assert g.pred_mat.dtype == np.int32 and g.pred_mat.shape[1] >= 1
    for t in range(inst.n_tasks):
        assert sorted(int(x) for x in inst.preds(t)) == \
            sorted(int(x) for x in g.pred_mat[t] if x >= 0)
    dev = g.to("cpu")
    assert isinstance(dev.pred_mat, torch.Tensor) and dev.pred_mat.dtype == torch.int32
    assert np.array_equal(dev.succ_mat.numpy(), g.succ_mat)


def _csr_rows(indptr, idx):
    return [list(idx[indptr[r]:indptr[r + 1]]) for r in range(len(indptr) - 1)]


@pytest.mark.parametrize("n_tasks", EDGES + [250])
def test_csr_holds_the_dense_slots_in_slot_order(n_tasks):
    """The CSR the kernel reads: every real slot of pred_mat / succ_mat, in
    the row's slot order, no -1 slot, int32, one offset per task + 1."""
    inst, _ = candidate_batch(n_tasks % 7, n_tasks, n_data=600 if n_tasks == 250 else 90)
    g = sdp.dense_graph(port_instance(inst))
    for mat, (indptr, idx) in ((g.pred_mat, g.pred_csr), (g.succ_mat, g.succ_csr)):
        assert indptr.dtype == np.int32 and idx.dtype == np.int32
        assert indptr.shape == (g.n_b + 1,) and indptr[0] == 0 and indptr[-1] == len(idx)
        assert not (idx < 0).any()
        assert _csr_rows(indptr, idx) == [[x for x in row if x >= 0] for row in mat]
    assert len(g.pred_csr[1]) == len(g.succ_csr[1]) == len(inst.pred_idx)
    # padding scattered inside the rows (columns reversed, one -1 column put
    # first): the same links, in the new slot order
    mat = np.concatenate([np.full((g.n_b, 1), -1, np.int32), g.pred_mat[:, ::-1]], axis=1)
    indptr, idx = sdp.csr_from_dense(mat)
    assert _csr_rows(indptr, idx) == [[x for x in row if x >= 0][::-1] for row in g.pred_mat]


def test_csr_is_built_once_per_graph_not_per_launch(monkeypatch):
    """The host graph builds its CSR once; ``to`` carries it to the device;
    the evaluator's cached device graph hands the same tensors to every
    sweep."""
    from repro_torch.core.eval_batch import BatchEvaluator
    from repro_torch.core.eval_batch import pack_solutions as port_pack

    from torch_port_helpers import port_solution

    calls = []
    orig = sdp.csr_from_dense
    monkeypatch.setattr(sdp, "csr_from_dense", lambda mat: calls.append(1) or orig(mat))
    inst, cands = candidate_batch(4, 64)
    pinst = port_instance(inst)
    eng = BatchEvaluator(pinst, backend="torch", device="cpu")
    packed = port_pack(pinst, [port_solution(c) for c in cands])
    eng.evaluate(packed, tails=True)
    assert len(calls) == 2                              # pred and succ, once each
    (dev_graph,) = list(eng._dev_graphs._d.values())
    first = dev_graph.pred_csr
    eng.evaluate(packed, tails=True)
    eng.evaluate(packed, tails=False)
    assert len(calls) == 2 and dev_graph.pred_csr is first
    assert isinstance(first[0], torch.Tensor) and first[0].dtype == torch.int32
    host = eng._graph
    assert np.array_equal(first[1].numpy(), host.pred_csr[1])
    again = host.to("cpu")
    assert len(calls) == 2 and torch.equal(again.succ_csr[1], dev_graph.succ_csr[1])


def test_wrapper_dispatch_rules():
    inst, cands = candidate_batch(0, 31)
    packed, dur, ev = reference(inst, cands)
    g, ops = operands(inst, packed, dur)
    dur_t, mpred_t, msucc_t = (torch.from_numpy(a) for a in ops)
    pred_t, succ_t = torch.from_numpy(g.pred_mat), torch.from_numpy(g.succ_mat)
    before = sdp.sweep.launches
    # CPU tensors route to the plain version, whatever the call, and count no launch
    for tails in (False, True):
        got = sdp.sweep(g, dur_t, mpred_t, msucc_t, tails=tails)
        want = sdp.sweep_torch(pred_t, succ_t, dur_t, mpred_t, msucc_t, g.n, tails=tails)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    start, finish, _, n_done, _ = got
    active = n_done == g.n
    got_q = sdp.backward_q(g, finish - start, msucc_t, active)
    want_q = sdp.backward_q_torch(succ_t, finish - start, msucc_t, g.n, active[:, None])
    assert torch.equal(got_q, want_q)
    assert sdp.sweep.launches == before
    with pytest.raises(TypeError, match="impl"):        # the route is the device's alone
        sdp.sweep(g, dur_t, mpred_t, msucc_t, impl="torch")
    assert sdp.MAX_TASKS == 8192                        # 1,024 threads x 8 tasks
