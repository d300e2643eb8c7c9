"""``repro_torch.instances.batch`` against ``repro.instances.batch``: the same
instances (made by the reference's families and carried over as arrays) pack
into the same padded arrays, shared buckets and bucket groups, and the
port's ``graph_from_pack`` holds the pack's dense matrices and the CSR of the
graph ``dense_graph`` builds."""
import dataclasses

import numpy as np
import pytest
from torch_port_helpers import port_instance

from repro.instances import batch as ref_batch
from repro.instances import generate as ref_generate

from repro_torch.instances import InstanceBatch, group_by_bucket, pack_instance
from repro_torch.instances import batch as port_batch
from repro_torch.kernels import schedule_dp as sdp

CASES = [("random_layered", 0, dict(n_tasks=40, n_data=100)),
         ("random_layered", 3, dict(n_tasks=65, n_data=150)),
         ("out_tree", 1, dict(n_tasks=31)),
         ("in_tree", 2, dict(n_tasks=33)),
         ("fft", 4, dict()),
         ("stencil", 5, dict())]


def both(case):
    family, seed, kw = case
    ref = ref_generate(family, seed, **kw)
    return ref, port_instance(ref)


def same_pack(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert a.bucket_key == b.bucket_key


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_pack_instance_and_ia_from_pack_equal_the_reference(case):
    ref, port = both(case)
    same_pack(pack_instance(port), ref_batch.pack_instance(ref))
    ia, ref_ia = (port_batch.ia_from_pack(pack_instance(port)),
                  ref_batch.ia_from_pack(ref_batch.pack_instance(ref)))
    assert ia.keys() == ref_ia.keys()
    for k in ia:
        assert np.asarray(ia[k]).dtype == np.asarray(ref_ia[k]).dtype, k
        assert np.array_equal(ia[k], ref_ia[k]), k


def test_instance_batch_shares_the_reference_buckets():
    pairs = [both(c) for c in CASES[:2]] + [both(("random_layered", 9, dict(n_tasks=50,
                                                                          n_data=120)))]
    refs, ports = [r for r, _ in pairs], [p for _, p in pairs]
    rb = ref_batch.InstanceBatch.from_instances(refs, widths=(8, 1, 1, 1), e_b=(0, 1024))
    pb = InstanceBatch.from_instances(ports, widths=(8, 1, 1, 1), e_b=(0, 1024))
    assert (pb.n_b, pb.p_b, pb.d_b, pb.widths, pb.e_b, pb.bucket_key) == \
        (rb.n_b, rb.p_b, rb.d_b, rb.widths, rb.e_b, rb.bucket_key)
    for a, b in zip(pb.packs, rb.packs):
        same_pack(a, b)
    arrays, ref_arrays = pb.arrays(), rb.arrays()
    assert arrays.keys() == ref_arrays.keys()
    for k in arrays:
        assert np.array_equal(arrays[k], ref_arrays[k]), k
    with pytest.raises(ValueError, match="at least one"):
        InstanceBatch.from_instances([])


def test_group_by_bucket_equals_the_reference():
    pairs = [both(c) for c in CASES] + [both(("random_layered", 7, dict(n_tasks=40,
                                                                       n_data=100)))]
    assert group_by_bucket([p for _, p in pairs]) == \
        ref_batch.group_by_bucket([r for r, _ in pairs])


@pytest.mark.parametrize("case", CASES[:3], ids=[f"{c[0]}-{c[1]}" for c in CASES[:3]])
def test_graph_from_pack_holds_the_packs_matrices_and_the_dense_graphs_csr(case):
    ref, port = both(case)
    pb = InstanceBatch.from_instances([port], n_b=sdp.bucket(port.n_tasks) + 32)
    g = pb.graph(0)
    pack = pb.packs[0]
    assert (g.n, g.n_b) == (port.n_tasks, pack.n_b)
    assert g.pred_mat is pack.pred_mat and g.succ_mat is pack.succ_mat
    solo = sdp.dense_graph(port, n_bucket=pack.n_b)
    for nm in ("pred_csr", "succ_csr"):
        for a, b in zip(getattr(g, nm), getattr(solo, nm)):
            assert np.array_equal(a, b)
    ref_g = ref_batch.InstanceBatch.from_instances(
        [ref], n_b=sdp.bucket(port.n_tasks) + 32).graph(0)
    assert np.array_equal(g.pred_mat, ref_g.pred_mat)
    assert np.array_equal(g.succ_mat, ref_g.succ_mat)


def test_evaluator_on_a_pack_equals_the_numpy_engine():
    from repro_torch.core.greedy import construct_greedy

    _, port = both(CASES[1])
    pb = InstanceBatch.from_instances([port], n_b=128)
    sols = [construct_greedy(port, s, rng=1) for s in ("slack_first", "r_first")]
    got = pb.evaluator(0, backend="torch", device="cpu").evaluate(sols, tails=True)
    want = pb.evaluator(0, backend="numpy").evaluate(sols, tails=True)
    for name in ("start", "finish", "makespan", "feasible", "q"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
