"""Helpers shared by the ``test_torch_*`` parity tests: the same data goes
through ``repro`` (the JAX/NumPy reference package) and ``repro_torch`` (the
PyTorch/CUDA port) as plain NumPy arrays."""
import numpy as np
import torch

from repro.core import random_instance as ref_random_instance
from repro.core.greedy import construct_greedy as ref_construct_greedy
from repro.core.solution import exact_schedule as ref_exact_schedule
from repro.core.solution import heads_tails as ref_heads_tails
from repro.core.tabu import _cc_moves, _n7_moves, apply_move

from repro_torch import convert

# The tensors here are tiny: one intra-op thread is as fast as many, and it
# keeps several test worker processes from oversubscribing the cores.
torch.set_num_threads(1)


def instance_fields(inst) -> dict:
    """Field dict of any object shaped like an ``Instance``."""
    return {f: getattr(inst, f) for f in convert.INSTANCE_FIELDS}


def solution_fields(sol) -> dict:
    lens = np.array([len(s) for s in sol.proc_seq], dtype=np.int64)
    indptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    return {"assign": sol.assign, "mem": sol.mem, "proc_seq_indptr": indptr,
            "proc_seq_idx": np.array([t for s in sol.proc_seq for t in s],
                                     dtype=np.int64)}


def port_instance(inst):
    """A ``repro`` Instance as a ``repro_torch`` Instance."""
    return convert.instance_from_arrays(instance_fields(inst))


def port_solution(sol):
    return convert.solution_from_arrays(solution_fields(sol))


def same_instance(a, b) -> bool:
    fa, fb = instance_fields(a), instance_fields(b)
    derived = ("pred_indptr", "pred_idx", "succ_indptr", "succ_idx")
    return all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa) \
        and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in derived)


def same_solution(a, b) -> bool:
    return (np.array_equal(a.assign, b.assign) and np.array_equal(a.mem, b.mem)
            and [list(map(int, s)) for s in a.proc_seq]
            == [list(map(int, s)) for s in b.proc_seq])


def candidate_batch(seed, n_tasks, n_data=90, max_k=24):
    """A mixed feasible/cyclic candidate batch from a real neighborhood,
    built with the reference package (as ``tests/test_schedule_dp.py``)."""
    inst = ref_random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    sol = ref_construct_greedy(inst, "slack_first", rng=seed)
    sched = ref_exact_schedule(inst, sol)
    r, q, _, crit = ref_heads_tails(inst, sol, sched)
    moves = _n7_moves(sol, crit) + _cc_moves(inst, sol, crit, r, sched.start, 5)
    cands = [sol]
    for m in moves[: max_k - 1]:
        c = sol.copy()
        apply_move(c, m)
        cands.append(c)
    return inst, cands


def padded(a, fill, dtype, n_b):
    k, n = a.shape
    out = np.full((k, n_b), fill, dtype=dtype)
    out[:, :n] = a
    return out
