"""State carried across packages as plain NumPy arrays.

An :class:`~repro_torch.core.mdfg.Instance` or
:class:`~repro_torch.core.solution.Solution` built elsewhere — by another
implementation of the same model, or loaded from disk — enters the port as a
dict of arrays and scalars and leaves it the same way.  The field names are
the dataclass's own, so ``{f: getattr(obj, f) for f in INSTANCE_FIELDS}`` on
any object with the same attributes is a valid input.

A solution's per-processor order (a list of lists) travels as a CSR pair:
``proc_seq_indptr (n_procs + 1,)`` and ``proc_seq_idx (n_tasks,)``.
"""
from __future__ import annotations

import numpy as np

from .core.mdfg import Instance
from .core.solution import Solution

__all__ = [
    "INSTANCE_FIELDS",
    "SOLUTION_FIELDS",
    "instance_from_arrays",
    "instance_to_arrays",
    "solution_from_arrays",
    "solution_to_arrays",
]

# the constructor fields; the pred/succ CSR closure is re-derived from them
INSTANCE_FIELDS = (
    "n_tasks", "n_data", "task_edges", "producer",
    "cons_indptr", "cons_idx", "in_indptr", "in_idx", "out_indptr", "out_idx",
    "proc_time", "data_size", "mem_cap", "access_time", "mem_level",
    "data_mem_ok", "name",
)
_INSTANCE_SCALARS = {"n_tasks": int, "n_data": int, "name": str}
SOLUTION_FIELDS = ("assign", "mem", "proc_seq_indptr", "proc_seq_idx")


def instance_from_arrays(fields: dict) -> Instance:
    """Build an :class:`Instance` from a field dict (arrays are copied, so
    the two sides never share memory).  ``name`` is optional; unknown keys
    (for example the derived ``pred_*``/``succ_*`` arrays) are ignored."""
    missing = [f for f in INSTANCE_FIELDS if f not in fields and f != "name"]
    if missing:
        raise KeyError(f"instance fields missing: {', '.join(missing)}")
    kw = {}
    for f in INSTANCE_FIELDS:
        if f not in fields:
            continue
        cast = _INSTANCE_SCALARS.get(f)
        kw[f] = cast(fields[f]) if cast else np.array(fields[f], copy=True)
    return Instance(**kw)


def instance_to_arrays(inst: Instance) -> dict:
    """The inverse of :func:`instance_from_arrays` (copies)."""
    out = {}
    for f in INSTANCE_FIELDS:
        v = getattr(inst, f)
        out[f] = v if f in _INSTANCE_SCALARS else np.array(v, copy=True)
    return out


def solution_from_arrays(fields: dict) -> Solution:
    """Build a :class:`Solution` from ``assign``, ``mem`` and the CSR form of
    the per-processor order."""
    indptr = np.asarray(fields["proc_seq_indptr"], dtype=np.int64)
    idx = np.asarray(fields["proc_seq_idx"], dtype=np.int64)
    proc_seq = [[int(t) for t in idx[indptr[p]:indptr[p + 1]]]
                for p in range(len(indptr) - 1)]
    return Solution(assign=np.array(fields["assign"], copy=True),
                    mem=np.array(fields["mem"], copy=True),
                    proc_seq=proc_seq)


def solution_to_arrays(sol: Solution) -> dict:
    """The inverse of :func:`solution_from_arrays` (copies)."""
    lens = np.array([len(s) for s in sol.proc_seq], dtype=np.int64)
    indptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    idx = np.array([t for s in sol.proc_seq for t in s], dtype=np.int64)
    return {"assign": np.array(sol.assign, copy=True),
            "mem": np.array(sol.mem, copy=True),
            "proc_seq_indptr": indptr, "proc_seq_idx": idx}
