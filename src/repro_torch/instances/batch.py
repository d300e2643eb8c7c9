"""Packed instance batches — the single array-form boundary for every engine.

The conversion of an :class:`~repro_torch.core.mdfg.Instance` into padded
arrays happens exactly once, here:

* :class:`InstancePack` — bucket-padded struct-of-arrays form of ONE
  instance (dense predecessor/successor index matrices, padded CSR edge
  lists with owner/valid companions, padded platform matrices).
* :class:`InstanceBatch` — a *shape-bucketed batch*: N instances padded to
  shared buckets (task/data counts to 32-multiples, edge lists to
  128-multiples — the quanta the device engine's captured rounds are keyed
  on), with per-instance real sizes riding along as scalars.  ``validate``
  runs once at construction; every consumer downstream
  (``eval_batch.BatchEvaluator``, ``kernels.schedule_dp``,
  ``device_search.solve_instances``) reads the padded arrays from here
  instead of re-deriving them.

Bucketing guarantees: two batches whose instances share ``bucket_key`` can
reuse one captured device round (the launch LRU in ``device_search`` is
keyed on exactly these numbers), so a sweep over a suite captures once per
bucket instead of once per instance.  NumPy only.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..core.mdfg import Instance, validate_instance

__all__ = [
    "InstancePack",
    "InstanceBatch",
    "pack_instance",
    "ia_from_pack",
    "group_by_bucket",
    "EDGE_QUANTUM",
]

_I32 = np.int32

# edge lists pad to this multiple (matches the device engine's historical
# 128-quantum; task/data axes use kernels.schedule_dp.bucket's 32-quantum)
EDGE_QUANTUM = 128


# --------------------------------------------------------------------------- #
# single-instance pack                                                         #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class InstancePack:
    """Bucket-padded array form of one instance (host numpy)."""

    n: int            # real task count
    p: int            # real proc count
    d: int            # real data count
    n_b: int
    p_b: int
    s_b: int          # seq capacity = n_b + 1
    d_b: int
    pred_mat: np.ndarray    # (n_b, Dp) int32, -1 pad
    succ_mat: np.ndarray    # (n_b, Ds) int32
    in_blk: np.ndarray      # (n_b, Din) int32, -1 pad (CSR order per task)
    out_blk: np.ndarray     # (n_b, Dout) int32
    in_idx: np.ndarray      # (E_in,) int32 padded, with valid mask
    in_owner: np.ndarray    # (E_in,) int32
    in_valid: np.ndarray    # (E_in,) bool
    in_ptr: np.ndarray      # (n_b + 1,) int32 (pad tasks repeat the end)
    out_idx: np.ndarray
    out_owner: np.ndarray
    out_valid: np.ndarray
    out_ptr: np.ndarray
    proc_time: np.ndarray   # (n_b, p_b) f64; pad tasks 0.0, pad procs +inf
    access_time: np.ndarray  # (p_b, n_mems) f64 (pad procs repeat row 0)
    data_size: np.ndarray   # (d_b,) f64 (pads 0)
    compat: np.ndarray      # (n_b, p_b) bool

    @property
    def bucket_key(self) -> tuple:
        """Everything a captured launch's shape depends on."""
        return (self.n_b, self.p_b, self.d_b,
                self.pred_mat.shape[1], self.succ_mat.shape[1],
                self.in_blk.shape[1], self.out_blk.shape[1],
                len(self.in_idx), len(self.out_idx))


def _padded_edge_len(e: int, e_b: int = 0, quantum: int = EDGE_QUANTUM) -> int:
    """Quantized edge-list length; the single source of truth shared by
    the actual padding (``_pad_csr``) and the batch bucket computation
    (``InstanceBatch.from_instances``) — they must agree for ``bucket_key``
    to describe the real array shapes."""
    return max(e_b, quantum * ((e + quantum - 1) // quantum), quantum)


def _pad_csr(n: int, n_b: int, indptr, idx, e_b: int,
             quantum: int = EDGE_QUANTUM):
    e = len(idx)
    e_b = _padded_edge_len(e, e_b, quantum)
    out_idx = np.zeros(e_b, dtype=_I32)
    out_idx[:e] = idx
    owner = np.zeros(e_b, dtype=_I32)
    owner[:e] = np.repeat(np.arange(n), np.diff(indptr))
    valid = np.zeros(e_b, dtype=bool)
    valid[:e] = True
    ptr = np.full(n_b + 1, indptr[-1], dtype=_I32)
    ptr[: n + 1] = indptr
    return out_idx, owner, valid, ptr, e_b


def _dense_blocks(n: int, n_b: int, indptr, idx, width: int) -> np.ndarray:
    from ..kernels.schedule_dp import dense_from_csr

    return dense_from_csr(n, n_b, indptr, idx, min_width=width)


def pack_instance(inst: Instance, *, n_b: int | None = None,
                  p_b: int | None = None, d_b: int | None = None,
                  widths: tuple[int, int, int, int] = (1, 1, 1, 1),
                  e_b: tuple[int, int] = (0, 0)) -> InstancePack:
    from ..kernels import schedule_dp as sdp

    n, p, d = inst.n_tasks, inst.n_procs, inst.n_data
    n_b = n_b or sdp.bucket(n)
    p_b = p_b or p
    d_b = d_b or sdp.bucket(d)
    in_idx, in_owner, in_valid, in_ptr, _ = _pad_csr(
        n, n_b, inst.in_indptr, inst.in_idx, e_b[0])
    out_idx, out_owner, out_valid, out_ptr, _ = _pad_csr(
        n, n_b, inst.out_indptr, inst.out_idx, e_b[1])
    pt = np.full((n_b, p_b), np.inf)
    pt[:n, :p] = inst.proc_time
    pt[n:, :] = 0.0  # pad tasks: zero duration everywhere
    at = np.zeros((p_b, inst.n_mems))
    at[:p] = inst.access_time
    at[p:] = inst.access_time[0]
    ds = np.zeros(d_b)
    ds[:d] = inst.data_size
    compat = np.zeros((n_b, p_b), dtype=bool)
    compat[:n, :p] = np.isfinite(inst.proc_time)
    return InstancePack(
        n=n, p=p, d=d, n_b=n_b, p_b=p_b, s_b=n_b + 1, d_b=d_b,
        pred_mat=_dense_blocks(n, n_b, inst.pred_indptr, inst.pred_idx, widths[0]),
        succ_mat=_dense_blocks(n, n_b, inst.succ_indptr, inst.succ_idx, widths[1]),
        in_blk=_dense_blocks(n, n_b, inst.in_indptr, inst.in_idx, widths[2]),
        out_blk=_dense_blocks(n, n_b, inst.out_indptr, inst.out_idx, widths[3]),
        in_idx=in_idx, in_owner=in_owner, in_valid=in_valid, in_ptr=in_ptr,
        out_idx=out_idx, out_owner=out_owner, out_valid=out_valid,
        out_ptr=out_ptr, proc_time=pt, access_time=at, data_size=ds,
        compat=compat,
    )


def ia_from_pack(ip: InstancePack) -> dict:
    """Instance arrays as a dict of launch arguments (stackable over a
    leading instance axis for the batch sweep).  ``n``/``p`` ride along as scalars so
    per-instance real sizes survive shared-bucket padding."""
    out = {f.name: np.asarray(getattr(ip, f.name))
           for f in dataclasses.fields(InstancePack)
           if f.name not in ("n", "p", "d", "n_b", "p_b", "s_b", "d_b")}
    out["n"] = np.int64(ip.n)
    out["p"] = np.int64(ip.p)
    return out


# --------------------------------------------------------------------------- #
# shape-bucketed batch                                                         #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class InstanceBatch:
    """N instances padded to shared shape buckets — the one conversion point.

    Construction validates every instance exactly once
    (:func:`~repro_torch.core.mdfg.validate_instance`) and computes the shared
    buckets in a single pass over the raw CSR data (no double packing).
    ``packs[i]`` is the padded form of instance ``i``; :meth:`arrays` stacks
    them into the ``(N, …)`` arrays the batched device launch consumes.
    """

    instances: tuple[Instance, ...]
    packs: tuple[InstancePack, ...]
    n_b: int
    p_b: int
    d_b: int
    widths: tuple[int, int, int, int]   # pred/succ/in/out dense widths
    e_b: tuple[int, int]                # padded in/out edge-list lengths

    def __len__(self) -> int:
        return len(self.instances)

    @property
    def bucket_key(self) -> tuple:
        """Shared-shape signature: batches with equal keys (and equal walk
        counts / search params) reuse one captured device launch."""
        return (self.n_b, self.p_b, self.d_b) + self.widths + self.e_b

    @classmethod
    def from_instances(cls, instances: Sequence[Instance], *,
                       n_b: int | None = None, p_b: int | None = None,
                       d_b: int | None = None,
                       widths: tuple[int, int, int, int] | None = None,
                       e_b: tuple[int, int] | None = None,
                       validate: bool = True) -> "InstanceBatch":
        """``widths``/``e_b`` are *floors*: the shared dense widths and padded
        edge-list lengths are the max of the computed values and the floors.
        The serving layer pins them to quantized signature values so every
        batch cut from one signature class lands on the exact same
        ``bucket_key`` (and therefore the same captured launch)."""
        from ..kernels import schedule_dp as sdp

        instances = tuple(instances)
        if not instances:
            raise ValueError("InstanceBatch needs at least one instance")
        if validate:
            for inst in instances:
                validate_instance(inst)
        n_b = n_b or max(sdp.bucket(i.n_tasks) for i in instances)
        p_b = p_b or max(i.n_procs for i in instances)
        d_b = d_b or max(sdp.bucket(i.n_data) for i in instances)
        n_mems = instances[0].n_mems
        if any(i.n_mems != n_mems for i in instances):
            raise ValueError("batched instances must share the memory-tier "
                             "count (pad data_mem_ok/mem_cap upstream)")

        def deg_width(i: Instance, indptr) -> int:
            deg = np.diff(indptr)
            return max(1, int(deg.max()) if len(deg) else 1)

        w_floor = widths or (1, 1, 1, 1)
        widths = tuple(
            max(w_floor[j],
                max(deg_width(i, getattr(i, f)) for i in instances))
            for j, f in enumerate(("pred_indptr", "succ_indptr",
                                   "in_indptr", "out_indptr")))
        e_floor = e_b or (0, 0)
        e_b = (max(_padded_edge_len(len(i.in_idx), e_floor[0])
                   for i in instances),
               max(_padded_edge_len(len(i.out_idx), e_floor[1])
                   for i in instances))
        packs = tuple(pack_instance(i, n_b=n_b, p_b=p_b, d_b=d_b,
                                    widths=widths, e_b=e_b)
                      for i in instances)
        return cls(instances=instances, packs=packs, n_b=n_b, p_b=p_b,
                   d_b=d_b, widths=widths, e_b=e_b)

    def arrays(self) -> dict:
        """Stacked ``(N, …)`` launch-argument pytree (``ia_from_pack`` rows)."""
        per = [ia_from_pack(ip) for ip in self.packs]
        return {k: np.stack([ia[k] for ia in per]) for k in per[0]}

    def graph(self, i: int):
        """The :class:`~repro_torch.kernels.schedule_dp.DenseGraph` of instance
        ``i``, built from the already-padded pack (no CSR re-walk)."""
        from ..kernels import schedule_dp as sdp

        return sdp.graph_from_pack(self.instances[i], self.packs[i])

    def evaluator(self, i: int, backend: str = "numpy", **kw):
        """A :class:`~repro_torch.core.eval_batch.BatchEvaluator` for instance
        ``i`` wired with this batch's pack: on ``backend="torch"`` its sweeps
        consume the pack's padded dense graph instead of re-deriving one
        (the numpy path works on raw CSR and has no padded form to share)."""
        from ..core.eval_batch import BatchEvaluator

        return BatchEvaluator(self.instances[i], backend=backend,
                              pack=self.packs[i], **kw)


def group_by_bucket(instances: Iterable[Instance]) -> list[list[int]]:
    """Group instance indices by their solo shape-bucket signature.

    Used by the suite sweep: instances inside one group pad to identical
    shared buckets, so the whole group runs through one captured
    ``solve_instances`` launch.
    """
    from ..kernels import schedule_dp as sdp

    groups: dict[tuple, list[int]] = {}
    for ix, inst in enumerate(instances):
        key = (sdp.bucket(inst.n_tasks), inst.n_procs,
               sdp.bucket(inst.n_data), inst.n_mems)
        groups.setdefault(key, []).append(ix)
    return [groups[k] for k in sorted(groups)]
