"""Crash-surviving multiwalk search state (DESIGN.md §13), for the port's
device engine.

Between two sync periods the whole walk state of a ``device_multiwalk`` run
lives in its launch's buffers (``device_search.pack_state``'s fields), and
every later replay is a pure function of them.  A :class:`SearchCheckpoint`
copies those buffers to the host at a sync, with what the host driver
tracks beside them (per-walk histories, the global incumbent history, the
critical-set and chunk buckets, the sync and Alg-3 counters, the iteration
reached); resuming from it replays the remaining rounds **bit-identically**:
the resumed run's result equals the uncrashed run's field for field under an
iteration / evaluation budget (wall-clock fields excepted; a ``time_limit``
budget carries the elapsed time over instead of restarting).

The port's state differs from the reference's (``repro.faults.checkpoint``):
it has no threefry ``key`` (the port's perturbation and tenure draws are
``_mix32`` words of the trajectory position) and it has ``chunk_overflow``.
The file layout is the reference's (one ``.npz``: a ``meta`` JSON byte
array and a ``state_<field>`` array per field), and a file whose fields are
not the port's raises :class:`CheckpointMismatch` naming them.  The
fingerprints are the reference's integers for the same instance and search
parameters; where a run executes (``TSParams.torch_device``) is not part of
them, since the trajectory does not depend on it.

Persistence is atomic (write to a temporary file, then ``os.replace``), so a
crash mid-save leaves the previous checkpoint intact.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zlib

import numpy as np

__all__ = [
    "SearchCheckpoint",
    "CheckpointMismatch",
    "STATE_FIELDS",
    "instance_fingerprint",
    "params_fingerprint",
    "snapshot",
    "check_compatible",
    "save",
    "load",
]

_VERSION = 1

# the walk state of one run: ``device_search.pack_state``'s fields
STATE_FIELDS = (
    "seq", "seq_len", "assign", "mem", "mpred", "msucc", "start", "finish",
    "cur_mk", "best_mk", "best_seq", "best_seq_len", "best_assign", "best_mem",
    "tabu", "unimproved", "accepted", "active", "it", "n_exact", "n_approx",
    "n_perturb", "stop", "overflow", "chunk_overflow", "seed",
)
_META = ("version", "instance_fp", "params_fp", "walks", "sync_index", "crit_cap",
         "chunk_cap", "iteration", "elapsed", "n_exact_host", "g_best", "init_mk_min",
         "g_hist", "histories")
# TSParams fields that say where a run executes, not what it computes
_PLACEMENT = ("torch_device",)


class CheckpointMismatch(ValueError):
    """Resume attempted against a different instance / params / walk shape
    than the checkpoint was taken under, or from a checkpoint whose state is
    not the port's."""


def instance_fingerprint(inst) -> int:
    """Order-stable CRC over the instance's defining arrays and counts."""
    h = zlib.crc32(f"{inst.n_tasks}|{inst.n_data}".encode())
    for f in ("task_edges", "producer", "cons_indptr", "cons_idx",
              "in_indptr", "in_idx", "out_indptr", "out_idx",
              "proc_time", "data_size", "mem_cap", "access_time",
              "mem_level", "data_mem_ok"):
        a = np.ascontiguousarray(getattr(inst, f))
        h = zlib.crc32(a.tobytes(), h)
        h = zlib.crc32(str(a.dtype).encode(), h)
    return h


def params_fingerprint(params) -> int:
    """CRC of the search parameters a trajectory depends on: the dataclass
    repr of every ``TSParams`` field but ``torch_device``, which is the
    reference's ``repr(params)`` for the same field values."""
    fields = ", ".join(f"{f.name}={getattr(params, f.name)!r}"
                       for f in dataclasses.fields(params)
                       if f.repr and f.name not in _PLACEMENT)
    return zlib.crc32(f"{type(params).__qualname__}({fields})".encode())


@dataclasses.dataclass
class SearchCheckpoint:
    """One sync-boundary snapshot of a ``device_multiwalk`` run."""

    version: int
    instance_fp: int
    params_fp: int
    walks: int
    sync_index: int          # completed sync periods before the snapshot
    crit_cap: int            # critical-set bucket (survives escalation)
    chunk_cap: int           # exact-evaluation chunks per round (survives escalation)
    iteration: int           # rounds committed: the budget's count resumes from it
    elapsed: float           # wall seconds consumed (budget carry-over)
    n_exact_host: int        # host-side Alg-3 re-evaluations so far
    g_best: float
    init_mk_min: float
    g_hist: list             # [(iteration, makespan)] global incumbent history
    histories: list          # per-walk incumbent histories
    state: dict              # STATE_FIELDS -> numpy copies


def snapshot(*, instance_fp: int, params_fp: int, walks: int, sync_index: int,
             crit_cap: int, chunk_cap: int, iteration: int, elapsed: float,
             n_exact_host: int, g_best: float, init_mk_min: float, g_hist, histories,
             state: dict) -> SearchCheckpoint:
    """Deep-copy the mutable pieces so later in-place updates by the driver
    cannot bleed into an already-taken checkpoint."""
    return SearchCheckpoint(
        version=_VERSION,
        instance_fp=int(instance_fp), params_fp=int(params_fp),
        walks=int(walks), sync_index=int(sync_index),
        crit_cap=int(crit_cap), chunk_cap=int(chunk_cap), iteration=int(iteration),
        elapsed=float(elapsed), n_exact_host=int(n_exact_host), g_best=float(g_best),
        init_mk_min=float(init_mk_min),
        g_hist=[(int(i), float(m)) for i, m in g_hist],
        histories=[[(int(i), float(m)) for i, m in h] for h in histories],
        state={k: np.array(v, copy=True) for k, v in state.items()},
    )


def _check_state_fields(names) -> None:
    missing = [f for f in STATE_FIELDS if f not in names]
    extra = sorted(set(names) - set(STATE_FIELDS))
    if missing or extra:
        raise CheckpointMismatch(
            "checkpoint state is not the port's device-engine state: "
            + "; ".join(s for s in (f"missing {missing}" if missing else "",
                                    f"unknown {extra}" if extra else "") if s))


def check_compatible(ckpt: SearchCheckpoint, *, instance_fp: int, params_fp: int,
                     walks: int) -> None:
    version = getattr(ckpt, "version", None)
    if version != _VERSION:
        raise CheckpointMismatch(f"checkpoint version {version} != {_VERSION}")
    _check_state_fields(ckpt.state)
    if ckpt.instance_fp != instance_fp:
        raise CheckpointMismatch("checkpoint was taken on a different instance")
    if ckpt.params_fp != params_fp:
        raise CheckpointMismatch("checkpoint was taken under different TSParams")
    if ckpt.walks != walks:
        raise CheckpointMismatch(f"checkpoint has W={ckpt.walks}, resume requested W={walks}")


def save(ckpt: SearchCheckpoint, path: str) -> str:
    """Atomic persist: numpy arrays verbatim (dtype-preserving), scalars
    and histories as a JSON sidecar inside the same ``.npz``."""
    meta = {k: getattr(ckpt, k) for k in _META}
    arrays = {f"state_{k}": np.asarray(v) for k, v in ckpt.state.items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                     **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load(path: str) -> SearchCheckpoint:
    """Read a checkpoint :func:`save` wrote.  A file whose state fields or
    scalars are not the port's (a reference checkpoint, for one) raises
    :class:`CheckpointMismatch` before anything is built from it."""
    with np.load(path) as z:
        meta = json.loads(bytes(np.asarray(z["meta"])).decode())
        names = [k[len("state_"):] for k in z.files if k.startswith("state_")]
        _check_state_fields(names)
        missing = [k for k in _META if k not in meta]
        if missing:
            raise CheckpointMismatch(f"checkpoint meta lacks {missing}")
        state = {}
        for k in names:
            v = np.asarray(z[f"state_{k}"])
            # 0-d arrays come back as scalars of the original dtype, matching
            # what pack_state builds (np.int64(0), np.bool_(False), ...)
            state[k] = v[()] if v.ndim == 0 else v
    meta = {k: meta[k] for k in _META}
    meta["g_hist"] = [(int(i), float(m)) for i, m in meta["g_hist"]]
    meta["histories"] = [[(int(i), float(m)) for i, m in h] for h in meta["histories"]]
    return SearchCheckpoint(state=state, **meta)
