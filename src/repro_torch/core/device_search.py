"""Device-resident multi-walk tabu search — the whole round on the card,
captured once as a CUDA graph and replayed between host reads.

:func:`~repro_torch.core.tabu.tabu_multiwalk` ping-pongs between Python and
the evaluator every round.  This engine runs the full multiwalk round — N7 /
change-core move generation, the approximate head/tail window ranking, the
tabu table and aspiration, chunked top-K exact evaluation through the
schedule-DP kernel (K1, ``kernels/csrc/schedule_dp.cu``), commit, and
incumbent tracking — as one function on tensors over the packed ``(W, …)``
walk state, which lives in device tensors for the whole run.  The host
touches it only every ``sync_every`` rounds, where it reads the incumbent
series and a few flags, checks the wall clock and callbacks and, when
enabled, runs Algorithm 3 on the active walks.

On the card one round is recorded once per launch shape as a
``torch.cuda.CUDAGraph`` and replayed ``sync_every`` times; the recording
holds K1 for the tails (backward only, masked by ``active``), for each of
``J`` exact-evaluation chunks and for the perturbation batch, and the
sequential row prefix sum (``schedule_dp.seq_cumsum``) the durations need.
No replay reads anything back to the host.  A replayed round after the
run's stop condition holds (every walk converged, a budget spent, an
overflow) changes nothing: every update is masked by a device flag, the
``cond`` of the reference's ``while_loop``.  On the CPU (the tests) the same
round runs eagerly, without capture, and K1 runs its plain version; on the
card the graph is the only route, and a failure to capture raises.

Static-shape discipline, as in the reference:

* task/data counts and edge lists are padded to **shape buckets**
  (``repro_torch.instances.batch``), so instances of a bucket share one
  captured launch; the real sizes live in device tensors that the launch's
  buffers are refilled with (K1 reads the task count on the device);
* the per-round neighbourhood has a fixed capacity from a **critical-set
  bucket** ``crit_cap``, and the exact evaluation a fixed number ``J`` of
  top-K chunks: a round that needs more sets an overflow flag and is not
  committed, and the host relaunches with twice the bucket (``J`` starts at
  1).  Both are counted in ``launch_cache_info()["overflow_relaunches"]``;
* launches live in a bounded LRU keyed on the bucket tuple
  (``launch_cache_info()``); each holds its static instance, state and
  series buffers and its graph, and a run refills them with ``copy_``.

Threads (the solve service runs device work on an executor thread, and a
watchdog may start a second one beside a hung first): a run holds its
launch from its first load to its last read, and a run that finds its
launch shape held by another gets a launch of its own, outside the cache
(``launch_cache_info()["uncached"]``), so no two runs share buffers.
Captures are serialised, and each records in ``"thread_local"`` capture
mode, so another thread's CUDA calls cannot break it; the capture's first,
eager round runs with every synchronising call an error (the proof that a
round reads nothing back), and every host read of this module waits for
it, since that debug mode is process-wide.  The kernels' launch counters
are process-wide too: under concurrency ``device_stats["k1_replayed"]`` /
``["seq_cumsum_replayed"]`` are a run's own.

Parity contract (``tests/test_torch_device_search.py``): in float64, with
``mem_update_period >= MEM_UPDATE_DISABLED`` (Algorithm 3 never fires
inside the horizon) and outside the perturbation branch, the trajectory —
history, incumbent, iteration and eval counts — is **bit-for-bit** that of
the NumPy ``tabu_search`` (W=1) / ``tabu_multiwalk`` search loops.  Every float
op replays the NumPy engine's operands and order: max reductions are
order-independent, durations replay the global cumsum-difference through
the sequential prefix sum, approximate-window sums replay the scalar
left-to-right order, tie-breaks use stable partitions and sorts over the
scalar enumeration order, and tenures are the counter-based draws of
``tabu._tenure_draw`` replayed in 32-bit words.  Divergence points are
explicit: the perturbation draws one random move per stalled walk from
``_mix32(seed, walk, it, 2)`` (the reference draws from a threefry stream;
the NumPy search applies a ``perturbation_size`` chain), and Algorithm 3 is
amortized to sync boundaries instead of running after every accepted move.

``solve_instances`` runs a batch of same-bucket instances with an explicit
leading instance axis on every buffer: one graph replays the round of every
instance (K1 once per instance and call site, since each has its own graph),
and each instance's updates are masked by its own flag, so a finished
instance stays frozen and per-instance trajectories equal solo runs.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import types

import numpy as np
import torch

from .._device import resolve_device
from ..faults import inject as _inject
from ..instances.batch import InstanceBatch, InstancePack, ia_from_pack, pack_instance
from ..kernels import schedule_dp as sdp
from .eval_batch import APPROX_WINDOW, LRUCache
from .mdfg import Instance
from .memory_update import memory_update
from .solution import _EPS, Solution, exact_schedule
from .tabu import MultiWalkResult, TSEvent, TSParams, WalkInfo, _maybe_sanitize

__all__ = [
    "DeviceConfig",
    "MEM_UPDATE_DISABLED",
    "InstanceBatch",
    "InstancePack",
    "pack_instance",
    "ia_from_pack",
    "pack_state",
    "unpack_solution",
    "device_multiwalk",
    "solve_instances",
    "warm_launches",
    "launch_cache_info",
]

# mem_update_period at or above this disables Algorithm 3 inside the search
# (the parity profile); below it, the device engine amortizes Alg-3 to sync
# boundaries instead of running it per accepted move.
MEM_UPDATE_DISABLED = 1 << 30

_I32 = np.int32
_NONE = 1 << 62  # "unbounded" sentinel for budget axes
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Launch shape/behaviour knobs.  The reference's ``donate`` has no
    counterpart: the state always lives in the launch's own buffers and is
    updated in place."""

    sync_every: int = 64          # rounds replayed between host reads
    crit_cap: int | None = None   # critical-set capacity; None = auto bucket
    perturb: bool = True          # one random move per stalled walk and round


# sized for serving traffic: the signature classes of a serving trace ×
# its quantized batch sizes × the two warmed chunk counts (8 × 4 × 2 at the
# reference's serving profile) and the solo shapes beside them must coexist
# without thrashing
_LAUNCHES = LRUCache(maxsize=128)
# guards the cache together with every launch's ``owner``, and the counters
_LAUNCH_LOCK = threading.Lock()
# held by a capture, and by every host read / write of a launch's buffers:
# the capture's eager round sets a process-wide sync debug mode
_SYNC_LOCK = threading.RLock()

# overflow→relaunch escalations (critical-set bucket or chunk count) since
# process start; each costs a fresh capture mid-run
_OVERFLOW_RELAUNCHES = 0
# launches built beside a cached one another run held (never cached)
_UNCACHED = 0


def launch_cache_info() -> dict:
    """Captured-launch cache counters (`{hits, misses, evictions, currsize,
    maxsize, overflow_relaunches, uncached}`)."""
    with _LAUNCH_LOCK:
        info = _LAUNCHES.info()
        info["overflow_relaunches"] = _OVERFLOW_RELAUNCHES
        info["uncached"] = _UNCACHED
    return info


def _note_overflow_relaunch() -> None:
    global _OVERFLOW_RELAUNCHES
    with _LAUNCH_LOCK:
        _OVERFLOW_RELAUNCHES += 1


# --------------------------------------------------------------------------- #
# state packing (host NumPy)                                                   #
# --------------------------------------------------------------------------- #
def _fill_seq_rows(sol: Solution, seq_row, seq_len_row, mpred_row,
                   msucc_row) -> None:
    """Write one walk's padded sequences + machine links from a Solution."""
    for pp, s in enumerate(sol.proc_seq):
        seq_len_row[pp] = len(s)
        if s:
            seq_row[pp, : len(s)] = s
            arr = np.asarray(s, dtype=_I32)
            if len(arr) >= 2:
                mpred_row[arr[1:]] = arr[:-1]
                msucc_row[arr[:-1]] = arr[1:]


def pack_state(ip: InstancePack, sols: list[Solution], scheds,
               seed: int) -> dict:
    """Walk state (host NumPy; the launch copies it into its device
    buffers).  The reference's fields, without its threefry ``key`` (the
    port's draws are ``_mix32`` words of ``seed``) and with
    ``chunk_overflow`` (the exact-evaluation chunks overflowed)."""
    w = len(sols)
    seq = np.full((w, ip.p_b, ip.s_b), -1, dtype=_I32)
    seq_len = np.zeros((w, ip.p_b), dtype=_I32)
    assign = np.zeros((w, ip.n_b), dtype=_I32)
    mem = np.zeros((w, ip.d_b), dtype=_I32)
    mpred = np.full((w, ip.n_b), -1, dtype=_I32)
    msucc = np.full((w, ip.n_b), -1, dtype=_I32)
    start = np.zeros((w, ip.n_b))
    finish = np.zeros((w, ip.n_b))
    for i, (sol, sched) in enumerate(zip(sols, scheds)):
        assign[i, : ip.n] = sol.assign
        mem[i, : ip.d] = sol.mem
        _fill_seq_rows(sol, seq[i], seq_len[i], mpred[i], msucc[i])
        start[i, : ip.n] = sched.start
        finish[i, : ip.n] = sched.finish
    cur_mk = np.array([s.makespan for s in scheds])
    return {
        "seq": seq, "seq_len": seq_len, "assign": assign, "mem": mem,
        "mpred": mpred, "msucc": msucc, "start": start, "finish": finish,
        "cur_mk": cur_mk, "best_mk": cur_mk.copy(),
        "best_seq": seq.copy(), "best_seq_len": seq_len.copy(),
        "best_assign": assign.copy(), "best_mem": mem.copy(),
        "tabu": np.full((w, ip.n_b * ip.p_b * (ip.n_b + 2)), -1, dtype=_I32),
        "unimproved": np.zeros(w, dtype=_I32),
        "accepted": np.zeros(w, dtype=_I32),
        "active": np.ones(w, dtype=bool),
        "it": np.int64(0),
        "n_exact": np.int64(0),
        "n_approx": np.int64(0),
        "n_perturb": np.int64(0),
        "stop": np.bool_(False),            # max_evals tripped, or a callback stop
        "overflow": np.bool_(False),        # crit set exceeded crit_cap
        "chunk_overflow": np.bool_(False),  # J top-K chunks were not enough
        "seed": np.int64(seed & _M32),
    }


def unpack_solution(ip: InstancePack, seq, seq_len, assign, mem, w: int) -> Solution:
    proc_seq = [
        [int(t) for t in seq[w, pp, : int(seq_len[w, pp])]]
        for pp in range(ip.p)
    ]
    return Solution(assign=np.asarray(assign[w, : ip.n], dtype=np.int64).copy(),
                    mem=np.asarray(mem[w, : ip.d], dtype=np.int64).copy(),
                    proc_seq=proc_seq)


def _write_walk(ip: InstancePack, state: dict, w: int, sol: Solution,
                sched) -> None:
    """Host-side overwrite of one walk's packed rows (after Alg-3)."""
    state["seq"][w] = -1
    state["seq_len"][w] = 0
    state["mpred"][w] = -1
    state["msucc"][w] = -1
    _fill_seq_rows(sol, state["seq"][w], state["seq_len"][w],
                   state["mpred"][w], state["msucc"][w])
    state["assign"][w, : ip.n] = sol.assign
    state["mem"][w, : ip.d] = sol.mem
    state["start"][w] = 0.0
    state["finish"][w] = 0.0
    state["start"][w, : ip.n] = sched.start
    state["finish"][w, : ip.n] = sched.finish
    state["cur_mk"][w] = sched.makespan


_WALK_ROWS = ("seq", "seq_len", "mpred", "msucc", "assign", "mem", "start",
              "finish", "cur_mk")
_BEST = (("best_seq", "seq"), ("best_seq_len", "seq_len"),
         ("best_assign", "assign"), ("best_mem", "mem"))


# --------------------------------------------------------------------------- #
# the round's tensor helpers                                                   #
# --------------------------------------------------------------------------- #
def _mulmod32(h, c: int):
    """``(h * c) mod 2**32`` for ``0 <= h < 2**32`` without leaving int64:
    the product is split at 16 bits so no partial product overflows."""
    return ((h & 0xFFFF) * c + (((h >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _mix32(*words):
    """``tabu._mix32`` on int64 tensors (or ints) holding 32-bit words: the
    same avalanche, word for word (the tensors broadcast)."""
    h = 0x811C9DC5
    for wd in words:
        h = h ^ (wd & _M32)
        h = _mulmod32(h, 0x9E3779B1)
        h = h ^ (h >> 16)
        h = _mulmod32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
    return h


def perturbation_pick(seed, walk, it, n_moves):
    """Which valid move a stalled walk perturbs with: index
    ``_mix32(seed, walk, it, 2) % max(n_moves, 1)`` into its valid moves in
    enumeration order — a pure function of the trajectory position, like
    the tenure draws (word 0 / 1), so a replayed graph needs no generator
    state."""
    return _mix32(seed, walk, it, 2) % torch.clamp(n_moves, min=1)


def _true_first(mask):
    """Per row, the stable partition of ``mask`` (R, L): indices where it is
    true in order, then where it is false in order — what a stable argsort
    of ``~mask`` gives, from integer prefix counts (exact in any order) and
    one scatter to distinct positions."""
    m = mask.long()
    pos_t = torch.cumsum(m, dim=1) - 1
    pos_f = m.sum(dim=1, keepdim=True) + torch.cumsum(1 - m, dim=1) - 1
    dest = torch.where(mask, pos_t, pos_f)
    src = torch.arange(mask.shape[1], device=mask.device).expand_as(dest)
    return torch.empty_like(dest).scatter_(1, dest, src)


def _rep2(x):
    """``jnp.repeat(x, 2, axis=1)`` of a ``(W, C)`` tensor."""
    return x[:, :, None].expand(x.shape[0], x.shape[1], 2).reshape(x.shape[0], -1)


# --------------------------------------------------------------------------- #
# a launch: static buffers, the round, its graph                              #
# --------------------------------------------------------------------------- #
_IA_INT = ("pred_mat", "succ_mat", "in_blk", "out_blk", "in_idx", "in_owner",
           "in_ptr", "out_idx", "out_owner", "out_ptr")


def _csr_cap(batch: InstanceBatch) -> int:
    """Link capacity of the graphs' CSR forms, predecessor and successor
    alike: K1's shared-memory layout is fixed at capture, so the buffers are
    sized for the bucket.  It is a function of the shape alone (a DAG of
    ``n_b`` tasks whose in- / out-degrees fit the dense widths has at most
    ``n_b`` x the smaller width edges), so every batch of one
    ``bucket_key`` fits one launch, whatever its edge counts."""
    from ..instances.batch import _padded_edge_len

    return _padded_edge_len(batch.n_b * min(batch.widths[0], batch.widths[1]))


def _launch_key(batch: InstanceBatch, w_count: int, params: TSParams,
                crit_cap: int, chunk_cap: int, cfg: DeviceConfig, dev, cap) -> tuple:
    ip = batch.packs[0]
    return (ip.bucket_key, ip.access_time.shape[1], cap, w_count,
            crit_cap, chunk_cap, cfg.sync_every, cfg.perturb, params.top_k,
            params.n_change_core_positions, params.max_unimproved,
            params.max_iters, params.max_evals, len(batch), str(dev))


class _Launch:
    """Everything one launch shape needs, allocated once: the instance
    arrays (refilled per batch), the walk state and the series of one sync
    period (refilled per run), the K1 call sites, and on the card the
    captured round."""

    def __init__(self, batch: InstanceBatch, w_count: int, params: TSParams,
                 crit_cap: int, chunk_cap: int, cfg: DeviceConfig, dev, cap):
        ip = batch.packs[0]
        self.dev, self.n_inst, self.W = dev, len(batch), w_count
        self.n_b, self.p_b, self.s_b, self.d_b = ip.n_b, ip.p_b, ip.s_b, ip.d_b
        self.C, self.J, self.R = crit_cap, chunk_cap, cfg.sync_every
        self.K = params.top_k
        self.NPOS = params.n_change_core_positions
        self.max_unimp = params.max_unimproved
        self.max_iters = _NONE if params.max_iters is None else int(params.max_iters)
        self.max_evals = _NONE if params.max_evals is None else int(params.max_evals)
        self.perturb = cfg.perturb
        self.M_n7 = 2 * self.C
        self.M = self.M_n7 + self.C * self.p_b * (self.NPOS + 1)
        self.batch = None           # the InstanceBatch the buffers hold
        self.owner = None           # the run holding the buffers (under _LAUNCH_LOCK)
        self.graph = None           # torch.cuda.CUDAGraph once captured
        self.capture_seconds = 0.0
        self.k1_per_round = self.cumsum_per_round = 0

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # instance buffers, one set per instance (views of stacked tensors)
        stacked = {}
        for k, v in ia_from_pack(ip).items():
            if k in ("n", "p"):
                continue
            dt = (torch.int64 if k in _IA_INT else torch.bool if v.dtype == bool
                  else torch.float64)
            stacked[k] = zeros((self.n_inst,) + v.shape, dt)
        stacked["n"] = zeros((self.n_inst,), torch.int64)
        stacked["p"] = zeros((self.n_inst,), torch.int64)
        stacked["n32"] = zeros((self.n_inst, 1), torch.int32)
        for nm in ("pred", "succ"):
            stacked[f"{nm}_ptr"] = zeros((self.n_inst, self.n_b + 1), torch.int32)
            stacked[f"{nm}_idx"] = zeros((self.n_inst, cap), torch.int32)
        self.ia = [{k: v[i] for k, v in stacked.items()} for i in range(self.n_inst)]

        # walk state (pack_state's fields, shapes and types) and series,
        # leading instance axis
        self.state = {}
        for k, v in pack_state(ip, [], [], 0).items():
            v = np.asarray(v)
            shape = (w_count,) + v.shape[1:] if v.ndim else ()
            self.state[k] = zeros((self.n_inst,) + shape, torch.from_numpy(v).dtype)
        R, W = self.R, w_count
        self.series = {
            "best_mk": zeros((self.n_inst, R, W), torch.float64),
            "cur_mk": zeros((self.n_inst, R, W), torch.float64),
            "n_exact": zeros((self.n_inst, R), torch.int64),
            "it": zeros((self.n_inst, R), torch.int64),
            "active": zeros((self.n_inst, R, W), torch.bool),
            "ran": zeros((self.n_inst, R), torch.bool),
            "r": zeros((self.n_inst,), torch.int64),
        }

        # K1 call sites per instance: tails (W rows), the chunks (W·K rows),
        # the perturbation batch (W rows)
        self.plans = []
        for i in range(self.n_inst):
            a = self.ia[i]
            g = sdp.DenseGraph(n=ip.n, n_b=self.n_b, pred_mat=a["pred_mat"],
                               succ_mat=a["succ_mat"]).with_csr(
                (a["pred_ptr"], a["pred_idx"]), (a["succ_ptr"], a["succ_idx"]))
            self.plans.append((
                sdp.SweepLaunch(g, W, sdp.MODE_BACKWARD, a["n32"]),
                sdp.SweepLaunch(g, W * self.K, sdp.MODE_FORWARD, a["n32"]),
                sdp.SweepLaunch(g, W, sdp.MODE_FORWARD, a["n32"]) if self.perturb else None,
            ))

    # -- buffers ------------------------------------------------------------- #
    def load_instances(self, batch: InstanceBatch) -> None:
        """Copy ``batch``'s arrays into the instance buffers."""
        if self.batch is batch:
            return
        self.batch = None           # until the copy is whole
        with _SYNC_LOCK:
            self._copy_instances(batch)
        self.batch = batch

    def _copy_instances(self, batch: InstanceBatch) -> None:
        for a, ip in zip(self.ia, batch.packs):
            for k, v in ia_from_pack(ip).items():
                a[k].copy_(torch.as_tensor(np.asarray(v)))
            a["n32"].fill_(ip.n)
            for nm, mat in (("pred", ip.pred_mat), ("succ", ip.succ_mat)):
                indptr, idx = sdp.csr_from_dense(mat)
                a[f"{nm}_ptr"].copy_(torch.from_numpy(indptr))
                a[f"{nm}_idx"].zero_()
                a[f"{nm}_idx"][: len(idx)].copy_(torch.from_numpy(idx))

    def load_state(self, src: dict) -> None:
        """Copy a state (stacked host NumPy, or another launch's tensors)."""
        with _SYNC_LOCK:
            for k, v in self.state.items():
                v.copy_(torch.as_tensor(src[k]))

    # -- running ------------------------------------------------------------- #
    def run(self, rounds: int) -> bool:
        """One sync period: ``rounds`` (at most ``sync_every``) rounds of
        every instance.  Returns whether the round was captured (and its
        eager first round run) in this call."""
        ser = self.series
        ser["r"].zero_()
        ser["ran"].zero_()
        if self.dev.type != "cuda":
            for _ in range(rounds):
                going = [i for i in range(self.n_inst) if bool(self._running(i))]
                if not going:
                    break
                for i in going:
                    self._round(i)
            return False
        captured = self.graph is None
        if captured:
            self._capture()
        for _ in range(rounds):
            self.graph.replay()
        sdp.count_replays(self.k1_per_round, self.cumsum_per_round, rounds)
        return captured

    def _round_all(self) -> None:
        for i in range(self.n_inst):
            self._round(i)

    def _capture(self) -> None:
        """Record the round of every instance as one CUDA graph.  A first,
        eager round on a side stream (its effects undone) initializes what
        the round's operations set up lazily and proves it syncs nothing;
        then the capture, whose K1 / seq_cumsum nodes are counted against
        what the round's code implies.  One capture at a time (the node
        counts are process-wide), in ``"thread_local"`` mode."""
        with _SYNC_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        t0 = time.monotonic()
        dev = self.dev
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            saved = {k: v.clone() for k, v in self.state.items()}
            saved_ser = {k: v.clone() for k, v in self.series.items()}
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._round_all()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            for k, v in self.state.items():
                v.copy_(saved[k])
            for k, v in self.series.items():
                v.copy_(saved_ser[k])
        cur.wait_stream(side)
        k1_0, cs_0 = sdp.sweep.captured, sdp.seq_cumsum.captured
        graph = torch.cuda.CUDAGraph()
        # recorded on the side stream without torch.cuda.graph's device-wide
        # synchronize and cache release, which would reach into the work and
        # the memory of other threads' runs
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._round_all()
            finally:
                graph.capture_end()
        self.k1_per_round = sdp.sweep.captured - k1_0
        self.cumsum_per_round = sdp.seq_cumsum.captured - cs_0
        want = self.n_inst * (1 + self.J + (1 if self.perturb else 0))
        if self.k1_per_round != want:
            raise RuntimeError(f"the captured round holds {self.k1_per_round} K1 launches, "
                               f"its code implies {want}")
        # two prefix sums (in, out edges) per exact-evaluation batch
        if self.cumsum_per_round != 2 * (want - self.n_inst):
            raise RuntimeError(f"the captured round holds {self.cumsum_per_round} "
                               f"seq_cumsum launches, its code implies "
                               f"{2 * (want - self.n_inst)}")
        self.graph = graph
        self.capture_seconds = time.monotonic() - t0

    def _running(self, i: int):
        """The reference's while_loop ``cond`` for instance ``i`` (a 0-dim
        bool tensor)."""
        st = {k: v[i] for k, v in self.state.items()}
        return ((self.series["r"][i] < self.R) & st["active"].any() & ~st["stop"]
                & ~st["overflow"] & ~st["chunk_overflow"]
                & (st["it"] < self.max_iters) & (st["n_exact"] < self.max_evals))

    # -- the round ------------------------------------------------------------ #
    def _round(self, i: int) -> None:  # noqa: C901 — one round, as the reference's round_body
        st = {k: v[i] for k, v in self.state.items()}
        ser = {k: v[i] for k, v in self.series.items()}
        ia = self.ia[i]
        bwd, fwd, pert = self.plans[i]
        dev = self.dev
        W, C, K, M, M_n7 = self.W, self.C, self.K, self.M, self.M_n7
        n_b, p_b, s_b, d_b = self.n_b, self.p_b, self.s_b, self.d_b
        NPOS, WIN = self.NPOS, APPROX_WINDOW
        inf = math.inf
        max_evals = self.max_evals
        n, p = ia["n"], ia["p"]
        pred_mat, proc_time, access_time = ia["pred_mat"], ia["proc_time"], ia["access_time"]
        data_size, compat = ia["data_size"], ia["compat"]
        wi = torch.arange(W, device=dev)
        ar_nb = torch.arange(n_b, device=dev)
        ar_sb = torch.arange(s_b, device=dev)
        ar_pb = torch.arange(p_b, device=dev)

        running = self._running(i)
        it = st["it"] + 1
        active0 = st["active"]
        start, finish = st["start"], st["finish"]
        seq, seq_len = st["seq"].long(), st["seq_len"].long()
        assign, mem = st["assign"].long(), st["mem"].long()
        mpred, msucc = st["mpred"].long(), st["msucc"].long()
        cur_mk, best_mk = st["cur_mk"], st["best_mk"]

        def take_w(arr2d, idx):
            """arr2d (W, n), idx (W, ...) → gathered values per walk."""
            return torch.gather(arr2d, 1, idx.reshape(W, -1)).reshape(idx.shape)

        def durations(assign_rows, mem_rows):
            """``solution.durations`` replayed bit-exactly per row: global
            sequential prefix sums over the CSR edge values, then indptr
            differences."""
            def io_time(pre):
                idx, owner, valid, ptr = (ia[f"{pre}_idx"], ia[f"{pre}_owner"],
                                          ia[f"{pre}_valid"], ia[f"{pre}_ptr"])
                rate = access_time[assign_rows[:, owner], mem_rows[:, idx]]
                vals = torch.where(valid[None, :], data_size[idx][None, :] * rate, 0.0)
                c = sdp.seq_cumsum(vals)
                return c[:, ptr[1:]] - c[:, ptr[:-1]]

            t_in = io_time("in")
            t_out = io_time("out")
            pt = proc_time[ar_nb[None, :], assign_rows]
            return t_in + pt + t_out

        def eval_candidates(assign_c, mpred_c, mem_rows, plan):
            """Exact DP on (rows, n_b) candidate rows: durations + K1 forward."""
            dur = durations(assign_c, mem_rows)
            start_c, finish_c, n_done = plan(dur, mpred_c)
            feasible = n_done == n
            valid_col = (ar_nb < n)[None, :]
            mk = torch.where(feasible, torch.where(valid_col, finish_c, -inf).amax(dim=1), inf)
            return start_c, finish_c, feasible, mk

        def seq_positions():
            """(mach, pos) (W, n_b) from the padded sequence tensor."""
            t_safe = torch.where(validp, seq, n_b).reshape(W, -1)
            mach = torch.full((W, n_b + 1), -1, dtype=torch.long, device=dev)
            pos = torch.full((W, n_b + 1), -1, dtype=torch.long, device=dev)
            pvals = ar_pb[None, :, None].expand(W, p_b, s_b).reshape(W, -1)
            svals = ar_sb[None, None, :].expand(W, p_b, s_b).reshape(W, -1)
            # padding slots all write the trash column n_b, sliced off
            mach.scatter_(1, t_safe, pvals)
            pos.scatter_(1, t_safe, svals)
            return mach[:, :n_b], pos[:, :n_b]

        def links_from_seq(seq_n, seq_len_n):
            vp = ar_sb[None, None, :] < seq_len_n[:, :, None]
            t_safe = torch.where(vp, seq_n, n_b)
            mp = torch.full((W, n_b + 1), -1, dtype=torch.long, device=dev)
            ms = torch.full((W, n_b + 1), -1, dtype=torch.long, device=dev)
            mp.scatter_(1, t_safe[:, :, 1:].reshape(W, -1),
                        torch.where(vp[:, :, 1:], t_safe[:, :, :-1], -1).reshape(W, -1))
            ms.scatter_(1, t_safe[:, :, :-1].reshape(W, -1),
                        torch.where(vp[:, :, 1:], t_safe[:, :, 1:], -1).reshape(W, -1))
            return mp[:, :n_b], ms[:, :n_b]

        def new_seq_at(seq_dst, u, j, k, cc, idx):
            """Element ``idx`` of each move's post-move destination sequence
            (``eval_batch._new_seq_at`` verbatim)."""
            t = idx - (idx > j).long()
            orig = t + ((~cc) & (t >= k)).long()
            g = torch.gather(seq_dst, 2, orig.clamp(0, s_b - 1)[..., None])[..., 0]
            return torch.where(idx == j, u, g)

        def reprice(u, b, blk_mat):
            """Vectorized AT re-pricing with the scalar sequential sum order:
            per-move block list, left-to-right adds over zero-padded width."""
            blocks = blk_mat[u.clamp(0, n_b - 1)]                      # (W, M, L)
            ok = blocks >= 0
            bsafe = torch.where(ok, blocks, 0)
            memv = mem[wi[:, None, None], bsafe]                       # (W, M, L)
            vals = torch.where(ok, data_size[bsafe] * access_time[b[..., None], memv], 0.0)
            tot = torch.zeros(vals.shape[:2], dtype=torch.float64, device=dev)
            for jj in range(vals.shape[2]):
                tot = tot + vals[:, :, jj]
            return tot

        # ---------------- tails, critical set ------------------------------ #
        dur_all = finish - start
        q_all = bwd(dur_all, msucc, active0)
        r_all = start
        slack = cur_mk[:, None] - r_all - q_all
        crit = (slack <= _EPS * torch.clamp(cur_mk, min=1.0)[:, None]) \
            & (ar_nb < n)[None, :] & active0[:, None]
        overflow = (active0 & (crit.sum(dim=1) > C)).any()

        # ---------------- move generation (N7) ----------------------------- #
        validp = ar_sb[None, None, :] < seq_len[:, :, None]
        seq_c = seq.clamp(0, n_b - 1)
        c_on = torch.where(validp, take_w(crit, seq_c.reshape(W, -1)).reshape(W, p_b, s_b),
                           False)
        no = torch.zeros((W, p_b, 1), dtype=torch.bool, device=dev)
        prev = torch.cat([no, c_on[:, :, :-1]], dim=2)
        nxt = torch.cat([c_on[:, :, 1:], no], dim=2)
        starts_m = c_on & ~prev
        ends_m = c_on & ~nxt
        sidx = ar_sb.expand(W, p_b, s_b)
        lo_run = torch.cummax(torch.where(starts_m, sidx, -1), dim=2).values
        hi_run = torch.cummin(torch.where(ends_m, sidx, s_b + 7).flip(2), dim=2).values.flip(2)
        keep = c_on & (hi_run - lo_run >= 1)
        flat_keep = keep.reshape(W, p_b * s_b)
        order_n7 = _true_first(flat_keep)[:, :C]
        slot_ok = flat_keep.gather(1, order_n7)
        pp_n7 = order_n7 // s_b
        ss_n7 = order_n7 % s_b
        u_n7 = seq_c.reshape(W, -1).gather(1, order_n7)
        lo_n7 = lo_run.reshape(W, -1).gather(1, order_n7)
        hi_n7 = hi_run.reshape(W, -1).gather(1, order_n7)
        # two moves per slot: [to-head, to-tail] interleaved
        n7_task, n7_src_p, n7_src_s = _rep2(u_n7), _rep2(pp_n7), _rep2(ss_n7)
        n7_dst = torch.stack([lo_n7, hi_n7], dim=2).reshape(W, M_n7)
        n7_valid = torch.stack([slot_ok & (ss_n7 != lo_n7), slot_ok & (ss_n7 != hi_n7)],
                               dim=2).reshape(W, M_n7)

        # ---------------- move generation (change-core) -------------------- #
        crit_order = _true_first(crit)[:, :C]                          # (W, C)
        crit_ok = crit.gather(1, crit_order)
        u_cc = crit_order
        mach, pos = seq_positions()
        a_cc = take_w(mach, u_cc)
        k_cc = take_w(pos, u_cc)
        r_starts = torch.where(validp, take_w(r_all, seq_c.reshape(W, -1)).reshape(W, p_b, s_b),
                               inf)
        r_u = take_w(r_all, u_cc)                                      # (W, C)
        anchor = torch.searchsorted(r_starts, r_u[:, None, :].expand(W, p_b, C).contiguous())
        anchor = anchor.transpose(1, 2)                                # (W, C, p_b)
        lo = torch.clamp(anchor - NPOS // 2, min=0)
        hi = torch.minimum(seq_len[:, None, :], lo + NPOS)
        jj = lo[..., None] + torch.arange(NPOS + 1, device=dev)        # (W, C, p_b, NPOS+1)
        cc_valid = (jj <= hi[..., None]) \
            & crit_ok[:, :, None, None] \
            & compat[u_cc.clamp(0, n_b - 1)][..., None] \
            & (ar_pb[None, None, :, None] != a_cc[:, :, None, None]) \
            & (ar_pb[None, None, :, None] < p)
        shp = jj.shape
        mv_task = torch.cat([n7_task, u_cc[:, :, None, None].expand(shp).reshape(W, -1)], 1)
        mv_src_p = torch.cat([n7_src_p, a_cc[:, :, None, None].expand(shp).reshape(W, -1)], 1)
        mv_src_s = torch.cat([n7_src_s, k_cc[:, :, None, None].expand(shp).reshape(W, -1)], 1)
        mv_dst_p = torch.cat([n7_src_p, ar_pb[None, None, :, None].expand(shp).reshape(W, -1)], 1)
        mv_dst_s = torch.cat([n7_dst, jj.reshape(W, -1)], 1)
        mv_cc = torch.cat([torch.zeros((W, M_n7), dtype=torch.bool, device=dev),
                           torch.ones((W, M - M_n7), dtype=torch.bool, device=dev)], 1)
        mv_valid = torch.cat([n7_valid, cc_valid.reshape(W, -1)], 1) & active0[:, None]
        n_moves = mv_valid.sum(dim=1)
        participates = active0 & (n_moves > 0)
        n_approx = st["n_approx"] + torch.where(active0, n_moves, 0).sum()

        # sanitize masked slots so downstream gathers stay in bounds
        mv_task = torch.where(mv_valid, mv_task, 0)
        mv_src_p = torch.where(mv_valid, mv_src_p, 0)
        mv_src_s = torch.where(mv_valid, mv_src_s, 0)
        mv_dst_p = torch.where(mv_valid, mv_dst_p, 0)
        mv_dst_s = torch.where(mv_valid, mv_dst_s, 0)

        # ---------------- approximate evaluation --------------------------- #
        seq_dst = torch.gather(seq, 1, mv_dst_p[:, :, None].expand(W, M, s_b))  # (W, M, s_b)
        dur_u0 = take_w(dur_all, mv_task)
        q_u0 = take_w(q_all, mv_task)
        t_in_cc = reprice(mv_task, mv_dst_p, ia["in_blk"])
        t_out_cc = reprice(mv_task, mv_dst_p, ia["out_blk"])
        d_cc = t_in_cc + proc_time[mv_task, mv_dst_p] + t_out_cc
        dur_u = torch.where(mv_cc, d_cc, dur_u0)
        q_u = torch.where(mv_cc, q_u0 - dur_u0 + d_cc, q_u0)
        finite = torch.isfinite(dur_u)
        new_len = seq_len.gather(1, mv_dst_p) + mv_cc.long()
        w_lo = torch.where(mv_cc, mv_dst_s, torch.minimum(mv_src_s, mv_dst_s))
        w_hi = torch.minimum(new_len, w_lo + WIN)
        est = torch.zeros((W, M), dtype=torch.float64, device=dev)
        xp = torch.gather(seq_dst, 2, (w_lo - 1).clamp(0, s_b - 1)[..., None])[..., 0]
        xp = xp.clamp(0, n_b - 1)
        prev_finish = torch.where(w_lo > 0, take_w(r_all, xp) + take_w(dur_all, xp), 0.0)
        win_of = torch.full((W, M, n_b + 1), -1, dtype=torch.int8, device=dev)
        win_heads = torch.zeros((W, M, WIN), dtype=torch.float64, device=dev)
        for s in range(WIN):
            idxp = w_lo + s
            act = mv_valid & (idxp < w_hi)
            x = new_seq_at(seq_dst, mv_task, mv_dst_s, mv_src_s, mv_cc, idxp)
            x = torch.where(act, x, 0)
            preds = pred_mat[x]                                        # (W, M, Dp)
            pok = preds >= 0
            psafe = torch.where(pok, preds, n_b)
            tpos = torch.gather(win_of, 2, psafe)
            in_win = tpos >= 0
            head_at = torch.gather(win_heads, 2, tpos.clamp(0, WIN - 1).long())
            pclip = preds.clamp(0, n_b - 1)
            dsel = torch.where(preds == mv_task[..., None], dur_u[..., None],
                               take_w(dur_all, pclip))
            f_win = head_at + dsel
            f_def = take_w(r_all, pclip) + take_w(dur_all, pclip)
            f = torch.where(pok, torch.where(in_win, f_win, f_def), -inf)
            head = torch.maximum(prev_finish, f.amax(dim=2))
            win_of.scatter_(2, torch.where(act, x, n_b)[..., None], s)
            win_heads[:, :, s] = head
            is_u = x == mv_task
            dx = torch.where(is_u, dur_u, take_w(dur_all, x))
            qx = torch.where(is_u, q_u, take_w(q_all, x))
            est = torch.where(act, torch.maximum(est, head + qx), est)
            prev_finish = torch.where(act, head + dx, prev_finish)
        tailm = mv_valid & (w_hi < new_len)
        x_t = new_seq_at(seq_dst, mv_task, mv_dst_s, mv_src_s, mv_cc, w_hi)
        x_t = torch.where(tailm, x_t, 0).clamp(0, n_b - 1)
        est = torch.where(tailm, torch.maximum(est, prev_finish + take_w(q_all, x_t)), est)
        est = torch.where(finite & mv_valid, est, inf)

        # ---------------- sort, tabu pre-filter ---------------------------- #
        # resulting configuration (task, dst_proc, machine-pred-after-move),
        # derived per move and carried through the sort
        pi = mv_dst_s - 1
        pio = pi + ((~mv_cc) & (pi >= mv_src_s)).long()
        pred_cfg = torch.where(
            pi >= 0, torch.gather(seq_dst, 2, pio.clamp(0, s_b - 1)[..., None])[..., 0], -2)
        cfg_idx = (mv_task * p_b + mv_dst_p) * (n_b + 2) + (pred_cfg + 2)
        order = torch.argsort(est, dim=1, stable=True)

        def srt(a):
            return a.gather(1, order)

        est_s = srt(est)
        task_s, srcp_s, srcs_s = srt(mv_task), srt(mv_src_p), srt(mv_src_s)
        dstp_s, dsts_s, cc_s = srt(mv_dst_p), srt(mv_dst_s), srt(mv_cc)
        valid_s = srt(mv_valid & finite)
        tabu = st["tabu"]
        expiry = tabu.gather(1, srt(cfg_idx).clamp(0, tabu.shape[1] - 1))
        is_tabu = expiry >= it
        adm = valid_s & ~(is_tabu & (est_s >= best_mk[:, None]))
        n_adm = adm.sum(dim=1)
        adm_perm = _true_first(adm)

        def comp(a):
            return a.gather(1, adm_perm)

        c_task, c_srcp, c_srcs, c_dstp, c_dsts, c_cc, c_tabu = (
            comp(task_s), comp(srcp_s), comp(srcs_s), comp(dstp_s),
            comp(dsts_s), comp(cc_s), comp(is_tabu))

        # ---------------- chunked top-K exact evaluation ------------------- #
        def apply_and_eval(sel_idx, slot_ok, arrs, plan):
            """``sel_idx`` (W, kk) indices into a move-array bundle (the
            compact admissible arrays for the top-K chunks, the raw ones
            for the perturbation): splice each walk's links and assignment,
            then K1 forward on the (W·kk) candidate rows."""
            task_a, srcs_a, dstp_a, dsts_a, cc_a = arrs
            kk = sel_idx.shape[1]
            u = torch.where(slot_ok, task_a.gather(1, sel_idx), 0)
            ksrc = srcs_a.gather(1, sel_idx)
            b = torch.where(slot_ok, dstp_a.gather(1, sel_idx), 0)
            j = dsts_a.gather(1, sel_idx)
            ccm = cc_a.gather(1, sel_idx)
            x = take_w(mpred, u)
            y = take_w(msucc, u)
            pad = torch.full((W, kk, 1), -1, dtype=torch.long, device=dev)
            mp = torch.cat([mpred[:, None, :].expand(W, kk, n_b), pad], dim=2)
            ms = torch.cat([msucc[:, None, :].expand(W, kk, n_b), pad], dim=2)
            asg = torch.cat([assign[:, None, :].expand(W, kk, n_b), pad + 1], dim=2)

            def safe(t, okm):
                return torch.where(okm & slot_ok, t, n_b)[..., None]

            ms.scatter_(2, safe(x, x >= 0), y[..., None])
            mp.scatter_(2, safe(y, y >= 0), x[..., None])
            dseq = torch.gather(seq, 1, b[:, :, None].expand(W, kk, s_b))
            same = ~ccm
            len_dst = seq_len.gather(1, b) - same.long()
            pi2 = j - 1
            pio2 = pi2 + (same & (pi2 >= ksrc)).long()
            pred_t = torch.where(
                pi2 >= 0, torch.gather(dseq, 2, pio2.clamp(min=0)[..., None])[..., 0], -1)
            sio2 = j + (same & (j >= ksrc)).long()
            succ_t = torch.where(
                j < len_dst, torch.gather(dseq, 2, sio2.clamp(max=s_b - 1)[..., None])[..., 0],
                -1)
            mp.scatter_(2, safe(u, slot_ok), pred_t[..., None])
            ms.scatter_(2, safe(u, slot_ok), succ_t[..., None])
            ms.scatter_(2, safe(pred_t, pred_t >= 0), u[..., None])
            mp.scatter_(2, safe(succ_t, succ_t >= 0), u[..., None])
            asg.scatter_(2, safe(u, slot_ok), b[..., None])
            mem_rows = mem[:, None, :].expand(W, kk, d_b).reshape(W * kk, d_b)
            start_c, finish_c, feas, mk = eval_candidates(
                asg[:, :, :n_b].reshape(W * kk, n_b), mp[:, :, :n_b].reshape(W * kk, n_b),
                mem_rows, plan)
            return (start_c.reshape(W, kk, n_b), finish_c.reshape(W, kk, n_b),
                    feas.reshape(W, kk), mk.reshape(W, kk))

        def chunk_sizes(pos, examined, done, found, n_exact):
            done = done | (found & (examined >= K)) | (pos >= n_adm)
            avail = torch.clamp(max_evals - n_exact, min=0)
            want = torch.where(participates & ~done, torch.clamp(n_adm - pos, max=K), 0)
            # an exclusive prefix over small nonnegative integers is exact in
            # any order
            before = torch.cumsum(want, dim=0) - want
            size = torch.minimum(torch.clamp(torch.minimum(want, avail - before), min=0), want)
            return done | (want > 0) & (size <= 0), size

        ar_k = torch.arange(K, device=dev)
        pos = torch.zeros(W, dtype=torch.long, device=dev)
        examined = torch.zeros(W, dtype=torch.long, device=dev)
        done = ~participates
        found = torch.zeros(W, dtype=torch.bool, device=dev)
        chosen_i = torch.zeros(W, dtype=torch.long, device=dev)
        chosen_mk = torch.full((W,), inf, dtype=torch.float64, device=dev)
        chosen_start = torch.zeros((W, n_b), dtype=torch.float64, device=dev)
        chosen_finish = torch.zeros((W, n_b), dtype=torch.float64, device=dev)
        n_exact = st["n_exact"]
        compact = (c_task, c_srcs, c_dstp, c_dsts, c_cc)
        # the reference's data-dependent chunk loop as J masked chunks: a
        # chunk whose sizes are all 0 changes nothing but ``done``, and once
        # all sizes are 0 they stay 0
        for _ in range(self.J):
            done, size = chunk_sizes(pos, examined, done, found, n_exact)
            slot = ar_k[None, :] < size[:, None]
            sel = torch.where(slot, (pos[:, None] + ar_k[None, :]).clamp(0, M - 1), 0)
            start_c, finish_c, feas, mk = apply_and_eval(sel, slot, compact, fwd)
            tabu_slot = c_tabu.gather(1, sel)
            elig = slot & feas & ~(tabu_slot & (mk >= best_mk[:, None]))
            mk_m = torch.where(elig, mk, inf)
            jmin = torch.argmin(mk_m, dim=1, keepdim=True)     # the first minimum
            cand_mk = mk_m.gather(1, jmin)[:, 0]
            better = cand_mk < chosen_mk
            sel_j = sel.gather(1, jmin)[:, 0]
            pick = jmin[:, :, None].expand(W, 1, n_b)
            chosen_start = torch.where(better[:, None], start_c.gather(1, pick)[:, 0],
                                       chosen_start)
            chosen_finish = torch.where(better[:, None], finish_c.gather(1, pick)[:, 0],
                                        chosen_finish)
            pos = pos + size
            examined = examined + size
            found = found | better
            chosen_i = torch.where(better, sel_j, chosen_i)
            chosen_mk = torch.where(better, cand_mk, chosen_mk)
            n_exact = n_exact + size.sum()
        # still live after J chunks: the round needs more, and is not committed
        chunk_over = (chunk_sizes(pos, examined, done, found, n_exact)[1] > 0).any()
        found = found & participates

        # ---------------- stalled walks: budget stop or perturbation ------- #
        exhausted = participates & ~found & (n_exact >= max_evals)
        stop = st["stop"] | exhausted.any()
        if self.perturb:
            perturb_w = participates & ~found & (n_exact < max_evals)
            # one random move per stalled walk, evaluated every round as one
            # (W, 1) candidate batch through the same splice/eval path,
            # masked by perturb_w
            ridx = perturbation_pick(st["seed"], wi, it, n_moves)
            pick = _true_first(mv_valid).gather(1, ridx[:, None])
            p_start, p_finish, p_feas, p_mk = apply_and_eval(
                pick, perturb_w[:, None], (mv_task, mv_src_s, mv_dst_p, mv_dst_s, mv_cc), pert)
            p_ok = perturb_w & p_feas[:, 0]
            p_start, p_finish, p_mk = p_start[:, 0], p_finish[:, 0], p_mk[:, 0]

            def g(a):
                return a.gather(1, pick)[:, 0]

            p_u, p_a, p_k, p_b2, p_j, p_cc = (g(mv_task), g(mv_src_p), g(mv_src_s),
                                              g(mv_dst_p), g(mv_dst_s), g(mv_cc))
            n_exact = n_exact + perturb_w.long().sum()
        else:
            perturb_w = p_ok = torch.zeros(W, dtype=torch.bool, device=dev)
            p_u = p_a = p_k = p_b2 = p_j = torch.zeros(W, dtype=torch.long, device=dev)
            p_cc = p_ok
            p_start = p_finish = start
            p_mk = cur_mk

        # ---------------- commit (accepted move or feasible perturbation) -- #
        commit = found | p_ok
        ci = chosen_i[:, None]

        def cm(c_arr, p_arr):
            return torch.where(found, c_arr.gather(1, ci)[:, 0], p_arr)

        cm_u, cm_a, cm_k = cm(c_task, p_u), cm(c_srcp, p_a), cm(c_srcs, p_k)
        cm_b, cm_j, cm_cc = cm(c_dstp, p_b2), cm(c_dsts, p_j), cm(c_cc, p_cc)
        new_start = torch.where(found[:, None], chosen_start,
                                torch.where(p_ok[:, None], p_start, start))
        new_finish = torch.where(found[:, None], chosen_finish,
                                 torch.where(p_ok[:, None], p_finish, finish))
        new_mk = torch.where(found, chosen_mk, torch.where(p_ok, p_mk, cur_mk))

        # tabu the destroyed configuration (accepted moves only)
        mp_before = take_w(mpred, cm_u[:, None])[:, 0]
        destroyed = (cm_u * p_b + cm_a) * (n_b + 2) \
            + torch.where(mp_before >= 0, mp_before, -2) + 2
        h_cc = _mix32(st["seed"], wi, it, 1)
        h_n7 = _mix32(st["seed"], wi, it, 0)
        tenure = torch.where(cm_cc, p + h_cc % (2 * p), n + h_n7 % torch.clamp(n, min=1))

        # sequence splice (dst row gets remove+insert arithmetic; cc moves
        # also rewrite the source row)
        ii = ar_sb[None, :]
        dst_row = torch.gather(seq, 1, cm_b[:, None, None].expand(W, 1, s_b))[:, 0]
        new_len_b = seq_len.gather(1, cm_b[:, None])[:, 0] + cm_cc.long()
        t2 = ii - (ii > cm_j[:, None]).long()
        orig2 = t2 + ((~cm_cc)[:, None] & (t2 >= cm_k[:, None])).long()
        g2 = dst_row.gather(1, orig2.clamp(0, s_b - 1))
        new_dst = torch.where(ii == cm_j[:, None], cm_u[:, None], g2)
        new_dst = torch.where(ii < new_len_b[:, None], new_dst, -1)
        src_row = torch.gather(seq, 1, cm_a[:, None, None].expand(W, 1, s_b))[:, 0]
        src_len = seq_len.gather(1, cm_a[:, None])[:, 0]
        rem = src_row.gather(1, (ii + (ii >= cm_k[:, None]).long()).clamp(0, s_b - 1))
        new_src = torch.where(ii < (src_len - 1)[:, None], rem, -1)
        m_src = (ar_pb[None, :, None] == cm_a[:, None, None]) & (commit & cm_cc)[:, None, None]
        m_dst = (ar_pb[None, :, None] == cm_b[:, None, None]) & commit[:, None, None]
        seq_n = torch.where(m_src, new_src[:, None, :], seq)
        seq_n = torch.where(m_dst, new_dst[:, None, :], seq_n)
        moved = (commit & cm_cc)[:, None]
        seq_len_n = seq_len + ((ar_pb[None, :] == cm_b[:, None]) & moved).long() \
            - ((ar_pb[None, :] == cm_a[:, None]) & moved).long()
        a_idx = torch.where(commit, cm_u, 0)[:, None]
        assign_n = assign.clone().scatter_(
            1, a_idx, torch.where(commit[:, None], cm_b[:, None], assign.gather(1, a_idx)))
        mp_n, ms_n = links_from_seq(seq_n, seq_len_n)

        start_n = torch.where(commit[:, None], new_start, start)
        finish_n = torch.where(commit[:, None], new_finish, finish)
        cur_mk_n = torch.where(commit, new_mk, cur_mk)
        accepted_n = st["accepted"] + found.int()
        improved = found & (cur_mk_n < best_mk - 1e-9)
        best_mk_n = torch.where(improved, cur_mk_n, best_mk)
        unimp = torch.where(improved, 0,
                            st["unimproved"] + (participates & ~exhausted).int())
        active_n = active0 & (n_moves > 0) & (unimp < self.max_unimp)

        # ---------------- write back, masked by the loop condition --------- #
        over = running & overflow
        go = running & ~overflow & ~chunk_over
        st["overflow"].copy_(st["overflow"] | over)
        st["chunk_overflow"].copy_(st["chunk_overflow"] | (running & ~overflow & chunk_over))
        # the tabu table in place: one entry per walk, its old value where
        # the walk accepted nothing
        t_idx = torch.where(found & go, destroyed, 0)[:, None]
        tabu.scatter_(1, t_idx, torch.where((found & go)[:, None], (it + tenure)[:, None].int(),
                                            tabu.gather(1, t_idx)))
        imp = improved[:, None]
        new = {
            "it": it, "n_exact": n_exact, "n_approx": n_approx, "stop": stop,
            "n_perturb": st["n_perturb"] + perturb_w.long().sum(),
            "seq": seq_n, "seq_len": seq_len_n, "assign": assign_n,
            "mpred": mp_n, "msucc": ms_n, "start": start_n, "finish": finish_n,
            "cur_mk": cur_mk_n, "best_mk": best_mk_n, "unimproved": unimp,
            "accepted": accepted_n, "active": active_n,
            "best_seq": torch.where(improved[:, None, None], seq_n, st["best_seq"]),
            "best_seq_len": torch.where(imp, seq_len_n, st["best_seq_len"]),
            "best_assign": torch.where(imp, assign_n, st["best_assign"]),
            "best_mem": torch.where(imp, mem, st["best_mem"]),
        }
        for k, v in new.items():
            st[k].copy_(torch.where(go, v, st[k]))
        r = ser["r"]
        at = r.clamp(max=self.R - 1).view(1)
        for k, v in (("best_mk", best_mk_n), ("cur_mk", cur_mk_n), ("n_exact", n_exact),
                     ("it", it), ("active", active_n),
                     ("ran", torch.ones((), dtype=torch.bool, device=dev))):
            buf = ser[k]
            buf.index_copy_(0, at, torch.where(go, v, buf.index_select(0, at)[0])[None])
        r.copy_(r + go.long())


def _get_launch(batch: InstanceBatch, w_count: int, params: TSParams, crit_cap: int,
                chunk_cap: int, cfg: DeviceConfig, dev, *, owner=None):
    """Fetch/allocate the launch for these buckets (bounded LRU).  The
    instance arrays are refilled into the launch's buffers on every use,
    never baked in: two instances that share buckets share one captured
    round.  ``owner`` (a dict standing for one run) takes the launch for
    that run until :func:`_release`; a cached launch another owner holds is
    left to it, and the caller gets a launch of its own that is not cached
    (kept in ``owner`` by key, so the run finds it again).
    Returns ``(launch, fresh)``."""
    global _UNCACHED
    cap = _csr_cap(batch)
    key = _launch_key(batch, w_count, params, crit_cap, chunk_cap, cfg, dev, cap)
    with _LAUNCH_LOCK:
        launch, fresh = _LAUNCHES.get(key), False
        if launch is None:
            launch, fresh = _Launch(batch, w_count, params, crit_cap, chunk_cap, cfg, dev,
                                    cap), True
            _LAUNCHES.put(key, launch)
        elif owner is not None and launch.owner is not None and launch.owner is not owner:
            launch = owner.get(key)
            if launch is None:
                launch, fresh = _Launch(batch, w_count, params, crit_cap, chunk_cap, cfg,
                                        dev, cap), True
                owner[key] = launch
                _UNCACHED += 1
        if owner is not None:
            launch.owner = owner
    return launch, fresh


def _release(launch: "_Launch") -> None:
    with _LAUNCH_LOCK:
        launch.owner = None


# --------------------------------------------------------------------------- #
# host loop                                                                    #
# --------------------------------------------------------------------------- #
def _start_walks(instances, inits, params):
    """Alg-3 on every init and its schedule (the walks' starting state)."""
    cur_sols, scheds = [], []
    for inst, init_list in zip(instances, inits):
        sols = [memory_update(inst, s, refresh_every=params.mem_refresh_every,
                              scalar=params.mem_update_scalar) for s in init_list]
        sc = [exact_schedule(inst, s) for s in sols]
        if not all(x is not None for x in sc):
            raise ValueError("initial solutions must be acyclic")
        cur_sols.append(sols)
        scheds.append(sc)
    return cur_sols, scheds


def _drive(batch: InstanceBatch, cur_sols, scheds, seeds, params: TSParams,
           cfg: DeviceConfig, callbacks, labels, *, solo: bool) -> list[MultiWalkResult]:
    """The run of every instance of ``batch`` to its stop: launch, replay
    ``sync_every`` rounds, read the series and flags, handle overflow,
    callbacks and budgets, Alg-3 on the active walks; then the results.

    ``solo`` is :func:`device_multiwalk`'s call: its callbacks fire at every
    sync, and its walks' incumbents are certified at syncs when sanitize
    mode is on.  The run holds its launch (:func:`_get_launch`'s ``owner``)
    until its last read.  At the end of each sync period's host
    work the ``device_search.sync`` fault point fires, keyed on the count of
    such periods (1, 2, …), as the reference's ``device_multiwalk`` does."""
    t0 = time.monotonic()
    dev = resolve_device(params.torch_device)
    instances, packs = list(batch.instances), list(batch.packs)
    n_inst, w_count = len(instances), len(cur_sols[0])
    crit_cap = cfg.crit_cap or max(_auto_crit_cap(i, s, sc)
                                   for i, s, sc in zip(instances, cur_sols, scheds))
    chunk_cap = 1
    states = [pack_state(ip, s, sc, sd)
              for ip, s, sc, sd in zip(packs, cur_sols, scheds, seeds)]
    live = {k: np.stack([st[k] for st in states]) for k in states[0]}
    init_best = live["best_mk"].copy()                        # (I, W)
    histories = [[[(0, float(init_best[i, w]))] for w in range(w_count)]
                 for i in range(n_inst)]
    g_hist = [[(0, float(init_best[i].min()))] for i in range(n_inst)]
    g_best = [h[0][1] for h in g_hist]
    mem_updates_on = params.mem_update_period < MEM_UPDATE_DISABLED
    n_exact_host = np.zeros(n_inst, dtype=np.int64)
    cb_stop = np.zeros(n_inst, dtype=bool)
    timed_out = False
    compile_s = 0.0
    k1_0, cs_0 = sdp.sweep.launches, sdp.seq_cumsum.launches
    rounds = it_min = sync_index = own_k1 = own_cs = 0
    current, me = None, {}          # ``me``: this run, as a launch's owner

    def host(src: dict, keys=None):
        with _SYNC_LOCK:
            return {k: src[k].cpu().numpy() for k in (keys or src)}

    try:
        while True:
            if time.monotonic() - t0 > params.time_limit:
                timed_out = True
                break
            # this run's launch for the buckets, held to its last read
            launch, _ = _get_launch(batch, w_count, params, crit_cap, chunk_cap, cfg, dev,
                                    owner=me)
            if current is not launch:
                try:
                    launch.load_instances(batch)
                    launch.load_state(live if current is None else current.state)
                except BaseException:
                    _release(launch)        # ``finally`` below releases ``current`` only
                    raise
                if current is not None:
                    _release(current)
                current = launch
            # no round past the iteration budget commits: replay no more of them
            n_rounds = cfg.sync_every if params.max_iters is None else \
                max(1, min(cfg.sync_every, params.max_iters - it_min))
            if launch.run(n_rounds):
                compile_s += launch.capture_seconds
            if dev.type == "cuda":
                rounds += n_rounds
                own_k1 += launch.k1_per_round * n_rounds
                own_cs += launch.cumsum_per_round * n_rounds
            ser = host(launch.series)
            flags = host(launch.state, ("overflow", "chunk_overflow", "active", "stop", "it",
                                        "n_exact", "n_approx", "cur_mk", "best_mk"))
            it_min = int(flags["it"].min())

            sync_improved = np.zeros(n_inst, dtype=bool)
            for i in range(n_inst):
                for r in range(cfg.sync_every):
                    if not ser["ran"][i, r]:
                        continue
                    it_r = int(ser["it"][i, r])
                    for w in range(w_count):
                        bmk = float(ser["best_mk"][i, r, w])
                        if bmk < histories[i][w][-1][1] - 1e-9:
                            histories[i][w].append((it_r, bmk))
                    nb = float(ser["best_mk"][i, r].min())
                    if nb < g_best[i]:
                        g_best[i] = nb
                        g_hist[i].append((it_r, nb))
                        sync_improved[i] = True

            if flags["overflow"].any() or flags["chunk_overflow"].any():
                # the overflowing round was not committed: relaunch with the next
                # bucket from the same state
                # neither can overflow at its largest bucket: the critical set
                # holds at most n_b tasks, and a walk passes its admissible moves
                # in ceil(M / K) chunks, plus one where the eval budget cuts a chunk
                before = (crit_cap, chunk_cap)
                if flags["overflow"].any():
                    crit_cap = min(max(crit_cap * 2, 32), batch.n_b)
                else:
                    chunk_cap = min(chunk_cap * 2, -(-launch.M // launch.K) + 1)
                if (crit_cap, chunk_cap) == before:
                    raise RuntimeError(f"the round overflowed at crit_cap={crit_cap}, "
                                       f"chunk_cap={chunk_cap}")
                launch.state["overflow"].zero_()
                launch.state["chunk_overflow"].zero_()
                _note_overflow_relaunch()
                continue

            if callbacks is not None:
                # per-instance anytime hooks at the sync boundary (after overflow
                # handling, before Alg-3); a truthy return stops that instance
                for i in range(n_inst):
                    cb = callbacks[i]
                    if cb is None or cb_stop[i]:
                        continue
                    act = flags["active"][i]
                    if not solo and not act.any() and not sync_improved[i]:
                        continue
                    cur_min = float(flags["cur_mk"][i][act].min()) if act.any() else g_best[i]
                    ev = TSEvent(iteration=int(flags["it"][i]), best_makespan=g_best[i],
                                 current_makespan=cur_min, elapsed=time.monotonic() - t0,
                                 n_exact_evals=int(flags["n_exact"][i]) + int(n_exact_host[i]),
                                 n_approx_evals=int(flags["n_approx"][i]),
                                 improved=bool(sync_improved[i]))
                    on_imp = getattr(cb, "on_improvement", None)
                    if sync_improved[i] and on_imp is not None and on_imp(ev):
                        cb_stop[i] = True
                    on_it = getattr(cb, "on_iteration", None)
                    if not cb_stop[i] and on_it is not None and on_it(ev):
                        cb_stop[i] = True
                    if cb_stop[i]:
                        launch.state["stop"][i] = True    # freezes the instance's rounds

            done = ~flags["active"].any(axis=1) | flags["stop"] | cb_stop
            if params.max_iters is not None:
                done |= flags["it"] >= params.max_iters
            if params.max_evals is not None:
                done |= flags["n_exact"] >= params.max_evals
            if done.all():
                break

            if mem_updates_on:
                rows = host(launch.state, _WALK_ROWS)
                for i in range(n_inst):
                    if done[i]:
                        continue
                    it_now = int(flags["it"][i])
                    for w in range(w_count):
                        if not flags["active"][i, w]:
                            continue
                        sub = {k: rows[k][i, w:w + 1].copy() for k in _WALK_ROWS}
                        sol_w = unpack_solution(packs[i], sub["seq"], sub["seq_len"],
                                                sub["assign"], sub["mem"], 0)
                        sol_w = memory_update(instances[i], sol_w,
                                              refresh_every=params.mem_refresh_every,
                                              scalar=params.mem_update_scalar)
                        sched_w = exact_schedule(instances[i], sol_w)
                        if sched_w is None:
                            raise RuntimeError("memory_update returned a cyclic solution")
                        n_exact_host[i] += 1
                        _write_walk(packs[i], sub, 0, sol_w, sched_w)
                        with _SYNC_LOCK:
                            for k in _WALK_ROWS:
                                launch.state[k][i, w:w + 1].copy_(torch.from_numpy(sub[k]))
                        if sched_w.makespan < flags["best_mk"][i, w] - 1e-9:
                            launch.state["best_mk"][i, w] = float(sched_w.makespan)
                            for best, cur in _BEST:
                                launch.state[best][i, w].copy_(launch.state[cur][i, w])
                            histories[i][w].append((it_now, float(sched_w.makespan)))
                            if solo:
                                _maybe_sanitize(instances[i], sol_w,
                                                f"device_multiwalk sync incumbent walk {w}",
                                                params, mk=float(sched_w.makespan))
                            if sched_w.makespan < g_best[i]:
                                g_best[i] = float(sched_w.makespan)
                                g_hist[i].append((it_now, g_best[i]))

            sync_index += 1
            # chaos harness: a seeded plan can lose the device at a sync
            # boundary (the reference's point and keying)
            _inject.fire("device_search.sync", key=sync_index)

        state = live if current is None else host(current.state)
    finally:
        if current is not None:
            _release(current)
    stats = {
        "crit_cap": crit_cap, "chunk_cap": chunk_cap,
        "k1_launches": sdp.sweep.launches - k1_0,
        "seq_cumsum_launches": sdp.seq_cumsum.launches - cs_0,
        "rounds_replayed": rounds,
        # this run's own replayed launches (the counters above are
        # process-wide, so under concurrency they hold other runs' too)
        "k1_replayed": own_k1, "seq_cumsum_replayed": own_cs,
        "k1_per_round": current.k1_per_round if current is not None else 0,
        "seq_cumsum_per_round": current.cumsum_per_round if current is not None else 0,
    }
    results = []
    for i in range(n_inst):
        active = state["active"][i]
        if cb_stop[i]:
            stop_reason = "callback"
        elif not active.any():
            stop_reason = "converged"
        elif timed_out:
            stop_reason = "time_limit"
        elif params.max_iters is not None and state["it"][i] >= params.max_iters:
            stop_reason = "max_iters"
        elif state["stop"][i] or (params.max_evals is not None
                                  and state["n_exact"][i] >= params.max_evals):
            stop_reason = "max_evals"
        else:
            stop_reason = "time_limit"
        best_mk = np.array(state["best_mk"][i])
        best_sols = [unpack_solution(packs[i], state["best_seq"][i], state["best_seq_len"][i],
                                     state["best_assign"][i], state["best_mem"][i], w)
                     for w in range(w_count)]
        if mem_updates_on:
            # in-launch incumbents were taken with a frozen allocation; re-run
            # Alg-3 on any capacity-infeasible walk best so the report upholds
            # the NumPy search loops' feasibility contract
            best_sols, best_mk = _repair_bests(instances[i], params, best_sols, best_mk)
        gi = int(np.argmin(best_mk))
        _maybe_sanitize(instances[i], best_sols[gi],
                        "device_multiwalk final best" if solo
                        else f"solve_instances final best (instance {i})",
                        params, mk=float(best_mk[gi]), capacity=mem_updates_on)
        per_walk = [
            WalkInfo(init_label=labels[w], initial_makespan=histories[i][w][0][1],
                     best_makespan=float(best_mk[w]), best=best_sols[w],
                     history=histories[i][w],
                     stop_reason=stop_reason if active[w] else "converged")
            for w in range(w_count)]
        res = MultiWalkResult(
            best=best_sols[gi], best_makespan=float(best_mk[gi]),
            initial_makespan=float(init_best[i].min()),
            iterations=int(state["it"][i]), elapsed=time.monotonic() - t0,
            history=g_hist[i],
            n_exact_evals=int(state["n_exact"][i]) + int(n_exact_host[i]),
            n_approx_evals=int(state["n_approx"][i]), stop_reason=stop_reason,
            n_perturbations=int(state["n_perturb"][i]), walks=w_count, per_walk=per_walk)
        res.compile_seconds = compile_s  # type: ignore[attr-defined]
        res.device_stats = dict(stats)   # type: ignore[attr-defined]
        results.append(res)
    return results


def device_multiwalk(
    inst: Instance,
    inits: list[Solution],
    params: TSParams | None = None,
    *,
    config: DeviceConfig | None = None,
    init_labels: list[str] | None = None,
    on_iteration=None,
    on_improvement=None,
    on_checkpoint=None,
    resume_from=None,
) -> MultiWalkResult:
    """Drop-in ``tabu_multiwalk`` with the round loop on the device
    (``params.torch_device``: ``"cuda"`` by default, which raises without a
    GPU; ``"cpu"`` runs the same round eagerly with the plain K1).

    Callbacks fire at sync boundaries (every ``config.sync_every`` rounds)
    rather than per iteration; Algorithm 3 runs at the same boundaries when
    ``params.mem_update_period < MEM_UPDATE_DISABLED``.  The result carries
    ``compile_seconds`` (the capture time of its launches) and
    ``device_stats`` (buckets, K1 / ``seq_cumsum`` launches, rounds
    replayed).  ``on_checkpoint`` / ``resume_from`` belong to the fault
    layer's checkpointing, which is not ported yet (ROADMAP A6): passing
    either raises.
    """
    if on_checkpoint is not None or resume_from is not None:
        raise NotImplementedError(
            "on_checkpoint / resume_from need the fault layer's checkpointing "
            "(repro_torch.faults.checkpoint), not ported yet (ROADMAP A6)")
    params = params or TSParams()
    cfg = config or DeviceConfig()
    w_count = len(inits)
    if w_count < 1:
        raise ValueError("device_multiwalk needs at least one init")
    labels = init_labels or [f"walk{w}" for w in range(w_count)]
    resolve_device(params.torch_device)
    batch = InstanceBatch.from_instances([inst])
    cur_sols, scheds = _start_walks([inst], [inits], params)
    cb = None
    if on_iteration is not None or on_improvement is not None:
        cb = [types.SimpleNamespace(on_iteration=on_iteration,
                                    on_improvement=on_improvement)]
    return _drive(batch, cur_sols, scheds, [params.seed], params, cfg, cb, labels,
                  solo=True)[0]


def _repair_bests(inst: Instance, params: TSParams, best_sols, best_mk):
    """Re-run Algorithm 3 on capacity-infeasible walk incumbents (their
    allocation was frozen between syncs) and refresh their makespans."""
    from .solution import memory_feasible

    for w, sol in enumerate(best_sols):
        sched = exact_schedule(inst, sol)
        assert sched is not None
        if memory_feasible(inst, sol, sched):
            continue
        sol = memory_update(inst, sol, refresh_every=params.mem_refresh_every,
                            scalar=params.mem_update_scalar)
        sched = exact_schedule(inst, sol)
        assert sched is not None
        best_sols[w] = sol
        best_mk[w] = sched.makespan
    return best_sols, best_mk


def _auto_crit_cap(inst, sols, scheds) -> int:
    from .solution import heads_tails

    worst = 16
    for sol, sched in zip(sols, scheds):
        _, _, _, crit = heads_tails(inst, sol, sched)
        worst = max(worst, int(crit.sum()))
    # no headroom factor: overflow escalation doubles the bucket on demand,
    # and a tight capacity halves the padded neighbourhood the window pass
    # and sorts chew through every round
    return min(sdp.bucket(worst, 32), inst.n_tasks)


# --------------------------------------------------------------------------- #
# a batch of same-bucket instances                                            #
# --------------------------------------------------------------------------- #
def solve_instances(
    instances: "list[Instance] | InstanceBatch",
    inits: list[list[Solution]],
    params: TSParams | None = None,
    *,
    config: DeviceConfig | None = None,
    seeds: "list[int] | None" = None,
    callbacks: "list | None" = None,
) -> list[MultiWalkResult]:
    """Run the device engine over a batch of same-bucket instances, one
    graph replay per round for the whole batch.

    ``instances`` may be a plain list (packed here) or a prebuilt
    :class:`~repro_torch.instances.InstanceBatch`.  Every buffer carries a
    leading instance axis, every update is masked by the instance's own
    loop condition, so per-instance results are identical to per-instance
    ``device_multiwalk`` calls with the same ``crit_cap``.  Budgets apply
    per instance; wall time is checked between sync periods; Algorithm 3
    runs on the host at sync boundaries as in the single-instance run.

    ``seeds`` gives each instance its own search seed (tenure/perturbation
    words — the value ``params.seed`` carries on a solo run); the captured
    round is seed-independent.  ``callbacks`` is an optional per-instance
    list of :class:`~repro_torch.core.api.Callbacks`-shaped objects
    (``None`` entries allowed), fired per instance at sync boundaries with
    that instance's own :class:`TSEvent`; a truthy return stops *that
    instance only* (its ``stop_reason`` becomes ``"callback"``).
    """
    params = params or TSParams()
    cfg = config or DeviceConfig()
    batch = instances if isinstance(instances, InstanceBatch) \
        else InstanceBatch.from_instances(instances)
    n_inst = len(batch)
    if n_inst < 1 or len(inits) != n_inst:
        raise ValueError("need at least one instance and one init list per instance")
    w_count = len(inits[0])
    if not all(len(x) == w_count for x in inits):
        raise ValueError("equal walk counts required")
    if seeds is None:
        seeds = [params.seed] * n_inst
    if len(seeds) != n_inst:
        raise ValueError("one seed per instance")
    if callbacks is not None and len(callbacks) != n_inst:
        raise ValueError("one callback slot per instance")
    resolve_device(params.torch_device)
    cur_sols, scheds = _start_walks(batch.instances, inits, params)
    return _drive(batch, cur_sols, scheds, list(seeds), params, cfg, callbacks,
                  [f"walk{w}" for w in range(w_count)], solo=False)


# --------------------------------------------------------------------------- #
# warm pool                                                                    #
# --------------------------------------------------------------------------- #
def warm_launches(
    instances: "list[Instance] | InstanceBatch",
    walks: int,
    params: TSParams | None = None,
    *,
    config: DeviceConfig | None = None,
    batch_sizes: tuple = (1,),
) -> dict:
    """Capture the ``solve_instances`` rounds one launch shape needs.

    ``instances`` (a list or prebuilt :class:`InstanceBatch`) declares the
    shape — shared buckets, dense widths, padded edge lengths; ``walks`` and
    ``params`` supply the launch-relevant search knobs; ``batch_sizes`` are
    the batch widths to warm.  Each missing launch is allocated and, on the
    card, captured on replicas of the first instance with its walks'
    starting state (nothing is replayed).  The crit-set bucket is
    ``config.crit_cap`` or the batch's task bucket.  Each size is warmed at
    one exact-evaluation chunk, where a run starts, and at two, the first
    rung of the chunk-overflow relaunch (a round whose first ``top_k``
    candidates are all refused needs it); a round that needs more than two
    still captures its launch when it comes.  Returns per-size seconds and
    launch-cache counter deltas.
    """
    from .api import multiwalk_inits  # lazy: api imports this module lazily

    params = params or TSParams()
    cfg = config or DeviceConfig()
    dev = resolve_device(params.torch_device)
    batch = instances if isinstance(instances, InstanceBatch) \
        else InstanceBatch.from_instances(instances)
    inst = batch.instances[0]
    crit = cfg.crit_cap or batch.n_b
    init_sols, _ = multiwalk_inits(inst, walks, params.seed)
    sols, scheds = _start_walks([inst], [init_sols], params)
    state = pack_state(batch.packs[0], sols[0], scheds[0], params.seed)
    before = launch_cache_info()
    per_size: dict = {}
    for bs in sorted({int(b) for b in batch_sizes}):
        if bs < 1:
            raise ValueError("batch sizes must be positive")
        t0 = time.monotonic()
        rep = InstanceBatch.from_instances(
            [inst] * bs, n_b=batch.n_b, p_b=batch.p_b, d_b=batch.d_b,
            widths=batch.widths, e_b=batch.e_b, validate=False)
        any_fresh = False
        # ``_drive`` relaunches at min(2 J, ceil(M / K) + 1) chunks: 2 after 1
        for j in (1, 2):
            launch, fresh = _get_launch(rep, walks, params, crit, j, cfg, dev, owner={})
            try:
                if fresh:
                    launch.load_instances(rep)
                    launch.load_state({k: np.stack([v] * bs) for k, v in state.items()})
                    if dev.type == "cuda":
                        launch._capture()
            finally:
                _release(launch)
            any_fresh |= fresh
        per_size[bs] = {"fresh": any_fresh, "seconds": time.monotonic() - t0}
    after = launch_cache_info()
    return {
        "bucket_key": batch.bucket_key,
        "per_size": per_size,
        "compile_seconds": sum(v["seconds"] for v in per_size.values() if v["fresh"]),
        "cache_delta": {k: after[k] - before[k]
                        for k in ("hits", "misses", "evictions", "overflow_relaunches")},
        "cache": after,
    }
