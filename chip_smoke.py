#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch.solve(inst, "tabu_multiwalk")`` at the paper's instance
size (250 tasks, 600 data blocks, 10 cores; 8 walks, top-K 10) through the
hand-written schedule-DP kernel, and holds that kernel against its plain
PyTorch version on the card.  Phases, one JSON line each:

  env        torch / CUDA versions, the card's name and power limit
  build      nvcc builds every kernel from the sources in this checkout
  kernels    each kernel against its plain version, bit for bit
  main_path  the solve on the card, against the port's NumPy backend, certified,
             with the host time of each phase of the search round
  timing     kernel, plain version, bound and host engine at the main path's shape

then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  Without a GPU it exits non-zero.

"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense, non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

EDGE_SIZES = (31, 32, 33, 63, 64, 65, 250)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def candidate_batch(seed: int, n_tasks: int, n_data: int, max_k: int):
    """A mixed feasible/cyclic candidate batch from a real neighbourhood:
    the greedy incumbent plus N7 / change-core neighbours taken evenly across
    the move list (the N7 end is mostly cyclic, the change-core end mostly not)."""
    from repro_torch.core import random_instance
    from repro_torch.core.greedy import construct_greedy
    from repro_torch.core.solution import exact_schedule, heads_tails
    from repro_torch.core.tabu import _cc_moves, _n7_moves, apply_move

    inst = random_instance(seed, n_tasks=n_tasks, n_data=n_data)
    sol = construct_greedy(inst, "slack_first", rng=seed)
    sched = exact_schedule(inst, sol)
    r, _, _, crit = heads_tails(inst, sol, sched)
    moves = _n7_moves(sol, crit) + _cc_moves(inst, sol, crit, r, sched.start, 5)
    cands = [sol]
    step = max(1, len(moves) // max(1, max_k - 1))
    for m in moves[::step][: max_k - 1]:
        c = sol.copy()
        apply_move(c, m)
        cands.append(c)
    for i in range(max_k - len(cands)):  # thin neighbourhood: repeat rows to the asked size
        cands.append(cands[i])
    return inst, cands


def sweep_operands(inst, cands, np_dtype, device):
    """The tensors ``BatchEvaluator`` hands the sweep for these candidates."""
    import numpy as np
    import torch

    from repro_torch.core.eval_batch import BatchEvaluator, pack_solutions
    from repro_torch.kernels import schedule_dp as sdp

    eng = BatchEvaluator(inst, backend="numpy")
    packed = pack_solutions(inst, cands)
    dur = eng._durations(packed)
    graph = sdp.dense_graph(inst)
    k, n, n_b = packed.k, inst.n_tasks, graph.n_b

    def up(a, fill, dt):
        out = np.full((k, n_b), fill, dtype=dt)
        out[:, :n] = a
        return torch.from_numpy(out).to(device)

    return (eng, packed, graph.to(device), up(dur, 0.0, np_dtype),
            up(packed.mpred, -1, np.int32), up(packed.msucc, -1, np.int32))


def max_abs_err(got, want) -> float:
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        if a.numel():
            worst = max(worst, float((a.to(torch.float64) - b.to(torch.float64)).abs().max()))
    return worst


def phase_kernels(device):
    """Kernel vs plain version, all three call shapes, f64 and f32, bit equal."""
    import numpy as np
    import torch

    from repro_torch.kernels import schedule_dp as sdp

    worst = 0.0
    n_cyclic = n_rows = n_checks = 0
    for n in EDGE_SIZES:
        n_data, max_k = (600, 80) if n == 250 else (90, 24)
        inst, cands = candidate_batch(n % 7, n, n_data, max_k)
        for np_dtype in (np.float64, np.float32):
            _, _, graph, dur, mpred, msucc = sweep_operands(inst, cands, np_dtype, device)
            for tails in (False, True):
                got = sdp.sweep(graph, dur, mpred, msucc, tails=tails)
                torch.cuda.synchronize()
                want = sdp.sweep_torch(graph.pred_mat, graph.succ_mat, dur, mpred,
                                       msucc, graph.n, tails=tails)
                worst = max(worst, max_abs_err(got, want))
                for name, a, b in zip(("start", "finish", "level", "n_done", "q"), got, want):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"schedule_dp {name} differs from the plain version: "
                            f"n={n} {np_dtype.__name__} tails={tails}")
                n_checks += 1
            # backward-only shape: node weight finish - start, some rows masked out
            start, finish, _, n_done, q_full = want
            active = n_done == graph.n
            n_cyclic += int((~active).sum())
            n_rows += int(active.numel())
            active[::3] = False
            node = finish - start
            got_q = sdp.backward_q(graph, node, msucc, active)
            torch.cuda.synchronize()
            want_q = sdp.backward_q_torch(graph.succ_mat, node, msucc, graph.n,
                                          active[:, None])
            worst = max(worst, max_abs_err([got_q], [want_q]))
            if not torch.equal(got_q, want_q):
                raise AssertionError(f"schedule_dp backward-only q differs: n={n} "
                                     f"{np_dtype.__name__}")
            if not torch.equal(got_q[active], q_full[active]):
                raise AssertionError("backward-only q disagrees with the full sweep's q")
            n_checks += 1
    if n_cyclic == 0:
        raise AssertionError("no cyclic row in any batch: the comparison is too easy")
    say("kernels", kernels=["schedule_dp"], sizes=list(EDGE_SIZES), checks=n_checks,
        rows=n_rows, cyclic_rows=n_cyclic, max_abs_err=worst,
        tolerance="0 (torch.equal), float64 and float32")
    return worst


class HostTimers:
    """Host seconds spent in each phase of the search round, taken by
    wrapping the functions ``tabu_multiwalk`` calls (by the names it calls
    them under, so nothing else is slowed).  The phases do not nest, so the
    times add up; what is left of the wall time is the round's own Python.
    ``evaluate`` is the exact evaluation (padding, transfers and the wait for
    the device included: it returns NumPy arrays); its batches, their largest
    row count and the deepest level seen are recorded too."""

    def __init__(self):
        from repro_torch.core import tabu
        from repro_torch.core.eval_batch import BatchEvaluator, PackedSolutions

        self.targets = {
            "evaluate": (BatchEvaluator, "evaluate"),
            "backward_tails": (BatchEvaluator, "backward_tails"),
            "apply_moves": (PackedSolutions, "apply_moves"),
            "positions": (PackedSolutions, "positions"),
            "n7_moves": (tabu, "_n7_move_batch"),
            "change_core_moves": (tabu, "_cc_move_batch"),
            "approx_ranking": (tabu, "approx_eval_moves"),
            "resulting_configs": (tabu, "_resulting_configs"),
            "memory_update": (tabu, "memory_update"),
            "exact_schedule": (tabu, "exact_schedule"),
        }
        self.reset()

    def reset(self):
        self.seconds = dict.fromkeys(self.targets, 0.0)
        self.calls = dict.fromkeys(self.targets, 0)
        self.max_rows = self.max_levels = 0

    def _wrap(self, phase, orig):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            self.seconds[phase] += time.perf_counter() - t0
            self.calls[phase] += 1
            if phase == "evaluate":
                self.max_rows = max(self.max_rows, int(out.feasible.shape[0]))
                if out.feasible.any():
                    self.max_levels = max(self.max_levels,
                                          int(out.level[out.feasible].max()) + 1)
            return out
        return timed

    def __enter__(self):
        self.orig = {ph: getattr(o, nm) for ph, (o, nm) in self.targets.items()}
        for ph, (o, nm) in self.targets.items():
            setattr(o, nm, self._wrap(ph, self.orig[ph]))
        return self

    def __exit__(self, *exc):
        for ph, (o, nm) in self.targets.items():
            setattr(o, nm, self.orig[ph])

    def breakdown(self, wall: float) -> dict:
        out = {ph: {"s": self.seconds[ph], "calls": self.calls[ph]} for ph in self.targets}
        out["other"] = {"s": wall - sum(self.seconds.values()), "calls": None}
        return out


def phase_main_path():
    """The solve through the default backend, against the NumPy backend."""
    from repro_torch import solve
    from repro_torch.analysis.certify import certify_solution
    from repro_torch.core import TSParams, random_instance
    from repro_torch.kernels import schedule_dp as sdp

    n_tasks, n_data, walks, iters = 250, 600, 8, 30
    inst = random_instance(0, n_tasks=n_tasks, n_data=n_data)
    params = TSParams(top_k=10, max_unimproved=10**9, time_limit=10**9, max_iters=iters)
    kw = dict(walks=walks, params=params, seed=0)

    with HostTimers() as log:
        sdp.sweep.launches = 0
        t0 = time.perf_counter()
        rep = solve(inst, "tabu_multiwalk", **kw)      # default: torch on cuda
        wall = time.perf_counter() - t0
        launches, batches = sdp.sweep.launches, log.calls["evaluate"]
        max_rows, max_levels = log.max_rows, log.max_levels
        host = log.breakdown(wall)
        log.reset()
        t0 = time.perf_counter()
        ref = solve(inst, "tabu_multiwalk", **kw, backend="numpy")
        wall_ref = time.perf_counter() - t0
        host_ref = log.breakdown(wall_ref)
    if launches != batches or launches <= 0:
        raise AssertionError(f"{batches} evaluate batches but {launches} kernel launches")
    if (rep.makespan, rep.history, rep.n_exact_evals, rep.iterations) != \
            (ref.makespan, ref.history, ref.n_exact_evals, ref.iterations):
        raise AssertionError("torch backend and NumPy backend trajectories differ")
    cert = certify_solution(inst, rep.solution, reported_makespan=rep.makespan,
                            claimed_feasible=rep.feasible)
    if not cert.ok:
        raise AssertionError("certificate rejected the result: " + cert.summary())
    base = solve(inst, "load_balance", seed=0).makespan
    n_b = sdp.bucket(n_tasks)
    say("main_path", n_tasks=n_tasks, n_data=n_data, n_procs=inst.n_procs, walks=walks,
        top_k=params.top_k, iterations=rep.iterations, stop_reason=rep.stop_reason,
        makespan=rep.makespan, initial_makespan=rep.initial_makespan,
        load_balance_makespan=base, improvement_over_load_balance=1.0 - rep.makespan / base,
        n_exact_evals=rep.n_exact_evals, evaluate_batches=batches, launches=launches,
        largest_launch=[max_rows, n_b], deepest_level=max_levels,
        matches_numpy_backend=True, certified=True, feasible=rep.feasible,
        wall_s=wall, evaluate_s=host["evaluate"]["s"], host_phases=host,
        wall_s_numpy_backend=wall_ref,
        evaluate_s_numpy_backend=host_ref["evaluate"]["s"],
        host_phases_numpy_backend=host_ref, backend=rep.extras["backend"])
    return launches, max_rows


def cuda_median_ms(fn, reps: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails: bool) -> dict:
    """Least time for this call's work: bytes each read/written once over the
    memory rate, against the max/add operations this data needs over the
    peak rate of its type."""
    b, n_b = dur.shape
    es = dur.element_size()
    fired = finish > 0                              # durations are positive
    indeg = (graph.pred_mat >= 0).sum(dim=1)[None, :] + (mpred >= 0)
    # per fired task: (links + 1) max for finish, the same again for start, one add
    ops = int((fired * (2 * (indeg + 1) + 1)).sum())
    n_in = b * n_b * (es + 4) + graph.pred_mat.numel() * 4     # dur, mpred, pred_mat
    n_out = b * n_b * (es + es + 4) + b * 4                    # start, finish, level, n_done
    if tails:                                                  # + msucc, succ_mat in, q out
        feas = (n_done == graph.n)[:, None]
        outdeg = (graph.succ_mat >= 0).sum(dim=1)[None, :] + (msucc >= 0)
        ops += int((feas * fired * ((outdeg + 1) + 2)).sum())
        n_in += b * n_b * 4 + graph.succ_mat.numel() * 4
        n_out += b * n_b * es
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dur.dtype).split(".")[-1]] * 1e3
    return {"bytes": n_in + n_out, "operations": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def chain_probe_ms_per_level(blocks: int, threads: int, device) -> float:
    """Measured cost of the least a two-phase level can be (one dependent
    shared-memory load, a voting barrier, one store, a barrier)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    lib = _build.load("schedule_dp")
    fn = lib.schedule_dp_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(blocks, dtype=torch.float64, device=device)
    levels = 20000

    def run():
        err = fn(levels, blocks, threads, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"chain probe launch failed: CUDA error {err}")

    ms = cuda_median_ms(run, reps=10, warmup=2)
    if float(out[0]) <= 0:
        raise AssertionError("chain probe did not run")
    return ms / levels


def phase_timing(device, rows: int):
    """K1 at the main path's shape: forward only (what the search launches)
    and forward + tails."""
    import numpy as np
    import torch

    from repro_torch.kernels import schedule_dp as sdp

    inst, cands = candidate_batch(0, 250, 600, rows)
    eng, packed, graph, dur, mpred, msucc = sweep_operands(inst, cands, np.float64, device)
    per_level = chain_probe_ms_per_level(rows, 256, device)
    out = {}
    for tails in (False, True):
        launches_before = sdp.sweep.launches
        res = sdp.sweep(graph, dur, mpred, msucc, tails=tails)
        torch.cuda.synchronize()
        start, finish, level, n_done, q = res
        ms = cuda_median_ms(lambda: sdp.sweep(graph, dur, mpred, msucc, tails=tails),
                            reps=100, warmup=10)
        plain_ms = cuda_median_ms(
            lambda: sdp.sweep_torch(graph.pred_mat, graph.succ_mat, dur, mpred, msucc,
                                    graph.n, tails=tails), reps=5, warmup=1)
        bound = sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails)
        depth = int(level.max()) + 1
        chain_levels = depth * (2 if tails else 1)   # the backward loop is as deep
        out["tails" if tails else "forward"] = {
            "ms": ms, "plain_ms": plain_ms, **bound,
            "depth_levels": depth, "chain_ms": chain_levels * per_level,
            "timed_launches": sdp.sweep.launches - launches_before}
    # the host engine on the same rows, for context
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng._forward_dp(packed, eng._durations(packed))
        t.append((time.perf_counter() - t0) * 1e3)
    say("timing", shape=[rows, graph.n_b], dtype="float64",
        chain_probe_ms_per_level=per_level, forward=out["forward"], tails=out["tails"],
        numpy_forward_dp_host_ms=statistics.median(t),
        note="ms: median of 100 launches timed with CUDA events after 10 warm-up "
             "launches, inputs resident on the card; chain_ms = levels x measured cost "
             "of a minimal two-barrier level and is the bound that binds; bound_ms is "
             "the bytes/operations bound")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import numpy as np

    import repro_torch  # noqa: F401
    from repro_torch.kernels import _build
    from repro_torch.kernels import schedule_dp as sdp

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, numpy=np.__version__, card=smi,
        device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    say("build", kernels=sorted(_build.KERNEL_SOURCES), flags=list(_build.NVCC_FLAGS),
        seconds=time.perf_counter() - t0, build_dir=str(_build.build_dir()))

    worst = phase_kernels(device)
    launches, max_rows = phase_main_path()
    timing = phase_timing(device, rows=max_rows)

    fwd = timing["forward"]
    print(json.dumps({"kernels": [{
        "name": "schedule_dp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/schedule_dp.cu",
        "replaces": "src/repro/kernels/schedule_dp.py:334",
        "launches": launches, "max_abs_err": worst,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None,
        "chain_ms": fwd["chain_ms"], "shape": [max_rows, sdp.bucket(250)],
        "dtype": "float64", "call": "forward only",
        "tails_ms": timing["tails"]["ms"], "tails_plain_ms": timing["tails"]["plain_ms"],
        "tails_bound_ms": timing["tails"]["bound_ms"],
        "tails_chain_ms": timing["tails"]["chain_ms"],
    }], "seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
