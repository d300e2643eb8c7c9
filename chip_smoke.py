#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through their hand-written kernels and holds
every kernel against its plain PyTorch version on the card:

* the scheduler: ``repro_torch.solve(inst, "tabu_multiwalk")`` at the paper's
  instance size (250 tasks, 600 data blocks, 10 cores; 8 walks, top-K 10)
  through the schedule-DP kernel (K1), and ``solve(inst, "tabu_device")``,
  the device-resident search, whose round is captured as a CUDA graph that
  launches K1 and the sequential prefix-sum kernel (``seq_cumsum``);
* the scheduling-solve service: ``repro_torch.serve.SolveService`` at the
  reference's full serving profile (36 requests of three families, 70-80
  tasks, 4 walks, 20 iterations, Poisson arrivals at 4/s), its batches
  through ``solve_instances``' captured rounds (K1, ``seq_cumsum``), a fault
  lane, and the ``table2`` suite swept on the device engine;
* model serving: recurrentgemma-2b at its published width (26 layers, d 2560,
  vocab 256000), random bf16 parameters from seed 0, batch 4, 4096-token
  prompts (twice the attention window), 32 greedy tokens, through the flash
  attention kernel (K2) and the RG-LRU scan kernel (K3);
* model serving: mamba2-780m at its published width and depth (48 SSD layers,
  d 1536, 48 heads of 64, state 128, vocab 50280), the same batch, prompts
  and tokens, through the Mamba-2 SSD kernel (K4) in every layer, at the
  prefill and at every decode step.

Phases, one JSON line each:

  env            torch / CUDA versions, the card's name and power limit
  build          nvcc builds every kernel from the sources in this checkout
  ptxas          registers, shared memory, stack and spills of every kernel
                 function, from the builds' ``ptxas -v`` output; the bf16
                 tensor-core kernels (K2, K4) must not spill, and K1's and
                 K3's kernels must use neither spills nor a stack
  kernels        K1 against its plain version, bit for bit
  model_kernels  K2 (f32 2e-5, bf16 2e-2, LSE 1e-5 in both), K3 (bit for bit)
                 and K4 (f32 1e-4; bf16 x/B/C: y 2e-2, h_last 1e-4) against
                 their plain versions, at the reference's test shapes, ragged
                 ones, T = 1 and the serving shapes
  main_path      the solve on the card, against the port's NumPy backend,
                 certified, with the host time of each phase of the search round
  device_path    ``tabu_device`` at the same configuration: without Algorithm 3
                 (cold, then three warm runs paired in alternating order with
                 NumPy runs) bit-identical to the NumPy ``tabu_multiwalk``
                 with no perturbation; with it, certified with capacity; the
                 replays run with every synchronising call an error, the time
                 of one replayed round, and the K1 / seq_cumsum launches that
                 the profiler sees in replays held to the captured round's
                 nodes; then seq_cumsum against its plain version (bit for
                 bit), timed beside its bound and its chain of dependent adds
  model_serve    per arch (recurrentgemma-2b, then mamba2-780m): the
                 full-width serve (launch counts of every model kernel
                 asserted), the card's kernel time by class over a profiled
                 prefill and 8 decode steps, and the serve held teacher-forced
                 against the same model on the plain versions; for
                 mamba2-780m also the same check in float32, and the plain
                 version against itself at another chunk length (the
                 rounding noise of a correct bf16 path)
  timing         K1, plain version, bound, its time per level against the
                 measured least cost of a level, and the host engine at the
                 main path's shape
  model_timing   K2, K3 and K4 at the serving shapes: kernel, plain version,
                 bound (K4's at the precision it computes in, and at the fp32
                 rate), for K2 PyTorch's scaled_dot_product_attention, and
                 the K3 and K4 decode steps beside their bounds
  solve_service  the solve service: warm-up (one WarmSpec per signature
                 class), the Poisson trace with no capture during traffic,
                 the K1 / seq_cumsum launches of the served run, one served
                 cut under the profiler (its K1 launches = captured nodes x
                 rounds), every report certified and bit-identical to its
                 solo tabu_device solve (the solo loop timed cold and warm),
                 the first 12 requests again under a seeded fault plan of
                 every kind with a watchdog (every request one terminal
                 state, survivors equal to their solo solves, no launch
                 failing but by an injected fault), and the table2 sweep on
                 the device engine against the NumPy engine

then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  Without a GPU it exits non-zero.

"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense): float32 and
# float64 outside the tensor cores, bfloat16 in them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}

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


def ptxas_report(log: str) -> list:
    """Per kernel function (by its mangled name) of one ``nvcc -Xptxas=-v``
    log: registers, stack frame, spill stores and loads, static shared memory
    (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "stack": 0,
                   "spill_stores": 0, "spill_loads": 0, "static_smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return out


# libraries whose every kernel must use neither spills nor a stack frame
NO_STACK_LIBRARIES = ("schedule_dp", "rglru")


def phase_ptxas(names) -> None:
    """What ptxas reported for every kernel function; the bf16 tensor-core
    kernels (``*_mma_kernel``) must not spill, and no kernel of
    ``NO_STACK_LIBRARIES`` may spill or use a stack frame."""
    from repro_torch.kernels import _build

    report = {name: ptxas_report(_build.build_log(name)) for name in names}
    say("ptxas", functions=report,
        note="registers per thread, bytes of stack, spill stores / loads and static shared "
             "memory per kernel function (dynamic shared memory is set at launch)")
    faults = ptxas_faults(report)
    if faults:
        raise AssertionError("; ".join(faults))


def ptxas_faults(report: dict) -> list:
    """What ``phase_ptxas`` refuses in a report (library name -> functions)."""
    faults = []
    spilled = [f["kernel"] for fs in report.values() for f in fs
               if "mma_kernel" in f["kernel"] and (f["spill_stores"] or f["spill_loads"])]
    if spilled:
        faults.append(f"tensor-core kernels spill registers: {spilled}")
    stacked = [f["kernel"] for name in NO_STACK_LIBRARIES for f in report.get(name, ())
               if f["stack"] or f["spill_stores"] or f["spill_loads"]]
    if stacked:
        faults.append(f"K1 / K3 kernels spill or use a stack frame: {stacked}")
    return faults


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
            if np_dtype is np.float64:      # as the device round calls it
                worst = max(worst, check_sweep_launch(graph, dur, mpred, msucc, active))
                n_checks += 2
    if n_cyclic == 0:
        raise AssertionError("no cyclic row in any batch: the comparison is too easy")
    say("kernels", kernels=["schedule_dp"], sizes=list(EDGE_SIZES), checks=n_checks,
        rows=n_rows, cyclic_rows=n_cyclic, max_abs_err=worst,
        tolerance="0 (torch.equal), float64 and float32")
    return worst


def check_sweep_launch(graph, dur, mpred, msucc, active) -> float:
    """K1 as the device-resident round calls it (``SweepLaunch``: outputs
    allocated once, the task count read on the device, the CSR in buffers
    longer than its links; the graph's own ``n`` set to 0, so a kernel that
    ignored the device count would disagree), forward and backward-only,
    against the plain version, bit for bit."""
    import dataclasses

    import torch

    from repro_torch.kernels import schedule_dp as sdp

    dev, b = dur.device, dur.shape[0]

    def longer(csr):
        return csr[0], torch.cat([csr[1], torch.zeros(128, dtype=torch.int32, device=dev)])

    g = dataclasses.replace(graph, n=0).with_csr(longer(graph.pred_csr),
                                                 longer(graph.succ_csr))
    n_valid = torch.full((1,), graph.n, dtype=torch.int32, device=dev)
    start, finish, n_done = sdp.SweepLaunch(g, b, sdp.MODE_FORWARD, n_valid)(dur, mpred)
    q = sdp.SweepLaunch(g, b, sdp.MODE_BACKWARD, n_valid)(finish - start, msucc, active)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    w_start, w_finish, _, w_done, _ = sdp.sweep_torch(
        graph.pred_mat, graph.succ_mat, dur, mpred, msucc, graph.n, tails=False)
    w_q = sdp.backward_q_torch(graph.succ_mat, w_finish - w_start, msucc, graph.n,
                               active[:, None])
    got, want = (start, finish, n_done, q), (w_start, w_finish, w_done, w_q)
    for name, x, y in zip(("start", "finish", "n_done", "q"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"schedule_dp through SweepLaunch: {name} differs from the "
                                 f"plain version (n={graph.n})")
    return max_abs_err(got, want)


class HostTimers:
    """Host seconds spent in each phase of the search round, taken by
    wrapping the functions ``tabu_multiwalk`` calls (by the names it calls
    them under, so nothing else is slowed).  The phases do not nest, so the
    times add up; what is left of the wall time is the round's own Python.
    ``evaluate`` is the exact evaluation (padding, transfers and the wait for
    the device included: it returns NumPy arrays); its batches, their largest
    row count and the deepest level seen are recorded too."""

    def __init__(self, targets=None):
        from repro_torch.core import tabu
        from repro_torch.core.eval_batch import BatchEvaluator, PackedSolutions

        self.targets = targets or {
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
    return launches, max_rows, wall


def device_targets() -> dict:
    """What ``HostTimers`` wraps around a ``tabu_device`` solve: the walks'
    greedy starts (Algorithm 1), Algorithm 3 and the scalar schedules (the
    inits, the syncs, the final repair), one sync period of replays (the
    capture included, when it happens; the replays are queued, the wait for
    them falls in the next host read, under "other"), and the capture on its
    own."""
    from repro_torch.core import api
    from repro_torch.core import device_search as ds

    return {"greedy_inits": (api, "multiwalk_inits"),
            "memory_update": (ds, "memory_update"),
            "exact_schedule": (ds, "exact_schedule"),
            "sync_period": (ds._Launch, "run"),
            "capture": (ds._Launch, "_capture")}


def walk_iters_per_s(walks: int, iterations: int, seconds: float) -> float:
    """Walk-iterations per second (``benchmarks/search_bench.py``'s
    definition): W × iterations / warm seconds of the engine, its walks'
    greedy starts built before the clock starts."""
    return walks * iterations / seconds


def same_trajectory(res, ref) -> bool:
    """Two ``MultiWalkResult``s took the same trajectory: incumbent, history,
    counts, stop reason and every walk's history."""
    return ((res.best_makespan, res.history, res.n_exact_evals, res.n_approx_evals,
             res.iterations, res.stop_reason)
            == (ref.best_makespan, ref.history, ref.n_exact_evals, ref.n_approx_evals,
                ref.iterations, ref.stop_reason)
            and [w.history for w in res.per_walk] == [w.history for w in ref.per_walk])


def phase_device_path(device, tabu_multiwalk_wall: float):
    """``tabu_device`` at the main path's configuration: the parity profile
    against the NumPy ``tabu_multiwalk`` (cold, then warm), then the run
    with Algorithm 3 at syncs (the counts set to 0 before it, read after)."""
    import dataclasses

    import torch

    from repro_torch import solve
    from repro_torch.analysis.certify import certify_solution
    from repro_torch.core import TSParams, random_instance
    from repro_torch.core import device_search as ds
    from repro_torch.core.api import multiwalk_inits
    from repro_torch.core.tabu import tabu_multiwalk
    from repro_torch.kernels import schedule_dp as sdp

    n_tasks, n_data, walks, iters = 250, 600, 8, 30
    inst = random_instance(0, n_tasks=n_tasks, n_data=n_data)
    params = TSParams(top_k=10, max_unimproved=10**9, time_limit=10**9, max_iters=iters)
    # the parity profile, on the walks' starts solve() builds, the engines
    # timed alone (search_bench's definition)
    parity = dataclasses.replace(params, mem_update_period=ds.MEM_UPDATE_DISABLED, seed=0)
    inits, _ = multiwalk_inits(inst, walks, 0)
    walls = {"numpy": [], "device": []}
    ref = None

    def parity_run(engine: str):
        t0 = time.perf_counter()
        if engine == "numpy":
            res = tabu_multiwalk(inst, [s.copy() for s in inits],
                                 dataclasses.replace(parity, backend="numpy"))
        else:
            res = ds.device_multiwalk(inst, [s.copy() for s in inits], parity)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ref is not None and not same_trajectory(res, ref):
            raise AssertionError(f"the {engine} parity run and the NumPy tabu_multiwalk differ")
        if res.n_perturbations != 0:
            raise AssertionError(f"the {engine} parity run entered the perturbation branch")
        return res, wall

    ref, wall = parity_run("numpy")
    walls["numpy"].append(wall)
    torch.cuda.reset_peak_memory_stats(device)     # the captures' pools included
    cold, cold_wall = parity_run("device")
    # warm pairs in alternating order, so that a drift of the host's speed
    # within the call falls on both engines
    for order in (("device", "numpy"), ("numpy", "device"), ("device", "numpy")):
        for engine in order:
            walls[engine].append(parity_run(engine)[1])
    numpy_wall = statistics.median(walls["numpy"])
    warm_wall = statistics.median(walls["device"])
    pair_ratios = [n / d for n, d in zip(walls["numpy"][1:], walls["device"])]
    kw = dict(walks=walks, seed=0)

    relaunches = ds.launch_cache_info()["overflow_relaunches"]
    with HostTimers(device_targets()) as log:
        sdp.sweep.launches = sdp.seq_cumsum.launches = 0
        t0 = time.perf_counter()
        rep = solve(inst, "tabu_device", params=params, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, cs = sdp.sweep.launches, sdp.seq_cumsum.launches
        host = log.breakdown(wall)
    peak = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    st = rep.extras["device_stats"]
    if k1 <= 0 or cs <= 0 or (k1, cs) != (st["k1_launches"], st["seq_cumsum_launches"]):
        raise AssertionError(f"{k1} K1 and {cs} seq_cumsum launches counted, the solve "
                             f"reports {st['k1_launches']} and {st['seq_cumsum_launches']}")
    cert = certify_solution(inst, rep.solution, reported_makespan=rep.makespan,
                            claimed_feasible=rep.feasible)
    if not (cert.ok and rep.feasible):
        raise AssertionError("certificate rejected the device path's result: " + cert.summary())
    # one replayed round at this shape (the run has stopped, so a replay is
    # masked throughout: every kernel runs, nothing changes)
    batch = ds.InstanceBatch.from_instances([inst])
    launch, fresh = ds._get_launch(batch, walks, params, st["crit_cap"], st["chunk_cap"],
                                   ds.DeviceConfig(), device)
    if fresh or launch.graph is None:
        raise AssertionError("the device path's launch is not in the cache")
    with host_syncs_are_errors():
        round_ms = cuda_median_ms(launch.graph.replay, reps=20, warmup=2)
    round_profile, profiled = replayed_round_profile(launch, st, replays=8)
    ip = batch.packs[0]
    base = solve(inst, "load_balance", seed=0).makespan
    say("device_path", n_tasks=n_tasks, n_data=n_data, n_procs=inst.n_procs, walks=walks,
        top_k=params.top_k, iterations=rep.iterations, stop_reason=rep.stop_reason,
        wall_s=wall, compile_seconds=rep.extras["compile_seconds"],
        memory_update_s=host["memory_update"]["s"],
        memory_update_calls=host["memory_update"]["calls"], host_phases=host,
        k1_launches=k1, seq_cumsum_launches=cs, k1_per_round=st["k1_per_round"],
        seq_cumsum_per_round=st["seq_cumsum_per_round"],
        rounds_replayed=st["rounds_replayed"],
        overflow_relaunches=ds.launch_cache_info()["overflow_relaunches"] - relaunches,
        chunk_cap=st["chunk_cap"], crit_cap=st["crit_cap"], round_ms=round_ms,
        round_profile=round_profile, round_launches_profiled=profiled,
        makespan=rep.makespan, initial_makespan=rep.initial_makespan,
        load_balance_makespan=base, improvement_over_load_balance=1.0 - rep.makespan / base,
        n_perturbations=rep.extras["n_perturbations"], certified=True, feasible=rep.feasible,
        max_memory_allocated=peak, memory_reserved=reserved,
        tabu_table_bytes=walks * ip.n_b * ip.p_b * (ip.n_b + 2) * 4,
        host_syncs_in_replay=0,
        parity={"matches_numpy_tabu_multiwalk": True, "n_perturbations": 0,
                "makespan": ref.best_makespan, "iterations": ref.iterations,
                "cold": {"wall_s": cold_wall, "compile_seconds": cold.compile_seconds,
                         "walk_iters_per_s": walk_iters_per_s(walks, ref.iterations, cold_wall)},
                "warm_wall_s": walls["device"], "numpy_wall_s": walls["numpy"],
                "warm_wall_s_median": warm_wall, "numpy_wall_s_median": numpy_wall,
                "walk_iters_per_s": walk_iters_per_s(walks, ref.iterations, warm_wall),
                "numpy_walk_iters_per_s": walk_iters_per_s(walks, ref.iterations, numpy_wall),
                "speedup": numpy_wall / warm_wall,
                "speedup_by_pair": pair_ratios,
                "speedup_range": [min(pair_ratios), max(pair_ratios)]},
        tabu_multiwalk_wall_s=tabu_multiwalk_wall,
        note="wall_s and the parity runs' wall_s: host clock around solve() ending in a "
             "synchronize; compile_seconds: the capture (an eager first round on a side "
             "stream, then the recording); round_ms: median of 20 replays of the captured "
             "round, CUDA events; round_profile: torch.profiler over 8 replays, its K1 and "
             "seq_cumsum launches held to 8 x the captured round's nodes "
             "(round_launches_profiled: each window taken, at most 3); the round_ms replays "
             "run under torch.cuda.set_sync_debug_mode('error'), as does each capture's "
             "eager first round (host_syncs_in_replay is 0 or the run raised); k1_launches / seq_cumsum_launches: the round's nodes x the rounds "
             "replayed, plus the eager first round of each capture; parity: "
             "device_multiwalk and the NumPy tabu_multiwalk on the same 8 greedy starts, "
             "built before the clock starts, every run held to the first NumPy run's "
             "trajectory: NumPy, device cold, then three warm pairs in alternating order "
             "(device numpy, numpy device, device numpy); walk_iters_per_s = walks x "
             "iterations / median warm wall_s (the NumPy runs' over all four), speedup "
             "their ratio, speedup_by_pair each warm pair's; "
             "max_memory_allocated: peak over the parity runs (the captures) and this "
             "run; memory_reserved: the allocator's holding after it")
    return {"schedule_dp": k1, "seq_cumsum": cs}


@contextlib.contextmanager
def host_syncs_are_errors():
    """Every synchronising call raises inside the block (a process-wide
    debug mode: the caller runs nothing else on the card meanwhile)."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def replayed_round_profile(launch, stats: dict, replays: int):
    """``device_breakdown`` over ``replays`` replays of ``launch``'s captured
    round, held to what the capture recorded: ``replays`` x its K1 and
    ``seq_cumsum`` nodes must be the launches the profiler saw on the card.
    A window whose counts differ is taken again, at most three in all (the
    profiler can drop records of a window); the counts of every window are
    returned beside the last profile."""
    want = {"K1 schedule_dp": replays * stats["k1_per_round"],
            "seq_cumsum": replays * stats["seq_cumsum_per_round"]}
    seen = []
    for _ in range(3):
        prof = device_breakdown(lambda: [launch.graph.replay() for _ in range(replays)],
                                top=12)
        got = {c: prof["by_class"].get(c, {}).get("launches", 0) for c in want}
        seen.append(got)
        if got == want:
            return prof, seen
    raise AssertionError(f"{replays} replays of the captured round: the profiler saw "
                         f"{seen}, the capture recorded {want}")


def cumsum_operands(inst, rows: int, seed: int, device):
    """What the device round hands ``seq_cumsum`` for ``rows`` candidate
    rows of ``inst``: on the padded in-edge list, each edge's data size
    times the access time of its owner's core for its block's tier (zeros
    past the real edges), for assignments and allocations drawn from
    ``seed``."""
    import numpy as np
    import torch

    from repro_torch.instances import pack_instance

    ip = pack_instance(inst)
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, ip.p, (rows, ip.n_b))
    mem = rng.integers(0, ip.access_time.shape[1], (rows, ip.d_b))
    rate = ip.access_time[assign[:, ip.in_owner], mem[:, ip.in_idx]]
    vals = np.where(ip.in_valid[None, :], ip.data_size[ip.in_idx][None, :] * rate, 0.0)
    return torch.from_numpy(vals).to(device)


def cumsum_bound(v) -> dict:
    """Least time for ``seq_cumsum(v)``: ``v`` read once and the
    ``(rows, e + 1)`` result written once, against one float64 add per
    element."""
    rows, e = v.shape
    n_bytes = rows * e * 8 + rows * (e + 1) * 8
    ops = rows * e
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float64"] * 1e3
    return {"bytes": n_bytes, "operations": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_seq_cumsum(device, rows: int) -> dict:
    """``seq_cumsum`` against its plain version (on the CPU, where it is
    ``np.cumsum``'s order) bit for bit at several widths and at the round's
    shape, then timed there beside its bound, its plain version on the card
    and ``torch.cumsum``; how far ``torch.cumsum`` on the card lands from
    the sequential sums is recorded."""
    import torch

    from repro_torch.core import random_instance
    from repro_torch.kernels import schedule_dp as sdp

    inst = random_instance(0, n_tasks=250, n_data=600)
    worst = 0.0
    v = cumsum_operands(inst, rows, 0, device)
    for width in (1, 255, 256, 257, 4096, v.shape[1]):
        x = cumsum_operands(inst, rows, width, device)[:, :width].contiguous() \
            if width <= v.shape[1] else torch.rand((rows, width), dtype=torch.float64,
                                                   device=device) * 1e4
        got = sdp.seq_cumsum(x)
        torch.cuda.synchronize()
        want = sdp.seq_cumsum_torch(x.cpu())
        worst = max(worst, max_abs_err([got.cpu()], [want]))
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"seq_cumsum differs from its plain version at width {width}")
    card = torch.cumsum(v, dim=1)
    torch_cumsum_err = max_abs_err([card.cpu()], [sdp.seq_cumsum_torch(v.cpu())[:, 1:]])
    ms = cuda_median_ms(lambda: sdp.seq_cumsum(v), reps=100, warmup=10)
    device_ms = profiled_device_ms(lambda: sdp.seq_cumsum(v), "seq_cumsum", reps=100)
    plain_ms = cuda_median_ms(lambda: sdp.seq_cumsum_torch(v), reps=20, warmup=3)
    library_ms = cuda_median_ms(lambda: torch.cumsum(v, dim=1), reps=100, warmup=10)
    per_add = add_chain_ms_per_add(device)
    out = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "max_abs_err": worst, "shape": list(v.shape),
           "torch_cumsum_on_card_max_abs_err": torch_cumsum_err,
           "chain_ms": v.shape[1] * per_add, "add_chain_ms_per_add": per_add,
           **cumsum_bound(v)}
    say("seq_cumsum", **out,
        note="bit-equal to its plain version (the CPU's torch.cumsum, np.cumsum's order) at "
             "every width; ms: median of 100 wrapper calls by CUDA events (host work "
             "included), device_ms the kernel's mean device time over 100 launches "
             "(torch.profiler), plain_ms the plain version on the card (20), library_ms "
             "torch.cumsum on the card (100); chain_ms = width x add_chain_ms_per_add, the "
             "measured time of one dependent float64 add: each row is such a chain, so "
             "this floor binds, not bound_ms (bytes / operations); "
             "torch_cumsum_on_card_max_abs_err: how far the card's torch.cumsum lands "
             "from the sequential sums")
    return out


# --------------------------------------------------------------------------- #
# the scheduling-solve service                                                #
# --------------------------------------------------------------------------- #
# a serving profile: a mixed-family trace (``families``: (family, generator
# kwargs) pairs) with Poisson arrivals at ``rate`` per second, its search
# shape and the engine's launch-shape knobs
ServeProfile = collections.namedtuple(
    "ServeProfile",
    "families n_requests walks max_iters rate batch_sizes sync_every crit_cap")


# the reference's full serving profile (benchmarks/serve_bench.py:88-93)
SERVE_PROFILE = ServeProfile(
    families=(("random_layered", {"n_tasks": 70, "n_data": 160}),
              ("out_tree", {"n_tasks": 70}),
              ("fft", {"width": 16, "stages": 4})),
    n_requests=36, walks=4, max_iters=20, rate=4.0, batch_sizes=(1, 2, 4, 8),
    sync_every=8, crit_cap=64)
SERVE_MAX_WAIT = 0.05          # the reference's BatchPolicy(max_wait=0.05)
# the fault lane: the trace's first requests again under a seeded plan of
# every fault kind; the watchdog gives up on a launch before a hang ends
FAULT_REQUESTS = 12
# cuts of one request: the NumPy fallback's launches (0.5-1.8 s on a busy
# host) stay inside the watchdog, so hangs are what is abandoned
FAULT_PLAN = {"seed": 5, "rate": 0.3, "hang_seconds": 2.5, "skew_seconds": 0.1}
FAULT_WATCHDOG_S = 2.0
FAULT_MAX_BATCH = 1
# the race lane: requests of one launch shape, one of them hung at its
# launch; the stale run wakes while the fresh lane serves the rest
RACE_REQUESTS = 12
RACE_HUNG_RID = 1


def serve_params():
    """The reference's serving search knobs (``serve_bench.serve_params``):
    iteration-bound budgets, no Algorithm 3 inside the horizon."""
    from repro_torch.core import TSParams
    from repro_torch.core.device_search import MEM_UPDATE_DISABLED

    return TSParams(max_unimproved=10**9, time_limit=1e9, top_k=5,
                    mem_update_period=MEM_UPDATE_DISABLED)


def serve_trace(prof: ServeProfile, seed: int = 0):
    """The reference's deterministic trace (``serve_bench.build_trace``):
    request ``k`` is family ``k mod 3`` from generator seed ``10000·seed + k``
    and solved at search seed ``seed + k``; arrival offsets are Poisson."""
    import numpy as np

    from repro_torch.instances import generate

    rng = np.random.default_rng(seed)
    items = []
    for k in range(prof.n_requests):
        fam, kw = prof.families[k % len(prof.families)]
        inst = generate(fam, np.random.default_rng(10_000 * seed + k), **kw)
        items.append({"family": fam, "instance": inst, "seed": seed + k})
    arrivals = np.cumsum(rng.exponential(1.0 / prof.rate, size=len(items)))
    return items, arrivals


def same_report(a, b) -> bool:
    """Two ``SolveReport``s are bit-identical: makespan, history, counts, and
    the solution's assignment, allocation and machine sequences."""
    import numpy as np

    return ((a.makespan, a.history, a.iterations, a.n_exact_evals, a.n_approx_evals)
            == (b.makespan, b.history, b.iterations, b.n_exact_evals, b.n_approx_evals)
            and np.array_equal(a.solution.assign, b.solution.assign)
            and np.array_equal(a.solution.mem, b.solution.mem)
            and [list(map(int, s)) for s in a.solution.proc_seq]
            == [list(map(int, s)) for s in b.solution.proc_seq])


def solo_solve(item, prof: ServeProfile, params, torch_device: str, backend: str = "device"):
    """A request solved alone: ``tabu_device`` at the service's launch knobs,
    or the NumPy ``tabu_multiwalk`` (the service's fallback backend)."""
    from repro_torch import Budget, solve

    kw = dict(walks=prof.walks, budget=Budget(max_iters=prof.max_iters), seed=item["seed"],
              params=params)
    if backend == "device":
        return solve(item["instance"], "tabu_device", torch_device=torch_device,
                     device={"sync_every": prof.sync_every, "crit_cap": prof.crit_cap}, **kw)
    return solve(item["instance"], "tabu_multiwalk", backend="numpy", **kw)


async def run_service(items, arrivals, prof: ServeProfile, params, torch_device: str, *,
                      on_start=None, plan=None, resilience=None, max_batch=None,
                      pace: bool = True) -> dict:
    """``items`` through a device-backend ``SolveService``: one ``WarmSpec``
    per signature class, warmed at start; then ``on_start(service)``, the
    requests at their arrival offsets (``pace``) under ``plan``, and every
    request awaited to its terminal state (a result or a typed error) and
    its incumbent stream drained."""
    import asyncio

    from repro_torch import Budget
    from repro_torch.faults import plan_context
    from repro_torch.faults.errors import ReproError
    from repro_torch.serve import (BatchPolicy, EngineConfig, SolveService, WarmSpec,
                                   launch_signature)

    budget = Budget(max_iters=prof.max_iters)
    warm, seen = [], set()
    for item in items:
        sig = launch_signature(item["instance"], prof.walks, budget)
        if sig not in seen:
            seen.add(sig)
            warm.append(WarmSpec(item["instance"], prof.walks, budget))
    svc = SolveService(
        config=EngineConfig(backend="device", sync_every=prof.sync_every,
                            crit_cap=prof.crit_cap, batch_sizes=prof.batch_sizes,
                            torch_device=torch_device),
        policy=BatchPolicy(max_batch=max_batch or max(prof.batch_sizes),
                           max_wait=SERVE_MAX_WAIT),
        params=params, warm=warm, resilience=resilience)
    await svc.start()
    if on_start is not None:
        on_start(svc)
    events: dict = {}

    async def drain(rid):
        events[rid] = 0
        async for _ in svc.stream_incumbents(rid):
            events[rid] += 1

    with plan_context(plan) if plan is not None else contextlib.nullcontext():
        rids, drains = [], []
        t0 = time.monotonic()
        for k, item in enumerate(items):
            if pace and arrivals[k] > time.monotonic() - t0:
                await asyncio.sleep(arrivals[k] - (time.monotonic() - t0))
            rid = await svc.submit(item["instance"], budget, seed=item["seed"],
                                   walks=prof.walks)
            rids.append(rid)
            drains.append(asyncio.ensure_future(drain(rid)))
        outcomes = []
        for rid in rids:
            try:
                outcomes.append(await asyncio.wait_for(svc.result(rid), timeout=600.0))
            except ReproError as e:
                outcomes.append(e)
        wall = time.monotonic() - t0
        await asyncio.gather(*drains)
        metrics = svc.metrics()
        await svc.shutdown()
    return {"outcomes": outcomes, "wall_s": wall, "metrics": metrics,
            "events": [events[r] for r in rids], "signatures": len(seen), "service": svc,
            "rids": rids}


def profiled_cut(engine, items, prof: ServeProfile, served: dict):
    """One served cut again, through the service's engine with its warm
    launch, under ``torch.profiler``: the K1 and ``seq_cumsum`` launches on
    the card must be the launch's captured nodes x the rounds it replayed
    (at most three windows: the profiler can drop records of one), and its
    lanes must equal what the service served."""
    from repro_torch import Budget
    from repro_torch.core import device_search as ds
    from repro_torch.serve import Batcher, BatchPolicy, RequestQueue

    budget = Budget(max_iters=prof.max_iters)
    by_sig: dict = {}
    for k, item in enumerate(items):
        by_sig.setdefault(served[k].request.signature, []).append(k)
    # one request: the profiler's records of a cut grow with its lanes (a
    # cut of eight replays ~300,000 kernels, slow to gather)
    ks = max(by_sig.values(), key=len)[:1]
    q = RequestQueue()
    for k in ks:
        q.submit(items[k]["instance"], budget, seed=items[k]["seed"], walks=prof.walks)
    q.close()
    asm = engine.assemble(Batcher(q, BatchPolicy(max_batch=len(ks))).cut())
    seen = []
    for _ in range(3):
        cache0 = ds.launch_cache_info()
        out = []
        prof_out = device_breakdown(lambda: out.extend(engine.execute(asm)))
        if ds.launch_cache_info()["misses"] != cache0["misses"]:
            raise AssertionError("the profiled cut did not replay a warm launch")
        st = out[0].report.extras["device_stats"]
        want = {"K1 schedule_dp": st["k1_per_round"] * st["rounds_replayed"],
                "seq_cumsum": st["seq_cumsum_per_round"] * st["rounds_replayed"]}
        got = {c: prof_out["by_class"].get(c, {}).get("launches", 0) for c in want}
        seen.append(got)
        for k, rr in zip(ks, out):
            if not same_report(rr.report, served[k].report):
                raise AssertionError(f"the profiled cut's request {k} differs from its served "
                                     "report")
        if got == want and want["K1 schedule_dp"] > 0:
            return {"requests": len(ks), "padded_to": asm.padded_to,
                    "rounds_replayed": st["rounds_replayed"],
                    "k1_per_round": st["k1_per_round"],
                    "seq_cumsum_per_round": st["seq_cumsum_per_round"],
                    "launches_profiled": seen, "wall_ms": prof_out["wall_ms"],
                    "device_busy_ms": prof_out["device_busy_ms"],
                    "device_idle_share": prof_out["device_idle_share"],
                    "by_class": prof_out["by_class"]}
    raise AssertionError(f"one served cut: the profiler saw {seen}, its launch's captured "
                         f"nodes x rounds are {want}")


class FaultLedger:
    """What the fault lane did: every decision the plan made at a
    ``fire`` point (its kind, by point), and how every ``Engine.execute``
    call ended, the abandoned ones included (each a thread of its own)."""

    def __init__(self, plan):
        self.plan = plan
        self.fires = collections.Counter()
        # (backend, seconds, the exception raised or None, the lanes returned or None)
        self.executes = []

    def __enter__(self):
        from repro_torch.faults import inject as finj

        self._fire = finj.fire

        def fire(point, key=0, *, rid=None):
            kind = finj.would_fire(self.plan, "fire", point, key) \
                if finj.active() is self.plan else None
            if kind is not None:
                self.fires[f"{point}:{kind}"] += 1
            return self._fire(point, key, rid=rid)

        finj.fire = fire
        return self

    def __exit__(self, *exc):
        from repro_torch.faults import inject as finj

        finj.fire = self._fire

    def watch(self, svc) -> None:
        execute = svc.engine.execute

        def recorded(assembled, callbacks=None):
            t0 = time.perf_counter()
            try:
                out = execute(assembled, callbacks)
            except BaseException as e:
                self.executes.append((assembled.backend, time.perf_counter() - t0, e, None))
                raise
            self.executes.append((assembled.backend, time.perf_counter() - t0, None, out))
            return out

        svc.engine.execute = recorded


def join_solve_threads(timeout: float) -> int:
    """Wait for the service's solve-lane threads, the abandoned ones too
    (their launches run to their end); returns how many were still running."""
    import threading

    lanes = [t for t in threading.enumerate() if t.name.startswith("serve-solve")]
    deadline = time.monotonic() + timeout
    for t in lanes:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in lanes):
        raise AssertionError("a solve lane did not end")
    return len(lanes)


def fault_lane(items, prof: ServeProfile, params, solos: list, torch_device: str, *,
               plan_kw: dict = FAULT_PLAN, watchdog: float = FAULT_WATCHDOG_S,
               retry=None) -> dict:
    """``items`` served under the plan ``plan_kw`` (every kind, unless it
    names its kinds) with a watchdog shorter than a hang: every request must
    end in exactly one terminal state, every survivor must equal its solo
    solve on the backend that served it, every lane a device launch returned
    (the abandoned launches' included) must equal its solo ``tabu_device``
    solve, and no launch may fail but by an injected fault, the stale runs
    of abandoned launches included.  ``retry`` is the service's
    ``RetryPolicy`` (its default when None)."""
    import asyncio

    import torch

    from repro_torch.core import device_search as ds
    from repro_torch.faults import FaultPlan
    from repro_torch.faults.errors import (CertifyFailure, CompileTimeout, ReproError)
    from repro_torch.serve import RequestResult, ResiliencePolicy

    if watchdog >= plan_kw["hang_seconds"]:
        raise ValueError("the watchdog must give up on a launch before a hang ends")
    plan = FaultPlan(**plan_kw)
    policy = ResiliencePolicy(watchdog_deadline=watchdog) if retry is None \
        else ResiliencePolicy(retry=retry, watchdog_deadline=watchdog)
    uncached = ds.launch_cache_info()["uncached"]
    with FaultLedger(plan) as ledger:
        out = asyncio.run(run_service(
            items, None, prof, params, torch_device, on_start=ledger.watch, plan=plan,
            resilience=policy, max_batch=FAULT_MAX_BATCH, pace=False))
        lanes = join_solve_threads(timeout=600.0)
    if torch_device != "cpu":
        torch.cuda.synchronize()            # a sticky CUDA error would raise here
    uncached = ds.launch_cache_info()["uncached"] - uncached
    outcomes = out["outcomes"]
    if len(outcomes) != len(items):
        raise AssertionError("a request of the fault lane has no terminal state")
    survivors, failed, numpy_solos = collections.Counter(), collections.Counter(), {}
    for k, o in enumerate(outcomes):
        if isinstance(o, ReproError):
            failed[type(o).__name__] += 1
            continue
        if not isinstance(o, RequestResult) or not o.metrics.get("certified"):
            raise AssertionError(f"fault-lane request {k} ended uncertified: {o!r}")
        backend = o.metrics["backend"]
        if backend == "device":
            want = solos[k]
        else:
            want = numpy_solos[k] = solo_solve(items[k], prof, params, torch_device, "numpy")
        if not same_report(o.report, want):
            raise AssertionError(f"fault-lane survivor {k} ({backend}) differs from its solo "
                                 "solve")
        survivors[backend] += 1
    k_of = {rid: k for k, rid in enumerate(out["rids"])}
    device_lanes = 0
    for backend, _, _, returned in ledger.executes:
        if backend != "device" or returned is None:
            continue
        for item in returned:
            if isinstance(item, RequestResult):
                k = k_of[item.request.rid]
                if not same_report(item.report, solos[k]):
                    raise AssertionError(f"a device launch returned request {k} unlike its "
                                         "solo solve")
                device_lanes += 1
    real = [e for _, _, e, _ in ledger.executes
            if e is not None and not (isinstance(e, ReproError) and e.injected)]
    if real:
        raise AssertionError(f"a launch failed outside the plan: {real[0]!r}")
    allowed = (CompileTimeout, CertifyFailure)
    for o in outcomes:
        if isinstance(o, ReproError) and not (o.injected or isinstance(o, allowed)):
            raise AssertionError(f"a request failed outside the plan: {o!r} "
                                 f"(cause {o.__cause__!r})")
    res = out["metrics"]["resilience"]
    if res["watchdog_kills"] < 1:
        raise AssertionError("the fault lane abandoned no launch")
    if out["metrics"]["failed"] != sum(failed.values()):
        raise AssertionError("the service's failure count disagrees with the outcomes")
    return {"requests": len(items), "survivors": sum(survivors.values()),
            "survivors_by_backend": dict(survivors), "failed": dict(failed),
            "resilience": res, "fires": dict(ledger.fires),
            "device_search_sync_fires": {k.split(":")[1]: v for k, v in ledger.fires.items()
                                         if k.startswith("device_search.sync:")},
            "executes": len(ledger.executes),
            "executes_raised": sum(e is not None for _, _, e, _ in ledger.executes),
            "execute_s": {b: sorted(round(s, 3) for bb, s, _, _ in ledger.executes if bb == b)
                          for b in {bb for bb, _, _, _ in ledger.executes}},
            "device_lanes_returned": device_lanes, "uncached_launches": uncached,
            "solve_lanes": lanes, "numpy_fallback_survivors": len(numpy_solos),
            "wall_s": out["wall_s"], "cuda_errors": 0,
            "plan": {**plan_kw, "kinds": list(plan.kinds),
                     "points": None if plan.points is None else list(plan.points)},
            "watchdog_deadline_s": watchdog, "max_batch": FAULT_MAX_BATCH}


def one_shape(items, prof: ServeProfile) -> list:
    """The indices of the trace's largest class of one launch signature."""
    from repro_torch import Budget
    from repro_torch.serve import launch_signature

    by_sig: dict = {}
    for k, item in enumerate(items):
        sig = launch_signature(item["instance"], prof.walks, Budget(max_iters=prof.max_iters))
        by_sig.setdefault(sig, []).append(k)
    return max(by_sig.values(), key=len)


def race_plan(n: int, hang_seconds: float) -> dict:
    """The first seeded plan (seed 0, 1, ...) whose only fault over rids
    ``0 .. n-1`` is a ``compile_hang`` at ``engine.execute.launch`` of rid
    ``RACE_HUNG_RID``: one abandon, and a fresh lane with work after it."""
    from repro_torch.faults import FaultPlan, would_fire

    for seed in range(10_000):
        kw = {"seed": seed, "rate": 0.1, "kinds": ("compile_hang",),
              "points": ("engine.execute.launch",), "hang_seconds": hang_seconds}
        plan = FaultPlan(**kw)
        if [r for r in range(n)
                if would_fire(plan, "fire", "engine.execute.launch", r)] == [RACE_HUNG_RID]:
            return kw
    raise ValueError(f"no plan hangs rid {RACE_HUNG_RID} alone among {n}")


def race_lane(items, prof: ServeProfile, params, solos: list, torch_device: str, *,
              hang_seconds: float = FAULT_PLAN["hang_seconds"],
              watchdog: float = FAULT_WATCHDOG_S) -> dict:
    """Requests of one launch shape, the launch of one of them hung (one
    attempt each, so it fails once): the watchdog abandons it, the fresh lane
    serves the rest, and the stale run wakes and runs ``solve_instances``
    beside the fresh lane's runs of the same shape, so one of them must take
    an uncached launch.  Every survivor runs on the device and equals its
    solo solve, and so does the stale run's lane."""
    from repro_torch.serve import RetryPolicy

    plan_kw = race_plan(len(items), hang_seconds)
    out = fault_lane(items, prof, params, solos, torch_device, plan_kw=plan_kw,
                     watchdog=watchdog, retry=RetryPolicy(max_attempts=1))
    if out["survivors_by_backend"].get("device", 0) < 1 or out["numpy_fallback_survivors"]:
        raise AssertionError(f"the race lane's survivors did not run on the device: {out}")
    if out["device_lanes_returned"] <= out["survivors"]:
        raise AssertionError("the abandoned launch returned no lane: its stale run never ran")
    if out["uncached_launches"] < 1:
        raise AssertionError("no device run found its launch shape held: the stale run ran "
                             "beside no fresh one")
    return out


def check_served(outcomes) -> None:
    """Every request of a clean run was served and certified."""
    from repro_torch.serve import RequestResult

    for k, o in enumerate(outcomes):
        if not isinstance(o, RequestResult):
            raise AssertionError(f"request {k} failed: {o!r}")
        if not o.metrics.get("certified"):
            raise AssertionError(f"request {k} was served uncertified")


def phase_solve_service(device) -> dict:
    """The scheduling-solve service on the card at the reference's full
    serving profile: warm-up, then the Poisson trace (the counts set to 0
    just before it, read just after; no launch captured during traffic),
    one served cut under the profiler, the solo loop every served report is
    held to bit for bit, the fault lane, the race lane, and the ``table2``
    suite swept on the device engine against the NumPy engine."""
    import asyncio
    import os

    import torch

    from repro_torch import Budget
    from repro_torch.core import device_search as ds
    from repro_torch.instances import sweep
    from repro_torch.kernels import schedule_dp as sdp

    prof, params = SERVE_PROFILE, serve_params()
    items, arrivals = serve_trace(prof, seed=0)
    t_phase = time.perf_counter()
    spans = {}

    def span(name, t0):
        spans[name] = time.perf_counter() - t0
        return time.perf_counter()

    saved_env = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"       # every report certified
    try:
        before = {}
        t0 = time.perf_counter()

        def at_traffic(svc):
            nonlocal t0
            t0 = span("warm_up", t0)
            before.update(ds.launch_cache_info())
            sdp.sweep.launches = sdp.seq_cumsum.launches = 0

        served = asyncio.run(run_service(items, arrivals, prof, params, "cuda",
                                         on_start=at_traffic))
        torch.cuda.synchronize()
        t0 = span("traffic", t0)
        k1, cs = sdp.sweep.launches, sdp.seq_cumsum.launches
        after = ds.launch_cache_info()
        traffic = {k: after[k] - before[k]
                   for k in ("hits", "misses", "overflow_relaunches", "uncached")}
        outcomes = served["outcomes"]
        check_served(outcomes)
        # a relaunch of an overflowing round is a hit on a warmed launch
        if traffic["misses"] or traffic["uncached"]:
            raise AssertionError(f"launches captured during traffic: {traffic}")
        if k1 <= 0 or cs <= 0:
            raise AssertionError(f"{k1} K1 and {cs} seq_cumsum launches in the served run")
        if sum(served["events"]) < 1:
            raise AssertionError("no request streamed an incumbent")
        one_cut = profiled_cut(served["service"].engine, items, prof, outcomes)

        t0 = span("profiled_cut", t0)
        solos = [solo_solve(item, prof, params, "cuda") for item in items]
        t0 = span("seq_cold", t0)
        solo_captures = ds.launch_cache_info()["misses"] - after["misses"]
        solo_capture_s = sum(r.extras["compile_seconds"] for r in solos)
        for k, (o, solo) in enumerate(zip(outcomes, solos)):
            if not (solo.extras.get("certified") and same_report(o.report, solo)):
                raise AssertionError(f"served request {k} differs from its solo tabu_device "
                                     "solve")

        faults = fault_lane(items[:FAULT_REQUESTS], prof, params, solos, "cuda")
        t0 = span("fault_lane", t0)
        ks = one_shape(items, prof)[:RACE_REQUESTS]
        race = race_lane([items[k] for k in ks], prof, params, [solos[k] for k in ks], "cuda")
        t0 = span("race_lane", t0)
        dev = sweep("table2", backend="device", walks=prof.walks,
                    budget=Budget(max_iters=prof.max_iters), sanitize=True)
        t0 = span("sweep_device", t0)
        # the starts need no search: the NumPy sweep's initial makespans are
        # its walks' starts, one iteration deep
        ref = sweep("table2", backend="numpy", walks=prof.walks, budget=Budget(max_iters=1),
                    sanitize=True)
        span("sweep_numpy", t0)
    finally:
        if saved_env is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = saved_env
    check_sweep(dev, ref)
    m = served["metrics"]
    n = len(items)
    seq_warm_s = spans["seq_cold"] - solo_capture_s
    say("solve_service", profile={**prof._asdict(), "max_wait": SERVE_MAX_WAIT},
        requests=n, signatures=served["signatures"],
        compile_seconds=m["warmup"]["compile_seconds"],
        warm_signatures=m["warmup"]["signatures"], batches=m["batches"],
        mean_batch_size=m["mean_batch_size"], cuts_by_reason=m["cuts_by_reason"],
        traffic_launch_cache=traffic, k1_launches=k1, seq_cumsum_launches=cs,
        streamed_events=sum(served["events"]),
        requests_streaming=sum(e > 0 for e in served["events"]),
        served_wall_s=served["wall_s"], latency_p50_s=m["latency_p50"],
        latency_p99_s=m["latency_p99"], served_solved_per_s=n / served["wall_s"],
        seq_cold_s=spans["seq_cold"], seq_cold_solved_per_s=n / spans["seq_cold"],
        seq_cold_captures=solo_captures, seq_cold_capture_s=solo_capture_s,
        seq_warm_s=seq_warm_s, seq_warm_solved_per_s=n / seq_warm_s,
        parity={"bit_identical": n, "certified": n},
        profiled_cut=one_cut, faults=faults, race=race,
        sweep={"suite": dev.suite, "buckets": dev.buckets, "compiles": dev.compiles,
               "wall_s": spans["sweep_device"], "initial_makespans_equal_numpy": True,
               "rows": [{k: r[k] for k in ("name", "makespan", "initial_makespan", "lb",
                                           "ratio", "certified")} for r in dev.rows]},
        launch_cache=ds.launch_cache_info(), memory_reserved=torch.cuda.memory_reserved(device),
        phase_s=time.perf_counter() - t_phase, spans_s=spans,
        note="the reference's full serving profile (36 requests, Poisson 4/s from seed 0); "
             "compile_seconds: the warm-up's captures, each signature x batch size at one "
             "exact-evaluation chunk and at two (the chunk-overflow relaunch's first rung); "
             "traffic_launch_cache: launch-cache deltas over the traffic (misses and "
             "uncached launches must be 0: no capture during traffic; an overflow "
             "relaunch is a hit on a warmed launch); k1_launches / seq_cumsum_launches: "
             "the kernels' counters (a replay adds the captured round's nodes), set to 0 "
             "after warm-up and read after the traffic, i.e. captured nodes x rounds "
             "replayed, which the profiler checks on one cut (profiled_cut); latency: "
             "service clock from submit to result; served_solved_per_s: requests / wall "
             "from the first submit to the last result (arrivals included); seq_cold: the "
             "36 solo tabu_device solves in order, capturing each solo launch shape "
             "(seq_cold_captures, seq_cold_capture_s); seq_warm_s: seq_cold_s minus those "
             "captures' seconds (derived, not a second pass); every served report "
             "bit-identical to its solo solve and certified (REPRO_SANITIZE=1); "
             "profiled_cut: a request of the largest signature class again, a cut of its "
             "own through the service's engine under torch.profiler, its K1 and "
             "seq_cumsum launches equal to the launch's captured nodes x rounds; faults: "
             "the first 12 requests under the plan with every kind, a watchdog shorter "
             "than a hang, every request ending in one terminal state, every survivor "
             "equal to its solo solve on the backend that served it, every lane a device "
             "launch returned (abandoned ones included) equal to its solo tabu_device "
             "solve, every launch failure an injected one, then torch.cuda.synchronize(); "
             "race: the same checks on 12 requests of the largest signature class, one "
             "hung at its launch and abandoned (one attempt), its stale run waking beside "
             "the fresh lane: every survivor on the device, the stale run's lane held to "
             "its solo solve, uncached_launches >= 1; sweep: table2 on the device engine "
             "(crit_cap n_b, 20 iterations) certified, makespan >= lb, initial makespans "
             "equal to the NumPy sweep's (one iteration: the starts need no search); "
             "spans_s: host seconds of each part of the phase")
    return {"schedule_dp": k1, "seq_cumsum": cs}


def check_sweep(dev, ref) -> None:
    """The device sweep captured at most once per bucket, certified every
    row above its lower bound, and started where the NumPy sweep did."""
    if dev.compiles > dev.buckets:
        raise AssertionError(f"the device sweep captured {dev.compiles} launches for "
                             f"{dev.buckets} buckets")
    for r, n in zip(dev.rows, ref.rows):
        if not (r["certified"] and r["makespan"] >= r["lb"] - 1e-6):   # the reference's slack
            raise AssertionError(f"sweep row {r['name']}: certified {r['certified']}, "
                                 f"makespan {r['makespan']} against lb {r['lb']}")
        if r["initial_makespan"] != n["initial_makespan"] or r["name"] != n["name"]:
            raise AssertionError(f"sweep row {r['name']} starts at {r['initial_makespan']}, "
                                 f"the NumPy sweep's at {n['initial_makespan']}")


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


def profiled_device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time of the kernels whose name holds ``kernel`` over
    ``reps`` calls of ``fn``, from torch.profiler (host and device activity,
    as ``device_breakdown`` records them).  For a launch of a few
    microseconds, CUDA events around one call time the wrapper's host work.
    The profiler may miss records of a window (46 of 50 were seen once on an
    H100), so the mean is over the launches it saw, and a window that saw
    fewer than half is taken again, at most three in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, n = 0.0, 0
        for e in prof.key_averages():
            if kernel in e.key and str(e.device_type).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                total_us += us if us is not None else getattr(e, "self_cuda_time_total", 0)
                n += e.count
        seen.append(n)
        if n > reps:
            break
        if n >= reps // 2:
            if len(seen) > 1:
                print(json.dumps({"note": f"the profiler saw {seen} of {reps} launches of "
                                          f"{kernel} in successive windows"}),
                      file=sys.stderr, flush=True)
            return total_us / n / 1e3
    raise AssertionError(f"the profiler saw {seen} launches of {kernel}, expected {reps}")


def csr_bytes(csr) -> int:
    """Bytes of one CSR form of the graph (row offsets and links, int32)."""
    return sum(a.numel() for a in csr) * 4


def sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails: bool) -> dict:
    """Least time for this call's work: bytes each read/written once over the
    memory rate (the graph as the CSR the kernel reads), against the max/add
    operations this data needs over the peak rate of its type."""
    b, n_b = dur.shape
    es = dur.element_size()
    fired = finish > 0                              # durations are positive
    indeg = (graph.pred_mat >= 0).sum(dim=1)[None, :] + (mpred >= 0)
    # per fired task: (links + 1) max for finish and start, one add
    ops = int((fired * ((indeg + 1) + 1)).sum())
    n_in = b * n_b * (es + 4) + csr_bytes(graph.pred_csr)      # dur, mpred, pred CSR
    n_out = b * n_b * (es + es + 4) + b * 4                    # start, finish, level, n_done
    if tails:                                                  # + msucc, succ CSR in, q out
        feas = (n_done == graph.n)[:, None]
        outdeg = (graph.succ_mat >= 0).sum(dim=1)[None, :] + (msucc >= 0)
        ops += int((feas * fired * ((outdeg + 1) + 2)).sum())
        n_in += b * n_b * 4 + csr_bytes(graph.succ_csr)
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


def add_chain_ms_per_add(device) -> float:
    """Measured time of one float64 add that waits on the one before (a
    single thread adding a long chain), the step of ``seq_cumsum``'s row."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.load("schedule_dp").schedule_dp_add_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float64, device=device)
    n = 1 << 20

    def run():
        err = fn(n, 1.0, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"add chain probe launch failed: CUDA error {err}")

    ms = cuda_median_ms(run, reps=10, warmup=2)
    if float(out[0]) != n:
        raise AssertionError(f"add chain probe summed {float(out[0])}, expected {n}")
    return ms / n


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
        # CUDA events around one wrapper call (the yardstick of every kernel's
        # ms: the wrapper's host work before the launch is in it) and, beside
        # it, the kernel's own device time
        ms = cuda_median_ms(lambda: sdp.sweep(graph, dur, mpred, msucc, tails=tails),
                            reps=100, warmup=10)
        device_ms = profiled_device_ms(
            lambda: sdp.sweep(graph, dur, mpred, msucc, tails=tails), "sweep_kernel", reps=100)
        plain_ms = cuda_median_ms(
            lambda: sdp.sweep_torch(graph.pred_mat, graph.succ_mat, dur, mpred, msucc,
                                    graph.n, tails=tails), reps=5, warmup=1)
        bound = sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails)
        depth = int(level.max()) + 1
        chain_levels = depth * (2 if tails else 1)   # the backward loop is as deep
        out["tails" if tails else "forward"] = {
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, **bound,
            "depth_levels": depth, "chain_ms": chain_levels * per_level,
            "ms_per_level": ms / chain_levels, "device_ms_per_level": device_ms / chain_levels,
            "timed_launches": sdp.sweep.launches - launches_before}
    # the host engine on the same rows, for context
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng._forward_dp(packed, eng._durations(packed))
        t.append((time.perf_counter() - t0) * 1e3)
    out["chain_probe_ms_per_level"] = per_level
    say("timing", shape=[rows, graph.n_b], dtype="float64",
        chain_probe_ms_per_level=per_level, forward=out["forward"], tails=out["tails"],
        numpy_forward_dp_host_ms=statistics.median(t),
        note="ms: median of 100 wrapper calls timed with CUDA events after 10 warm-up "
             "calls, inputs resident on the card (the wrapper's host work before the "
             "launch included); device_ms: the kernel's mean device time over 100 "
             "launches from torch.profiler; chain_ms = levels x measured cost "
             "of a minimal two-barrier level and is the bound that binds; ms_per_level "
             "= ms / levels (depth_levels, twice that with tails) and device_ms_per_level "
             "the same of device_ms, beside chain_probe_ms_per_level; bound_ms is the "
             "bytes/operations bound")
    return out


# --------------------------------------------------------------------------- #
# model path: K2 (flash attention) and K3 (RG-LRU scan)                        #
# --------------------------------------------------------------------------- #
ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
# (b, sq, skv, h, kvh, d, causal, window, q_offset): the six shapes of
# tests/test_kernels.py, ragged ones, and the serving shape
FLASH_SHAPES = (
    (2, 256, 256, 4, 2, 64, True, None, 0),
    (1, 128, 128, 8, 8, 128, False, None, 0),
    (2, 128, 512, 4, 1, 64, True, 128, 0),
    (1, 256, 512, 4, 4, 64, True, None, 256),
    (1, 384, 384, 6, 2, 32, True, None, 0),
    (2, 256, 256, 2, 1, 64, True, 64, 0),
    (1, 100, 1000, 2, 1, 32, False, None, 0),
    (1, 100, 1000, 2, 1, 32, True, 300, 900),
    (2, 77, 77, 10, 1, 256, True, 48, 0),
    (1, 333, 333, 10, 1, 72, True, 100, 0),
)
FLASH_SERVE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 10, 1, 256, True, 2048, 0)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
# the fp32 LSE, |diff| <= tol (1 + |lse|), in both input types: bf16 scores are
# exact products summed in fp32 (by the tensor cores), so only the order of
# the sums and one rounding of the scale differ from the plain version
FLASH_LSE_TOL = 1e-5
# (b, t, d, h0): the reference's test shapes, T = 1, ragged T, the serving
# shapes, then the kernel's edges: a partial last tile (T = 4097, 1000, 33),
# rows that are not 16-byte aligned (d = 2562, 66, 31: copied element by
# element) and lanes past d (2562, 200, 66, 31), T = 1 and T = 2
RGLRU_SHAPES = ((2, 512, 64, True), (1, 256, 128, True), (3, 128, 32, False),
                (2, 1, 96, True), (3, 1000, 200, False), (3, 1000, 200, True),
                (SERVE_BATCH, 1, 2560, True), (SERVE_BATCH, SERVE_PROMPT, 2560, True),
                (2, 4097, 2562, True), (2, 4097, 2560, False), (3, 33, 66, True),
                (3, 200, 31, False), (2, 1, 31, False), (SERVE_BATCH, 1, 2562, True),
                (SERVE_BATCH, 2, 2560, False))
MAMBA_ARCH = "mamba2-780m"
# (b, t, h, p, g, n): the four shapes of tests/test_kernels.py::test_ssd_sweep,
# two ragged T, one decode step and the prefill at the serving width
SSD_SERVE = (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128)
SSD_SHAPES = ((2, 256, 4, 32, 2, 64), (1, 256, 4, 64, 1, 128), (2, 128, 8, 16, 8, 32),
              (1, 512, 2, 32, 1, 64), (2, 300, 4, 32, 2, 64), (1, 1000, 8, 64, 1, 128),
              (SERVE_BATCH, 1, 48, 64, 1, 128), SSD_SERVE)
# y: max |diff| / max |y| (tests/test_kernels.py for float32; bf16 x/B/C round y
# to bf16, one unit in the last place is 2^-8); h_last stays fp32: 1e-4
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_H_TOL = 1e-4
# recurrentgemma-2b's served vs plain-version logits, as a share of max
# |logit|: about ten times the 3.8e-4 a correct bf16 path reads on an H100 at
# every step
TEACHER_FORCED_LIMIT = 4e-3
# mamba2-780m in bf16: the random 48-layer model amplifies bf16 rounding (a
# correct path reads 1.9e-2 to 3.4e-2 on an H100), so its limit is measured in
# the same run: the plain version against itself at another chunk length, the
# same function summed in another order, and the served logits must lie within
# YARDSTICK_FACTOR times that reading's worst step
YARDSTICK_CHUNK = 32
YARDSTICK_FACTOR = 2.0
# the mamba2-780m check again in float32 at full width and depth (random
# weights from seed 0 in float32): about ten times the 5e-6 a correct path
# reads (1e-6 to 5e-6 per step, as the plain version against itself at chunk 32)
FLOAT32_TEACHER_FORCED_LIMIT = 5e-5


def randn(gen, shape, device, dtype=None):
    import torch

    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return z if dtype is None else z.to(dtype)


def flash_operands(shape, dtype, device, seed=0):
    import torch

    b, sq, skv, h, kvh, d, causal, window, q_offset = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q = randn(gen, (b, sq, h, d), device, dtype)
    k = randn(gen, (b, skv, kvh, d), device, dtype)
    v = randn(gen, (b, skv, kvh, d), device, dtype)
    return q, k, v, dict(causal=causal, window=window, q_offset=q_offset)


def _within(got, want, tol: float) -> tuple[bool, float]:
    import torch

    g, w = got.to(torch.float64), want.to(torch.float64)
    err = (g - w).abs()
    return bool((err <= tol + tol * w.abs()).all()), float(err.max()) if err.numel() else 0.0


def flash_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work this data needs."""
    import numpy as np

    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(q, k, v, causal, window, q_offset, with_lse=False) -> dict:
    """Least time for K2's work: q, k, v read and the output (and LSE) written
    once over the memory rate, against 4 D operations per unmasked pair (2 D
    for q.k, 2 D for p.v) over the peak rate of the input type."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pairs = flash_pairs(sq, skv, causal, window, q_offset) * b * h
    ops = 4 * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + (b * sq * h * 4 if with_lse else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return {"bytes": nbytes, "operations": ops, "pairs": pairs, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rglru_bound(a, h0) -> dict:
    """Least time for K3's scan: a and x~ read, y written, h0 read, all fp32,
    against one multiply and one add per element at the fp32 rate."""
    nbytes = 3 * a.numel() * 4 + (h0.numel() * 4 if h0 is not None else 0)
    ops = 2 * a.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return {"bytes": nbytes, "operations": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_operations(t: int, p: int, n: int, chunk: int) -> tuple[int, int]:
    """Operations of the chunked form over ``t`` steps of one (batch, head),
    split as (C B^T, the rest): per chunk of q steps 2 q^2 N for C B^T, 2 q^2 P
    for M X, 2 q N P for (C exp L) h^T and 2 q N P for the state update."""
    cb = rest = 0
    for c0 in range(0, t, chunk):
        q = min(chunk, t - c0)
        cb += 2 * q * q * n
        rest += 2 * q * q * p + 4 * q * n * p
    return cb, rest


def ssd_bound(x, b_mat, d_skip, h0, chunk: int) -> dict:
    """Least time for K4's work at ``chunk`` steps per chunk (the kernel's):
    x, dt, B, C, a_log, d_skip and h0 read, y and h_last written once over the
    memory rate, against the least operations the chunked form needs (C B^T
    once per (batch, group), the rest per (batch, head)) at the peak rate of
    the precision the kernel computes in: bf16 x/B/C over T >= 2 steps take
    the tensor-core kernel (every product on bf16 operands, the bf16 rate);
    float32, and a bf16 decode step, the CUDA-core kernel.  ``fp32_rate_*``
    keeps the CUDA-core count: C B^T at the rate of B's type (products of bf16
    are exact in fp32), the rest at the fp32 rate.  ``kernel_operations``
    counts the chunked form with C B^T per head (what ``achieved_tflops``
    divides); ``tpu_operations`` the TPU kernel's count (per head, chunk 128)."""
    from repro_torch.kernels import ssd

    b, t, h, p = x.shape
    g, n = b_mat.shape[2:]
    cb, rest = ssd_operations(t, p, n, chunk)
    cb_ops, rest_ops = b * g * cb, b * h * rest
    nbytes = 2 * x.numel() * x.element_size() + b * t * h * 4 \
        + 2 * b_mat.numel() * b_mat.element_size() + h * 4 \
        + (h * 4 if d_skip is not None else 0) + (h0.numel() * 4 if h0 is not None else 0) \
        + b * h * p * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops32 = (cb_ops / PEAK_FLOPS[str(b_mat.dtype).split(".")[-1]]
               + rest_ops / PEAK_FLOPS["float32"]) * 1e3
    tensor_cores = ssd.on_tensor_cores(x.dtype, t)
    t_ops = (cb_ops + rest_ops) / PEAK_FLOPS["bfloat16"] * 1e3 if tensor_cores else t_ops32
    return {"bytes": nbytes, "operations": cb_ops + rest_ops, "cb_operations": cb_ops,
            "kernel_operations": b * h * (cb + rest),
            "tpu_operations": b * h * sum(ssd_operations(t, p, n, 128)),
            "chunk": chunk, "precision": "bf16 tensor cores" if tensor_cores else "fp32 CUDA cores",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_rate_ops_ms": t_ops32, "fp32_rate_bound_ms": max(t_bytes, t_ops32),
            "fp32_rate_bound_by": "bytes" if t_bytes >= t_ops32 else "operations"}


def ssd_operands(shape, dtype, device, with_extras=True, seed=0):
    """x, B, C in ``dtype``; dt = softplus(normal) > 0, a_log, d_skip, h0 fp32
    (the last two None without ``with_extras``)."""
    import torch

    b, t, h, p, g, n = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = randn(gen, (b, t, h, p), device, dtype)
    dt = torch.nn.functional.softplus(randn(gen, (b, t, h), device))
    a_log = 0.5 * randn(gen, (h,), device)
    bm = (0.3 * randn(gen, (b, t, g, n), device)).to(dtype)
    cm = (0.3 * randn(gen, (b, t, g, n), device)).to(dtype)
    d_skip = randn(gen, (h,), device) if with_extras else None
    h0 = 0.1 * randn(gen, (b, h, p, n), device) if with_extras else None
    return x, dt, a_log, bm, cm, d_skip, h0


def rglru_operands(shape, dtype, device, seed=0):
    import torch

    b, t, d, with_h0 = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = randn(gen, (b, t, d), device, dtype)
    a_param = 0.1 * randn(gen, (d,), device)
    ig = torch.sigmoid(randn(gen, (b, t, d), device)).to(dtype)
    ag = torch.sigmoid(randn(gen, (b, t, d), device)).to(dtype)
    h0 = randn(gen, (b, d), device) if with_h0 else None
    return x, a_param, ig, ag, h0


def phase_model_kernels(device):
    """K2, K3 and K4 against their plain versions on the card."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_lse = {"float32": 0.0, "bfloat16": 0.0}
    n_flash = 0
    for i, shape in enumerate(FLASH_SHAPES + (FLASH_SERVE,)):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, kw = flash_operands(shape, dtype, device, seed=i)
            before = fa.flash_attention.launches
            got, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            if fa.flash_attention.launches != before + 1:
                raise AssertionError("flash_attention did not launch its kernel")
            want, want_lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
            ok, err = _within(lse, want_lse, FLASH_LSE_TOL)
            worst_lse[name] = max(worst_lse[name], err)
            if not ok:
                raise AssertionError(f"flash_attention lse differs: {shape} {name} err {err}")
            ok, err = _within(got, want, FLASH_TOL[name])
            worst[name] = max(worst[name], err)
            if not ok:
                raise AssertionError(f"flash_attention differs from its plain version: "
                                     f"{shape} {name} max_abs_err {err}")
            n_flash += 1
    worst_rg = 0.0
    for i, shape in enumerate(RGLRU_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, a_param, ig, ag, h0 = rglru_operands(shape, dtype, device, seed=i)
            before = rg.rglru_scan.launches
            y, h = rg.rglru_scan(x, a_param, ig, ag, h0)
            torch.cuda.synchronize()
            if rg.rglru_scan.launches != before + 1:
                raise AssertionError("rglru_scan did not launch its kernel")
            want_y, want_h = rg.rglru_scan_torch(x, a_param, ig, ag, h0)
            worst_rg = max(worst_rg, _within(y, want_y, 0.0)[1], _within(h, want_h, 0.0)[1])
            if not (torch.equal(y, want_y) and torch.equal(h, want_h)):
                raise AssertionError(f"rglru_scan differs from its plain version: {shape} {dtype}")
    ssd_err = {"float32": 0.0, "bfloat16": 0.0}
    ssd_rel = {"float32": 0.0, "bfloat16": 0.0}
    ssd_h_err = 0.0
    n_ssd = 0
    for i, shape in enumerate(SSD_SHAPES):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for with_extras in (True, False):
                args = ssd_operands(shape, dtype, device, with_extras, seed=100 + i)
                before = ssd.ssd_chunked.launches
                y, h = ssd.ssd_chunked(*args)
                torch.cuda.synchronize()
                if ssd.ssd_chunked.launches != before + 1:
                    raise AssertionError("ssd_chunked did not launch its kernel")
                want_y, want_h = ssd.ssd_chunked_torch(*args)
                if y.dtype != dtype or h.dtype != torch.float32:
                    raise AssertionError(f"ssd_chunked returned {y.dtype} / {h.dtype}")
                diff = float((y.float() - want_y.float()).abs().max())
                rel = diff / float(want_y.float().abs().max())
                ok_h, err_h = _within(h, want_h, SSD_H_TOL)
                ssd_err[name] = max(ssd_err[name], diff)
                ssd_rel[name] = max(ssd_rel[name], rel)
                ssd_h_err = max(ssd_h_err, err_h)
                if not (rel < SSD_TOL[name] and ok_h and bool(torch.isfinite(y).all())):
                    raise AssertionError(
                        f"ssd_chunked differs from its plain version: {shape} {name} "
                        f"h0/d_skip={with_extras}: y {rel:.3g} of max |y|, h_last {err_h:.3g}")
                n_ssd += 1
    say("model_kernels", flash_checks=n_flash, flash_max_abs_err=worst,
        flash_lse_max_abs_err=worst_lse,
        flash_tolerance={**FLASH_TOL, "lse": FLASH_LSE_TOL},
        flash_shapes=[list(s) for s in FLASH_SHAPES + (FLASH_SERVE,)],
        rglru_checks=2 * len(RGLRU_SHAPES), rglru_max_abs_err=worst_rg,
        rglru_tolerance="0 (torch.equal), float32 and bfloat16 inputs",
        rglru_shapes=[list(s) for s in RGLRU_SHAPES],
        ssd_checks=n_ssd, ssd_max_abs_err=ssd_err, ssd_max_rel_err=ssd_rel,
        ssd_h_last_max_abs_err=ssd_h_err,
        ssd_tolerance={"y": SSD_TOL, "h_last": SSD_H_TOL,
                       "measure": "y: max |diff| / max |y|; h_last: |diff| <= tol (1 + |h|)"},
        ssd_shapes=[list(s) for s in SSD_SHAPES])
    return {"flash_attention": max(worst.values()), "flash_f32": worst["float32"],
            "rglru_scan": worst_rg, "ssd_chunked": max(max(ssd_err.values()), ssd_h_err)}


def model_kernel_wrappers() -> dict:
    """The model path's kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    return {"flash_attention": fa.flash_attention, "rglru_scan": rg.rglru_scan,
            "ssd_chunked": ssd.ssd_chunked}


def expected_launches(cfg, gen: int) -> dict:
    """Kernel launches of one serve of ``gen`` tokens: K2 once per attention
    layer (prefill only; decode reads the ring in PyTorch), K3 and K4 once per
    recurrent / SSM layer at the prefill and at each of the gen - 1 steps."""
    return {"flash_attention": cfg.kinds.count("attn_local"),
            "rglru_scan": cfg.kinds.count("rec") * gen,
            "ssd_chunked": cfg.kinds.count("ssm") * gen}


@contextlib.contextmanager
def plain_kernels(ssd_chunk: int | None = None):
    """The model path with K2, K3 and K4 replaced by their plain versions (for
    the comparison only: the port itself has no such route); the plain SSD
    runs at ``ssd_chunk`` steps per chunk if given, else at the kernel's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    plain_ssd = ssd.ssd_chunked_torch if ssd_chunk is None else \
        functools.partial(ssd.ssd_chunked_torch, chunk=ssd_chunk)
    orig = ops.flash_attention, ops.rglru_scan, ops.ssd_chunked
    ops.flash_attention, ops.rglru_scan, ops.ssd_chunked = \
        fa.flash_attention_torch, rg.rglru_scan_torch, plain_ssd
    try:
        yield
    finally:
        ops.flash_attention, ops.rglru_scan, ops.ssd_chunked = orig


def check_fixed_limit(cfg, model, prompts, ids, device, errs, plain) -> dict:
    """recurrentgemma-2b: every step within ``TEACHER_FORCED_LIMIT``."""
    if not max(errs) <= TEACHER_FORCED_LIMIT:
        raise AssertionError(f"{cfg.arch_id}: served logits differ from the plain versions' by "
                             f"{max(errs):.3g} of max |logit| (limit {TEACHER_FORCED_LIMIT})")
    return {"teacher_forced_limit": TEACHER_FORCED_LIMIT}


def check_against_yardstick(cfg, model, prompts, ids, device, errs, plain) -> dict:
    """mamba2-780m: every bf16 step within ``YARDSTICK_FACTOR`` times the worst
    step of the plain versions against themselves with the SSD at
    ``YARDSTICK_CHUNK``, then the float32 check."""
    with plain_kernels(ssd_chunk=YARDSTICK_CHUNK):
        other = teacher_forced_logits(cfg, model, prompts, ids, device)
    yardstick = [rel_err(a, b) for a, b in zip(other, plain)]
    del other
    limit = YARDSTICK_FACTOR * max(yardstick)
    if not max(errs) <= limit:
        raise AssertionError(f"{cfg.arch_id}: served logits differ from the plain versions' by "
                             f"{max(errs):.3g} of max |logit|, more than {YARDSTICK_FACTOR} x "
                             f"the plain versions' own {max(yardstick):.3g} at chunk "
                             f"{YARDSTICK_CHUNK}")
    return {"teacher_forced_limit": limit,
            "plain_vs_plain_other_chunk_rel_err": yardstick,
            **float32_teacher_forced(cfg, prompts, ids, device)}


def float32_teacher_forced(cfg, prompts, ids, device) -> dict:
    """The full-width model in float32 (random weights from seed 0), teacher-
    forced with the served ids through the kernels and through the plain
    versions; raises past ``FLOAT32_TEACHER_FORCED_LIMIT``."""
    import dataclasses

    import torch

    from repro_torch.models import arch_init_params

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = arch_init_params(cfg32, torch.Generator(device=device).manual_seed(0), device=device)
    kern = teacher_forced_logits(cfg32, model, prompts, ids, device)
    with plain_kernels():
        plain = teacher_forced_logits(cfg32, model, prompts, ids, device)
    errs = [rel_err(a, b) for a, b in zip(kern, plain)]
    del model, kern, plain
    torch.cuda.empty_cache()
    limit = FLOAT32_TEACHER_FORCED_LIMIT
    if not max(errs) <= limit:
        raise AssertionError(f"{cfg.arch_id} in float32: served logits differ from the plain "
                             f"versions' by {max(errs):.3g} of max |logit| (limit {limit})")
    return {"float32_teacher_forced_rel_err": errs, "float32_teacher_forced_limit": limit}


def teacher_forced_logits(cfg, model, prompts, ids, device):
    """Prefill logits and each decode step's logits, feeding the served ids."""
    from repro_torch.models import arch_decode_step
    from repro_torch.runtime import make_prefill_step

    plen, gen = prompts.shape[1], ids.shape[1]
    logits, cache = make_prefill_step(cfg, max_len=plen + gen, device=device)(
        model, {"tokens": prompts})
    out = [logits.float()]
    for i in range(gen - 1):
        logits, cache = arch_decode_step(cfg, model, cache, ids[:, i:i + 1], plen + i)
        out.append(logits.float())
    return out


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _kernel_class(name: str) -> str:
    if "sweep_kernel" in name:       # K1's four instances
        return "K1 schedule_dp"
    if "seq_cumsum" in name:
        return "seq_cumsum"
    if "flash_fwd" in name:          # flash_fwd_kernel (f32), flash_fwd_mma_kernel (bf16)
        return "K2 flash_attention"
    if "rglru_scan" in name:         # rglru_scan_kernel (T >= 2), rglru_scan_step_kernel
        return "K3 rglru_scan"
    if "ssd_chunk" in name:          # ssd_chunk_kernel, ssd_chunk_mma_kernel (bf16 prefill)
        return "K4 ssd_chunked"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "matmul", "splitk")):
        return "matmul (cuBLAS)"
    return "elementwise / reduction / copy"


def device_breakdown(fn, top: int = 0) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the card's kernel time
    by class; busy share = kernel time / wall time of the window.  ``top``
    adds the kernels with the most device time, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict = {}
    by_name = []
    n_kernels = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        c = by_class.setdefault(_kernel_class(e.key), {"ms": 0.0, "launches": 0})
        c["ms"] += us / 1e3
        c["launches"] += e.count
        n_kernels += e.count
        by_name.append({"kernel": e.key[:120], "ms": us / 1e3, "launches": e.count})
    if n_kernels == 0:
        raise AssertionError("the profiler recorded no kernel of the window")
    busy = sum(c["ms"] for c in by_class.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
           "kernels": n_kernels,
           "by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1]["ms"]))}
    if top:
        out["top_kernels"] = sorted(by_name, key=lambda k: -k["ms"])[:top]
    return out


def phase_model_serve(device, arch: str, check):
    """The full-width serve of ``arch`` through its kernels, then the
    comparison with the plain versions, held by ``check`` (which raises past
    its limit and returns its readings).  Every model kernel's count is set to
    0 just before the measured serve and read just after it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import arch_init_params
    from repro_torch.runtime import make_prefill_step, make_serve_step, next_token

    cfg = get_config(arch)
    wrappers = model_kernel_wrappers()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = arch_init_params(cfg, gen, device=device)
    prompts = torch.randint(1, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                            device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # first serve: library handles, lazy module loads and the allocator's
    # first growth land here; it is reported, the second one is the reading
    first = serve(cfg, model, prompts, 2, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    for fn in wrappers.values():
        fn.launches = 0
    res = serve(cfg, model, prompts, SERVE_GEN, device=device)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    want = expected_launches(cfg, SERVE_GEN)
    if launches != want:
        raise AssertionError(f"{arch}: main-path launches {launches}, expected {want}")
    if res.ids.shape != (SERVE_BATCH, SERVE_GEN) or not (
            (res.ids >= 0) & (res.ids < cfg.vocab_size)).all():
        raise AssertionError(f"served ids out of range or misshapen: {res.ids.shape}")

    # where the card's time goes: one prefill, then 8 decode steps, profiled
    prefill = make_prefill_step(cfg, max_len=SERVE_PROMPT + SERVE_GEN, device=device)
    step = make_serve_step(cfg, device=device)
    held = {}

    def do_prefill():
        held["logits"], held["cache"] = prefill(model, {"tokens": prompts})

    def do_decode():
        tok, cache = next_token(cfg, held["logits"])[:, None], held["cache"]
        for i in range(8):
            tok, cache = step(model, cache, tok, SERVE_PROMPT + i)

    profile = {"prefill": device_breakdown(do_prefill), "decode_8_steps": device_breakdown(do_decode)}
    del held

    # teacher-forced against the same model on the plain versions
    ids = torch.from_numpy(res.ids).to(device)
    kern = teacher_forced_logits(cfg, model, prompts, ids, device)
    with plain_kernels():
        before = {name: fn.launches for name, fn in wrappers.items()}
        plain = teacher_forced_logits(cfg, model, prompts, ids, device)
        if {name: fn.launches for name, fn in wrappers.items()} != before:
            raise AssertionError("the plain-version run launched a kernel")
    errs = [rel_err(a, b) for a, b in zip(kern, plain)]
    for i, (a, b) in enumerate(zip(kern, plain)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite logits at step {i}")
    readings = check(cfg, model, prompts, ids, device, errs, plain)
    served_again = torch.stack([a[:, :cfg.vocab_size].argmax(-1) for a in kern], 1).cpu()
    plain_greedy = torch.stack([b[:, :cfg.vocab_size].argmax(-1) for b in plain], 1).cpu()
    del kern, plain, model
    torch.cuda.empty_cache()

    say("model_serve", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype, batch=SERVE_BATCH,
        prompt_len=SERVE_PROMPT, gen=SERVE_GEN, window=cfg.attn_window,
        launches=launches, expected_launches=want,
        prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=res.decode_ms_per_step,
        first_serve_prefill_ms=first.prefill_s * 1e3,
        decode_steps=res.steps, tok_per_s=res.tokens_per_s,
        max_memory_allocated_bytes=peak, init_s=init_s,
        teacher_forced_rel_err=errs,
        served_ids_reproduced_teacher_forced=bool((served_again == torch.from_numpy(res.ids)).all()),
        greedy_tokens_same_on_plain_versions=int((plain_greedy == torch.from_numpy(res.ids)).sum()),
        sample_ids=res.ids[0, :16].tolist(), device_profile=profile, **readings,
        note="prefill_ms: prompt forward + first token, synchronised, in the second "
             "serve of the process (first_serve_prefill_ms: the first, with set-up); "
             "decode: 31 steps of one token each; max_memory_allocated over the second "
             "serve; rel_err = max |diff| / max |logit| per step; device_profile: "
             "torch.profiler kernel time by class over one prefill and over 8 decode "
             "steps (wall includes the profiler's own host cost)")
    return launches


def sdpa_backend(q, k, v, mask) -> str:
    import torch

    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    from torch.nn.attention import SDPBackend

    code = int(choose(q, k, v, mask, 0.0, False))
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(code, f"code {code}")


def phase_model_timing(device):
    """K2, K3 and K4 at the serving shapes: kernel, plain version, bound,
    library."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    q, k, v, kw = flash_operands(FLASH_SERVE, torch.bfloat16, device, seed=7)
    f_ms = cuda_median_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=20, warmup=3)
    f_plain = cuda_median_ms(lambda: fa.flash_attention_torch(q, k, v, **kw), reps=3, warmup=1)
    f_bound = flash_bound(q, k, v, **kw)
    # yardstick only: the port never calls it
    s, h = q.shape[1], q.shape[2]
    pos = torch.arange(s, device=device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - kw["window"])
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(-1, h, -1, -1).contiguous()
    vt = v.transpose(1, 2).expand(-1, h, -1, -1).contiguous()
    lib_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band),
                            reps=20, warmup=3)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band).transpose(1, 2)
    lib_err = float((lib_out.float() - fa.flash_attention(q, k, v, **kw).float()).abs().max())
    backend = sdpa_backend(qt, kt, vt, band)
    del qt, kt, vt, lib_out

    x, a_param, ig, ag, h0 = rglru_operands((SERVE_BATCH, SERVE_PROMPT, 2560, True),
                                            torch.bfloat16, device, seed=8)
    a, xb = rg.rglru_gates(x, a_param, ig, ag)
    # CUDA events around one launch, as for every kernel, and the kernel's
    # own device time beside it (the events also take the launch's host work)
    r_ms = cuda_median_ms(lambda: rg._launch_cuda(a, xb, h0), reps=20, warmup=3)
    r_dev = profiled_device_ms(lambda: rg._launch_cuda(a, xb, h0), "rglru_scan_kernel", reps=20)
    r_plain = cuda_median_ms(lambda: rg.scan_torch(a, xb, h0), reps=3, warmup=1)
    r_wrapper = cuda_median_ms(lambda: rg.rglru_scan(x, a_param, ig, ag, h0), reps=20, warmup=3)
    r_bound = rglru_bound(a, h0)
    d_a, d_xb = a[:, :1].contiguous(), xb[:, :1].contiguous()
    r_decode = cuda_median_ms(lambda: rg._launch_cuda(d_a, d_xb, h0), reps=50, warmup=5)
    r_decode_dev = profiled_device_ms(lambda: rg._launch_cuda(d_a, d_xb, h0),
                                      "rglru_scan_step_kernel", reps=50)
    r_decode_bound = rglru_bound(d_a, h0)
    # K4 as the prefill calls it (bf16 x/B/C, d_skip, an fp32 h0) and as a
    # decode step calls it (T = 1)
    args = ssd_operands(SSD_SERVE, torch.bfloat16, device, True, seed=9)
    s_ms = cuda_median_ms(lambda: ssd.ssd_chunked(*args), reps=20, warmup=3)
    s_plain = cuda_median_ms(lambda: ssd.ssd_chunked_torch(*args), reps=3, warmup=1)
    s_bound = ssd_bound(args[0], args[3], args[5], args[6], chunk=ssd.CHUNK)
    del args
    dec = ssd_operands((SERVE_BATCH, 1) + SSD_SERVE[2:], torch.bfloat16, device, True, seed=10)
    s_dec = cuda_median_ms(lambda: ssd.ssd_chunked(*dec), reps=50, warmup=5)
    s_dec_dev = profiled_device_ms(lambda: ssd.ssd_chunked(*dec), "ssd_chunk_kernel", reps=50)
    s_dec_plain = cuda_median_ms(lambda: ssd.ssd_chunked_torch(*dec), reps=20, warmup=3)
    s_dec_bound = ssd_bound(dec[0], dec[3], dec[5], dec[6], chunk=ssd.CHUNK)
    out = {
        "flash_attention": {"ms": f_ms, "plain_ms": f_plain, **f_bound, "library_ms": lib_ms,
                            "library": f"scaled_dot_product_attention ({backend}), kv heads "
                                       "expanded and band mask built outside the timing",
                            "library_max_abs_diff": lib_err, "shape": list(FLASH_SERVE)},
        "rglru_scan": {"ms": r_ms, "device_ms": r_dev, "plain_ms": r_plain, **r_bound,
                       "library_ms": None,
                       "wrapper_ms_with_gates": r_wrapper, "decode_step_ms": r_decode,
                       "decode_step_device_ms": r_decode_dev,
                       "decode_step_bound_ms": r_decode_bound["bound_ms"],
                       "decode_step_bound_by": r_decode_bound["bound_by"],
                       "decode_step_bytes": r_decode_bound["bytes"],
                       "shape": [SERVE_BATCH, SERVE_PROMPT, 2560]},
        "ssd_chunked": {"ms": s_ms, "plain_ms": s_plain, **s_bound, "library_ms": None,
                        "achieved_tflops": s_bound["kernel_operations"] / s_ms * 1e-9,
                        "decode_step_ms": s_dec, "decode_step_device_ms": s_dec_dev,
                        "decode_step_plain_ms": s_dec_plain,
                        "decode_step_bound_ms": s_dec_bound["bound_ms"],
                        "decode_step_bound_by": s_dec_bound["bound_by"],
                        "decode_step_bytes": s_dec_bound["bytes"],
                        "shape": list(SSD_SERVE), "dtype": "bfloat16 x/B/C, fp32 dt/h0"},
    }
    say("model_timing", **out,
        note="ms: median of 20 launches (plain version: 3) timed with CUDA events after "
             "warm-up, inputs resident on the card; rglru device_ms: the scan kernel's "
             "mean device time over 20 launches from torch.profiler (the gate math is "
             "PyTorch and is in wrapper_ms_with_gates); ssd ms is the "
             "wrapper (one launch, d_skip fused); its bound_ms counts the least operations "
             "at the kernel's chunk (C B^T once per group) at the rate of the precision "
             "the kernel computes in (bf16 tensor cores for a bf16 prefill), "
             "fp32_rate_bound_ms the same work with all but C B^T at the fp32 rate; "
             "kernel_operations is the chunked form with C B^T per head, achieved_tflops "
             "those over ms, tpu_operations the TPU kernel's count (per head, chunk 128); "
             "decode_step_ms is event-timed around one wrapper call (host work "
             "included), decode_step_device_ms the kernel's own time from "
             "torch.profiler, mean of 50")
    return out


# every hand-written kernel: name, its source, the TPU kernel it replaces
KERNELS = (
    ("schedule_dp", "src/repro_torch/kernels/csrc/schedule_dp.cu",
     "src/repro/kernels/schedule_dp.py:334"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:99"),
    ("rglru_scan", "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:41"),
    ("ssd_chunked", "src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:75"),
    # a helper of the device-resident round, with no TPU kernel: it replaces
    # the reference's blocked sequential lax.scan of the durations
    ("seq_cumsum", "src/repro_torch/kernels/csrc/schedule_dp.cu",
     "src/repro/core/device_search.py:199"),
)
HELPERS = ("seq_cumsum",)


def kernel_entries(launches: dict, errs: dict, times: dict, extras: dict) -> list:
    """The ``kernels`` line: one entry per kernel, launches from its main
    path's run, its worst error against its plain version, and its times and
    bound at the main path's shape (``times[name]`` holds ms, plain_ms,
    bound_ms, bound_by and library_ms, which is None where no single PyTorch
    call computes the function)."""
    return [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             **({"helper": True, "tpu_kernel": None} if name in HELPERS else {}),
             "launches": launches[name], "max_abs_err": errs[name],
             **{k: times[name].get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
             **extras.get(name, {})}
            for name, source, replaces in KERNELS]


def launches_by_path(paths: dict) -> dict:
    """K1's and ``seq_cumsum``'s launches on each path that runs them (the
    counts set to 0 just before the path, read just after)."""
    return {name: {path: got[name] for path, got in paths.items() if name in got}
            for name in ("schedule_dp", "seq_cumsum")}


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

    # float32 products of the plain versions stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()                      # one nvcc per source, all at once
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    say("build", kernels=sorted(_build.KERNEL_SOURCES), flags=list(_build.NVCC_FLAGS),
        seconds=time.perf_counter() - t0, build_dir=str(_build.build_dir()))
    phase_ptxas(sorted(_build.KERNEL_SOURCES))

    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    worst = timed("kernels", phase_kernels, device)
    model_err = timed("model_kernels", phase_model_kernels, device)
    launches, max_rows, main_wall = timed("main_path", phase_main_path)
    device_launches = timed("device_path", phase_device_path, device, main_wall)
    cum = timed("seq_cumsum", phase_seq_cumsum, device, 80)
    model_launches = timed("model_serve " + ARCH, phase_model_serve, device, ARCH,
                           check_fixed_limit)
    mamba_launches = timed("model_serve " + MAMBA_ARCH, phase_model_serve, device, MAMBA_ARCH,
                           check_against_yardstick)
    timing = timed("timing", phase_timing, device, max_rows)
    mtime = timed("model_timing", phase_model_timing, device)
    # last, so that the earlier phases run as they did before it joined
    service_launches = timed("solve_service", phase_solve_service, device)

    fwd, tails = timing["forward"], timing["tails"]
    by_path = launches_by_path({"main_path": {"schedule_dp": launches},
                                "device_path": device_launches,
                                "solve_service": service_launches})
    fl, rg, sd = mtime["flash_attention"], mtime["rglru_scan"], mtime["ssd_chunked"]
    entries = kernel_entries(
        launches={"schedule_dp": launches, "flash_attention": model_launches["flash_attention"],
                  "rglru_scan": model_launches["rglru_scan"],
                  "ssd_chunked": mamba_launches["ssd_chunked"],
                  "seq_cumsum": device_launches["seq_cumsum"]},
        errs={"schedule_dp": worst, **model_err, "seq_cumsum": cum["max_abs_err"]},
        times={"schedule_dp": fwd, **mtime, "seq_cumsum": cum},
        extras={
            "schedule_dp": {"launches_by_path": by_path["schedule_dp"],
                            "chain_ms": fwd["chain_ms"], "shape": [max_rows, sdp.bucket(250)],
                            "dtype": "float64", "call": "forward only",
                            "depth_levels": fwd["depth_levels"],
                            "ms_per_level": fwd["ms_per_level"],
                            "chain_probe_ms_per_level": timing["chain_probe_ms_per_level"],
                            "device_ms": fwd["device_ms"],
                            "device_ms_per_level": fwd["device_ms_per_level"],
                            "tails_ms": tails["ms"], "tails_device_ms": tails["device_ms"],
                            "tails_plain_ms": tails["plain_ms"],
                            "tails_bound_ms": tails["bound_ms"],
                            "tails_chain_ms": tails["chain_ms"]},
            "flash_attention": {"max_abs_err_f32": model_err["flash_f32"],
                                "library": fl["library"], "shape": fl["shape"],
                                "dtype": "bfloat16"},
            "rglru_scan": {"shape": rg["shape"], "dtype": "float32 scan (bfloat16 model)",
                           "device_ms": rg["device_ms"],
                           "decode_step_ms": rg["decode_step_ms"],
                           "decode_step_device_ms": rg["decode_step_device_ms"],
                           "decode_step_bound_ms": rg["decode_step_bound_ms"],
                           "decode_step_bound_by": rg["decode_step_bound_by"]},
            "ssd_chunked": {"shape": sd["shape"], "dtype": sd["dtype"],
                            "precision": sd["precision"],
                            "fp32_rate_bound_ms": sd["fp32_rate_bound_ms"],
                            "fp32_rate_bound_by": sd["fp32_rate_bound_by"],
                            "operations": sd["operations"],
                            "kernel_operations": sd["kernel_operations"],
                            "tpu_operations": sd["tpu_operations"],
                            "achieved_tflops": sd["achieved_tflops"],
                            "decode_step_ms": sd["decode_step_ms"],
                            "decode_step_device_ms": sd["decode_step_device_ms"],
                            "decode_step_bound_ms": sd["decode_step_bound_ms"]},
            "seq_cumsum": {"shape": cum["shape"], "dtype": "float64",
                           "path": "device_path", "launches_by_path": by_path["seq_cumsum"],
                           "device_ms": cum["device_ms"],
                           "chain_ms": cum["chain_ms"],
                           "add_chain_ms_per_add": cum["add_chain_ms_per_add"],
                           "torch_cumsum_on_card_max_abs_err":
                               cum["torch_cumsum_on_card_max_abs_err"]},
        })
    print(json.dumps({"kernels": entries, "seconds": time.perf_counter() - t_start,
                      "phase_seconds": phase_s}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
