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
* the analysis CLI (``python -m repro_torch.analysis``): ``selftest``,
  ``lint`` over the port, and ``certify`` of the smoke suite through the
  torch backend (K1) and the device backend (K1, ``seq_cumsum``) on the card;
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
  prefill and at every decode step;
* model serving: qwen2.5-14b, the serving launcher's default arch, at its
  published width and depth (48 global-attention layers, d 5120, 40 heads
  over 8 kv heads of 128, d_ff 13824, vocab 152064, qkv biases, untied head),
  the same batch, prompts and tokens, through K2 at every layer's prefill
  and a linear KV cache for the decode;
* model serving: the MoE, encoder-decoder and vision-token archs at their
  published widths and depths, batch 4, 32 tokens, through K2 at every
  attention of the prefill: granite-moe-1b-a400m (24 layers, d 1024, 16
  heads over 8 kv heads of 64, 32 experts top 8 with the reference's dense
  dispatch) over 4096-token prompts; whisper-medium (24 encoder and 24
  decoder layers, d 1024, 16 heads of 64, LayerNorm, biased GELU MLPs) over
  1500 stub-frontend frames with a 416-token decoder prompt (K2 non-causal in
  the encoder, causal in the decoder, non-causal from the decoder over the
  encoder: 72 launches); internvl2-26b (48 layers, d 6144, 48 heads over 8
  kv heads of 128) over 4096-token prompts whose first 256 positions are
  stub-frontend vision embeddings;
* crash / resume of the device search: the device path's solve lost at a
  sync by a seeded plan, its checkpoint saved, loaded and resumed, equal to
  the run that never crashed;
* training: recurrentgemma-2b at its published width and depth (fp32
  masters, bf16 compute, random from seed 0), batch 1 of 4096-token
  sequences, AdamW, under the HDATS planner's residency plan for one H100,
  through ``repro_torch.launch.train``'s path: K2 and K3 forward and their
  hand-written backwards (K2 bwd, K3 bwd) in every step;
* training: mamba2-780m at its published width and depth (48 SSD layers,
  780 M fp32 masters, bf16 compute) the same way, through K4 forward and its
  hand-written backward (K4 bwd) in every layer of every step;
* the multi-device layer: granite-moe-1b-a400m trained with DTensor
  parameters on a one-rank NCCL mesh through ``make_train_step(rules=)``,
  K2 and K2 bwd run on each rank's shard through ``local_map``; the dry run
  (``launch/dryrun.py``) of each trained configuration held against its
  measured step, and of llama3-405b's ``train_4k`` on the 2 x 16 x 16
  production mesh; the multi-rank cases on gloo ranks under the card's
  torch, and the dry-run cells whose views folded a sharded dim there.

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
                 ones, T = 1 and the serving shapes (K2 also in bf16 at
                 qwen2.5-14b's and codeqwen1.5-7b's causal d-128 prefills,
                 granite's and internvl2's GQA prefills and whisper's
                 encoder, decoder and cross-attention shapes);
                 K2 bwd (dq, dk, dv: f32 1e-5 on the CUDA cores, bf16 2e-2 of
                 max |grad| on the tensor cores; rows that see no key get zero
                 dq) at the reference's gradient test shapes, ragged ones and
                 the training shape, where two bf16 calls must give
                 bit-identical gradients, K3 bwd (bit for bit, with and
                 without a last-state gradient), and K4 bwd (dx, ddt, da_log,
                 dB, dC, dd_skip, dh0: f32 1e-4, bf16 2e-2 of max |grad|) at
                 K4's shapes, T < 64 with G < H, mamba2-780m's training
                 shape and the edges of its tensor-core passes (T 4097, P 16
                 and 32, N 32 and 64, G = H, 1 < G < H, T = 1), with h0,
                 d_skip and a nonzero dh_last and without, two bf16 calls at
                 the training shape bit-identical
  main_path      the solve on the card (6 iterations), against the port's
                 NumPy backend, certified, with the host time of each phase of
                 the search round
  device_path    ``tabu_device`` at the same configuration: without Algorithm 3
                 (cold, then two warm runs paired in alternating order with
                 NumPy runs) bit-identical to the NumPy ``tabu_multiwalk``
                 with no perturbation; with it, certified with capacity; the
                 replays run with every synchronising call an error, the time
                 of one replayed round, and the K1 / seq_cumsum launches that
                 the profiler sees in replays held to the captured round's
                 nodes; then seq_cumsum against its plain version (bit for
                 bit), timed beside its bound and its chain of dependent adds
  analysis_cli   python -m repro_torch.analysis in this process: selftest
                 catches its RPR101 / RPR102 and schedule injections, lint
                 finds nothing in the port, certify --suite smoke
                 --max-iters 4 passes all 7 instances on numpy, on torch and
                 on device (cuda), the torch rows' makespans, histories and
                 exact evaluations equal to numpy's, K1 (and on device
                 seq_cumsum, captured and replayed) launches counted
  crash_resume   the device path's solve (Algorithm 3 at syncs, a sync every 8
                 rounds): uncrashed with a checkpoint at each sync, lost at a
                 middle sync by a seeded device_lost, saved, loaded, resumed;
                 the result equal to the uncrashed one field for field, the
                 incumbents monotone across the seam, and the K1 launches the
                 profiler sees in the first resumed period held to the
                 captured round's nodes x rounds
  model_serve    per arch (recurrentgemma-2b, mamba2-780m, qwen2.5-14b, then
                 granite-moe-1b-a400m, whisper-medium, internvl2-26b: these
                 three, with K2's timings at their shapes first, run last,
                 after train, in a child process, ``--slice-serves``, whose
                 lines are relayed): the
                 full-width serve (launch counts of every model kernel
                 asserted), the card's kernel time by class over a profiled
                 prefill and 8 decode steps, and the serve held teacher-forced
                 against the same model on the plain versions; for
                 mamba2-780m also the same check in float32, and the plain
                 version against itself at another chunk length (the
                 rounding noise of a correct bf16 path); for qwen2.5-14b
                 and the last three the plain version against itself with
                 attention summed in the reference TPU kernel's order
                 (online softmax over 128-key blocks); for granite also
                 both readings with every run on the plain run's expert
                 choice, held to the same factor in bf16 and in float32 (its
                 random MoE can swap a token's 8th and 9th expert on one
                 unit of rounding), and the swaps counted
  timing         K1, plain version, bound, its time per level against the
                 measured least cost of a level, and the host engine at the
                 main path's shape
  model_timing   K2 (recurrentgemma-2b's, qwen2.5-14b's and codeqwen1.5-7b's
                 prefill shapes), K3 and K4 at the serving shapes: kernel,
                 plain version, bound (K4's at the precision it computes
                 in, and at the fp32 rate), for K2 PyTorch's scaled_dot_product_attention, and
                 the K3 and K4 decode steps beside their bounds; K2 bwd, K3
                 bwd and K4 bwd at the training shape (K2 bwd, its four kernels with
                 the dk/dv and dq passes on the tensor cores, beside the
                 backward of scaled_dot_product_attention through autograd,
                 with its achieved TFLOP/s on the design's 14 D a pair); in a
                 child process, ``--model-timing``, whose lines are relayed
  solve_service  the solve service: warm-up (one WarmSpec per signature
                 class), the Poisson trace with no capture during traffic,
                 the K1 / seq_cumsum launches of the served run, one served
                 cut under the profiler (its K1 launches = captured nodes x
                 rounds), every report certified and bit-identical to its
                 solo tabu_device solve (the solo loop timed cold and warm),
                 the first 6 requests again under a seeded fault plan of
                 every kind with a watchdog (every request one terminal
                 state, survivors equal to their solo solves, no launch
                 failing but by an injected fault), and the table2 sweep on
                 the device engine against the NumPy engine

  train          (the last phase of this process) recurrentgemma-2b at full
                 width: the plan (scan group,
                 save / offload / remat per class, estimated step time), step
                 1's loss and gradients held against the same step on the
                 plain versions (loss 1e-3, every gradient 2e-2 of its max
                 |grad|, each, or within twice the plain versions' own
                 reading of it in another summation order; both printed), 4
                 steps through launch/train.py's path with K2 / K3 forward
                 and backward launches per step held to what the plan
                 implies, step time, tokens/s, model FLOPs / time / 989e12,
                 peak memory beside the reckoned peak, offloaded bytes, the
                 card's time by kernel class over one more step, and the
                 recovery drill at the smoke size (a run lost at steps 3 and
                 6, restored from its checkpoints: losses and parameters
                 bit-identical to the run that never failed)
  train_ssm      (a child process, ``--train-ssm``, after ``train``) the same
                 for mamba2-780m at full width: K4 / K4 bwd launches per step,
                 the step-1 gate (the yardstick also runs the plain SSD at
                 another chunk length), the profiled step, the recovery drill
  train_moe      (a child process, ``--train-moe``, after ``train_ssm``)
                 granite-moe-1b-a400m at full width the same way (batch 1 x
                 4096), its step-1 gate with every run on the plain run's
                 expert choice and the unpinned swaps counted, the dense
                 dispatch's held activations reckoned beside the peak, and
                 the MoE block's share of the step
  train_encdec   (a child process, ``--train-encdec``) whisper-medium at full
                 width the same way at batch 16 of 1500 frames and 448
                 decoder tokens, every layer in a recompute region (K2 144 /
                 K2 bwd 72 a step), tokens/s and frames/s, and step 1 also
                 held in float32 (its bf16 gate reads rounding noise: the
                 random tied embedding's logits reach +-140)
  distributed    (a child process, ``--distributed``, after the training)
                 the multi-device layer: (a) granite-moe-1b-a400m at 1 x
                 4096 with its parameters DTensors on a one-rank NCCL mesh
                 ("data", "model") of shape (1, 1) under arch_rules, step 1
                 held to the unsharded step of the same seed on the recorded
                 expert choice (loss 1e-3, gradients 2e-2; bit-equality the
                 reading), then 2 steps through make_train_step(rules=) with
                 K2 / K2 bwd 24 / 24 a step through local_map; (b) the dry
                 run (launch/dryrun.py: a fake process group, fake tensors)
                 of each trained configuration at its training shape on a
                 (1, 1) mesh, its peak bytes and flops beside the measured
                 step's; (c) llama3-405b train_4k on the 2 x 16 x 16
                 production mesh, status ok, per-device bytes, flops and
                 wire bytes; (d) multi_rank: 8 gloo ranks on this machine's
                 CPU under its torch (``--multi-rank``, beside (a)), port
                 against port: qwen2.5-14b's smoke train step under heads-TP
                 (4 x 2) and q-sequence TP (1 x 8), llama3-405b's
                 sequence-sharded decode (1 x 8) and the 4-stage pipeline,
                 each sharded against unsharded within the gloo tests' gates
                 (a check of the card's DTensor, not of the device path);
                 (e) strict_fold_cells: the dry-run cells that folded a
                 sharded dim (granite's 2-layer t cell on 4 x 2 and 2 x 2 x
                 2, qwen2.5-14b train_4k on 16 x 16), status ok.  The dry
                 runs need no card: each runs in a process of its own
                 (``--dry-run SPEC``), (b)'s beside the build and the
                 kernels' gates (nothing timed), (c)'s and (e)'s beside the
                 training children

then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  Without a GPU it exits non-zero.

"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
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


# the main path's iterations, cut as phases were added (each of its two
# solves took ~62 s of the script's limit at 30 iterations)
MAIN_PATH_ITERS = 6


def phase_main_path():
    """The solve through the default backend, against the NumPy backend."""
    from repro_torch import solve
    from repro_torch.analysis.certify import certify_solution
    from repro_torch.core import TSParams, random_instance
    from repro_torch.kernels import schedule_dp as sdp

    n_tasks, n_data, walks, iters = 250, 600, 8, MAIN_PATH_ITERS
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
    for order in (("device", "numpy"), ("numpy", "device")):
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
             "trajectory: NumPy, device cold, then two warm pairs in alternating order "
             "(device numpy, numpy device); walk_iters_per_s = walks x "
             "iterations / median warm wall_s (the NumPy runs' over all three), speedup "
             "their ratio, speedup_by_pair each warm pair's; "
             "max_memory_allocated: peak over the parity runs (the captures) and this "
             "run; memory_reserved: the allocator's holding after it")
    return {"schedule_dp": k1, "seq_cumsum": cs}, {"inst": inst, "inits": inits,
                                                   "params": params}


# crash / resume of the device search at the device path's configuration:
# syncs every 8 rounds, so the 30 iterations cross three syncs, and a plan
# that loses the device at a middle one (the reference's chaos_bench section
# B, its rate)
CRASH_SYNC_EVERY = 8
CRASH_RATE = 0.25


def crash_plan(n_syncs: int) -> tuple[dict, int]:
    """The first plan (seed 0, 1, ...) whose first ``device_lost`` at
    ``device_search.sync`` lands strictly inside a run of ``n_syncs`` syncs
    (after the first, before the last), as ``would_fire`` predicts it."""
    from repro_torch.faults import FaultPlan, would_fire

    for seed in range(10_000):
        kw = {"seed": seed, "rate": CRASH_RATE, "kinds": ("device_lost",),
              "points": ("device_search.sync",)}
        hits = [k for k in range(1, n_syncs + 1)
                if would_fire(FaultPlan(**kw), "fire", "device_search.sync", k)]
        if hits and 1 < hits[0] < n_syncs:
            return kw, hits[0]
    raise ValueError(f"no plan loses the device inside a run of {n_syncs} syncs")


def same_result(res, ref) -> bool:
    """``same_trajectory`` and the same best solution, field for field."""
    import numpy as np

    return (same_trajectory(res, ref) and res.best.proc_seq == ref.best.proc_seq
            and np.array_equal(res.best.assign, ref.best.assign)
            and np.array_equal(res.best.mem, ref.best.mem))


class FirstPeriodProfile:
    """Inside the block, the first sync period a ``_Launch`` runs is run under
    ``device_breakdown``: its rounds, whether it captured, its launch, and
    the card's kernels by class."""

    def __init__(self):
        self.window = self.rounds = self.launch = self.captured = None

    def __enter__(self):
        from repro_torch.core import device_search as ds

        self._run = real = ds._Launch.run

        def run(launch, rounds):
            if self.window is not None:
                return real(launch, rounds)
            out = {}
            self.window = device_breakdown(lambda: out.setdefault("c", real(launch, rounds)))
            self.rounds, self.launch, self.captured = rounds, launch, out["c"]
            return out["c"]

        ds._Launch.run = run
        return self

    def __exit__(self, *exc):
        from repro_torch.core import device_search as ds

        ds._Launch.run = self._run


def phase_crash_resume(device, ctx: dict, ckpt_dir: Path = ROOT / "build") -> dict:
    """The device search crashed at a sync and resumed from disk, on the card:
    the device path's greedy starts and configuration (Algorithm 3 at each
    sync), ``sync_every`` 8; an uncrashed run collecting checkpoints; a run
    lost at the middle sync a seeded plan predicts; its last checkpoint saved
    and loaded; the resume.  Gates: the resumed result equals the uncrashed
    one field for field, the incumbents never rise across the seam, and the
    profiler sees K1 = the captured round's nodes x rounds in the first
    resumed period (the counts set to 0 before the resume, read after)."""
    import torch

    from repro_torch.core import device_search as ds
    from repro_torch.faults import FaultPlan, plan_context
    from repro_torch.faults import checkpoint as ckpt_io
    from repro_torch.faults.errors import DeviceLost
    from repro_torch.kernels import schedule_dp as sdp

    inst, inits, params = ctx["inst"], ctx["inits"], ctx["params"]
    cfg = ds.DeviceConfig(sync_every=CRASH_SYNC_EVERY)
    walls = {}

    def timed_run(name, **kw):
        t0 = time.perf_counter()
        try:
            return ds.device_multiwalk(inst, [s.copy() for s in inits], params, config=cfg, **kw)
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0

    ref_ckpts = []
    ref = timed_run("uncrashed", on_checkpoint=ref_ckpts.append)
    plan_kw, crash_sync = crash_plan(len(ref_ckpts))
    crash_ckpts = []
    with plan_context(FaultPlan(**plan_kw)):
        try:
            timed_run("crashed", on_checkpoint=crash_ckpts.append)
        except DeviceLost as e:
            lost = repr(e)
        else:
            raise AssertionError(f"the plan predicted a lost device at sync {crash_sync}")
    if len(crash_ckpts) != crash_sync:
        raise AssertionError(f"lost at sync {crash_sync} after {len(crash_ckpts)} checkpoints")
    path = Path(ckpt_dir) / "crash_resume.ckpt.npz"
    ckpt_io.save(crash_ckpts[-1], str(path))
    restored = ckpt_io.load(str(path))
    resume_ckpts = []
    with FirstPeriodProfile() as first:
        sdp.sweep.launches = sdp.seq_cumsum.launches = 0
        resumed = timed_run("resumed", resume_from=restored, on_checkpoint=resume_ckpts.append)
        k1, cs = sdp.sweep.launches, sdp.seq_cumsum.launches
    if not same_result(resumed, ref):
        raise AssertionError("the resumed run differs from the uncrashed one")
    # the search's global incumbent at each checkpoint, then at the end (the
    # last entry of its history; the reported makespan may lie above it,
    # after Algorithm 3 repairs a capacity-infeasible incumbent)
    g_seq = [c.g_best for c in crash_ckpts + resume_ckpts] + [resumed.history[-1][1]]
    if any(b > a for a, b in zip(g_seq, g_seq[1:])):
        raise AssertionError(f"the incumbent rose across the crash / resume seam: {g_seq}")
    st = resumed.device_stats
    want = st["k1_per_round"] * (first.rounds + int(first.captured))
    seen = first.window["by_class"].get("K1 schedule_dp", {}).get("launches", 0)
    if seen != want:
        raise AssertionError(f"the first resumed period: the profiler saw {seen} K1 launches, "
                             f"its {first.rounds} rounds of {st['k1_per_round']} nodes make {want}")
    if k1 != st["k1_launches"] or (device.type == "cuda" and k1 <= 0):
        raise AssertionError(f"{k1} K1 launches counted, the resumed run reports "
                             f"{st['k1_launches']}")
    say("crash_resume", n_tasks=inst.n_tasks, walks=len(inits), iterations=resumed.iterations,
        sync_every=CRASH_SYNC_EVERY, syncs=len(ref_ckpts), crash_sync=crash_sync,
        plan=plan_kw, lost=lost, resumed_from_iteration=restored.iteration,
        resumed_identical=True, incumbent_monotone=True, incumbents=g_seq,
        makespan=resumed.best_makespan, final_incumbent=resumed.history[-1][1],
        stop_reason=resumed.stop_reason,
        checkpoint_bytes=path.stat().st_size, wall_s=walls,
        k1_launches=k1, seq_cumsum_launches=cs, rounds_replayed=st["rounds_replayed"],
        first_period={"rounds": first.rounds, "captured": first.captured,
                      "k1_profiled": seen, "k1_per_round": st["k1_per_round"],
                      "device_profile": first.window},
        note="the device path's greedy starts and TSParams (Algorithm 3 at syncs), "
             "DeviceConfig(sync_every=8); uncrashed: collects a checkpoint at each sync; "
             "crashed: the same run under the plan, lost after its crash_sync-th "
             "checkpoint; resumed: from that checkpoint saved to and loaded from disk, "
             "equal to the uncrashed run in makespan, history, iterations, exact and "
             "approximate evaluations, stop reason, every walk's history and the best "
             "solution's assign, mem and proc_seq; k1_launches: the resumed run's, counts "
             "set to 0 before it; first_period: its first sync period under torch.profiler")
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
    # row-major, as the round's torch.where hands it over (numpy's fancy
    # indexing gives a column-major array, which costs both seq_cumsum and
    # torch.cumsum a copy the round does not make)
    return torch.from_numpy(np.ascontiguousarray(vals)).to(device)


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
    # torch.cumsum's own kernels, by the names the profiler gives them
    library_kernels = profiled_kernel_names(lambda: torch.cumsum(v, dim=1))
    library_by_kernel = {name: profiled_device_ms(lambda: torch.cumsum(v, dim=1), name, reps=100)
                         for name in library_kernels}
    library_device_ms = sum(library_by_kernel.values())
    per_add = add_chain_ms_per_add(device)
    chain_ms = v.shape[1] * per_add
    # a row must make its width of dependent float64 adds to stay bit-equal,
    # so chain_ms, not the bytes bound, is the floor; the kernel is left as
    # it is if it is no slower than the library's kernels and within 2x of
    # that floor
    closed = device_ms <= library_device_ms and chain_ms / device_ms >= 0.5
    out = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms,
           "library_device_ms_by_kernel": {k[:100]: ms for k, ms in library_by_kernel.items()},
           "max_abs_err": worst, "shape": list(v.shape),
           "torch_cumsum_on_card_max_abs_err": torch_cumsum_err,
           "chain_ms": chain_ms, "add_chain_ms_per_add": per_add,
           "chain_share": chain_ms / device_ms,
           "decision": "closed, no redesign" if closed else "redesign", **cumsum_bound(v)}
    say("seq_cumsum", **out,
        note="bit-equal to its plain version (the CPU's torch.cumsum, np.cumsum's order) at "
             "every width; ms: median of 100 wrapper calls by CUDA events (host work "
             "included), device_ms the kernel's mean device time over 100 launches "
             "(torch.profiler), plain_ms the plain version on the card (20), library_ms "
             "torch.cumsum on the card (100), library_device_ms its kernels' mean device "
             "time over 100 calls (torch.profiler; by kernel, names cut to 100 characters); "
             "the input row-major, as the round hands it over; chain_share = "
             "chain_ms / device_ms; decision: closed if device_ms <= library_device_ms "
             "and chain_share >= 0.5; chain_ms = width x add_chain_ms_per_add, the "
             "measured time of one dependent float64 add: each row is such a chain, so "
             "this floor binds, not bound_ms (bytes / operations); "
             "torch_cumsum_on_card_max_abs_err: how far the card's torch.cumsum lands "
             "from the sequential sums")
    return out


# --------------------------------------------------------------------------- #
# the analysis CLI                                                            #
# --------------------------------------------------------------------------- #
# ``certify``'s budget: the reference's CLI test (``--max-iters 4``)
ANALYSIS_ITERS = 4


def run_analysis_cli(argv: list) -> tuple[int, dict]:
    """``python -m repro_torch.analysis <argv> --json`` in this process:
    its exit code and its JSON report."""
    import io

    from repro_torch.analysis import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*argv, "--json"])
    return rc, json.loads(out.getvalue())


def check_certified(got: dict, want_rows: int, backend: str) -> None:
    if got["n_failed"] or len(got["rows"]) != want_rows or \
            not all(r["certificate"]["ok"] for r in got["rows"]):
        raise AssertionError(f"certify --backend {backend}: {got['n_failed']} of "
                             f"{len(got['rows'])} certificates failed")


def check_cli_launches(launches: dict) -> None:
    """certify's torch backend launched K1, and its device backend captured
    K1 and ``seq_cumsum`` into its round and replayed them."""
    d = launches["device"]
    if launches["torch"]["schedule_dp"] <= 0 or min(
            d["schedule_dp"], d["schedule_dp_captured"], d["seq_cumsum"],
            d["seq_cumsum_captured"]) <= 0:
        raise AssertionError(f"certify did not run through K1 / seq_cumsum: {launches}")


def phase_analysis_cli(torch_device: str = "cuda") -> dict:
    """The analysis CLI as a user runs it: ``selftest`` catches both
    injections, ``lint`` finds nothing in the port, and ``certify`` passes
    every instance of the smoke suite through the torch backend (K1) and
    the device backend (the captured round: K1 and ``seq_cumsum``) on the
    card; the torch rows' trajectories are the NumPy backend's, bit for
    bit.  The counts are set to 0 just before each certify run and read
    just after."""
    import torch

    from repro_torch.instances.suites import get_suite
    from repro_torch.kernels import schedule_dp as sdp

    t0 = time.perf_counter()
    rc, st = run_analysis_cli(["selftest"])
    if rc or not st["certify_detected"] or not {"RPR101", "RPR102"} <= set(st["lint_rules"]):
        raise AssertionError(f"selftest missed an injection: {st}")
    seconds = {"selftest": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rc, lint = run_analysis_cli(["lint"])
    if rc or lint["findings"]:
        raise AssertionError(f"lint found {len(lint['findings'])} finding(s) in the port")
    seconds["lint"] = time.perf_counter() - t0
    n_inst = len(get_suite("smoke").items)
    certify = ["certify", "--suite", "smoke", "--max-iters", str(ANALYSIS_ITERS)]
    t0 = time.perf_counter()
    rc, ref = run_analysis_cli([*certify, "--backend", "numpy"])
    check_certified(ref, n_inst, "numpy")
    seconds["certify numpy"] = time.perf_counter() - t0
    launches, rows = {}, {}
    for backend in ("torch", "device"):
        sdp.sweep.launches = sdp.sweep.captured = 0
        sdp.seq_cumsum.launches = sdp.seq_cumsum.captured = 0
        t0 = time.perf_counter()
        rc, got = run_analysis_cli([*certify, "--backend", backend,
                                    "--torch-device", torch_device])
        if torch_device != "cpu":
            torch.cuda.synchronize()
        seconds["certify " + backend] = time.perf_counter() - t0
        launches[backend] = {"schedule_dp": sdp.sweep.launches,
                             "schedule_dp_captured": sdp.sweep.captured,
                             "seq_cumsum": sdp.seq_cumsum.launches,
                             "seq_cumsum_captured": sdp.seq_cumsum.captured}
        check_certified(got, n_inst, backend)
        rows[backend] = got["rows"]
    check_cli_launches(launches)

    def trajectory(r):
        return r["makespan"], r["history"], r["n_exact_evals"]

    if [trajectory(r) for r in rows["torch"]] != [trajectory(r) for r in ref["rows"]]:
        raise AssertionError("certify --backend torch and --backend numpy trajectories differ")
    say("analysis_cli", torch_device=torch_device, selftest=st,
        lint={"n_files": lint["n_files"], "findings": 0, "suppressed": len(lint["suppressed"]),
              "suppressed_by_rule": dict(collections.Counter(
                  f["rule"] for f in lint["suppressed"]))},
        certify={"suite": "smoke", "max_iters": ANALYSIS_ITERS, "instances": n_inst,
                 "certified": {"numpy": n_inst, "torch": n_inst, "device": n_inst},
                 "torch_matches_numpy": True,
                 "makespans": {b: [r["makespan"] for r in rs]
                               for b, rs in (("numpy", ref["rows"]), *rows.items())}},
        launches=launches, seconds=seconds,
        note="python -m repro_torch.analysis {selftest, lint, certify} run in this process "
             "(cli.main); certify: the smoke suite, tabu_multiwalk with 2 walks on "
             "--backend numpy and torch, tabu_device on --backend device; launches: "
             "sdp.sweep / sdp.seq_cumsum counts set to 0 before each certify run and read "
             "after it (launches include the replays, captured the graphs' nodes); "
             "torch_matches_numpy: makespan, history and exact evaluations per instance")
    d = launches["device"]
    return {"torch": {"schedule_dp": launches["torch"]["schedule_dp"]},
            "device": {"schedule_dp": d["schedule_dp"], "seq_cumsum": d["seq_cumsum"]}}


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
FAULT_REQUESTS = 6
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
    # a served run never reaches the sync fault point: the reference fires it
    # only in a solo device_multiwalk
    sync_fires = {k: v for k, v in ledger.fires.items() if k.startswith("device_search.sync:")}
    if sync_fires:
        raise AssertionError(f"a served device run fired device_search.sync: {sync_fires}")
    if out["metrics"]["failed"] != sum(failed.values()):
        raise AssertionError("the service's failure count disagrees with the outcomes")
    return {"requests": len(items), "survivors": sum(survivors.values()),
            "survivors_by_backend": dict(survivors), "failed": dict(failed),
            "resilience": res, "fires": dict(ledger.fires),
            "device_search_sync_fires": {k.split(":")[1]: v for k, v in sync_fires.items()},
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


class StaleRunMeetsFreshLane:
    """Makes the race lane's race happen whatever the host's timing.  The
    thread whose launch hangs (``engine.execute.launch`` of ``hung_rid``)
    is marked when it reaches that point; from then on a run of any other
    thread releases its launch only once the marked thread, woken as the
    stale run, has asked for a launch (and so found this shape held), or
    after ``timeout`` seconds.  Without it the stale run meets a fresh run
    only when their device work happens to overlap: on the card the fresh
    runs spend most of their time on the host, and one run of the race lane
    found no fresh run holding the shape.  ``devsearch`` and ``inject`` are
    the modules whose ``_get_launch`` / ``_release`` and ``fire`` it wraps."""

    def __init__(self, hung_rid: int, timeout: float, devsearch=None, inject=None):
        import threading

        if devsearch is None:
            from repro_torch.core import device_search as devsearch
        if inject is None:
            from repro_torch.faults import inject
        self.hung_rid, self.timeout = hung_rid, timeout
        self.devsearch, self.inject = devsearch, inject
        self.hung_thread = None
        self.stale_asked = threading.Event()
        self.waited_s = 0.0

    def __enter__(self):
        import threading

        ds, finj = self.devsearch, self.inject
        self._saved = ds._get_launch, ds._release, finj.fire
        get, release, fire = self._saved

        def marked_fire(point, key=0, *, rid=None):
            if point == "engine.execute.launch" and key == self.hung_rid:
                self.hung_thread = threading.get_ident()
            return fire(point, key, rid=rid)

        def get_launch(*args, **kwargs):
            out = get(*args, **kwargs)
            if threading.get_ident() == self.hung_thread:
                self.stale_asked.set()
            return out

        def held_release(launch):
            me = threading.get_ident()
            if self.hung_thread not in (None, me) and not self.stale_asked.is_set():
                t0 = time.perf_counter()
                self.stale_asked.wait(self.timeout)
                self.waited_s += time.perf_counter() - t0
            return release(launch)

        ds._get_launch, ds._release, finj.fire = get_launch, held_release, marked_fire
        return self

    def __exit__(self, *exc):
        ds, finj = self.devsearch, self.inject
        ds._get_launch, ds._release, finj.fire = self._saved


def race_lane(items, prof: ServeProfile, params, solos: list, torch_device: str, *,
              hang_seconds: float = FAULT_PLAN["hang_seconds"],
              watchdog: float = FAULT_WATCHDOG_S) -> dict:
    """Requests of one launch shape, the launch of one of them hung (one
    attempt each, so it fails once): the watchdog abandons it, the fresh lane
    serves the rest, and the stale run wakes and runs ``solve_instances``
    beside the fresh lane's runs of the same shape (a fresh run keeps its
    launch until the stale run has asked for one, at most half the
    watchdog: :class:`StaleRunMeetsFreshLane`), so one of them must take an
    uncached launch.  Every survivor runs on the device and equals its solo
    solve, and so does the stale run's lane."""
    from repro_torch.serve import RetryPolicy

    plan_kw = race_plan(len(items), hang_seconds)
    with StaleRunMeetsFreshLane(RACE_HUNG_RID, timeout=watchdog / 2) as meet:
        out = fault_lane(items, prof, params, solos, torch_device, plan_kw=plan_kw,
                         watchdog=watchdog, retry=RetryPolicy(max_attempts=1))
    out["stale_run_asked"] = meet.stale_asked.is_set()
    out["fresh_lane_waited_s"] = meet.waited_s
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
             "the first 6 requests under the plan with every kind, a watchdog shorter "
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


def profiled_device_ms(fn, kernel: str, reps: int, per_call: int = 1) -> float:
    """Mean device time of the kernels whose name holds ``kernel`` over
    ``reps`` calls of ``fn``, from torch.profiler (host and device activity,
    as ``device_breakdown`` records them).  For a launch of a few
    microseconds, CUDA events around one call time the wrapper's host work.
    The profiler may miss records of a window (46 of 50 were seen once on an
    H100), so the mean is over the launches it saw, and a window that saw
    fewer than half is taken again, at most three in all.  ``per_call``: the
    kernels one call launches, each named once: the mean of each name is
    taken over its own records and the means are summed, so a record the
    profiler misses does not shift the others."""
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
        total_us, n, by_name = 0.0, 0, {}
        for e in prof.key_averages():
            if kernel in e.key and str(e.device_type).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                us = us if us is not None else getattr(e, "self_cuda_time_total", 0)
                total_us += us
                n += e.count
                by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us,
                                  by_name.get(e.key, (0.0, 0))[1] + e.count)
        if per_call > 1:
            n = min(c for _, c in by_name.values()) if len(by_name) == per_call else 0
            total_us = n * sum(us / c for us, c in by_name.values()) if n else 0.0
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


def profiled_grids(fn, kernels, trace: Path) -> dict:
    """The grid of each of ``kernels`` (a name each kernel's holds) as one
    call of ``fn`` launched it, from the kernel events of torch.profiler's
    trace of that call (written to ``trace``); a window that lost a record is
    taken again, at most three in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") == "kernel"]
        found = {k: [e["args"]["grid"] for e in events if k in e.get("name", "")]
                 for k in kernels}
        if all(len(v) == 1 for v in found.values()):
            return {k: v[0] for k, v in found.items()}
    raise AssertionError(f"the profiler's kernel events of one call: {found}")


def profiled_kernel_names(fn) -> list:
    """Names of the kernels a call of ``fn`` launches (over 10 calls, so one
    lost record loses no name), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")})
    if not names:
        raise AssertionError("the profiler recorded no kernel of the call")
    return names


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


def fp32_chain_ms_per_step(device) -> float:
    """Measured time of one step of K3 backward's dependent chain (a float32
    add, then a multiply, each waiting on the one before) on one thread."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.load("rglru").rglru_bwd_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float32, device=device)
    n = 1 << 20

    def run():
        err = fn(n, 1.0, 1.0, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fp32 chain probe launch failed: CUDA error {err}")

    ms = cuda_median_ms(run, reps=10, warmup=2)
    if float(out[0]) != n:
        raise AssertionError(f"fp32 chain probe ended at {float(out[0])}, expected {n}")
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
# the global-attention decoders' prefill: qwen2.5-14b (GQA 40:8, a group of 5
# that does not divide the kernel's 128-row tile) and codeqwen1.5-7b (MHA),
# d 128, causal, no window; checked and timed in bf16 only
QWEN_ARCH = "qwen2.5-14b"
FLASH_QWEN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40, 8, 128, True, None, 0)
FLASH_CODEQWEN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 128, True, None, 0)
# the MoE, encoder-decoder and vision-token archs, served at published width
# (bf16, batch 4, 32 tokens): granite-moe-1b-a400m and internvl2-26b over
# 4096-token prompts (internvl2-26b's first 256 positions vision embeddings),
# whisper-medium over its 1500 encoder frames (the published 30 s window after
# the stubbed conv stem) with a 416-token decoder prompt, so prompt + generated
# is its published decoder context of 448
MOE_ARCH, ENCDEC_ARCH, VLM_ARCH = "granite-moe-1b-a400m", "whisper-medium", "internvl2-26b"
WHISPER_PROMPT = 416
# K2 at their prefills, d 64 for the first two archs: granite's GQA 16:8
# causal; whisper's encoder (non-causal, 1500 = 11 x 128 + 92 kv rows), its
# decoder's causal self-attention and its cross-attention (416 decoder rows
# over the 1500 encoder rows, non-causal); internvl2's GQA 48:8 (a group of 6)
FLASH_GRANITE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 8, 64, True, None, 0)
FLASH_WHISPER_ENC = (SERVE_BATCH, 1500, 1500, 16, 16, 64, False, None, 0)
FLASH_WHISPER_SELF = (SERVE_BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 16, 16, 64, True, None, 0)
FLASH_WHISPER_CROSS = (SERVE_BATCH, WHISPER_PROMPT, 1500, 16, 16, 64, False, None, 0)
FLASH_INTERNVL2 = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 48, 8, 128, True, None, 0)
# name in the kernels line -> shape
FLASH_SLICE_SHAPES = {MOE_ARCH: FLASH_GRANITE, ENCDEC_ARCH + " encoder": FLASH_WHISPER_ENC,
                      ENCDEC_ARCH + " decoder self": FLASH_WHISPER_SELF,
                      ENCDEC_ARCH + " cross": FLASH_WHISPER_CROSS, VLM_ARCH: FLASH_INTERNVL2}
FLASH_BF16_SHAPES = (FLASH_QWEN, FLASH_CODEQWEN) + tuple(FLASH_SLICE_SHAPES.values())
# ... and granite's in float32 too, the shape of its float32 gate
FLASH_F32_SERVED = (FLASH_GRANITE,)
# training: recurrentgemma-2b at its published width and depth, batch 1 of
# 4096-token sequences (every attention layer reaches its 2048-token window)
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 4
FLASH_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 10, 1, 256, True, 2048, 0)
RGLRU_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 2560, False)
# training granite-moe-1b-a400m (as recurrentgemma-2b trains) and
# whisper-medium (batch 16 of its 30-second window, 1500 frames after the
# stubbed conv stem, and its 448-token decoder context) at published width
# and depth, each in a process of its own (--train-moe, --train-encdec) after
# train_ssm; K2 and its backward at their d-64 shapes: granite's causal GQA
# 16:8, whisper's encoder self-attention (non-causal), decoder self-attention
# (causal) and cross-attention (448 decoder rows over the 1500 encoder rows)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 16, 448
FLASH_BWD_GRANITE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 64, True, None, 0)
FLASH_BWD_WHISPER = {
    "encoder": (ENCDEC_TRAIN_BATCH, 1500, 1500, 16, 16, 64, False, None, 0),
    "decoder self": (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_SEQ, 16, 16, 64, True,
                     None, 0),
    "cross": (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1500, 16, 16, 64, False, None, 0)}
# the MoE's sparse dispatch at granite-moe-1b-a400m's benchmarked training
# step (tokens = 2 x 4096, top 8 of 32 experts, d_model 1024, d_ff 512): each
# wrapper within MOE_KERNEL_LIMIT (max |diff| / max |plain|) of its plain
# version in float32 on the same bf16 inputs, about five bf16 roundings of
# the largest output (a wrong row, expert or tile reads of order 1)
MOE_TIMING_SHAPE = (2 * 4096, 8, 32, 1024, 512)
MOE_KERNEL_LIMIT = 1e-2
# K2's backward against its plain version: the reference's gradient test
# shapes (tests/test_kernels.py::test_flash_xla_custom_vjp_grads: 2 x 512, 4
# heads over 2, d 32, windows None and 128), ragged shapes, rows that see no
# key (q_offset -5), the training shape, and granite's and whisper's training
# shapes; max |diff| / max |grad| per gradient: 1e-5 in float32 (the
# reference's own bar), 2e-2 in bf16 (K2's)
FLASH_BWD_SHAPES = (
    (2, 512, 512, 4, 2, 32, True, None, 0),
    (2, 512, 512, 4, 2, 32, True, 128, 0),
    (1, 300, 300, 6, 3, 40, True, 64, 0),
    (2, 77, 90, 6, 3, 40, False, None, 0),
    (1, 96, 96, 8, 1, 256, True, None, -5),
    (1, 100, 1000, 2, 1, 32, True, 300, 900),
    FLASH_TRAIN,
    FLASH_BWD_GRANITE,
    *FLASH_BWD_WHISPER.values(),
)
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the kernels one bf16 call of K2's backward launches, in order
# (csrc/flash_attention_bwd.cu; float32 takes flash_bwd_dkdv_kernel and
# flash_bwd_dq_kernel on the CUDA cores in place of the two mma kernels)
FLASH_BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_mma_kernel",
                     "flash_bwd_reduce_kernel", "flash_bwd_dq_mma_kernel")
# the step-1 gate of the full-width train against the same step on the plain
# versions (written before the first run): the loss within TRAIN_LOSS_LIMIT
# relative, every gradient tensor within TRAIN_GRAD_LIMIT of its max |grad|;
# where bf16 noise defeats one of them, that reading's limit is the plain
# versions' own reading of it in another summation order (attention in the
# TPU kernel's order, the backward's kv sums in blocks of
# TRAIN_YARDSTICK_CHUNK q rows; the SSD's forward and backward at
# YARDSTICK_CHUNK steps a chunk) times YARDSTICK_FACTOR, and both readings
# are printed (mamba2-780m's gradients read 2.66e-2 on the plain versions at
# chunk 32 against 64, one H100 run: the fixed 2e-2 is below its noise)
TRAIN_LOSS_LIMIT = 1e-3
TRAIN_GRAD_LIMIT = 2e-2
TRAIN_YARDSTICK_CHUNK = 64
# recovery drill at the smoke size: the run lost at these steps, restored from
# its checkpoints, against the run that never failed
RECOVERY_STEPS, RECOVERY_FAIL_AT, RECOVERY_CKPT_EVERY = 8, (3, 6), 2
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
# K3's backward: every RGLRU_SHAPES shape, then the training shape and its
# ragged twin (a partial first tile, a group past d), T = 1 and batch 4 at the
# training width (the wide grid), each with and without h0; each is taken
# with and without a last-state gradient, in the group the wrapper picks
RGLRU_BWD_SHAPES = RGLRU_SHAPES + tuple(
    (b, t, d, h0)
    for b, t, d in ((TRAIN_BATCH, TRAIN_SEQ, 2560), (TRAIN_BATCH, TRAIN_SEQ + 1, 2562),
                    (TRAIN_BATCH, 1, 2560), (SERVE_BATCH, TRAIN_SEQ, 2560))
    for h0 in (True, False))
# ... and at these in every group the kernel has (8, 32): d a multiple of
# neither (31, 66), of 8 but not 32 (2552 = 8 x 319, 16-byte rows) and the
# training width with a partial first tile
RGLRU_BWD_ALL_GROUPS = ((3, 200, 31, False), (3, 33, 66, True), (2, 100, 2552, True),
                        (TRAIN_BATCH, TRAIN_SEQ + 1, 2560, True))
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
# K4's backward against its plain version (written before the first run):
# every SSD_SHAPES shape, T < 64 with G < H, and the training shape of
# mamba2-780m (batch 1 x 4096), each in float32 and bf16, once with h0, d_skip
# and a nonzero dh_last and once without them; max |diff| / max |grad| per
# gradient: 1e-4 in float32 (the forward's SSD_TOL), 2e-2 in bf16 (K2 bwd's:
# dx, dB and dC are rounded to bf16 once, the rest stays fp32)
SSD_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128)
# ... and the edges of the tensor-core passes (bf16): T past a chunk boundary
# at full width, head_dim 16 and 32, state 32 and 64, G = H, 1 < G < H, and
# T = 1 (one chunk of one step)
SSD_BWD_EDGES = ((TRAIN_BATCH, TRAIN_SEQ + 1, 48, 64, 1, 128), (2, 200, 6, 16, 2, 64),
                 (2, 130, 4, 32, 1, 32), (1, 300, 4, 64, 4, 64), (2, 1, 4, 64, 1, 128))
SSD_BWD_SHAPES = SSD_SHAPES + ((2, 40, 6, 32, 3, 64), SSD_TRAIN) + SSD_BWD_EDGES
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_GRADS = ("dx", "ddt", "da_log", "dB", "dC", "dd_skip", "dh0")
# the kernels one bf16 call of K4's backward launches at the training shape,
# in order (csrc/ssd_bwd.cu): the tensor-core state pass, chunk pass and dB / dC
# pass, then the heads' sums
SSD_BWD_KERNELS = ("ssd_bwd_states_mma_kernel", "ssd_bwd_chunk_mma_kernel",
                   "ssd_bwd_dbdc_mma_kernel", "ssd_bwd_sum_heads_kernel")
# training mamba2-780m at its published width and depth, as recurrentgemma-2b
# trains (batch 1 of 4096-token sequences, AdamW, 4 steps, the greedy H100
# plan), in a process of its own (--train-ssm) after this one's last profiled
# window
SSM_TRAIN_ARCH = "mamba2-780m"
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
# qwen2.5-14b in bf16: 48 random global-attention layers carry any last-bit
# difference of an attention output to the logits, which are bf16, and there a
# few units in the last place of the largest logits are about 1e-2 of max
# |logit| (on an H100 the reference TPU kernel's own algorithm in fp32, online
# softmax over 128-key blocks, reads 8.0e-3 against the dense plain version at
# the prefill), so no fixed limit near 4e-3 can hold: the limit is measured in
# the same run, that algorithm (TPU_BLOCK_KV keys a block) against the plain
# version, and the served logits must lie within YARDSTICK_FACTOR times that
# reading's worst step; whether they also met TEACHER_FORCED_LIMIT is reported
TPU_BLOCK_KV = 128
# the mamba2-780m check again in float32 at full width and depth (random
# weights from seed 0 in float32): about ten times the 5e-6 a correct path
# reads (1e-6 to 5e-6 per step, as the plain version against itself at chunk 32)
FLOAT32_TEACHER_FORCED_LIMIT = 5e-5
# archs whose step-1 gate runs in float32 at full width and depth (limits
# written before its first run): whisper-medium's random tied N(0, 1)
# embedding over d 1024 gives logits of about +-140, where one bf16 unit is
# 0.5 to 1, so rounding moves the softmax's argmax and the bf16 gate's
# gradients read ~2.4 of max |grad| on the plain versions against
# themselves: no fault could show there, and its bf16 reading is printed,
# not gated.  In float32 the loss within 1e-5 relative and every gradient
# tensor within 1e-3 of its max |grad| (a key bias of its block's wk,
# ``grad_errors``).  The first run read 2.7e-3 (the first decoder layers'
# cross-attention wq / wk, whose gradients pass the softmax's cancellation
# 48 layers down) and 1.03e-3 for the key biases, so, as in bf16, each
# reading is held to its fixed limit or twice the plain versions' own
# reading in the yardstick's summation order, whichever is larger
STEP1_FLOAT32_ARCHS = (ENCDEC_ARCH,)
FLOAT32_TRAIN_LOSS_LIMIT = 1e-5
FLOAT32_TRAIN_GRAD_LIMIT = 1e-3


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
    """Unmasked (q, k) pairs of one (batch, head): the work this data needs
    (``kernels.fake.flash_pairs``, which the dry run's flop formula counts)."""
    from repro_torch.kernels import fake

    return fake.flash_pairs(sq, skv, causal, window, q_offset)


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
    for M X, 2 q N P for (C exp L) h^T and 2 q N P for the state update
    (``kernels.fake.ssd_operations``)."""
    from repro_torch.kernels import fake

    return fake.ssd_operations(t, p, n, chunk)


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
    """K2, K3 and K4, and the backwards of K2, K3 and K4, against their
    plain versions on the card."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_lse = {"float32": 0.0, "bfloat16": 0.0}
    n_flash = 0
    both = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    cases = [(shape, both) for shape in FLASH_SHAPES + (FLASH_SERVE,)] + \
        [(shape, both[1:]) for shape in FLASH_BF16_SHAPES] + \
        [(shape, both[:1]) for shape in FLASH_F32_SERVED]
    for i, (shape, dtypes) in enumerate(cases):
        for name, dtype in dtypes:
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
    bwd = flash_bwd_checks(device)
    for name in worst:
        worst[name] = max(worst[name], bwd["fwd_abs"][name])
        worst_lse[name] = max(worst_lse[name], bwd["fwd_lse_abs"][name])
    n_flash += bwd["checks"]
    rg_bwd = rglru_bwd_checks(device)
    ssd_bwd = ssd_bwd_checks(device)
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
        flash_bf16_only_shapes=[list(s) for s in FLASH_BF16_SHAPES],
        flash_f32_only_shapes=[list(s) for s in FLASH_F32_SERVED],
        flash_fwd_at_bwd_shapes={"checks": bwd["checks"], "max_abs_err": bwd["fwd_abs"],
                                 "lse_max_abs_err": bwd["fwd_lse_abs"]},
        rglru_checks=2 * len(RGLRU_SHAPES), rglru_max_abs_err=worst_rg,
        rglru_tolerance="0 (torch.equal), float32 and bfloat16 inputs",
        rglru_shapes=[list(s) for s in RGLRU_SHAPES],
        ssd_checks=n_ssd, ssd_max_abs_err=ssd_err, ssd_max_rel_err=ssd_rel,
        ssd_h_last_max_abs_err=ssd_h_err,
        ssd_tolerance={"y": SSD_TOL, "h_last": SSD_H_TOL,
                       "measure": "y: max |diff| / max |y|; h_last: |diff| <= tol (1 + |h|)"},
        ssd_shapes=[list(s) for s in SSD_SHAPES],
        flash_bwd_checks=bwd["checks"], flash_bwd_max_rel_err=bwd["rel"],
        flash_bwd_max_abs_err=bwd["abs"], flash_bwd_no_key_rows_zero=bwd["no_key_rows_zero"],
        flash_bwd_bit_identical_repeat=bwd["bit_identical_repeat"],
        flash_bwd_tolerance={**FLASH_BWD_TOL, "measure": "max |diff| / max |grad| per "
                                                         "gradient (dq, dk, dv)"},
        flash_bwd_shapes=[list(s) for s in FLASH_BWD_SHAPES],
        rglru_bwd_checks=rg_bwd["checks"], rglru_bwd_max_abs_err=rg_bwd["abs"],
        rglru_bwd_tolerance="0 (torch.equal) on da, dx~ and dh0, with and without dh_last",
        rglru_bwd_shapes=[list(s) for s in RGLRU_BWD_SHAPES],
        rglru_bwd_all_group_shapes=[list(s) for s in RGLRU_BWD_ALL_GROUPS],
        rglru_bwd_checks_by_group=rg_bwd["checks_by_group"],
        rglru_bwd_bit_identical_repeat=rg_bwd["bit_identical_repeat"],
        ssd_bwd_checks=ssd_bwd["checks"], ssd_bwd_max_rel_err=ssd_bwd["rel"],
        ssd_bwd_max_abs_err=ssd_bwd["abs"],
        ssd_bwd_bit_identical_repeat=ssd_bwd["bit_identical_repeat"],
        ssd_bwd_tolerance={**SSD_BWD_TOL, "measure": "max |diff| / max |grad| per gradient ("
                                                     + ", ".join(SSD_GRADS) + ")"},
        ssd_bwd_shapes=[list(s) for s in SSD_BWD_SHAPES])
    return {"flash_attention": max(worst.values()), "flash_f32": worst["float32"],
            "rglru_scan": worst_rg, "ssd_chunked": max(max(ssd_err.values()), ssd_h_err),
            "flash_attention_bwd": max(bwd["abs"].values()),
            "flash_attention_bwd_f32": bwd["abs"]["float32"],
            "rglru_scan_bwd": rg_bwd["abs"],
            "ssd_chunked_bwd": max(ssd_bwd["abs"].values()),
            "ssd_chunked_bwd_f32": ssd_bwd["abs"]["float32"],
            "ssd_chunked_bwd_rel": ssd_bwd["rel"]}


def flash_bwd_checks(device) -> dict:
    """K2's backward against its plain version on the same (q, k, v, out,
    lse, dO): both input types at every ``FLASH_BWD_SHAPES`` shape.  The
    forward that made ``out`` and ``lse`` is held against its plain version
    there too (``FLASH_TOL``, ``FLASH_LSE_TOL``): these are the shapes the
    training paths give it.  Rows that see no key must get zero dq.  At the
    training shape in bf16 a second call on the same inputs must give
    bit-identical dq, dk and dv (the kernels sum in a fixed order, with no
    atomics)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    rel = {"float32": 0.0, "bfloat16": 0.0}
    err = {"float32": 0.0, "bfloat16": 0.0}
    fwd = {"float32": 0.0, "bfloat16": 0.0}
    fwd_lse = {"float32": 0.0, "bfloat16": 0.0}
    checks, no_key = 0, True
    for i, shape in enumerate(FLASH_BWD_SHAPES):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, kw = flash_operands(shape, dtype, device, seed=300 + i)
            before = fa.flash_attention.launches
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            if fa.flash_attention.launches != before + 1:
                raise AssertionError("flash_attention did not launch its kernel")
            want_out, want_lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
            ok_lse, e_lse = _within(lse, want_lse, FLASH_LSE_TOL)
            ok_out, e_out = _within(out, want_out, FLASH_TOL[name])
            fwd[name], fwd_lse[name] = max(fwd[name], e_out), max(fwd_lse[name], e_lse)
            if not (ok_lse and ok_out):
                raise AssertionError(f"flash_attention differs from its plain version: {shape} "
                                     f"{name} out {e_out:.3g}, lse {e_lse:.3g}")
            del want_out, want_lse
            gen = torch.Generator(device=device).manual_seed(400 + i)
            do = randn(gen, q.shape, device, dtype)
            before = fa.flash_attention_bwd.launches
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            if fa.flash_attention_bwd.launches != before + 1:
                raise AssertionError("flash_attention_bwd did not launch its kernel")
            want = fa.flash_attention_bwd_torch(q, k, v, out, lse, do, **kw)
            for label, a, b in zip(("dq", "dk", "dv"), got, want):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"flash_attention_bwd {label}: {a.dtype} {a.shape}")
                diff = float((a.float() - b.float()).abs().max())
                r = diff / max(float(b.float().abs().max()), 1e-30)
                rel[name], err[name] = max(rel[name], r), max(err[name], diff)
                if not (r < FLASH_BWD_TOL[name] and bool(torch.isfinite(a).all())):
                    raise AssertionError(
                        f"flash_attention_bwd {label} differs from its plain version: {shape} "
                        f"{name} {r:.3g} of max |grad|")
            if kw["q_offset"] < 0:
                blind = -kw["q_offset"]
                no_key = no_key and bool((got[0][:, :blind] == 0).all())
                if not no_key:
                    raise AssertionError("a row that sees no key got a nonzero dq")
            checks += 1
            if shape == FLASH_TRAIN and dtype == torch.bfloat16:
                again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError("two calls of flash_attention_bwd on the same inputs "
                                         "differ at the training shape")
                del again
            del q, k, v, out, lse, do, got, want
    return {"checks": checks, "rel": rel, "abs": err, "no_key_rows_zero": no_key,
            "bit_identical_repeat": True, "fwd_abs": fwd, "fwd_lse_abs": fwd_lse}


def rglru_bwd_checks(device) -> dict:
    """K3's backward (the reverse scan) bit for bit against its plain version
    at every ``RGLRU_BWD_SHAPES`` shape in the group the wrapper picks, and at
    every ``RGLRU_BWD_ALL_GROUPS`` shape in each group, with and without a
    last-state gradient; two calls at the training shape bit-identical."""
    import torch

    from repro_torch.kernels import rglru as rg

    cases = [(shape, None) for shape in RGLRU_BWD_SHAPES] + \
        [(shape, group) for shape in RGLRU_BWD_ALL_GROUPS for group in rg.BWD_GROUPS]
    worst, checks, groups = 0.0, 0, {}
    for i, (shape, group) in enumerate(cases):
        x, a_param, ig, ag, h0 = rglru_operands(shape, torch.float32, device, seed=500 + i)
        a, xb = rg.rglru_gates(x, a_param, ig, ag)
        y = rg.scan_torch(a, xb, h0)
        gen = torch.Generator(device=device).manual_seed(600 + i)
        dy = randn(gen, y.shape, device)
        for dh in (None, randn(gen, (shape[0], shape[2]), device)):
            before = rg.rglru_scan_bwd.launches
            if group is None:
                got = rg.rglru_scan_bwd(a, y, h0, dy, dh)
            else:
                got = rg._launch_bwd_cuda(a, y, h0, dy, dh, group=group)
            torch.cuda.synchronize()
            if rg.rglru_scan_bwd.launches != before + 1:
                raise AssertionError("rglru_scan_bwd did not launch its kernel")
            want = rg.scan_bwd_torch(a, y, h0, dy, dh)
            worst = max(worst, max_abs_err(got, want))
            if not all(torch.equal(p, q) for p, q in zip(got, want)):
                raise AssertionError(f"rglru_scan_bwd differs from its plain version: {shape} "
                                     f"group {group} dh_last={dh is not None}")
            checks += 1
        key = str(group or rg.bwd_group(shape[0], shape[2], rg._n_sms(device.index or 0)))
        groups[key] = groups.get(key, 0) + 2
        if list(shape) == list(RGLRU_TRAIN[:3]) + [False]:
            first = rg.rglru_scan_bwd(a, y, h0, dy, None)
            again = rg.rglru_scan_bwd(a, y, h0, dy, None)
            torch.cuda.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(first, again)):
                raise AssertionError("two rglru_scan_bwd calls at the training shape differ")
    return {"checks": checks, "abs": worst, "checks_by_group": groups,
            "bit_identical_repeat": True}


def ssd_bwd_operands(shape, dtype, device, with_extras=True, seed=0):
    """K4's inputs (``ssd_operands``), ``dy`` in ``dtype`` and, with the
    extras, a nonzero fp32 ``dh_last``."""
    import torch

    args = ssd_operands(shape, dtype, device, with_extras, seed)
    b, t, h, p, g, n = shape
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = randn(gen, (b, t, h, p), device, dtype)
    dh = randn(gen, (b, h, p, n), device) if with_extras else None
    return args, dy, dh


def ssd_bwd_checks(device) -> dict:
    """K4's backward against its plain version on the same inputs: both input
    types at every ``SSD_BWD_SHAPES`` shape, with h0, d_skip and a nonzero
    dh_last and without them (then no dh0 and no dd_skip come back).  At the
    training shape in bf16 a second call must give bit-identical gradients
    (every sum in a fixed order, no atomics)."""
    import torch

    from repro_torch.kernels import ssd

    rel = {"float32": 0.0, "bfloat16": 0.0}
    err = {"float32": 0.0, "bfloat16": 0.0}
    checks = 0
    for i, shape in enumerate(SSD_BWD_SHAPES):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for extras in (True, False):
                args, dy, dh = ssd_bwd_operands(shape, dtype, device, extras, seed=700 + i)
                before = ssd.ssd_chunked_bwd.launches
                got = ssd.ssd_chunked_bwd(*args, dy, dh)
                torch.cuda.synchronize()
                if ssd.ssd_chunked_bwd.launches != before + 1:
                    raise AssertionError("ssd_chunked_bwd did not launch its kernels")
                want = ssd.ssd_chunked_bwd_torch(*args, dy, dh)
                for label, a, b in zip(SSD_GRADS, got, want):
                    if b is None or a is None:
                        if (a is None) != (b is None):
                            raise AssertionError(f"ssd_chunked_bwd {label}: {a is None} / "
                                                 f"{b is None}")
                        continue
                    if a.dtype != b.dtype or a.shape != b.shape:
                        raise AssertionError(f"ssd_chunked_bwd {label}: {a.dtype} {a.shape}")
                    diff = float((a.float() - b.float()).abs().max())
                    r = diff / max(float(b.float().abs().max()), 1e-30)
                    rel[name], err[name] = max(rel[name], r), max(err[name], diff)
                    if not (r < SSD_BWD_TOL[name] and bool(torch.isfinite(a).all())):
                        raise AssertionError(
                            f"ssd_chunked_bwd {label} differs from its plain version: {shape} "
                            f"{name} h0/d_skip/dh_last={extras}: {r:.3g} of max |grad|")
                checks += 1
                if shape == SSD_TRAIN and dtype == torch.bfloat16 and not extras:
                    again = ssd.ssd_chunked_bwd(*args, dy, dh)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again) if a is not None):
                        raise AssertionError("two calls of ssd_chunked_bwd on the same inputs "
                                             "differ at the training shape")
                    del again
                del args, dy, dh, got, want
    return {"checks": checks, "rel": rel, "abs": err, "bit_identical_repeat": True}


def model_kernel_wrappers() -> dict:
    """The model path's kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    return {"flash_attention": fa.flash_attention, "rglru_scan": rg.rglru_scan,
            "ssd_chunked": ssd.ssd_chunked, **moe_wrappers(backward=False)}


def expected_launches(cfg, gen: int) -> dict:
    """Kernel launches of one serve of ``gen`` tokens: K2 once per attention
    layer, sliding-window or global (prefill only; decode reads the cache in
    PyTorch), K3 and K4 once per recurrent / SSM layer at the prefill and at
    each of the gen - 1 steps, and a MoE's sparse dispatch forward
    (``moe_launches``) once per layer at each of those.  An
    encoder-decoder: K2 once per encoder layer and twice per decoder layer
    (self- and cross-attention), all at the prefill."""
    moe = {k: v for k, v in moe_launches(cfg, 0 if cfg.encoder_layers else cfg.n_layers * gen,
                                         0).items() if k in moe_wrappers(backward=False)}
    if cfg.encoder_layers:
        return {"flash_attention": cfg.encoder_layers + 2 * cfg.n_layers, "rglru_scan": 0,
                "ssd_chunked": 0, **moe}
    return {"flash_attention": cfg.kinds.count("attn_local") + cfg.kinds.count("attn"),
            "rglru_scan": cfg.kinds.count("rec") * gen,
            "ssd_chunked": cfg.kinds.count("ssm") * gen, **moe}


def serve_prompt_len(cfg) -> int:
    """The served prompt: the decoder's for an encoder-decoder, else 4096."""
    return WHISPER_PROMPT if cfg.encoder_layers else SERVE_PROMPT


def serve_batch(cfg, generator, device) -> dict:
    """The served batch, drawn from ``generator`` as the launcher draws it:
    tokens, and the stub frontends' frames or vision embeddings."""
    from repro_torch.launch.model_serve import make_batch

    return make_batch(cfg, SERVE_BATCH, serve_prompt_len(cfg), generator, device=device)


def tpu_order_attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
                        block: int = TPU_BLOCK_KV, return_lse: bool = False,
                        name: str | None = None):
    """The reference TPU kernel's algorithm (``flash_attention_pallas``) in
    plain PyTorch and fp32: per block of ``block`` keys the masked scores, a
    running max, ``p = exp(s - m)``, the rescaled sum and accumulator; the
    plain version's function, summed in the TPU kernel's order.  A yardstick
    only (the port never calls it)."""
    import torch

    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    outs, lses = [], []
    for s0 in range(0, sq, 1024):
        qg = (q[:, s0:s0 + 1024].float() * scale).reshape(b, -1, kvh, g, d)
        n = qg.shape[1]
        q_pos = q_offset + s0 + torch.arange(n, device=q.device)[:, None]
        acc = qg.new_zeros((b, kvh, g, n, d))
        m = qg.new_full((b, kvh, g, n, 1), -1e30)
        l_sum = qg.new_zeros((b, kvh, g, n, 1))
        for k0 in range(0, skv, block):
            kb, vb = k[:, k0:k0 + block].float(), v[:, k0:k0 + block].float()
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            mask = torch.ones((n, kb.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            sc = torch.where(mask, torch.einsum("bqcgd,bkcd->bcgqk", qg, kb), -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(sc - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l_sum = alpha * l_sum + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bcgqk,bkcd->bcgqd", p, vb)
            m = m_new
        o = acc / l_sum.clamp_min(1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, h, d).to(q.dtype))
        lses.append((m + torch.log(l_sum.clamp_min(1e-30)))[..., 0].permute(0, 3, 1, 2)
                    .reshape(b, n, h))
    out = torch.cat(outs, 1)
    return (out, torch.cat(lses, 1)) if return_lse else out


@contextlib.contextmanager
def dense_moe():
    """The MoE blocks on the dense dispatch (the reference's einsums) where
    they would take the sparse one's kernels (for the comparison only: the
    port itself has no such route)."""
    from repro_torch.models import blocks

    orig = blocks.moe_branch

    def branch(cfg, p, x):
        got = orig(cfg, p, x)
        return "dense" if got == "sparse" else got

    blocks.moe_branch = branch
    try:
        yield
    finally:
        blocks.moe_branch = orig


@contextlib.contextmanager
def plain_kernels(ssd_chunk: int | None = None, flash=None):
    """The model path with K2, K3 and K4 replaced by their plain versions and
    the MoE on its dense dispatch (``dense_moe``; for the comparison only:
    the port itself has no such route); the plain SSD runs at ``ssd_chunk``
    steps per chunk if given, else at the kernel's, and attention through
    ``flash`` if given, else the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    plain_ssd = ssd.ssd_chunked_torch if ssd_chunk is None else \
        functools.partial(ssd.ssd_chunked_torch, chunk=ssd_chunk)
    orig = ops.flash_attention, ops.rglru_scan, ops.ssd_chunked
    ops.flash_attention, ops.rglru_scan, ops.ssd_chunked = \
        flash or fa.flash_attention_torch, rg.rglru_scan_torch, plain_ssd
    try:
        with dense_moe():
            yield
    finally:
        ops.flash_attention, ops.rglru_scan, ops.ssd_chunked = orig


def check_fixed_limit(cfg, model, batch, ids, device, errs, plain) -> dict:
    """recurrentgemma-2b: every step within ``TEACHER_FORCED_LIMIT``."""
    if not max(errs) <= TEACHER_FORCED_LIMIT:
        raise AssertionError(f"{cfg.arch_id}: served logits differ from the plain versions' by "
                             f"{max(errs):.3g} of max |logit| (limit {TEACHER_FORCED_LIMIT})")
    return {"teacher_forced_limit": TEACHER_FORCED_LIMIT}


def check_attention_yardstick(cfg, model, batch, ids, device, errs, plain) -> dict:
    """qwen2.5-14b (and the MoE, encoder-decoder and vision archs): every
    bf16 step within ``YARDSTICK_FACTOR`` times the worst step of the plain
    versions with attention summed in the TPU kernel's order
    (``tpu_order_attention``) against the plain versions; whether the steps
    also met ``TEACHER_FORCED_LIMIT`` is reported, not gated."""
    with plain_kernels(flash=tpu_order_attention):
        other = teacher_forced_logits(cfg, model, batch, ids, device)
    yardstick = [rel_err(a, b) for a, b in zip(other, plain)]
    del other
    limit = YARDSTICK_FACTOR * max(yardstick)
    if not max(errs) <= limit:
        raise AssertionError(f"{cfg.arch_id}: served logits differ from the plain versions' by "
                             f"{max(errs):.3g} of max |logit|, more than {YARDSTICK_FACTOR} x "
                             f"the plain versions' own {max(yardstick):.3g} in the TPU "
                             "kernel's order")
    return {"teacher_forced_limit": limit,
            "plain_vs_plain_tpu_order_rel_err": yardstick,
            "fixed_limit": TEACHER_FORCED_LIMIT,
            "fixed_limit_held": max(errs) <= TEACHER_FORCED_LIMIT}


def check_moe_yardstick(cfg, model, batch, ids, device, errs, plain) -> dict:
    """granite-moe-1b-a400m: the gate of ``check_attention_yardstick``, then
    ``routing_readings`` held by ``hold_pinned``, in bf16 and on the model in
    float32 (random weights from seed 0).  The random MoE routes each token
    to its top 8 of 32 experts, and a change of one unit in an attention
    output can move a token's 8th and 9th router logits past each other: with
    each run on its own expert choice the plain versions against themselves
    in another order may differ by as much as the logits themselves, and the
    first gate then bounds little.  With every run on the plain run's expert
    choice only the attention's rounding is left."""
    import dataclasses

    import torch

    from repro_torch.models import arch_init_params

    out = check_attention_yardstick(cfg, model, batch, ids, device, errs, plain)
    bf16 = hold_pinned(cfg.arch_id, "bf16", routing_readings(cfg, model, batch, ids, device))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = arch_init_params(cfg32, torch.Generator(device=device).manual_seed(0),
                               device=device)
    f32 = hold_pinned(cfg.arch_id, "float32",
                      routing_readings(cfg32, model32, batch, ids, device))
    del model32
    torch.cuda.empty_cache()
    return {**out, "routing_bf16": bf16, "routing_float32": f32}


@contextlib.contextmanager
def pinned_routing(routes: list, mode: str):
    """The MoE's expert choice against a recorded run's (for the comparison
    only: the port itself has no such route).  ``mode`` "record": each router
    call appends its top-k ids to ``routes``; "free": each call keeps its own
    ids; "pin": each call takes the next recorded ids in place of its own.
    Yields a list that gains, in the last two modes, the number of tokens of
    each call whose own top-k set differs from the recorded one."""
    from repro_torch.models import blocks

    orig = blocks.moe_route
    recorded = None if mode == "record" else iter(routes)
    swaps: list[int] = []

    def route(cfg, p, x):
        logits, top_i = orig(cfg, p, x)
        # a sharded run's ids are a DTensor: compared whole, pinned as one
        own = top_i.full_tensor() if hasattr(top_i, "full_tensor") else top_i
        if recorded is None:
            routes.append(own)
            return logits, top_i
        want = next(recorded, None)
        if want is None:
            raise AssertionError(f"more router calls than the {len(routes)} recorded")
        swaps.append(int((own.sort(-1).values != want.sort(-1).values).any(-1).sum()))
        if mode != "pin":
            return logits, top_i
        if hasattr(top_i, "full_tensor"):
            from torch.distributed.tensor import distribute_tensor

            want = distribute_tensor(want, top_i.device_mesh, top_i.placements)
        return logits, want

    blocks.moe_route = route
    try:
        yield swaps
    finally:
        blocks.moe_route = orig
    if recorded is not None and len(swaps) != len(routes):
        raise AssertionError(f"{len(swaps)} router calls against {len(routes)} recorded")


def routing_readings(cfg, model, batch, ids, device) -> dict:
    """``model`` teacher-forced with the served ids through the kernels, and
    through the plain versions with attention in the TPU kernel's order, each
    on the plain run's expert choice ("pinned") and against the plain
    versions (max |diff| / max |logit| per step).  ``swaps`` counts the
    (layer, token) routings whose own top-k set differs from the plain run's,
    out of ``routings``; each layer sees the plain run's routing upstream."""
    routes: list = []
    with plain_kernels(), pinned_routing(routes, "record"):
        plain = teacher_forced_logits(cfg, model, batch, ids, device)
    out = {"routings": sum(r[..., 0].numel() for r in routes)}
    for name, ctx in (("kernels", contextlib.nullcontext),
                      ("tpu_order", lambda: plain_kernels(flash=tpu_order_attention))):
        with ctx(), pinned_routing(routes, "pin") as swaps:
            got = teacher_forced_logits(cfg, model, batch, ids, device)
        out[f"pinned_{name}_rel_err"] = [rel_err(a, b) for a, b in zip(got, plain)]
        out[f"pinned_{name}_swaps"] = sum(swaps)
        del got
    return out


def hold_pinned(arch: str, what: str, readings: dict) -> dict:
    """Every step of the kernels on the plain run's expert choice within
    ``YARDSTICK_FACTOR`` times the worst step of the TPU-order run on it; the
    readings with their limit."""
    limit = YARDSTICK_FACTOR * max(readings["pinned_tpu_order_rel_err"])
    worst = max(readings["pinned_kernels_rel_err"])
    if not worst <= limit:
        raise AssertionError(f"{arch} ({what}, routing pinned to the plain run's): served "
                             f"logits differ from the plain versions' by {worst:.3g} of max "
                             f"|logit|, more than {YARDSTICK_FACTOR} x the plain versions' own "
                             f"{limit / YARDSTICK_FACTOR:.3g} in the TPU kernel's order")
    return {**readings, "pinned_limit": limit}


def check_against_yardstick(cfg, model, batch, ids, device, errs, plain) -> dict:
    """mamba2-780m: every bf16 step within ``YARDSTICK_FACTOR`` times the worst
    step of the plain versions against themselves with the SSD at
    ``YARDSTICK_CHUNK``, then the float32 check."""
    with plain_kernels(ssd_chunk=YARDSTICK_CHUNK):
        other = teacher_forced_logits(cfg, model, batch, ids, device)
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
            **float32_teacher_forced(cfg, batch, ids, device)}


def float32_teacher_forced(cfg, batch, ids, device) -> dict:
    """The full-width model in float32 (random weights from seed 0), teacher-
    forced with the served ids through the kernels and through the plain
    versions; raises past ``FLOAT32_TEACHER_FORCED_LIMIT``."""
    import dataclasses

    import torch

    from repro_torch.models import arch_init_params

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = arch_init_params(cfg32, torch.Generator(device=device).manual_seed(0), device=device)
    kern = teacher_forced_logits(cfg32, model, batch, ids, device)
    with plain_kernels():
        plain = teacher_forced_logits(cfg32, model, batch, ids, device)
    errs = [rel_err(a, b) for a, b in zip(kern, plain)]
    del model, kern, plain
    torch.cuda.empty_cache()
    limit = FLOAT32_TEACHER_FORCED_LIMIT
    if not max(errs) <= limit:
        raise AssertionError(f"{cfg.arch_id} in float32: served logits differ from the plain "
                             f"versions' by {max(errs):.3g} of max |logit| (limit {limit})")
    return {"float32_teacher_forced_rel_err": errs, "float32_teacher_forced_limit": limit}


def teacher_forced_logits(cfg, model, batch, ids, device):
    """Prefill logits of ``batch`` and each decode step's logits, feeding the
    served ids."""
    from repro_torch.models import arch_decode_step
    from repro_torch.runtime import make_prefill_step

    plen, gen = batch["tokens"].shape[1], ids.shape[1]
    logits, cache = make_prefill_step(cfg, max_len=plen + gen, device=device)(model, batch)
    out = [logits.float()]
    for i in range(gen - 1):
        logits, cache = arch_decode_step(cfg, model, cache, ids[:, i:i + 1], plen + i)
        out.append(logits.float())
    return out


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _kernel_class(name: str) -> str:
    if "flash_bwd_" in name:         # K2's backward: delta, dk/dv (_mma_ in bf16), reduce, dq
        return "K2 bwd flash_attention_bwd"
    if "rglru_scan_bwd" in name:     # K3's backward: the reverse scan
        return "K3 bwd rglru_scan_bwd"
    if "ssd_bwd_" in name:           # K4's backward: states, chunks, dB / dC, the sums
        return "K4 bwd ssd_chunked_bwd"
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
    # acc_events: keep every record of the window (torch warns that it
    # otherwise clears events at the end of each cycle)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
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


def profiler_records_seen(fn, kernel: str, reps: int, acc_events: bool = False) -> int:
    """Records of the kernels whose name holds ``kernel`` that one profiled
    window of ``reps`` calls of ``fn`` keeps (``reps`` when none is lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=acc_events) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if kernel in e.key and str(e.device_type).endswith("CUDA"))


def memory_reckoning(cfg, model) -> dict:
    """What a serve must hold, from the shapes: the weights as stored, and the
    decode cache of the batch at prompt + generated length.  Beside them the
    largest transients: the plain attention's fp32 score block (1024 q rows
    x all keys, for every head; the plain version holds about three at once:
    the scores, their masked copy and the exponentials) and, for a MoE, the
    dense dispatch's (B, S, E, D) expert outputs in the working type; the
    teacher-forced peak on the plain versions is reckoned as weights + cache
    + three score blocks.  A MoE's sparse dispatch holds at most the gathered
    rows (B S k, D) and the gate and up products (B S k, 2F) at once."""
    import math

    from repro_torch.models import arch_cache_defs

    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    plen = serve_prompt_len(cfg)
    cache = sum(math.prod(shape) * (4 if fp32 else itemsize)
                for layer in arch_cache_defs(cfg, SERVE_BATCH, plen + SERVE_GEN)
                for shape, fp32 in layer.values())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    skv = max(plen, cfg.n_frames if cfg.encoder_layers else 0)
    block = SERVE_BATCH * cfg.n_heads * min(1024, skv) * skv * 4
    out = {"weights_bytes": weights, "decode_cache_bytes": cache,
           "plain_attention_score_block_bytes": block,
           "teacher_forced_plain_peak_bytes": weights + cache + 3 * block}
    if sparse_moe(cfg):
        out["moe_dispatch_bytes"] = SERVE_BATCH * plen * cfg.top_k * (
            cfg.d_model + 2 * cfg.d_ff) * itemsize
    elif cfg.n_experts:
        out["moe_dispatch_bytes"] = SERVE_BATCH * plen * cfg.n_experts * cfg.d_model * itemsize
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
    batch = serve_batch(cfg, gen, device)
    plen = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    reckoned = memory_reckoning(cfg, model)

    # first serve: library handles, lazy module loads and the allocator's
    # first growth land here; it is reported, the second one is the reading
    first = serve(cfg, model, batch, 2, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    for fn in wrappers.values():
        fn.launches = 0
    res = serve(cfg, model, batch, SERVE_GEN, device=device)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    want = expected_launches(cfg, SERVE_GEN)
    if launches != want:
        raise AssertionError(f"{arch}: main-path launches {launches}, expected {want}")
    if res.ids.shape != (SERVE_BATCH, SERVE_GEN) or not (
            (res.ids >= 0) & (res.ids < cfg.vocab_size)).all():
        raise AssertionError(f"served ids out of range or misshapen: {res.ids.shape}")

    # where the card's time goes: one prefill, then 8 decode steps, profiled
    prefill = make_prefill_step(cfg, max_len=plen + SERVE_GEN, device=device)
    step = make_serve_step(cfg, device=device)
    held = {}

    def do_prefill():
        held["logits"], held["cache"] = prefill(model, batch)

    def do_decode():
        tok, cache = next_token(cfg, held["logits"])[:, None], held["cache"]
        for i in range(8):
            tok, cache = step(model, cache, tok, plen + i)

    profile = {"prefill": device_breakdown(do_prefill), "decode_8_steps": device_breakdown(do_decode)}
    del held

    # teacher-forced against the same model on the plain versions
    ids = torch.from_numpy(res.ids).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    kern = teacher_forced_logits(cfg, model, batch, ids, device)
    with plain_kernels():
        before = {name: fn.launches for name, fn in wrappers.items()}
        plain = teacher_forced_logits(cfg, model, batch, ids, device)
        if {name: fn.launches for name, fn in wrappers.items()} != before:
            raise AssertionError("the plain-version run launched a kernel")
    plain_peak = torch.cuda.max_memory_allocated(device)
    errs = [rel_err(a, b) for a, b in zip(kern, plain)]
    for i, (a, b) in enumerate(zip(kern, plain)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite logits at step {i}")
    readings = check(cfg, model, batch, ids, device, errs, plain)
    served_again = torch.stack([a[:, :cfg.vocab_size].argmax(-1) for a in kern], 1).cpu()
    plain_greedy = torch.stack([b[:, :cfg.vocab_size].argmax(-1) for b in plain], 1).cpu()
    del kern, plain, model
    torch.cuda.empty_cache()

    say("model_serve", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype, batch=SERVE_BATCH,
        prompt_len=plen, gen=SERVE_GEN, window=cfg.attn_window,
        encoder_layers=cfg.encoder_layers,
        n_frames=cfg.n_frames if cfg.encoder_layers else None,
        n_vis_tokens=cfg.n_vis_tokens, n_experts=cfg.n_experts, top_k=cfg.top_k,
        launches=launches, expected_launches=want,
        prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=res.decode_ms_per_step,
        first_serve_prefill_ms=first.prefill_s * 1e3,
        decode_steps=res.steps, tok_per_s=res.tokens_per_s,
        max_memory_allocated_bytes=peak, memory_reckoned=reckoned,
        teacher_forced_max_memory_allocated_bytes=plain_peak, init_s=init_s,
        teacher_forced_rel_err=errs,
        served_ids_reproduced_teacher_forced=bool((served_again == torch.from_numpy(res.ids)).all()),
        greedy_tokens_same_on_plain_versions=int((plain_greedy == torch.from_numpy(res.ids)).sum()),
        sample_ids=res.ids[0, :16].tolist(), device_profile=profile, **readings,
        note="prefill_ms: prompt forward + first token, synchronised, in the second "
             "serve of the process (first_serve_prefill_ms: the first, with set-up); "
             "decode: 31 steps of one token each; max_memory_allocated over the second "
             "serve (teacher_forced_max_memory_allocated over the kernel and plain "
             "teacher-forced runs); rel_err = max |diff| / max |logit| per step; device_profile: "
             "torch.profiler kernel time by class over one prefill and over 8 decode "
             "steps (wall includes the profiler's own host cost)")
    return launches


SLICE_CHECKS = ((MOE_ARCH, "check_moe_yardstick"), (ENCDEC_ARCH, "check_attention_yardstick"),
                (VLM_ARCH, "check_attention_yardstick"))


def slice_serves(device) -> dict:
    """K2 at the MoE, encoder-decoder and vision-token archs' five prefill
    shapes (``flash_timing``), then their serves (``phase_model_serve`` with
    each arch's check): the timings, K2's launches on each serve's path, and
    the seconds of each."""
    seconds = {}
    t0 = time.perf_counter()
    timings = {name: flash_timing(shape, device, seed=16 + i)
               for i, (name, shape) in enumerate(FLASH_SLICE_SHAPES.items())}
    seconds["flash_timing"] = time.perf_counter() - t0
    say("slice_timing", flash_attention=timings,
        note="K2 in bf16 at granite's, whisper's (encoder, decoder self, cross) and "
             "internvl2's prefill shapes, timed as model_timing times K2, before the "
             "serves' large profiled windows")
    launches = {}
    for arch, check in SLICE_CHECKS:
        t0 = time.perf_counter()
        launches[arch] = phase_model_serve(device, arch, globals()[check])
        seconds["model_serve " + arch] = time.perf_counter() - t0
    return {"launches": launches, "timings": timings, "phase_seconds": seconds}


def timed_train(device, arch: str, phase: str, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> dict:
    """``phase_train`` of ``arch`` as ``phase``, with the seconds it took."""
    t0 = time.perf_counter()
    out = phase_train(device, arch, phase, batch, seq)
    return {**out, "phase_seconds": {phase: time.perf_counter() - t0}}


def train_ssm(device) -> dict:
    """mamba2-780m trained at full width."""
    return timed_train(device, SSM_TRAIN_ARCH, "train_ssm")


def train_moe(device) -> dict:
    """granite-moe-1b-a400m trained at full width, batch 1 x 4096."""
    return timed_train(device, MOE_ARCH, "train_moe")


def train_encdec(device) -> dict:
    """whisper-medium trained at full width, batch 16 x (1500 frames, 448
    decoder tokens), step 1 gated in float32 (``STEP1_FLOAT32_ARCHS``)."""
    return timed_train(device, ENCDEC_ARCH, "train_encdec", ENCDEC_TRAIN_BATCH,
                       ENCDEC_TRAIN_SEQ)


def child_main(fn) -> int:
    """A child process's body (``--slice-serves``, ``--train-ssm``,
    ``--train-moe``, ``--train-encdec``, ``--model-timing``): ``fn`` on the
    card, on the kernels the parent built; its result is the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(fn(torch.device("cuda", 0))), flush=True)
    return 0


def run_child(flag: str, what: str) -> dict:
    """``CHILDREN[flag]`` in a child process, whose lines are relayed; run
    after this process's last profiled window.  Within one process
    torch.profiler loses the records of whole later windows once many
    windows have been taken: with the slice's serves in the same process
    (their profiled decodes take 20,000 to 38,000 kernels a window)
    ``model_timing`` saw 0 of 20 launches in three windows in a row; with
    them in a child between qwen2.5-14b's serve and ``model_timing``, the
    same; with ``model_timing`` moved before the serves, ``seq_cumsum``'s
    profiled window recorded nothing.  A fresh process after such a child
    kept every record.  ``model_timing`` runs in one of its own for the
    same reason: after the three serves' profiled windows in this process,
    K3 bwd's windows have kept 9 of 20 records three times running."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag],
                          capture_output=True, text=True, timeout=900, cwd=ROOT)
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{what} failed (exit {proc.returncode})")
    return json.loads(lines[-1])


def phase_slice_serves() -> dict:
    """:func:`slice_serves` in a child process (``--slice-serves``)."""
    return run_child("--slice-serves", "the slice's serves")


def phase_train_ssm() -> dict:
    """:func:`train_ssm` in a child process (``--train-ssm``): its profiled
    step is a large window, so it runs after this process's last one."""
    return run_child("--train-ssm", "the SSM training")


def phase_train_moe() -> dict:
    """:func:`train_moe` in a child process (``--train-moe``)."""
    return run_child("--train-moe", "the MoE training")


def phase_train_encdec() -> dict:
    """:func:`train_encdec` in a child process (``--train-encdec``)."""
    return run_child("--train-encdec", "the encoder-decoder training")


def sdpa_backend(q, k, v, mask, is_causal: bool = False) -> str:
    import torch

    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    from torch.nn.attention import SDPBackend

    code = int(choose(q, k, v, mask, 0.0, is_causal))
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(code, f"code {code}")


def sdpa_args(q, k, causal: bool, window, q_offset: int) -> dict:
    """PyTorch's scaled_dot_product_attention arguments for K2's mask:
    ``is_causal`` where that is the mask (no window, Sq = Skv, no offset:
    causal or not), else the mask as a boolean ``attn_mask``."""
    import torch

    sq, skv = q.shape[1], k.shape[1]
    if window is None and not (causal and (sq != skv or q_offset)):
        return {"is_causal": causal}
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return {"attn_mask": mask}


def flash_timing(shape, device, seed: int) -> dict:
    """K2 in bf16 at a serving shape: kernel (events, and the profiler's
    device time), plain version, bound, and PyTorch's
    scaled_dot_product_attention on the same mask (``sdpa_args``; a mask is
    built outside the timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = flash_operands(shape, torch.bfloat16, device, seed=seed)

    def kernel():
        return fa.flash_attention(q, k, v, **kw)

    ms = cuda_median_ms(kernel, reps=20, warmup=3)
    dev_ms = profiled_device_ms(kernel, "flash_fwd_mma_kernel", reps=20)
    plain_ms = cuda_median_ms(lambda: fa.flash_attention_torch(q, k, v, **kw), reps=3, warmup=1)
    # yardstick only: the port never calls it
    g = q.shape[2] // k.shape[2]      # head h reads kv head h // g
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    sdpa = sdpa_args(q, k, **kw)
    lib_ms = cuda_median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa),
                            reps=20, warmup=3)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa).transpose(1, 2)
    lib_err = float((lib_out.float() - kernel().float()).abs().max())
    backend = sdpa_backend(qt, kt, vt, sdpa.get("attn_mask"), sdpa.get("is_causal", False))
    how = "mask" if "attn_mask" in sdpa else f"is_causal={sdpa['is_causal']}"
    del qt, kt, vt, lib_out
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **flash_bound(q, k, v, **kw), "library_ms": lib_ms,
            "library": f"scaled_dot_product_attention ({backend}, {how}), "
                       "kv heads expanded and any mask built outside the timing",
            "library_max_abs_diff": lib_err, "shape": list(shape), "dtype": "bfloat16"}


def _library_ms(*calls) -> dict:
    """The first of ``calls`` (PyTorch's ``torch._grouped_mm`` on one layout
    of its operands, made before the timing) that runs: its ms, or the
    error of each."""
    errors = []
    for name, fn in calls:
        try:
            fn()
        except (RuntimeError, TypeError, ValueError, AttributeError) as e:
            errors.append(f"{name}: {type(e).__name__}: {e}"[:300])
            continue
        return {"library_ms": cuda_median_ms(fn, reps=20, warmup=3), "library": name}
    return {"library_ms": None, "library": None, "library_errors": errors}


def moe_dispatch_timing(device) -> dict:
    """The sparse dispatch's wrappers at ``MOE_TIMING_SHAPE`` (random router
    logits): each held against its plain version first (the order, the
    gather and its sum bit-equal; the rest within ``MOE_KERNEL_LIMIT``), then
    ms (events, median of 20 wrapper calls) beside bound_ms, plain_ms (3
    calls) and library_ms (``torch._grouped_mm``, PyTorch's grouped product,
    for the grouped products); the dense dispatch's einsums at the same
    shape; the grouped products at each tile of ``GEMM_TILES``; one MoE block
    forward and backward on each dispatch (its peak beyond its inputs, and
    its host time at 2 x 16 tokens, where the card waits on the host); and,
    with the routing fixed, each bf16 dispatch's output and gradients
    against the dense dispatch in float32."""
    import torch

    from repro_torch.kernels import moe_dispatch as md

    n, k, e, d, f = MOE_TIMING_SHAPE
    r = n * k
    gen = torch.Generator(device=device).manual_seed(23)
    top_i = torch.topk(randn(gen, (n, e), device), k, -1).indices
    order = md.moe_order(top_i, e)
    off, rop, tok = order.offsets, order.row_of_pair, order.token_of_row

    def bf(*shape, scale=1.0):
        return (scale * randn(gen, shape, device)).to(torch.bfloat16)

    x, xs, h, y, dy, dout = bf(n, d), bf(r, d), bf(r, f), bf(r, d), bf(r, d), bf(n, d)
    gu, dgu = bf(r, 2 * f, scale=2.0), bf(r, 2 * f)
    gate = torch.softmax(randn(gen, (n, k), device), -1)
    wg, wi = bf(e, d, f, scale=d ** -0.5), bf(e, d, f, scale=d ** -0.5)
    wo = bf(e, f, d, scale=f ** -0.5)
    wgi, wgi_t, wo_t = torch.cat([wg, wi], 2), torch.cat([wg.mT, wi.mT], 1), wo.mT
    ends = off[1:]

    def lib(a, b):
        """``torch._grouped_mm`` of a (R, K) and b (E, K, N), b as given and
        K-contiguous."""
        b_k = b.transpose(1, 2).contiguous().transpose(1, 2)
        return _library_ms(("b as given", lambda: torch._grouped_mm(a, b, offs=ends)),
                           ("b K-contiguous", lambda: torch._grouped_mm(a, b_k, offs=ends)))

    def lib_wgrad(a, g):
        a_t = a.t().contiguous()
        return _library_ms(("a^T strided", lambda: torch._grouped_mm(a.t(), g, offs=ends)),
                           ("a^T contiguous", lambda: torch._grouped_mm(a_t, g, offs=ends)))

    b2 = 2
    f32 = [t.float() for t in (xs, h, dgu, dy, wg, wi, wo)]
    cases = [  # name, kernel, plain, check, operations, bytes, library
        ("moe_order", lambda: md.moe_order(top_i, e), lambda: md.moe_order_torch(top_i, e),
         "equal", 0, 8 * r + 2 * r + 4 * 3 * r, None),
        ("moe_permute", lambda: md.moe_permute(x, order),
         lambda: md.moe_permute_torch(x, tok), "equal", 0, b2 * (n * d + r * d) + 4 * r, None),
        ("moe_permute_bwd", lambda: md.moe_permute_bwd(xs, rop),
         lambda: md.moe_permute_bwd_torch(xs, rop), "equal", r * d,
         b2 * (r * d + n * d) + 4 * r, None),
        ("grouped_mm gate-up", lambda: md.grouped_mm(xs, wg, off, wi),
         lambda: md.grouped_mm_torch(f32[0], f32[4], off, f32[5]), "limit", 2 * r * d * 2 * f,
         b2 * (r * d + e * d * 2 * f + r * 2 * f), lambda: lib(xs, wgi)),
        ("grouped_mm down", lambda: md.grouped_mm(h, wo, off),
         lambda: md.grouped_mm_torch(f32[1], f32[6], off), "limit", 2 * r * f * d,
         b2 * (r * f + e * f * d + r * d), lambda: lib(h, wo)),
        ("grouped_mm gate-up dx", lambda: md._launch_grouped_mm(dgu, off, wg.mT, wi.mT, "k"),
         lambda: md.grouped_mm_torch(f32[2], torch.cat([f32[4].mT, f32[5].mT], 1), off),
         "limit", 2 * r * d * 2 * f, b2 * (r * d + e * d * 2 * f + r * 2 * f),
         lambda: lib(dgu, wgi_t)),
        ("grouped_mm down dh", lambda: md._launch_grouped_mm(dy, off, wo.mT),
         lambda: md.grouped_mm_torch(f32[3], f32[6].mT, off), "limit", 2 * r * f * d,
         b2 * (r * f + e * f * d + r * d), lambda: lib(dy, wo_t)),
        ("grouped_mm_wgrad gate-up", lambda: md.grouped_mm_wgrad(xs, dgu, off, f),
         lambda: md.grouped_mm_wgrad_torch(f32[0], f32[2], off).split(f, 2), "limit",
         2 * r * d * 2 * f,
         b2 * (r * d + e * d * 2 * f + r * 2 * f), lambda: lib_wgrad(xs, dgu)),
        ("grouped_mm_wgrad down", lambda: md.grouped_mm_wgrad(h, dy, off),
         lambda: md.grouped_mm_wgrad_torch(f32[1], f32[3], off), "limit", 2 * r * f * d,
         b2 * (r * f + e * f * d + r * d), lambda: lib_wgrad(h, dy)),
        ("moe_swiglu", lambda: md.moe_swiglu(gu), lambda: md.moe_swiglu_torch(gu.float()),
         "limit", 5 * r * f, b2 * 3 * r * f, None),
        ("moe_swiglu_bwd", lambda: md.moe_swiglu_bwd(gu, h),
         lambda: md.moe_swiglu_bwd_torch(gu.float(), h.float()), "limit", 10 * r * f,
         b2 * 5 * r * f, None),
        ("moe_combine", lambda: md.moe_combine(y, gate, order),
         lambda: md.moe_combine_torch(y.float(), gate, rop), "limit", 2 * r * d,
         b2 * (r * d + n * d) + 8 * r, None),
        ("moe_combine_bwd", lambda: md.moe_combine_bwd(dout, y, gate, rop),
         lambda: md.moe_combine_bwd_torch(dout.float(), y.float(), gate, rop), "limit",
         4 * r * d, b2 * (n * d + 2 * r * d) + 12 * r, None),
    ]
    out = {}
    for name, fn, plain, check, ops, nbytes, library in cases:
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if check == "equal":
            worst = 0.0 if all(torch.equal(a, b) for a, b in zip(got, want)) else math.inf
        else:
            worst = max(float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp_min(1e-30))
                        for a, b in zip(got, want))
        limit = 0.0 if check == "equal" else MOE_KERNEL_LIMIT
        if not worst <= limit:
            raise AssertionError(f"MoE dispatch {name} differs from its plain version by "
                                 f"{worst:.3g} of max |plain| (limit {limit})")
        del got, want
        t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_median_ms(fn, reps=20, warmup=3)
        out[name] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "operations": ops, "bytes": nbytes, "rel_err_vs_plain": worst,
                     "limit": limit, "plain_ms": cuda_median_ms(plain, reps=3, warmup=1),
                     **(library() if library is not None else {"library_ms": None})}
        if ops and out[name]["bound_by"] == "operations":
            out[name]["achieved_tflops"] = ops / ms * 1e-9
    del f32
    xd, hd = x.reshape(2, n // 2, d), bf(2, n // 2, e, f)
    out["dense einsum gate+up"] = {"ms": cuda_median_ms(
        lambda: (torch.einsum("bse,xef->bsxf", xd, wg), torch.einsum("bse,xef->bsxf", xd, wi)),
        reps=5, warmup=1)}
    out["dense einsum down"] = {"ms": cuda_median_ms(
        lambda: torch.einsum("bsxf,xfd->bsxd", hd, wo), reps=5, warmup=1)}
    del hd
    rows = [lambda: md.grouped_mm(xs, wg, off, wi), lambda: md.grouped_mm(h, wo, off),
            lambda: md._launch_grouped_mm(dgu, off, wg.mT, wi.mT, "k"),
            lambda: md._launch_grouped_mm(dy, off, wo.mT)]
    grads = [lambda: md.grouped_mm_wgrad(xs, dgu, off, f), lambda: md.grouped_mm_wgrad(h, dy, off)]
    keep, tiles = (md.MM_TILE, md.WGRAD_TILE), {}
    try:
        for tile, what in md.GEMM_TILES.items():
            md.MM_TILE = md.WGRAD_TILE = tile
            tiles[what] = {"rows_ms": [cuda_median_ms(fn, reps=20, warmup=3) for fn in rows],
                           "wgrad_ms": [cuda_median_ms(fn, reps=20, warmup=3) for fn in grads]}
    finally:
        md.MM_TILE, md.WGRAD_TILE = keep
    out["tiles"] = {"chosen": {"MM_TILE": md.GEMM_TILES[keep[0]],
                               "WGRAD_TILE": md.GEMM_TILES[keep[1]]}, **tiles}
    del x, xs, h, y, dy, dout, gu, dgu, wgi, wgi_t, rows, grads
    torch.cuda.empty_cache()
    out["block"] = moe_block_readings(device)
    return out


def moe_block_readings(device) -> dict:
    """One granite MoE block (fp32 masters, bf16 work) at 2 x 4096 tokens on
    each dispatch: forward and backward ms, forward ms, the peak beyond its
    inputs, and host ms a call at 2 x 16 tokens; then, on one fixed routing
    (the float32 run's), the output and the gradients of x, the router and
    each expert weight of each bf16 dispatch against the dense dispatch in
    float32 (max |diff| / max |float32|): the rounding each bf16 path adds."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Decoder, blocks, init_params_

    n, _, _, d, _ = MOE_TIMING_SHAPE
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1)
    mlps = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        mlps[dtype] = (c, init_params_(Decoder(c, device=device, master=True),
                                      torch.Generator(device=device).manual_seed(0)).layers[0].mlp)
    gen = torch.Generator(device=device).manual_seed(1)
    x32, dy32 = randn(gen, (2, n // 2, d), device), randn(gen, (2, n // 2, d), device)
    x = x32.to(torch.bfloat16).requires_grad_()
    dy = dy32.to(torch.bfloat16)
    c16, mlp = mlps["bfloat16"]
    out = {}
    for branch in ("sparse", "dense"):
        def step():
            _, o = blocks._moe(c16, mlp, x, None, branch)
            o.backward(dy)

        def fwd():
            with torch.no_grad():
                blocks._moe(c16, mlp, x, None, branch)

        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        row = {"fwd_bwd_ms": cuda_median_ms(step, reps=5, warmup=1),
               "fwd_ms": cuda_median_ms(fwd, reps=5, warmup=1),
               "peak_beyond_inputs_bytes": torch.cuda.max_memory_allocated(device) - base}
        xh = x[:, :16].detach().clone().requires_grad_()
        dyh = dy[:, :16]
        for name, grad in (("host_fwd_ms", False), ("host_fwd_bwd_ms", True)):
            def call():
                with torch.set_grad_enabled(grad):
                    _, o = blocks._moe(c16, mlp, xh, None, branch)
                if grad:
                    o.backward(dyh)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            row[name] = (time.perf_counter() - t0) * 1e3 / 50
        out[branch] = row
    for p in mlp.parameters():
        p.grad = None
    # the rounding: every run on the float32 run's expert choice
    c32, mlp32 = mlps["float32"]
    fixed = blocks.moe_route(c32, mlp32, x32)[1]
    orig = blocks.moe_route
    runs = {}
    try:
        blocks.moe_route = lambda cfg, p, xx: (orig(cfg, p, xx)[0], fixed)
        for name, c, m, xx, g, branch in (("float32", c32, mlp32, x32, dy32, "dense"),
                                          ("bf16 dense", c16, mlp, x, dy, "dense"),
                                          ("bf16 sparse", c16, mlp, x, dy, "sparse")):
            xx = xx.detach().requires_grad_()
            params = dict(m.named_parameters())
            _, o = blocks._moe(c, m, xx, None, branch)
            grads = torch.autograd.grad(o, [xx, *params.values()], g)
            runs[name] = {"out": o.detach().float(),
                          **{k: v.float() for k, v in zip(["x", *params], grads)}}
    finally:
        blocks.moe_route = orig
    ref = runs.pop("float32")
    out["rel_err_vs_float32_dense"] = {
        name: {k: float((v - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
               for k, v in got.items()} for name, got in runs.items()}
    return out


def phase_model_timing(device):
    """K2, K3 and K4 at the serving shapes, the backwards of K2, K3 and K4
    at the training shape and the MoE's sparse dispatch at granite's
    (``moe_dispatch_timing``): kernel, plain version, bound, library."""
    import torch

    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    flash = flash_timing(FLASH_SERVE, device, seed=7)

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
    # the forward at the training shape (batch 1: 80 warps), as training calls it
    x1, ap1, ig1, ag1, _ = rglru_operands(RGLRU_TRAIN, torch.bfloat16, device, seed=15)
    a1, xb1 = rg.rglru_gates(x1, ap1, ig1, ag1)
    r_b1 = {"shape": list(RGLRU_TRAIN[:3]),
            "ms": cuda_median_ms(lambda: rg._launch_cuda(a1, xb1, None), reps=20, warmup=3),
            "device_ms": profiled_device_ms(lambda: rg._launch_cuda(a1, xb1, None),
                                            "rglru_scan_kernel", reps=20),
            "bound_ms": rglru_bound(a1, None)["bound_ms"],
            "status": "not redesigned, second round"}
    del x1, ap1, ig1, ag1, a1, xb1
    # K4 as the prefill calls it (bf16 x/B/C, d_skip, an fp32 h0) and as a
    # decode step calls it (T = 1)
    args = ssd_operands(SSD_SERVE, torch.bfloat16, device, True, seed=9)
    s_ms = cuda_median_ms(lambda: ssd.ssd_chunked(*args), reps=20, warmup=3)
    s_dev = profiled_device_ms(lambda: ssd.ssd_chunked(*args), "ssd_chunk_mma_kernel", reps=20)
    s_plain = cuda_median_ms(lambda: ssd.ssd_chunked_torch(*args), reps=3, warmup=1)
    s_bound = ssd_bound(args[0], args[3], args[5], args[6], chunk=ssd.CHUNK)
    del args
    # ... and as a training step calls it (batch 1, d_skip, no h0)
    x1, dt1, al1, bm1, cm1, d1, _ = ssd_operands(SSD_TRAIN, torch.bfloat16, device, True,
                                                 seed=18)
    s_b1 = {"shape": list(SSD_TRAIN),
            "ms": cuda_median_ms(lambda: ssd.ssd_chunked(x1, dt1, al1, bm1, cm1, d1),
                                 reps=20, warmup=3),
            "device_ms": profiled_device_ms(lambda: ssd.ssd_chunked(x1, dt1, al1, bm1, cm1, d1),
                                            "ssd_chunk_mma_kernel", reps=20),
            "bound_ms": ssd_bound(x1, bm1, d1, None, chunk=ssd.CHUNK)["bound_ms"]}
    del x1, dt1, al1, bm1, cm1, d1
    dec = ssd_operands((SERVE_BATCH, 1) + SSD_SERVE[2:], torch.bfloat16, device, True, seed=10)
    s_dec = cuda_median_ms(lambda: ssd.ssd_chunked(*dec), reps=50, warmup=5)
    s_dec_dev = profiled_device_ms(lambda: ssd.ssd_chunked(*dec), "ssd_chunk_kernel", reps=50)
    s_dec_plain = cuda_median_ms(lambda: ssd.ssd_chunked_torch(*dec), reps=20, warmup=3)
    s_dec_bound = ssd_bound(dec[0], dec[3], dec[5], dec[6], chunk=ssd.CHUNK)
    out = {
        "moe_dispatch_" + MOE_ARCH: moe_dispatch_timing(device),
        "flash_attention_bwd": flash_bwd_timing(device, seed=13),
        "flash_attention_bwd_" + MOE_ARCH: flash_bwd_timing(device, seed=19,
                                                            shape=FLASH_BWD_GRANITE),
        "flash_attention_bwd_" + ENCDEC_ARCH + " cross": flash_bwd_timing(
            device, seed=20, shape=FLASH_BWD_WHISPER["cross"]),
        "rglru_scan_bwd": rglru_bwd_timing(device, seed=14),
        "ssd_chunked_bwd": ssd_bwd_timing(device, seed=17),
        "flash_attention_qwen2.5-14b": flash_timing(FLASH_QWEN, device, seed=11),
        "flash_attention_codeqwen1.5-7b": flash_timing(FLASH_CODEQWEN, device, seed=12),
        "flash_attention": flash,
        "rglru_scan": {"ms": r_ms, "device_ms": r_dev, "plain_ms": r_plain, **r_bound,
                       "library_ms": None,
                       "wrapper_ms_with_gates": r_wrapper, "decode_step_ms": r_decode,
                       "decode_step_device_ms": r_decode_dev,
                       "decode_step_bound_ms": r_decode_bound["bound_ms"],
                       "decode_step_bound_by": r_decode_bound["bound_by"],
                       "decode_step_bytes": r_decode_bound["bytes"],
                       "training_shape": r_b1,
                       "shape": [SERVE_BATCH, SERVE_PROMPT, 2560]},
        "ssd_chunked": {"ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain, **s_bound,
                        "library_ms": None, "training_shape": s_b1,
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
             "warm-up, inputs resident on the card; flash_attention (recurrentgemma-2b's "
             "shape) and its qwen2.5-14b / codeqwen1.5-7b shapes (granite's, whisper's and "
             "internvl2's: in the slice_timing line): device_ms the bf16 "
             "kernel's mean device time over 20 launches from torch.profiler; "
             "rglru device_ms: the scan kernel's "
             "mean device time over 20 launches from torch.profiler (the gate math is "
             "PyTorch and is in wrapper_ms_with_gates); ssd ms is the "
             "wrapper (one launch, d_skip fused); its bound_ms counts the least operations "
             "at the kernel's chunk (C B^T once per group) at the rate of the precision "
             "the kernel computes in (bf16 tensor cores for a bf16 prefill), "
             "fp32_rate_bound_ms the same work with all but C B^T at the fp32 rate; "
             "kernel_operations is the chunked form with C B^T per head, achieved_tflops "
             "those over ms, tpu_operations the TPU kernel's count (per head, chunk 128); "
             "rglru_scan.training_shape: the forward at (1, 4096, 2560), 80 warps, not "
             "redesigned; "
             "decode_step_ms is event-timed around one wrapper call (host work "
             "included), decode_step_device_ms the kernel's own time from "
             "torch.profiler, mean of 50; ssd device_ms: the tensor-core kernel's mean "
             "device time over 20 launches, training_shape the same at (1, 4096) with no h0; "
             "flash_attention_bwd, rglru_scan_bwd and ssd_chunked_bwd at the "
             "training shape (K2 bwd also at granite-moe-1b-a400m's and at "
             "whisper-medium's cross-attention training shapes): ms the median of 10 (20, 10) event-timed wrapper calls, device_ms "
             "the profiler's time of the call's kernels (K2 bwd: delta, the tensor-core "
             "dk/dv pass, the group sum, the tensor-core dq pass; K3 bwd: the reverse scan "
             "in the group the wrapper picks, device_ms_by_group in each group there and "
             "at batch 4, chain_ms = T x fp32_chain_ms_per_step, one channel's dependent "
             "add and multiply measured on one thread; K4 bwd: its four bf16 kernels, the "
             "tensor-core state, chunk and dB / dC passes and the heads' sums, each with "
             "its grid (the profiler's trace of one call), registers, shared memory and "
             "blocks an SM; scratch_bytes the allocator's peak during one call less what "
             "stays allocated after it), plain_ms 3 calls "
             "of the plain backward, library_ms (K2 bwd) the backward of "
             "scaled_dot_product_attention through autograd at the same shape; K2 bwd's "
             "kernel_operations is the design's 14 D a visible pair (S and dP in both "
             "passes), achieved_tflops those over ms; moe_dispatch: moe_dispatch_timing "
             "(each wrapper's check against its plain version, then its timing)")
    return out


def flash_bwd_bound(q, k, v, causal, window, q_offset) -> dict:
    """Least time for K2's backward: q, k, v, out and dO read and dq, dk, dv
    written once (lse read, fp32) over the memory rate, against 10 D
    operations per unmasked pair (the scores again, dP, dV, dK and dQ, 2 D
    each) over the peak rate of the input type.  ``kernel_operations`` is the
    work of the kernels' design on the same pairs: 14 D, because the dk / dv
    pass and the dq pass each recompute S and dP (seven products of 2 D);
    the masked parts of the edge tiles they also compute are not counted."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pairs = flash_pairs(sq, skv, causal, window, q_offset) * b * h
    ops = 10 * d * pairs
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * q.element_size() + b * sq * h * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return {"bytes": nbytes, "operations": ops, "kernel_operations": 14 * d * pairs,
            "pairs": pairs, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rglru_bwd_bound(a, h0, dh_last) -> dict:
    """Least time for K3's backward: a, the states y and dy read and dx~, da
    written once (h0 and dh_last read, dh0 written), all fp32, against an add
    and two multiplies per element at the fp32 rate."""
    small = a.shape[0] * a.shape[2] * 4
    nbytes = 5 * a.numel() * 4 + small * (1 + (h0 is not None) + (dh_last is not None))
    ops = 3 * a.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return {"bytes": nbytes, "operations": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_bwd_operations(t: int, p: int, n: int, chunk: int) -> tuple[int, int]:
    """Operations of K4's backward over ``t`` steps of one (batch, head),
    split as (C B^T, the rest): per chunk of q steps 2 q^2 N for C B^T (once
    per group); per head 2 q^2 P each for dy x^T and M^T dy, 2 q^2 N each for
    the intra-chunk dB and dC, and 2 q N P each for the chunk's incoming state
    (recomputed: the forward keeps none), dH' B^T, C H^T, the inter-chunk dB
    and dC, and the state gradient passed back (``kernels.fake``)."""
    from repro_torch.kernels import fake

    return fake.ssd_bwd_operations(t, p, n, chunk)


def ssd_bwd_bound(x, b_mat, d_skip, h0, dh_last, chunk: int) -> dict:
    """Least time for K4's backward: x, dt, B, C, dy (x's type), a_log,
    d_skip, h0 and dh_last read, dx, ddt, dB, dC, da_log, dd_skip and dh0
    written once over the memory rate, against ``ssd_bwd_operations`` (C B^T
    once per (batch, group), the rest per (batch, head)) at the peak rate of
    the inputs' type (bf16: the tensor cores, where the bf16 route computes);
    ``fp32_rate_*`` the same work at the fp32 rate, the CUDA-core route's for
    float32 inputs."""
    b, t, h, p = x.shape
    g, n = b_mat.shape[2:]
    cb, rest = ssd_bwd_operations(t, p, n, chunk)
    ops = b * g * cb + b * h * rest
    state = b * h * p * n * 4
    nbytes = 3 * x.numel() * x.element_size() + 2 * b * t * h * 4 \
        + 4 * b_mat.numel() * b_mat.element_size() + 2 * h * 4 \
        + (2 * h * 4 if d_skip is not None else 0) + (2 * state if h0 is not None else 0) \
        + (state if dh_last is not None else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    t_ops32 = ops / PEAK_FLOPS["float32"] * 1e3
    return {"bytes": nbytes, "operations": ops, "chunk": chunk, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_rate_bound_ms": max(t_bytes, t_ops32),
            "fp32_rate_bound_by": "bytes" if t_bytes >= t_ops32 else "operations"}


def ssd_bwd_resources() -> dict:
    """Registers, spills and static shared memory (the build's ``ptxas -v``)
    of each of ``SSD_BWD_KERNELS``, and for the tensor-core passes their
    dynamic shared memory and blocks an SM on this card
    (``ssd_bwd_mma_resources``)."""
    import ctypes

    from repro_torch.kernels import _build

    report = ptxas_report(_build.build_log("ssd_bwd"))
    query = _build.load("ssd_bwd").ssd_bwd_mma_resources
    query.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = {}
    for name in SSD_BWD_KERNELS:
        found = [f for f in report if name in f["kernel"]]
        if len(found) != 1:
            raise AssertionError(f"ptxas reports {len(found)} functions named {name}")
        entry = {k: found[0][k] for k in ("registers", "spill_stores", "spill_loads",
                                          "static_smem")}
        if name in SSD_BWD_KERNELS[:3]:
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = query(SSD_BWD_KERNELS.index(name), ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"ssd_bwd_mma_resources({name}): CUDA error {err}")
            entry.update(dynamic_smem=smem.value, blocks_per_sm=blocks.value)
        out[name] = entry
    return out


def ssd_bwd_timing(device, seed: int) -> dict:
    """K4's backward in bf16 at the training shape, as a training step calls
    it (d_skip, no h0, no last-state gradient): events around one wrapper
    call, the profiler's device time of the ``SSD_BWD_KERNELS`` one call
    launches (together and each on its own) and their gap, the plain backward,
    the bound, each kernel's grid (from the profiler's trace of one call) and
    resources, and the scratch one call holds (the allocator's peak during the
    call less what stays allocated after it: the outputs); no single PyTorch
    call computes it (library_ms None)."""
    import torch

    from repro_torch.kernels import ssd

    args, dy, _ = ssd_bwd_operands(SSD_TRAIN, torch.bfloat16, device, True, seed)
    x, dt, a_log, bm, cm, d_skip, _ = args

    def kernel():
        return ssd.ssd_chunked_bwd(x, dt, a_log, bm, cm, d_skip, None, dy)

    ms = cuda_median_ms(kernel, reps=10, warmup=2)
    dev_ms = profiled_device_ms(kernel, "ssd_bwd_", reps=10, per_call=len(SSD_BWD_KERNELS))
    by_kernel = {name: profiled_device_ms(kernel, name, reps=10) for name in SSD_BWD_KERNELS}
    grids = profiled_grids(kernel, SSD_BWD_KERNELS, ROOT / "build" / "ssd_bwd_trace.json")
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    outs = kernel()
    torch.cuda.synchronize(device)
    scratch = torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device)
    del outs
    plain_ms = cuda_median_ms(
        lambda: ssd.ssd_chunked_bwd_torch(x, dt, a_log, bm, cm, d_skip, None, dy),
        reps=3, warmup=1)
    bound = ssd_bwd_bound(x, bm, d_skip, None, None, ssd.CHUNK)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound, "library_ms": None,
            "event_minus_device_ms": ms - dev_ms,
            "kernels": list(SSD_BWD_KERNELS), "device_ms_by_kernel": by_kernel,
            "entry_points": list(ssd.bwd_entry_points(torch.bfloat16)),
            "achieved_tflops": bound["operations"] / ms * 1e-9,
            "grids": grids, "blocks": {k: math.prod(v) for k, v in grids.items()},
            "resources": ssd_bwd_resources(), "scratch_bytes": scratch,
            "shape": list(SSD_TRAIN), "dtype": "bfloat16 x/B/C/dy, fp32 dt/d_skip"}


def ssd_bwd_scratch_bytes(dtype, b: int, t: int, h: int, p: int, n: int) -> int:
    """The bytes of the scratch one K4 backward allocates (``ssd.bwd_scratch``):
    on the tensor cores every chunk's state and state gradient as hi + lo bf16
    pairs and the per-(batch, head, chunk) da / dD partials."""
    from repro_torch.kernels import ssd

    return sum(math.prod(shape) * dt.itemsize
               for shape, dt in ssd.bwd_scratch(dtype, b, t, h, p, n).values())


def flash_bwd_timing(device, seed: int, shape=FLASH_TRAIN) -> dict:
    """K2's backward in bf16 at a training shape (recurrentgemma-2b's by
    default): kernel (events, and the profiler's device time of the
    ``FLASH_BWD_KERNELS`` kernels one call launches, together and each on its
    own), its achieved rate on the design's operations, plain version, bound,
    and the backward of PyTorch's scaled_dot_product_attention through
    autograd at the same shape (kv heads expanded, the mask as
    ``sdpa_args`` gives it, built and the forward run once outside the
    timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = flash_operands(shape, torch.bfloat16, device, seed=seed)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    do = randn(torch.Generator(device=device).manual_seed(seed + 1), q.shape, device,
               torch.bfloat16)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)

    ms = cuda_median_ms(kernel, reps=10, warmup=2)
    dev_ms = profiled_device_ms(kernel, "flash_bwd_", reps=10, per_call=len(FLASH_BWD_KERNELS))
    by_kernel = {name: profiled_device_ms(kernel, name, reps=10) for name in FLASH_BWD_KERNELS}
    plain_ms = cuda_median_ms(lambda: fa.flash_attention_bwd_torch(q, k, v, out, lse, do, **kw),
                              reps=3, warmup=1)
    # yardstick only: the port never calls it
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous().requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous().requires_grad_()
    sdpa = sdpa_args(q, k, **kw)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    dot = do.transpose(1, 2)
    lib_ms = cuda_median_ms(
        lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True),
        reps=10, warmup=2)
    backend = sdpa_backend(qt, kt, vt, sdpa.get("attn_mask"), sdpa.get("is_causal", False))
    how = "mask" if "attn_mask" in sdpa else f"is_causal={sdpa['is_causal']}"
    del qt, kt, vt, lib_out, dot
    bound = flash_bwd_bound(q, k, v, **kw)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
            "achieved_tflops": bound["kernel_operations"] / ms * 1e-9,
            "kernels": list(FLASH_BWD_KERNELS), "device_ms_by_kernel": by_kernel,
            "library_ms": lib_ms,
            "library": f"scaled_dot_product_attention backward through autograd ({backend}, "
                       f"{how}), kv heads expanded, forward outside the timing",
            "shape": list(shape), "dtype": "bfloat16"}


def rglru_bwd_timing(device, seed: int) -> dict:
    """K3's backward at the training shape (1 x 4096 x 2560, fp32, no h0 and
    no last-state gradient, as a training forward calls it): ms by events
    around one wrapper call, the kernel's device time in the group the
    wrapper picks and in each group the kernel has, there and at batch 4
    (``device_ms_by_group``); ``event_minus_device_ms`` is the wrapper's host
    work that the events also take, ``wrapper_host_ms`` the host's clock over
    calls enqueued back to back."""
    import torch

    from repro_torch.kernels import rglru as rg

    def operands(shape, seed):
        x, a_param, ig, ag, h0 = rglru_operands(shape, torch.bfloat16, device, seed=seed)
        a, xb = rg.rglru_gates(x, a_param, ig, ag)
        y = rg.scan_torch(a, xb, h0)
        dy = randn(torch.Generator(device=device).manual_seed(seed + 1), y.shape, device)
        return a, y, h0, dy

    a, y, h0, dy = operands(RGLRU_TRAIN, seed)
    ms = cuda_median_ms(lambda: rg.rglru_scan_bwd(a, y, h0, dy), reps=20, warmup=3)
    # the wrapper's host time per call: 50 calls enqueued back to back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        rg.rglru_scan_bwd(a, y, h0, dy)
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    dev_ms = profiled_device_ms(lambda: rg.rglru_scan_bwd(a, y, h0, dy),
                                "rglru_scan_bwd_kernel", reps=20)
    plain_ms = cuda_median_ms(lambda: rg.scan_bwd_torch(a, y, h0, dy, None), reps=3, warmup=1)
    by_group = {}
    for shape in (RGLRU_TRAIN, (SERVE_BATCH,) + RGLRU_TRAIN[1:]):
        ops = (a, y, h0, dy) if shape == RGLRU_TRAIN else operands(shape, seed + 2)
        by_group["x".join(map(str, shape[:3]))] = {
            str(g): profiled_device_ms(
                lambda g=g: rg._launch_bwd_cuda(*ops, None, group=g),
                "rglru_scan_bwd_kernel", reps=20)
            for g in rg.BWD_GROUPS}
        del ops
    group = rg.bwd_group(RGLRU_TRAIN[0], RGLRU_TRAIN[2], rg._n_sms(device.index or 0))
    per_add = fp32_chain_ms_per_step(device)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **rglru_bwd_bound(a, h0, None), "library_ms": None,
            "event_minus_device_ms": ms - dev_ms, "wrapper_host_ms": host_ms, "group": group,
            "warps": RGLRU_TRAIN[0] * -(-RGLRU_TRAIN[2] // group),
            "device_ms_by_group": by_group,
            "chain_ms": RGLRU_TRAIN[1] * per_add, "fp32_chain_ms_per_step": per_add,
            "shape": list(RGLRU_TRAIN[:3]), "dtype": "float32"}


class _YardstickFlash:
    """Attention in the plain versions' yardstick order, differentiable: the
    forward in the reference TPU kernel's order (``tpu_order_attention``), the
    plain backward with its kv sums in blocks of ``TRAIN_YARDSTICK_CHUNK`` q
    rows.  Built at first use (it needs torch)."""

    fn = None

    @classmethod
    def apply(cls, q, k, v, causal, window):
        import torch

        from repro_torch.kernels import flash_attention as fa

        if cls.fn is None:
            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, q, k, v, causal, window):
                    out, lse = tpu_order_attention(q, k, v, causal=causal, window=window,
                                                   return_lse=True)
                    ctx.save_for_backward(q, k, v, out, lse)
                    ctx.args = (causal, window)
                    return out

                @staticmethod
                def backward(ctx, do):
                    q, k, v, out, lse = ctx.saved_tensors
                    causal, window = ctx.args
                    dq, dk, dv = fa.flash_attention_bwd_torch(
                        q, k, v, out, lse, do, causal=causal, window=window,
                        chunk=TRAIN_YARDSTICK_CHUNK)
                    return dq, dk, dv, None, None

            cls.fn = Fn
        return cls.fn.apply(q, k, v, causal, window)


@contextlib.contextmanager
def plain_training(yardstick: bool = False):
    """The training path with K2, K3 and K4 (forward and backward) replaced
    by their plain versions and the MoE on its dense dispatch
    (``dense_moe``; for the comparison only: the port has no such route);
    ``yardstick``: attention summed in another order (``_YardstickFlash``)
    and the SSD's forward and backward at ``YARDSTICK_CHUNK`` steps a
    chunk."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    def yardstick_flash(q, k, v, *, causal=True, window=None, name=None):
        return _YardstickFlash.apply(q, k, v, causal, window)

    orig = ops.flash_attention, ops.rglru_scan, ops.ssd_chunked
    ops.flash_attention = yardstick_flash if yardstick else fa.flash_attention_torch_grad
    ops.rglru_scan = rg.rglru_scan_torch_grad
    ops.ssd_chunked = functools.partial(ssd.ssd_chunked_torch_grad, chunk=YARDSTICK_CHUNK) \
        if yardstick else ssd.ssd_chunked_torch_grad
    try:
        with dense_moe():
            yield
    finally:
        ops.flash_attention, ops.rglru_scan, ops.ssd_chunked = orig


def moe_wrappers(backward: bool = True) -> dict:
    """The MoE's sparse-dispatch kernel wrappers by name (the forward's, and
    the backward's with ``backward``); each counts its launches."""
    from repro_torch.kernels import moe_dispatch as md

    names = ["moe_order", "moe_permute", "grouped_mm", "moe_swiglu", "moe_combine"]
    if backward:
        names += ["moe_permute_bwd", "grouped_mm_wgrad", "moe_swiglu_bwd", "moe_combine_bwd"]
    return {name: getattr(md, name) for name in names}


def sparse_moe(cfg) -> bool:
    """Whether ``cfg``'s MoE blocks take the sparse dispatch on the card
    (``models.blocks.moe_branch`` of a plain bf16 CUDA tensor)."""
    from repro_torch.models import blocks

    return bool(cfg.n_experts) and blocks.sparse_experts(cfg) and cfg.dtype == "bfloat16"


def moe_launches(cfg, forwards: int, backwards: int) -> dict:
    """The sparse dispatch's launches for ``forwards`` runs of MoE blocks'
    forwards and ``backwards`` of their backwards: the order, the gather, the
    two grouped products, SwiGLU and the combine a forward; the two row
    products again, the two weight gradients and the other backwards a
    backward."""
    if not sparse_moe(cfg):
        forwards = backwards = 0
    return {"moe_order": forwards, "moe_permute": forwards,
            "grouped_mm": 2 * forwards + 2 * backwards, "moe_swiglu": forwards,
            "moe_combine": forwards, "moe_permute_bwd": backwards,
            "grouped_mm_wgrad": 2 * backwards, "moe_swiglu_bwd": backwards,
            "moe_combine_bwd": backwards}


def train_wrappers() -> dict:
    """The training path's kernel wrappers by name; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import schedule_dp as sdp
    from repro_torch.kernels import ssd

    return {"flash_attention": fa.flash_attention, "flash_attention_bwd": fa.flash_attention_bwd,
            "rglru_scan": rg.rglru_scan, "rglru_scan_bwd": rg.rglru_scan_bwd,
            "ssd_chunked": ssd.ssd_chunked, "ssd_chunked_bwd": ssd.ssd_chunked_bwd,
            **moe_wrappers(), "schedule_dp": sdp.sweep}


def expected_train_launches(cfg, scan_group, policy) -> dict:
    """Kernel launches of one training step: K2, K3 and K4 forward once per
    call of the first forward plus once per replay the plan implies (none
    for a held class; ``models.decoder.kernel_forwards``), and their
    backwards once per call of the first forward (``kernel_calls``); the
    MoE's sparse dispatch (``moe_launches``) forward in every layer's first
    forward and each of its replays (the plan holds none of its outputs),
    backward once a layer."""
    from repro_torch.models.decoder import kernel_calls, kernel_forwards, layer_replays

    fwd, calls = kernel_forwards(cfg, scan_group, policy), kernel_calls(cfg)
    moe_layers = 0 if cfg.encoder_layers else cfg.n_layers
    replays = sum(layer_replays(cfg, scan_group, policy)) if moe_layers else 0
    return {"flash_attention": fwd["attn_out"], "flash_attention_bwd": calls["attn_out"],
            "rglru_scan": fwd["rec_out"], "rglru_scan_bwd": calls["rec_out"],
            "ssd_chunked": fwd["ssm_out"], "ssd_chunked_bwd": calls["ssm_out"],
            **moe_launches(cfg, moe_layers + replays, moe_layers)}


def train_memory_reckoning(cfg, plan, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                           n_params: int | None = None) -> dict:
    """What a training step must hold at least, from the shapes: fp32
    parameters, gradients and AdamW moments (16 B a parameter; ``n_params``,
    the model's own count, else ``cfg.param_count()``), the bf16 casts of
    the weights autograd keeps (2 B), the logits with their gradient (bf16)
    and one fp32 block of the loss, and the activations: the planner's named
    classes for a decoder, where a MoE holds what its dispatch saves instead
    of the planner's top-k ``moe_hidden`` (the sparse dispatch, per layer:
    the gathered rows (B S k, D), the gate and up products (B S k, 2F), the
    hidden (B S k, F) and the experts' outputs (B S k, D), bf16, and two
    int32 indices a row; the dense one: g, u and the hidden (B, S, E, F) and
    the experts' outputs (B, S, E, D), bf16; the planner's figure is printed
    beside it); for an encoder-decoder, whose layers all
    run in recompute regions, each layer's input and the largest layer's
    working set (the encoder's: q, k, v, the output and the norms' outputs
    (B, F, D), the MLP's pre-activation and hidden (B, F, d_ff), bf16, and the
    LSE (B, F, H) fp32).  For SSM layers also K4's backward scratch (chunk
    states and state gradients as hi + lo bf16, per-chunk da / dD), which one
    layer's backward holds at a time.  Unnamed intermediates (norm and gate
    values) are not in it."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.plan import H100, layer_costs

    n = cfg.param_count() if n_params is None else n_params
    tokens = batch * seq
    logits = 2 * 2 * tokens * cfg.padded_vocab + 2 * 4 * 1024 * cfg.padded_vocab
    out = {"state_bytes": 16 * n, "weight_casts_bytes": 2 * n}
    if cfg.encoder_layers:
        frames = batch * cfg.n_frames
        d = cfg.d_model
        out["region_inputs_bytes"] = 2 * d * (cfg.encoder_layers * frames
                                              + cfg.n_layers * tokens + frames)
        out["layer_working_set_bytes"] = 2 * frames * (6 * d + 2 * cfg.d_ff) \
            + 4 * frames * cfg.n_heads
    else:
        costs = layer_costs(cfg, ShapeCell("train_cfg", seq, batch, "train"),
                            n_data_shards=1, n_model_shards=1, hw=H100)
        acts = sum(sum(lc.act_bytes.values()) for lc in costs)
        planner_moe = sum(lc.act_bytes.get("moe_hidden", 0) for lc in costs)
        if sparse_moe(cfg):
            out["moe_sparse_dispatch_bytes"] = cfg.n_layers * tokens * cfg.top_k * (
                2 * (2 * cfg.d_model + 3 * cfg.d_ff) + 2 * 4)
            acts -= planner_moe
        elif cfg.n_experts:
            out["moe_dense_dispatch_bytes"] = \
                cfg.n_layers * 2 * tokens * cfg.n_experts * (3 * cfg.d_ff + cfg.d_model)
            acts -= planner_moe
        out["named_activations_bytes"] = acts
    out["logits_bytes"] = logits
    if "ssm" in cfg.kinds:
        import torch

        out["ssd_bwd_scratch_bytes"] = ssd_bwd_scratch_bytes(
            torch.bfloat16, batch, seq, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    out["total_bytes"] = sum(out.values())
    if cfg.n_experts:
        out["planner_moe_hidden_bytes"] = planner_moe
    return out


def grads_of(tr, batch):
    """Loss and gradients (by parameter name, on the card) of one step."""
    import torch

    from repro_torch.models import arch_forward, cross_entropy_loss

    for p in tr.model.parameters():
        p.grad = None
    loss = cross_entropy_loss(tr.cfg, arch_forward(tr.cfg, tr.model, batch,
                                                   scan_group=tr.scan_group,
                                                   remat_policy=tr.policy), batch["labels"])
    loss.backward()
    if tr.policy is not None:
        tr.policy.clear()
    if loss.is_cuda:
        torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad for k, p in tr.model.named_parameters()}


def grad_errors(cfg, got: dict, want_host: dict) -> dict:
    """Per parameter, max |diff| / max |want| (want on the host); without
    RoPE a key bias (``.bk``) against the max |want| of its block's ``wk``:
    its exact gradient is zero (a bias on every key moves a row's scores by
    one constant), so its own max is rounding."""
    out = {}
    for k, g in got.items():
        w = want_host[k].to(g.device, non_blocking=True)
        scale = want_host[k[:-2] + "wk"] if k.endswith(".bk") and not cfg.rope_theta else w
        out[k] = float((g - w).abs().max() / scale.abs().max().clamp_min(1e-30))
    return out


def float32_trainer(tr, device):
    """``tr``'s arch in float32 at full width: fp32 masters from ``tr``'s
    seed (the values ``tr`` starts from), its plan and its batches; what
    ``train_step1_gate`` and ``grads_of`` read."""
    import dataclasses
    import types

    import torch

    from repro_torch.models import arch_init_params

    cfg = dataclasses.replace(tr.cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(tr.data.state.seed)
    return types.SimpleNamespace(cfg=cfg, model=arch_init_params(cfg, gen, device=device,
                                                                 master=True),
                                 scan_group=tr.scan_group, policy=tr.policy,
                                 batch_at=tr.batch_at)


def train_step1_gate(tr, device, loss_limit: float = TRAIN_LOSS_LIMIT,
                     grad_limit: float = TRAIN_GRAD_LIMIT, gated: bool = True) -> dict:
    """Step 1's loss and gradients on the kernels against the same step on
    the plain versions, and the plain versions against themselves in another
    summation order (the yardstick); each reading held to its fixed limit
    (``loss_limit``, ``grad_limit``) or twice the yardstick's, whichever is
    larger.  ``gated`` False: the readings are printed and hold nothing
    (``STEP1_FLOAT32_ARCHS``).  A MoE runs every step on the plain
    run's expert choice (``pinned_routing``): one unit of rounding can swap a
    token's k-th and (k+1)-th expert, and the random model's loss and
    gradients then move by more than rounding; ``routing`` gives the swaps
    each run would have made on its own upstream and, on its own expert
    choice (unpinned, not gated), the kernels' step's readings."""
    import torch

    from repro_torch.runtime.train import batch_to

    batch = batch_to(tr.batch_at(0), device)
    wrappers = train_wrappers()
    before = {k: w.launches for k, w in wrappers.items() if k != "schedule_dp"}
    moe = bool(tr.cfg.n_experts)
    routes: list = []

    def routing(mode):
        return pinned_routing(routes, mode) if moe else contextlib.nullcontext([])

    t0 = time.perf_counter()
    with plain_training(), routing("record"):
        plain_loss, g = grads_of(tr, batch)
        plain = {k: v.to("cpu") for k, v in g.items()}
    plain_s = time.perf_counter() - t0
    with plain_training(yardstick=True), routing("pin") as yard_swaps:
        yard_loss, g = grads_of(tr, batch)
        yard = grad_errors(tr.cfg, g, plain)
    if {k: w.launches for k, w in wrappers.items() if k != "schedule_dp"} != before:
        raise AssertionError("the plain-version training step launched a kernel")
    t0 = time.perf_counter()
    with routing("pin") as kern_swaps:
        kern_loss, g = grads_of(tr, batch)
    kern_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(v).all()) for v in g.values())
    kern = grad_errors(tr.cfg, g, plain)
    route_out = None
    if moe:
        with routing("free") as free_swaps:
            free_loss, g = grads_of(tr, batch)
            free = grad_errors(tr.cfg, g, plain)
        route_out = {"pinned": True, "router_calls": len(routes),
                     "routings": sum(r[..., 0].numel() for r in routes),
                     "pinned_kernels_swaps": sum(kern_swaps),
                     "pinned_yardstick_swaps": sum(yard_swaps),
                     "unpinned_kernels_swaps": sum(free_swaps),
                     "unpinned_loss_rel_err": abs(free_loss - plain_loss) / abs(plain_loss),
                     "unpinned_grad_rel_err_max": max(free.values())}
    for p in tr.model.parameters():
        p.grad = None
    del g, plain
    loss_err = abs(kern_loss - plain_loss) / abs(plain_loss)
    yard_loss_err = abs(yard_loss - plain_loss) / abs(plain_loss)
    grad_err, yard_grad_err = max(kern.values()), max(yard.values())
    fixed = loss_err <= loss_limit and grad_err <= grad_limit
    by_yardstick = loss_err <= YARDSTICK_FACTOR * max(yard_loss_err, 1e-7) and \
        grad_err <= YARDSTICK_FACTOR * yard_grad_err
    # each reading against its own limit: the fixed one, or twice the
    # yardstick's reading of the same quantity where that is larger
    held_loss = max(loss_limit, YARDSTICK_FACTOR * yard_loss_err)
    held_grad = max(grad_limit, YARDSTICK_FACTOR * yard_grad_err)
    worst = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    yard_worst = sorted(yard.items(), key=lambda kv: -kv[1])[:5]
    if gated and not (finite and math.isfinite(kern_loss) and loss_err <= held_loss
                      and grad_err <= held_grad):
        raise AssertionError(
            f"{tr.cfg.arch_id} ({tr.cfg.dtype}) step 1 differs from the plain versions: loss "
            f"{loss_err:.3g} (limit {loss_limit}, yardstick {yard_loss_err:.3g}), gradients "
            f"{grad_err:.3g} (limit {grad_limit}, yardstick {yard_grad_err:.3g}), "
            f"finite={finite}; worst {worst}, yardstick's worst {yard_worst}")
    return {"gated": gated, "dtype": tr.cfg.dtype,
            "loss_kernels": kern_loss, "loss_plain": plain_loss, "loss_yardstick": yard_loss,
            "loss_rel_err": loss_err, "grad_rel_err_max": grad_err,
            "yardstick_loss_rel_err": yard_loss_err, "yardstick_grad_rel_err_max": yard_grad_err,
            "within_fixed_limits": fixed, "within_yardstick": by_yardstick,
            "limits": {"loss": loss_limit, "grad": grad_limit,
                       "yardstick_factor": YARDSTICK_FACTOR},
            "loss_limit": held_loss, "grad_limit": held_grad,
            "worst_grads": worst, "yardstick_worst_grads": yard_worst,
            "plain_step_s": plain_s, "kernel_step_s": kern_s,
            "grad_tensors": len(kern), "routing": route_out}


def recovery_drill(device, arch: str = TRAIN_ARCH) -> dict:
    """``run_with_recovery`` of ``arch`` at the smoke size on the card: a run
    lost at ``RECOVERY_FAIL_AT`` and restored from its checkpoints against
    the run that never failed; losses and final parameters must be
    bit-identical."""
    import shutil

    import torch

    from repro_torch.launch.train import build_trainer, parse_args
    from repro_torch.runtime.elastic import FailureInjector, run_with_recovery

    runs = []
    for name, fail in (("clean", ()), ("failing", RECOVERY_FAIL_AT)):
        ckpt = ROOT / "build" / f"recovery_{arch}_{name}"
        shutil.rmtree(ckpt, ignore_errors=True)
        tr = build_trainer(parse_args(["--arch", arch, "--smoke", "--device", device.type,
                                       "--batch", "2", "--seq", "128", "--lr", "3e-3"]))
        losses = {}
        state, restarts = run_with_recovery(
            init_state=tr.state, train_step=tr.step_fn, batch_at=tr.batch_at,
            n_steps=RECOVERY_STEPS, ckpt_dir=str(ckpt), ckpt_every=RECOVERY_CKPT_EVERY,
            injector=FailureInjector(fail_at=fail) if fail else None,
            on_metrics=lambda s, m, losses=losses: losses.__setitem__(s, float(m["loss"])),
            reinit=tr.reinit)
        runs.append((state, restarts, losses))
        shutil.rmtree(ckpt, ignore_errors=True)
    (a, r0, la), (b, r1, lb) = runs
    same_params = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    if not (r0 == 0 and r1 == len(RECOVERY_FAIL_AT) and la == lb and same_params
            and a.step == b.step == RECOVERY_STEPS):
        raise AssertionError(f"recovery drill: restarts {r0}/{r1}, losses equal {la == lb}, "
                             f"parameters equal {same_params}")
    return {"steps": RECOVERY_STEPS, "fail_at": list(RECOVERY_FAIL_AT),
            "ckpt_every": RECOVERY_CKPT_EVERY, "restarts": r1, "losses": [la[s] for s in
                                                                          sorted(la)],
            "losses_bit_identical": True, "params_bit_identical": True}


def _numel(defs: dict) -> int:
    return sum(math.prod(d.shape) for d in defs.values())


def encdec_param_split(cfg) -> dict:
    """An encoder-decoder's parameters by the rows they multiply, from the
    port's definitions: ``frames`` (the encoder's layers and final norm, and
    each decoder layer's cross-attention keys and values, which project the
    encoder states) and ``tokens`` (the rest: the decoder's layers and final
    norm, the tied embedding and the learned positions)."""
    from repro_torch.models import blocks
    from repro_torch.models.attention import attn_defs
    from repro_torch.models.decoder import norm_defs
    from repro_torch.models.encdec import MAX_DEC_POSITIONS

    attn, mlp, norm = _numel(attn_defs(cfg)), _numel(blocks.mlp_defs(cfg)), \
        _numel(norm_defs(cfg, "ln"))
    kv = _numel({k: d for k, d in attn_defs(cfg).items() if k in ("wk", "wv", "bk", "bv")})
    frames = cfg.encoder_layers * (attn + mlp + 2 * norm) + norm + cfg.n_layers * kv
    tokens = cfg.n_layers * (2 * attn - kv + mlp + 3 * norm) + norm \
        + (cfg.padded_vocab + MAX_DEC_POSITIONS) * cfg.d_model
    return {"frames": frames, "tokens": tokens}


def train_model_flops(cfg, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> int:
    """Model FLOPs of one training step of ``batch`` x ``seq`` tokens: 6 per
    parameter per row that multiplies it (the embedding tables counted, as
    6 N counts them), plus the mixing the parameters leave out, x3 for the
    backward: attention's scores (4 D per visible pair, every attention
    layer, global or sliding-window) and the SSD's chunked form
    (``ssd_operations`` at the kernel's chunk, C B^T once per group).  A MoE
    counts its active parameters (``cfg.active_param_count()``: the
    non-expert ones and ``top_k / n_experts`` of the experts'); its dense
    dispatch runs every expert on every token, ``n_experts / top_k`` times
    the expert FLOPs credited here (4x for granite-moe-1b-a400m).  An
    encoder-decoder counts its encoder (and the cross-attention keys and
    values) over the ``n_frames`` frames of each row and the rest over the
    decoder tokens (``encdec_param_split``), and the scores of the encoder
    (frames x frames), the decoder (causal) and the cross-attention (tokens x
    frames)."""
    from repro_torch.kernels.ssd import CHUNK

    tokens = batch * seq
    per_pair = 4 * cfg.resolved_head_dim * cfg.n_heads * batch
    if cfg.encoder_layers:
        f = cfg.n_frames
        split = encdec_param_split(cfg)
        params = split["frames"] * batch * f + split["tokens"] * tokens
        attn = per_pair * (cfg.encoder_layers * flash_pairs(f, f, False, None, 0)
                           + cfg.n_layers * (flash_pairs(seq, seq, True, None, 0)
                                             + flash_pairs(seq, f, False, None, 0)))
        return 6 * params + 3 * attn
    attn = per_pair * sum(flash_pairs(seq, seq, True, cfg.attn_window if kind == "attn_local"
                                      else None, 0)
                          for kind in cfg.kinds if kind in ("attn", "attn_local"))
    ssd_ops = 0
    if "ssm" in cfg.kinds:
        cb, rest = ssd_operations(seq, cfg.ssm_head_dim, cfg.ssm_state, CHUNK)
        ssd_ops = batch * (cfg.ssm_groups * cb + cfg.n_ssm_heads * rest) \
            * cfg.kinds.count("ssm")
    return 6 * cfg.active_param_count() * tokens + 3 * (attn + ssd_ops)


def moe_block_ms(cfg, model, device, batch: int, seq: int) -> float:
    """One MoE block's forward and backward (router, dispatch, the weights'
    casts) at the training shape on the first layer's weights,
    median of 5 event-timed calls; the gradients it leaves are dropped."""
    import torch

    from repro_torch.models import blocks
    from repro_torch.models.decoder import working_dtype

    mlp = model.layers[0].mlp
    gen = torch.Generator(device=device).manual_seed(21)
    dt = working_dtype(cfg)
    x = randn(gen, (batch, seq, cfg.d_model), device, dt).requires_grad_()
    dy = randn(gen, (batch, seq, cfg.d_model), device, dt)

    def step():
        blocks.moe(cfg, mlp, x).backward(dy)

    ms = cuda_median_ms(step, reps=5, warmup=1)
    for p in model.parameters():
        p.grad = None
    return ms


def phase_train(device, arch: str = TRAIN_ARCH, phase: str = "train",
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """``arch`` trained at its published width and depth through
    ``launch/train.py``'s path under the planner's residency plan, at
    ``batch`` x ``seq`` tokens (the decoder's, for an encoder-decoder, whose
    batches also carry their frames): the step-1 gate against the plain
    versions, TRAIN_STEPS steps with every training kernel's count set to 0
    just before and read just after, one profiled step (for a MoE also its
    block's share of the step), and the recovery drill at the smoke size;
    printed as ``phase``.  An arch of ``STEP1_FLOAT32_ARCHS`` has its step 1
    gated in float32, and its bf16 reading printed ungated.  In the main
    process (``train``) it is the last profiled phase, and probes what later
    windows keep."""
    import gc

    import torch

    from repro_torch.launch.train import build_trainer, parse_args, train_main

    argv = ["--arch", arch, "--device", device.type, "--steps", str(TRAIN_STEPS),
            "--batch", str(batch), "--seq", str(seq), "--log-every", "1",
            "--ckpt-every", "1000000", "--ckpt-dir", str(ROOT / "build" / f"train_ckpt_{arch}")]
    t0 = time.perf_counter()
    tr = build_trainer(parse_args(argv))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, plan = tr.cfg, tr.plan
    gate = train_step1_gate(tr, device, gated=arch not in STEP1_FLOAT32_ARCHS)
    gate32 = None
    if arch in STEP1_FLOAT32_ARCHS:
        tr32 = float32_trainer(tr, device)
        gate32 = train_step1_gate(tr32, device, FLOAT32_TRAIN_LOSS_LIMIT,
                                  FLOAT32_TRAIN_GRAD_LIMIT)
        del tr32
        torch.cuda.empty_cache()

    wrappers = train_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    step_s, losses = [], []
    state = train_main(argv, trainer=tr,
                       on_step=lambda s, m, dt: (step_s.append(dt),
                                                 losses.append(float(m["loss"]))))
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    want = expected_train_launches(cfg, tr.scan_group, tr.policy)
    per_step = {k: launches[k] / TRAIN_STEPS for k in want}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"train launches per step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"train losses {losses}")
    profile = device_breakdown(lambda: tr.step_fn(state, tr.batch_at(TRAIN_STEPS)), top=8)
    records_after = None
    if phase == "train":
        # do profiled windows after the profiled full-width step keep their
        # records (one such window has been seen to keep 6 of 20)?  Three in
        # a row, with acc_events, without, and with again, so the flag and
        # the order can be told apart
        from repro_torch.kernels import schedule_dp as sdp

        probe = torch.rand((80, 1280), dtype=torch.float64, device=device)
        records_after = {"of": 20, "windows": [
            {"acc_events": acc, "seen": profiler_records_seen(
                lambda: sdp.seq_cumsum(probe), "seq_cumsum", reps=20, acc_events=acc)}
            for acc in (True, False, True)]}
        del probe
    tokens = batch * seq
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    model_flops = train_model_flops(cfg, batch, seq)
    offloaded = tr.policy.offloaded_bytes if tr.policy is not None else 0
    n_params = sum(p.numel() for p in tr.model.parameters())
    reckoned = train_memory_reckoning(cfg, plan, batch, seq, n_params)
    extra = {}
    if cfg.n_experts:
        block_ms = moe_block_ms(cfg, tr.model, device, batch, seq)
        extra["moe"] = {
            "block_fwd_bwd_ms": block_ms, "layers": cfg.n_layers,
            "share_of_step": cfg.n_layers * block_ms / (steady * 1e3),
            "share_of_profiled_busy": cfg.n_layers * block_ms / profile["device_busy_ms"]
            if profile.get("device_busy_ms") else None,
            "computed_over_routed_expert_flops":
                1.0 if sparse_moe(cfg) else cfg.n_experts / cfg.top_k}
    if cfg.encoder_layers:
        extra["frames_per_s"] = batch * cfg.n_frames / steady
        extra["frames"] = cfg.n_frames
        extra["encoder_layers"] = cfg.encoder_layers
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    drill = recovery_drill(device, arch)
    out = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(), "model_params": n_params,
           "dtype": cfg.dtype, "masters": "float32", "batch": batch, "seq": seq,
           "steps": TRAIN_STEPS, "optimizer": "adamw", "init_s": init_s,
           "plan": {"planner": plan.planner, "scan_group": plan.scan_group,
                    "save": list(plan.save_names), "offload": list(plan.offload_names),
                    "remat": sorted(set(_act_classes(cfg)) - set(plan.save_names)
                                    - set(plan.offload_names)),
                    # the reference hands an encoder-decoder no plan: every
                    # layer runs in a recompute region whatever it says
                    "applied": not cfg.encoder_layers,
                    "est_step_time_ms": plan.est_step_time * 1e3,
                    "hbm_budget_bytes": plan.hbm_budget, "hardware": "h100-sxm"},
           "step_s": step_s, "step_ms_steady": steady * 1e3,
           "tokens_per_s": tokens / steady, **extra, "losses": losses,
           "model_flops_per_step": model_flops,
           "mfu_vs_989_tflops": model_flops / steady / PEAK_FLOPS["bfloat16"],
           "max_memory_allocated_bytes": peak, "memory_reckoned": reckoned,
           "offloaded_bytes": offloaded, "launches": launches,
           "launches_per_step": per_step, "expected_launches_per_step": want,
           "step1_gate": gate, "step1_float32_gate": gate32,
           "step1_loss_reproduced_in_training": gate["loss_kernels"] ==
           losses[0], "device_profile_one_step": profile,
           "profiler_records_after_profile": records_after,
           "recovery": drill}
    say(phase, **out,
        note="step_s: wall per step, synchronised by the loss read (the first includes "
             "set-up); step_ms_steady: median of the later steps; tokens_per_s: the "
             "decoder's tokens (an encoder-decoder also frames_per_s); model_flops "
             "(train_model_flops): 6 per parameter per row that multiplies it (a MoE's "
             "active parameters; an encoder-decoder's encoder over its frames) plus the "
             "attention scores (4 D per visible pair) or the SSD's chunked form, x3 for "
             "the backward; memory_reckoned: train_memory_reckoning (what a MoE's "
             "dispatch saves in place of the planner's top-k moe_hidden); moe: one MoE "
             "block's "
             "forward and backward at the training shape, event-timed, x layers against "
             "the steady step and the profiled step's busy time; step1_gate: "
             "train_step1_gate (gated false where step1_float32_gate, the same step "
             "in float32, is the gate: STEP1_FLOAT32_ARCHS); "
             "device_profile_one_step: torch.profiler (acc_events) over one more step; "
             "profiler_records_after_profile (train only): seq_cumsum records a profiled "
             "window of 20 launches kept in each of three windows right after it (with "
             "acc_events, without, with); recovery: the smoke config (a full-width "
             "checkpoint would be ~43 GB per save for recurrentgemma-2b, ~12.5 GB for "
             "mamba2-780m)")
    return out


def _act_classes(cfg) -> set:
    from repro_torch.models.remat import classes_of

    return classes_of(cfg)


# every hand-written kernel: name, its source, the TPU kernel it replaces
KERNELS = (
    ("schedule_dp", "src/repro_torch/kernels/csrc/schedule_dp.cu",
     "src/repro/kernels/schedule_dp.py:334"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:99"),
    ("rglru_scan", "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:41"),
    ("ssd_chunked", "src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:75"),
    # the backwards of K2 and K3: the reference wrote their math in XLA
    # (custom VJPs), not in Pallas, so they replace no TPU kernel
    ("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/flash_xla.py:76"),
    ("rglru_scan_bwd", "src/repro_torch/kernels/csrc/rglru.cu",
     "src/repro/kernels/rglru_xla.py:56"),
    # K4's backward: the reference differentiates through its chunked SSD in
    # jnp (autodiff of a lax.scan), so it too replaces no TPU kernel
    ("ssd_chunked_bwd", "src/repro_torch/kernels/csrc/ssd_bwd.cu",
     "src/repro/kernels/ref.py:205"),
    # a helper of the device-resident round, with no TPU kernel: it replaces
    # the reference's blocked sequential lax.scan of the durations
    ("seq_cumsum", "src/repro_torch/kernels/csrc/schedule_dp.cu",
     "src/repro/core/device_search.py:199"),
)
HELPERS = ("seq_cumsum",)
BACKWARDS = {"flash_attention_bwd": "flash_attention", "rglru_scan_bwd": "rglru_scan",
             "ssd_chunked_bwd": "ssd_chunked"}


def kernel_entries(launches: dict, errs: dict, times: dict, extras: dict) -> list:
    """The ``kernels`` line: one entry per kernel, launches from its main
    path's run, its worst error against its plain version, and its times and
    bound at the main path's shape (``times[name]`` holds ms, plain_ms,
    bound_ms, bound_by and library_ms, which is None where no single PyTorch
    call computes the function)."""
    return [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             **({"helper": True, "tpu_kernel": None} if name in HELPERS else {}),
             **({"backward_of": BACKWARDS[name], "tpu_kernel": None}
                if name in BACKWARDS else {}),
             "launches": launches[name], "max_abs_err": errs[name],
             **{k: times[name].get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
             **extras.get(name, {})}
            for name, source, replaces in KERNELS]


# ---- the multi-device layer: sharding, specs, the dry run -------------------
# (a) granite trained with DTensor parameters on a one-rank mesh; (b) the dry
# run of each trained configuration on a (1, 1) mesh beside its measured
# step; (c) one production-mesh cell.  The dry runs need no card: each runs
# in a process of its own; (b)'s beside the build and the kernels' gates,
# where nothing is timed, read before the first timed phase; (c)'s (~2 min of
# one CPU core) beside the training children, read in the phase.
DIST_ARCH = MOE_ARCH
DIST_STEPS = 2
DIST_K2_PER_STEP = 24          # granite: K2 and K2 bwd once per layer a step
CALIBRATION = (("train", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ),
               ("train_ssm", SSM_TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ),
               ("train_moe", MOE_ARCH, TRAIN_BATCH, TRAIN_SEQ),
               ("train_encdec", ENCDEC_ARCH, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ))
PRODUCTION_DRY_RUN = {"arch": "llama3-405b", "cell": "train_4k", "multi_pod": True}
DRY_RUN_TIMEOUT = 600


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def calibration_specs() -> dict:
    """(b)'s dry runs by name: each trained configuration at its training
    shape on a (1, 1) mesh under the planner's plan for one H100."""
    return {phase: {"arch": arch, "cell": f"train_{batch}x{seq}", "batch": batch, "seq": seq,
                    "multi_pod": False, "mesh_shape": [1, 1], "plan": True}
            for phase, arch, batch, seq in CALIBRATION}


def dry_run_main(spec: str) -> int:
    """``--dry-run SPEC``: one ``launch.dryrun`` cell in this process (no card:
    a fake process group of the mesh's size and fake tensors).  ``SPEC`` is a
    JSON object: arch, cell (with batch and seq, a train cell of that shape),
    multi_pod, mesh_shape, plan (the planner's residency plan for one H100,
    as the trainer takes it), smoke (the smoke config), layers (a depth).
    The record's keys are the last line; the exit code is 0 when its status
    is ok."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as dr

    s = json.loads(spec)
    cfg = get_smoke_config(s["arch"]) if s.get("smoke") else get_config(s["arch"])
    if s.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=s["layers"])
    kw = {"cfg_override": cfg}
    if s.get("batch"):
        cell = ShapeCell(s["cell"], s["seq"], s["batch"], "train")
        dr.CELLS[s["cell"]] = cell
        if s.get("plan"):
            from repro_torch.plan import H100, plan_residency

            plan = plan_residency(get_config(s["arch"]), cell, n_devices=1, n_data_shards=1,
                                  n_model_shards=1, optimizer="adamw", use_tabu=False, hw=H100,
                                  torch_device="cpu")
            kw["remat_policy"] = plan.policy()
            if cfg.n_layers % plan.scan_group == 0:
                kw["scan_group"] = plan.scan_group
    if s.get("mesh_shape"):
        kw["mesh_shape"] = tuple(s["mesh_shape"])
    rec = dr.run_cell(s["arch"], s["cell"], multi_pod=s["multi_pod"], force=True,
                      out_dir=str(ROOT / "build" / "dryrun_torch"), **kw)
    print(json.dumps({k: rec.get(k) for k in (
        "arch", "cell", "mesh", "status", "error", "memory_analysis", "cost_analysis",
        "collectives", "n_devices", "time_lower_s", "time_step_s", "scan_group",
        "remat_policy")}), flush=True)
    return 0 if rec["status"] == "ok" else 1


def start_dry_runs(specs: dict) -> dict:
    """Each spec's ``--dry-run`` in a process of its own, all started now."""
    return {name: subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dry-run",
                                    json.dumps(spec)], cwd=ROOT, text=True,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for name, spec in specs.items()}


def collect_dry_runs(procs: dict) -> dict:
    """Each dry run's record (its last line) once its process has ended;
    raises if one failed or its status is not ok."""
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=DRY_RUN_TIMEOUT)
            lines = stdout.strip().splitlines()
            rec = json.loads(lines[-1]) if lines else {}
            if proc.returncode != 0 or rec.get("status") != "ok":
                raise AssertionError(f"dry run {name} failed (exit {proc.returncode}): "
                                     f"{rec.get('error')} {stderr[-2000:]}")
            out[name] = rec
    finally:
        stop(procs)
    return out


def stop(procs: dict) -> None:
    """End every process of ``procs`` that is still running."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def sharded_grads_of(tr, batch, rules):
    """Loss and gradients (each rank's shards, by parameter name) of one step
    of ``tr``'s model, whose parameters are DTensors, on ``batch`` placed by
    ``rules``."""
    import torch

    from repro_torch.models import arch_forward, cross_entropy_loss
    from repro_torch.runtime.train import shard_batch
    from repro_torch.sharding import get_mesh
    from repro_torch.sharding.partitioning import active

    for p in tr.model.parameters():
        p.grad = None
    with active(rules):
        placed = shard_batch(batch, get_mesh(), rules)
        loss = cross_entropy_loss(tr.cfg, arch_forward(tr.cfg, tr.model, placed, rules=rules,
                                                       scan_group=tr.scan_group,
                                                       remat_policy=tr.policy),
                                  placed["labels"])
        loss.backward()
    if tr.policy is not None:
        tr.policy.clear()
    if loss.to_local().is_cuda:
        torch.cuda.synchronize()
    return float(loss.detach().full_tensor()), {k: p.grad.to_local() for k, p in
                                                tr.model.named_parameters()}


def sharded_train(device, arch: str = DIST_ARCH, batch: int = TRAIN_BATCH,
                  seq: int = TRAIN_SEQ, steps: int = DIST_STEPS, smoke: bool = False) -> dict:
    """(a): ``arch``'s trainer, step 1 unsharded (the expert choice recorded
    for a MoE), then its parameters made DTensors on a one-rank (1, 1)
    ("data", "model") mesh (NCCL on the card, gloo on the host) under
    ``arch_rules``: step 1 again on the recorded expert choice, held to the
    unsharded one at ``train_moe``'s limits (bit-equality is the reading),
    then ``steps`` sharded steps through ``make_train_step(rules=)`` with
    every training kernel's count set to 0 just before and read just after,
    held on the card to what the plan implies."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import arch_rules
    from repro_torch.launch.train import build_trainer, parse_args
    from repro_torch.models import distribute_params
    from repro_torch.runtime import TrainState, adamw, make_train_step
    from repro_torch.runtime.train import batch_to
    from repro_torch.sharding import set_mesh
    from repro_torch.sharding.partitioning import is_dtensor

    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        tr = build_trainer(parse_args(["--arch", arch, "--device", device.type, "--batch",
                                       str(batch), "--seq", str(seq),
                                       *(["--smoke"] if smoke else [])]))
        data = batch_to(tr.batch_at(0), device)
        routes: list = []

        def routing(mode):
            return pinned_routing(routes, mode) if tr.cfg.n_experts else \
                contextlib.nullcontext([])

        with routing("record"):
            loss0, g = grads_of(tr, data)
            want = {k: v.to("cpu") for k, v in g.items()}
        del g
        for p in tr.model.parameters():
            p.grad = None
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device.type)
        rules = arch_rules(tr.cfg, ShapeCell("train_cfg", seq, batch, "train"), mesh)
        set_mesh(mesh)
        # the trainer's unsharded state (the parameters and AdamW moments it
        # holds) goes: the sharded steps hold their own
        tr.state = tr.step_fn = tr.reinit = None
        distribute_params(tr.model, mesh, rules)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        wrappers = train_wrappers()
        before = {k: w.launches for k, w in wrappers.items()}
        with routing("pin") as swaps:
            loss1, g = sharded_grads_of(tr, data, rules)
        step1_launches = {k: w.launches - before[k] for k, w in wrappers.items()}
        finite = all(bool(torch.isfinite(v).all()) for v in g.values())
        errs = grad_errors(tr.cfg, g, want)
        del g, want
        for p in tr.model.parameters():
            p.grad = None
        loss_err = abs(loss1 - loss0) / abs(loss0)
        grad_err = max(errs.values())
        if not (finite and loss_err <= TRAIN_LOSS_LIMIT and grad_err <= TRAIN_GRAD_LIMIT):
            raise AssertionError(f"{arch}: the sharded step 1 differs from the unsharded one: "
                                 f"loss {loss_err:.3g}, gradients {grad_err:.3g}, "
                                 f"finite={finite}")
        params = dict(tr.model.named_parameters())
        opt = adamw()
        step = make_train_step(tr.cfg, opt, tr.model, rules=rules, scan_group=tr.scan_group,
                               remat_policy=tr.policy)
        state = TrainState(params=params, opt_state=opt.init(params), step=0)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for w in wrappers.values():
            w.launches = 0
        step_s, losses = [], []
        for i in range(steps):
            t1 = time.perf_counter()
            state, m = step(state, tr.batch_at(i))
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t1)
        launches = {k: w.launches for k, w in wrappers.items()}
        expected = expected_train_launches(tr.cfg, tr.scan_group, tr.policy)
        per_step = {k: launches[k] / steps for k in expected}
        if device.type == "cuda" and (
                per_step != {k: float(v) for k, v in expected.items()}
                or per_step["flash_attention"] != DIST_K2_PER_STEP
                or per_step["flash_attention_bwd"] != DIST_K2_PER_STEP):
            raise AssertionError(f"sharded train launches per step {per_step}, "
                                 f"expected {expected}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"sharded train losses {losses}")
        sample = params["layers.0.attn.wq"]
        return {"arch": arch, "batch": batch, "seq": seq, "steps": steps, "backend": backend,
                "mesh": {"data": 1, "model": 1}, "rules": {"params": rules.params,
                                                         "acts": rules.acts},
                "all_params_dtensors": all(is_dtensor(p) for p in params.values()),
                "sample_placements": str(sample.placements),
                "step1_loss_unsharded": loss0, "step1_loss_sharded": loss1,
                "step1_loss_rel_err": loss_err, "step1_grad_rel_err_max": grad_err,
                "step1_bit_equal": loss1 == loss0 and grad_err == 0.0,
                "step1_limits": {"loss": TRAIN_LOSS_LIMIT, "grad": TRAIN_GRAD_LIMIT},
                "step1_routing_swaps": sum(swaps), "step1_launches": step1_launches,
                "launches": launches, "launches_per_step": per_step,
                "expected_launches_per_step": expected, "losses": losses, "step_s": step_s,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None,
                "seconds": time.perf_counter() - t0}
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def distributed(device) -> dict:
    """The ``--distributed`` child: (a) on the card."""
    t0 = time.perf_counter()
    trained = sharded_train(device)
    return {"sharded_train": trained,
            "phase_seconds": {"distributed": time.perf_counter() - t0}}


# (d): the multi-rank semantics on the card's machine: gloo ranks on its CPU
# with its torch, port against port (it has no JAX), each case sharded and
# unsharded from the same parameters at the gloo tests' sizes and gates.
# This holds the card's DTensor, not the device path.  (e): the dry-run
# cells that stopped on the card's torch, beside the training children.
MULTI_RANK_WORLD = 8
MULTI_RANK_TIMEOUT = 300
MULTI_RANK_TRAIN = (("heads_tp", (4, 2)), ("qseq_tp", (1, 8)))
MULTI_RANK_GATES = {"loss_abs_err": 1e-3, "grad_norm_rel_err": 1e-3, "decode_rel_err": 2e-3,
                    "pipeline_out_err": 1e-5, "pipeline_grad_err": 1e-4}
FOLD_DRY_RUNS = {
    "granite_t_4x2": {"arch": MOE_ARCH, "cell": "t", "batch": 8, "seq": 64, "layers": 2,
                      "multi_pod": False, "mesh_shape": [4, 2]},
    "granite_t_2x2x2": {"arch": MOE_ARCH, "cell": "t", "batch": 8, "seq": 64, "layers": 2,
                        "multi_pod": True, "mesh_shape": [2, 2, 2]},
    "qseq_production": {"arch": QWEN_ARCH, "cell": "train_4k", "multi_pod": False},
}


def multi_rank_train(shape: tuple) -> dict:
    """qwen2.5-14b's smoke train step (batch 8 x 32, AdamW) unsharded, then
    with DTensor parameters on a ("data", "model") mesh of ``shape``:
    heads-TP where its 4 heads divide "model", else q-sequence TP."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Decoder, distribute_params
    from repro_torch.models.common import init_params_
    from repro_torch.runtime import SyntheticLM, TrainState, adamw, make_train_step
    from repro_torch.sharding import make_rules, set_mesh

    cfg = get_smoke_config(QWEN_ARCH)
    batch = SyntheticLM(cfg, batch=8, seq_len=32, seed=0).batch_at(0)

    def step(model, rules=None):
        params = dict(model.named_parameters())
        opt = adamw(lr=1e-2)
        _, m = make_train_step(cfg, opt, model, rules=rules)(
            TrainState(params=params, opt_state=opt.init(params), step=0),
            {k: torch.as_tensor(v) for k, v in batch.items()})
        return float(m["loss"]), float(m["grad_norm"])

    def model():
        return init_params_(Decoder(cfg, device="cpu", master=True),
                            torch.Generator().manual_seed(0))

    loss0, norm0 = step(model())
    heads = cfg.n_heads % shape[1] == 0
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    rules = make_rules(shard_heads=heads, qseq_tp=not heads, batch_axes=("data",))
    set_mesh(mesh)
    try:
        sharded = distribute_params(model(), mesh, rules)
        loss, norm = step(sharded, rules)
        wq = dict(sharded.named_parameters())["layers.0.attn.wq"]
    finally:
        set_mesh(None)
    return {"arch": QWEN_ARCH + " (smoke)", "mesh": list(shape),
            "tp": "heads" if heads else "q-sequence", "seq_axis": rules.acts["seq"],
            "wq_placements": str(wq.placements), "loss": loss, "unsharded_loss": loss0,
            "loss_abs_err": abs(loss - loss0), "grad_norm": norm,
            "unsharded_grad_norm": norm0, "grad_norm_rel_err": abs(norm - norm0) / norm0}


def multi_rank_decode() -> dict:
    """llama3-405b's smoke config: 16 decode steps with the KV cache sharded
    along its sequence over "model" on a (1, 8) mesh, against the full
    forward of the same tokens (max |error| over max |logit|)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Decoder, arch_decode_step, arch_forward, arch_init_cache
    from repro_torch.models.common import init_params_
    from repro_torch.sharding import make_rules, set_mesh
    from repro_torch.sharding.partitioning import is_dtensor

    cfg = get_smoke_config("llama3-405b")
    model = init_params_(Decoder(cfg, device="cpu"), torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        full = arch_forward(cfg, model, {"tokens": tokens})
    mesh = make_mesh((1, 8), ("data", "model"), device_type="cpu")
    rules = make_rules(shard_heads=False, batch_axes=())
    set_mesh(mesh)
    try:
        cache = arch_init_cache(cfg, tokens.shape[0], 32, device="cpu")
        worst = 0.0
        with torch.no_grad():
            for t in range(tokens.shape[1]):
                lg, cache = arch_decode_step(cfg, model, cache, tokens[:, t:t + 1], t,
                                             rules=rules)
                worst = max(worst, float((lg - full[:, t]).abs().max()))
    finally:
        set_mesh(None)
    return {"arch": "llama3-405b (smoke)", "mesh": [1, 8], "steps": int(tokens.shape[1]),
            "decode_rel_err": worst / float(full.abs().max()),
            "cache_sharded": all(is_dtensor(c["k"]) and str(c["k"].placements)
                                 == "(Replicate(), Shard(dim=1))" for c in cache)}


def multi_rank_pipeline() -> dict:
    """The 4-stage pipeline on a ("stage", "data") 4 x 2 mesh against the
    stages applied in turn on one rank: outputs and the weights' gradients."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import pipeline_apply

    n_stages, lps, d = 4, 2, 16
    rng = np.random.default_rng(0)
    w0 = (rng.standard_normal((n_stages, lps, d, d)) / np.sqrt(d)).astype(np.float32)
    x = torch.tensor(rng.standard_normal((6, 4, d)).astype(np.float32))

    def stage_fn(p, xx):
        for i in range(lps):
            xx = torch.tanh(xx @ p[i])
        return xx

    plain_w = torch.tensor(w0, requires_grad=True)
    y = x
    for s in range(n_stages):
        y = stage_fn(plain_w[s], y)
    (y ** 2).sum().backward()
    w = torch.tensor(w0, requires_grad=True)
    out = pipeline_apply(make_mesh((4, 2), ("stage", "data"), device_type="cpu"), w, x,
                         stage_fn)
    (out ** 2).sum().backward()
    return {"stages": n_stages, "mesh": [4, 2],
            "pipeline_out_err": float((out.detach() - y.detach()).abs().max()),
            "pipeline_grad_err": float((w.grad - plain_w.grad).abs().max())}


def multi_rank_main() -> int:
    """``--multi-rank``: this process is rank ``RANK`` of a gloo group of
    ``WORLD_SIZE`` CPU ranks on ``localhost:MASTER_PORT``; it runs (d)'s
    cases in turn, and rank 0 prints their readings as its last line."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="tcp://localhost:" + os.environ["MASTER_PORT"],
                            rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=MULTI_RANK_TIMEOUT))
    try:
        t0 = time.perf_counter()
        out = {name: multi_rank_train(shape) for name, shape in MULTI_RANK_TRAIN}
        out["seq_sharded_decode"] = multi_rank_decode()
        out["pipeline"] = multi_rank_pipeline()
        out["rank_seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


MULTI_RANK_LOGS = ROOT / "build" / "multi_rank"


def start_multi_rank(world: int = MULTI_RANK_WORLD, logs: Path = MULTI_RANK_LOGS) -> dict:
    """(d)'s ranks, each ``chip_smoke.py --multi-rank`` in a process of its
    own, all started now; rank r's output goes to ``logs/rank{r}.out|err``."""
    import os

    port = free_port()
    logs.mkdir(parents=True, exist_ok=True)
    procs = {}
    for r in range(world):
        with open(logs / f"rank{r}.out", "w") as out, open(logs / f"rank{r}.err", "w") as err:
            procs[r] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--multi-rank"], cwd=ROOT,
                stdout=out, stderr=err,
                env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                     "MASTER_PORT": str(port)})
    return procs


def collect_multi_rank(procs: dict, logs: Path = MULTI_RANK_LOGS) -> dict:
    """Rank 0's readings once every rank has ended, held to (d)'s gates
    (:func:`check_multi_rank`); raises if a rank failed."""
    import torch

    t0 = time.perf_counter()
    try:
        for proc in procs.values():
            proc.wait(timeout=max(1.0, MULTI_RANK_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        stop(procs)
    bad = [r for r, p in procs.items() if p.returncode != 0]
    if bad:
        raise AssertionError(f"multi-rank: rank {bad[0]} failed (exit {procs[bad[0]].returncode})"
                             f": {(logs / f'rank{bad[0]}.err').read_text()[-3000:]}")
    lines = (logs / "rank0.out").read_text().strip().splitlines()
    if not lines:
        raise AssertionError("multi-rank: rank 0 printed no readings")
    return {**check_multi_rank(json.loads(lines[-1])), "torch": torch.__version__,
            "backend": "gloo", "world": len(procs), "seconds": time.perf_counter() - t0}


def check_multi_rank(out: dict) -> dict:
    """(d)'s readings with each gate's verdict; raises on any case outside
    its gate, or a decode whose cache was not sharded."""
    failed = []
    for case, got in out.items():
        if not isinstance(got, dict):
            continue
        for key, limit in MULTI_RANK_GATES.items():
            if key in got and not got[key] < limit:     # a NaN fails too
                failed.append(f"{case}: {key} {got[key]} (limit {limit})")
    if not out.get("seq_sharded_decode", {}).get("cache_sharded"):
        failed.append("seq_sharded_decode: the cache was not sharded along its sequence")
    missing = {*dict(MULTI_RANK_TRAIN), "seq_sharded_decode", "pipeline"} - set(out)
    if missing:
        failed.append(f"cases missing: {sorted(missing)}")
    if failed:
        raise AssertionError("multi-rank: " + "; ".join(failed))
    return {**out, "gates": MULTI_RANK_GATES,
            "check": "the card's torch DTensor on gloo CPU ranks, port against port "
                     "(sharded against unsharded from the same parameters); not the device "
                     "path"}


def per_device(rec: dict) -> dict:
    """A dry run's record as (c) and (e) print it: per device (rank 0)."""
    coll = rec["collectives"]
    return {"arch": rec["arch"], "cell": rec["cell"], "mesh": rec["mesh"],
            "n_devices": rec["n_devices"], "status": rec["status"],
            "argument_bytes_per_device": rec["memory_analysis"]["argument_size_in_bytes"],
            "peak_bytes_per_device": rec["memory_analysis"]["peak_bytes"],
            "flops_per_device": rec["cost_analysis"]["flops"],
            "bytes_accessed_per_device": rec["cost_analysis"]["bytes accessed"],
            "wire_bytes_per_device": coll["total_wire_bytes"],
            "collective_counts": coll["counts"], "wire_bytes_by_kind": coll["wire_bytes"],
            "dry_run_seconds": rec["time_step_s"]}


def calibration(dry: dict, trains: dict) -> dict:
    """(b): each trained configuration's dry run on the (1, 1) mesh against
    its measured step: reckoned peak bytes over the measured
    ``max_memory_allocated``, and the dry run's flops (the ops the step runs,
    recomputation and the dense dispatch included) over ``train_model_flops``
    and over the step's model flops (``model_flops_per_step``)."""
    from repro_torch.configs import get_config

    out = {}
    for phase, arch, batch, seq in CALIBRATION:
        rec, got = dry[phase], trains[phase]
        peak = rec["memory_analysis"]["peak_bytes"]
        flops = rec["cost_analysis"]["flops"]
        model = train_model_flops(get_config(arch), batch, seq)
        out[phase] = {"arch": arch, "batch": batch, "seq": seq,
                      "reckoned_peak_bytes": peak,
                      "measured_max_memory_allocated_bytes": got["max_memory_allocated_bytes"],
                      "peak_ratio": peak / got["max_memory_allocated_bytes"],
                      "reckoned_argument_bytes": rec["memory_analysis"]["argument_size_in_bytes"],
                      "dry_run_flops": flops, "train_model_flops": model,
                      "flops_ratio": flops / model,
                      "reckoned_bytes_accessed": rec["cost_analysis"]["bytes accessed"],
                      "measured_step_ms": got["step_ms_steady"],
                      "dry_run_step_s": rec["time_step_s"]}
    return out


def phase_distributed(trains: dict, calibration_runs: dict, beside: dict) -> dict:
    """The multi-device layer (``--distributed`` in a child process, after the
    training phases): (a) the sharded train step, with (d) the multi-rank
    cases on gloo CPU ranks beside it, (b) the dry runs of the trained
    configurations (``calibration_runs``, their records) held against their
    measured steps, (c) the production-mesh cell and (e) the cells that
    stopped on the card's torch, whose processes (``beside``, from
    ``start_dry_runs``) are read here; printed as ``distributed``."""
    ranks = start_multi_rank()
    try:
        out = run_child("--distributed", "the multi-device phase")
        multi_rank = collect_multi_rank(ranks)
    finally:
        stop(ranks)
    t0 = time.perf_counter()
    dry = {**calibration_runs, **collect_dry_runs(beside)}
    out["phase_seconds"]["production_wait"] = time.perf_counter() - t0
    line = {"sharded_train": out["sharded_train"], "calibration": calibration(dry, trains),
            "production": per_device(dry["production"]), "multi_rank": multi_rank,
            "strict_fold_cells": {name: per_device(dry[name]) for name in FOLD_DRY_RUNS},
            "dry_runs": dry}
    say("distributed", **line,
        note="sharded_train: granite at 1 x 4096 with DTensor parameters on a one-rank NCCL "
             "(1, 1) mesh under arch_rules, step 1 against the unsharded step on the "
             "recorded expert choice, then DIST_STEPS steps through make_train_step(rules=) "
             "with K2 / K2 bwd launched through local_map; calibration: launch/dryrun.py on "
             "a fake (1, 1) mesh at each trained configuration's shape under the planner's "
             "plan, against the measured step (peak: MemTracker; flops: FlopCounterMode's "
             "formulas over the ops run, recomputation included; train_model_flops: 6 N "
             "per row plus the mixing); production: llama3-405b train_4k on a fake 2 x 16 x "
             "16 mesh, per device (rank 0); bytes accessed are unfused; multi_rank: gloo CPU "
             "ranks under the card's torch, port against port, heads-TP 4 x 2, q-sequence "
             "TP 1 x 8, the sequence-sharded decode 1 x 8, the 4-stage pipeline; "
             "strict_fold_cells: the dry-run cells that folded a sharded dim (granite's t "
             "cell, 2 layers, on 4 x 2 and 2 x 2 x 2; qwen2.5-14b train_4k on 16 x 16, "
             "q-sequence TP), status ok")
    return {**out, "line": line}



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
    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    # the distributed phase's (b): dry runs that need no card, beside the
    # build and the kernels' gates (nothing there is timed), read before the
    # first timed phase
    calibration_procs = start_dry_runs(calibration_specs())
    try:
        t0 = time.perf_counter()
        _build.build()                      # one nvcc per source, all at once
        for name in _build.KERNEL_SOURCES:
            _build.load(name)
        say("build", kernels=sorted(_build.KERNEL_SOURCES), flags=list(_build.NVCC_FLAGS),
            seconds=time.perf_counter() - t0, build_dir=str(_build.build_dir()))
        phase_ptxas(sorted(_build.KERNEL_SOURCES))
        worst = timed("kernels", phase_kernels, device)
        model_err = timed("model_kernels", phase_model_kernels, device)
        calibration_runs = timed("calibration_dry_runs_wait", collect_dry_runs,
                                 calibration_procs)
    finally:
        stop(calibration_procs)
    launches, max_rows, main_wall = timed("main_path", phase_main_path)
    device_launches, device_ctx = timed("device_path", phase_device_path, device, main_wall)
    crash_launches = timed("crash_resume", phase_crash_resume, device, device_ctx)
    cum = timed("seq_cumsum", phase_seq_cumsum, device, 80)
    cli_launches = timed("analysis_cli", phase_analysis_cli)
    model_launches = timed("model_serve " + ARCH, phase_model_serve, device, ARCH,
                           check_fixed_limit)
    mamba_launches = timed("model_serve " + MAMBA_ARCH, phase_model_serve, device, MAMBA_ARCH,
                           check_against_yardstick)
    qwen_launches = timed("model_serve " + QWEN_ARCH, phase_model_serve, device, QWEN_ARCH,
                          check_attention_yardstick)
    timing = timed("timing", phase_timing, device, max_rows)
    mtime = timed("model_timing", run_child, "--model-timing", "the kernels' timing")
    service_launches = timed("solve_service", phase_solve_service, device)
    # last in this process: after its profiled full-width step the profiler
    # has been seen to drop most kernel records of later windows (6 of 20
    # launches), which the earlier phases' profiled gates and timings must
    # not meet
    train = timed("train", phase_train, device)
    # (c)'s and (e)'s dry runs need no card and a CPU core each (llama3-405b's
    # ~1.5 min, qwen2.5-14b's ~1 min): they run beside the training children
    # and are read in the distributed phase
    production = start_dry_runs({"production": PRODUCTION_DRY_RUN, **FOLD_DRY_RUNS})
    try:
        # then mamba2-780m's training and the MoE, encoder-decoder and vision
        # serves, each in a process of its own, once this one has taken its last
        # profiled window
        ssm = timed("train_ssm child", phase_train_ssm)
        phase_s.update(ssm.pop("phase_seconds"))
        moe_train = timed("train_moe child", phase_train_moe)
        phase_s.update(moe_train.pop("phase_seconds"))
        encdec_train = timed("train_encdec child", phase_train_encdec)
        phase_s.update(encdec_train.pop("phase_seconds"))
        # the multi-device layer, after the steps its dry runs are held against
        dist_out = timed("distributed child", phase_distributed,
                         {"train": train, "train_ssm": ssm, "train_moe": moe_train,
                          "train_encdec": encdec_train}, calibration_runs, production)
        phase_s.update(dist_out["phase_seconds"])
        dl = dist_out["sharded_train"]["launches"]
        slice_out = timed("slice_serves", phase_slice_serves)
        phase_s.update(slice_out["phase_seconds"])
        slice_launches, slice_times = slice_out["launches"], slice_out["timings"]

        fwd, tails = timing["forward"], timing["tails"]
        by_path = launches_by_path({"main_path": {"schedule_dp": launches},
                                    "device_path": device_launches,
                                    "crash_resume": crash_launches,
                                    "solve_service": service_launches,
                                    "analysis_cli torch": cli_launches["torch"],
                                    "analysis_cli device": cli_launches["device"],
                                    "train": {"schedule_dp": train["launches"]["schedule_dp"]},
                                    "train_ssm": {"schedule_dp": ssm["launches"]["schedule_dp"]},
                                    "train_moe": {
                                        "schedule_dp": moe_train["launches"]["schedule_dp"]},
                                    "train_encdec": {
                                        "schedule_dp": encdec_train["launches"]["schedule_dp"]}})
        tl, sl = train["launches"], ssm["launches"]
        ml, el = moe_train["launches"], encdec_train["launches"]
        fb, rb = mtime["flash_attention_bwd"], mtime["rglru_scan_bwd"]
        sb = mtime["ssd_chunked_bwd"]
        fl, rg, sd = mtime["flash_attention"], mtime["rglru_scan"], mtime["ssd_chunked"]
        fq, fc = mtime["flash_attention_qwen2.5-14b"], mtime["flash_attention_codeqwen1.5-7b"]
        entries = kernel_entries(
            launches={"schedule_dp": launches, "flash_attention": qwen_launches["flash_attention"],
                      "rglru_scan": model_launches["rglru_scan"],
                      "ssd_chunked": mamba_launches["ssd_chunked"],
                      "seq_cumsum": device_launches["seq_cumsum"],
                      "flash_attention_bwd": tl["flash_attention_bwd"],
                      "rglru_scan_bwd": tl["rglru_scan_bwd"],
                      "ssd_chunked_bwd": sl["ssd_chunked_bwd"]},
            errs={"schedule_dp": worst, **model_err, "seq_cumsum": cum["max_abs_err"]},
            times={"schedule_dp": fwd, **mtime, "flash_attention": fq, "seq_cumsum": cum},
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
                                    "path": "model_serve " + QWEN_ARCH,
                                    "launches_by_path": {
                                        "model_serve " + QWEN_ARCH:
                                            qwen_launches["flash_attention"],
                                        "model_serve " + ARCH: model_launches["flash_attention"],
                                        **{"model_serve " + arch: got["flash_attention"]
                                           for arch, got in slice_launches.items()},
                                        "train": tl["flash_attention"],
                                        "train_moe": ml["flash_attention"],
                                        "train_encdec": el["flash_attention"],
                                        "distributed": dl["flash_attention"]},
                                    "library": fq["library"], "shape": fq["shape"],
                                    "dtype": "bfloat16", "device_ms": fq["device_ms"],
                                    "shape_" + ARCH: {k: fl[k] for k in (
                                        "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "library")},
                                    **{"shape_" + name: {k: t[k] for k in (
                                        "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "library")}
                                       for name, t in (("codeqwen1.5-7b", fc),
                                                       *slice_times.items())}},
                "flash_attention_bwd": {
                    "path": "train", "launches_per_step": train["launches_per_step"][
                        "flash_attention_bwd"],
                    "launches_by_path": {"train": tl["flash_attention_bwd"],
                                         "train_moe": ml["flash_attention_bwd"],
                                         "train_encdec": el["flash_attention_bwd"],
                                         "distributed": dl["flash_attention_bwd"]},
                    "max_abs_err_f32": model_err["flash_attention_bwd_f32"],
                    "device_ms": fb["device_ms"], "library": fb["library"], "shape": fb["shape"],
                    "dtype": fb["dtype"], "operations": fb["operations"],
                    "kernel_operations": fb["kernel_operations"],
                    "achieved_tflops": fb["achieved_tflops"], "kernels": fb["kernels"],
                    "device_ms_by_kernel": fb["device_ms_by_kernel"],
                    **{"shape_" + name: {k: mtime["flash_attention_bwd_" + name][k] for k in (
                        "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library", "achieved_tflops")}
                       for name in (MOE_ARCH, ENCDEC_ARCH + " cross")}},
                "rglru_scan_bwd": {
                    "path": "train", "launches_per_step": train["launches_per_step"][
                        "rglru_scan_bwd"],
                    "launches_by_path": {"train": tl["rglru_scan_bwd"]},
                    "device_ms": rb["device_ms"], "shape": rb["shape"], "dtype": rb["dtype"],
                    "group": rb["group"], "warps": rb["warps"],
                    "device_ms_by_group": rb["device_ms_by_group"], "chain_ms": rb["chain_ms"],
                    "event_minus_device_ms": rb["event_minus_device_ms"],
                    "wrapper_host_ms": rb["wrapper_host_ms"]},
                "rglru_scan": {"shape": rg["shape"], "dtype": "float32 scan (bfloat16 model)",
                               "launches_by_path": {"model_serve " + ARCH:
                                                    model_launches["rglru_scan"],
                                                    "train": tl["rglru_scan"]},
                               "device_ms": rg["device_ms"],
                               "decode_step_ms": rg["decode_step_ms"],
                               "decode_step_device_ms": rg["decode_step_device_ms"],
                               "decode_step_bound_ms": rg["decode_step_bound_ms"],
                               "decode_step_bound_by": rg["decode_step_bound_by"],
                               "training_shape": rg["training_shape"]},
                "ssd_chunked_bwd": {
                    "path": "train_ssm", "launches_per_step": ssm["launches_per_step"][
                        "ssd_chunked_bwd"],
                    "launches_by_path": {"train_ssm": sl["ssd_chunked_bwd"]},
                    "max_abs_err_f32": model_err["ssd_chunked_bwd_f32"],
                    "max_rel_err": model_err["ssd_chunked_bwd_rel"],
                    "device_ms": sb["device_ms"], "shape": sb["shape"], "dtype": sb["dtype"],
                    "operations": sb["operations"], "achieved_tflops": sb["achieved_tflops"],
                    "kernels": sb["kernels"], "device_ms_by_kernel": sb["device_ms_by_kernel"],
                    "grids": sb["grids"], "blocks": sb["blocks"],
                    "resources": sb["resources"], "entry_points": sb["entry_points"],
                    "event_minus_device_ms": sb["event_minus_device_ms"],
                    "scratch_bytes": sb["scratch_bytes"]},
                "ssd_chunked": {"shape": sd["shape"], "dtype": sd["dtype"],
                                "launches_by_path": {"model_serve " + MAMBA_ARCH:
                                                     mamba_launches["ssd_chunked"],
                                                     "train_ssm": sl["ssd_chunked"]},
                                "device_ms": sd["device_ms"],
                                "training_shape": sd["training_shape"],
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
                               "chain_ms": cum["chain_ms"], "chain_share": cum["chain_share"],
                               "add_chain_ms_per_add": cum["add_chain_ms_per_add"],
                               "library_device_ms": cum["library_device_ms"],
                               "library_device_ms_by_kernel": cum["library_device_ms_by_kernel"],
                               "decision": cum["decision"],
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

    finally:
        stop(production)

CHILDREN = {"--slice-serves": slice_serves, "--train-ssm": train_ssm,
            "--train-moe": train_moe, "--train-encdec": train_encdec,
            "--model-timing": phase_model_timing, "--distributed": distributed}


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dry-run":
        sys.exit(dry_run_main(sys.argv[2]))
    if sys.argv[1:] == ["--multi-rank"]:
        sys.exit(multi_rank_main())
    child = CHILDREN.get(sys.argv[1]) if len(sys.argv) == 2 else None
    sys.exit(child_main(child) if child is not None else main())
