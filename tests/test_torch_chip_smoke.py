"""The plumbing of ``chip_smoke.py`` that needs no GPU: its refusal to run
without one, the candidate batches it builds, the byte/operation bounds it
computes (K1 to K4, seq_cumsum), the host-phase timers it wraps around the
search round and the device engine, the device path's parity check and K1
call, the launch counts it expects of each served arch, and its ``kernels``
line."""
import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import solve
from repro_torch.core import TSParams, random_instance
from repro_torch.core import tabu as port_tabu
from repro_torch.core.eval_batch import BatchEvaluator, PackedSolutions
from repro_torch.kernels import schedule_dp as sdp

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU refusal")
def test_without_a_gpu_it_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr


@pytest.fixture(scope="module")
def operands(smoke):
    inst, cands = smoke.candidate_batch(3, 33, 90, 12)
    assert len(cands) == 12
    return smoke.sweep_operands(inst, cands, np.float64, torch.device("cpu"))


def test_operands_are_what_the_evaluator_hands_the_sweep(operands):
    eng, packed, graph, dur, mpred, msucc = operands
    assert dur.shape == mpred.shape == msucc.shape == (12, 64)
    assert dur.dtype == torch.float64 and mpred.dtype == torch.int32
    ev = eng.evaluate(packed, tails=True)
    start, finish, level, n_done, q = sdp.sweep(graph, dur, mpred, msucc, tails=True)
    feas = (n_done == graph.n).numpy()
    assert np.array_equal(feas, ev.feasible)
    assert 0 < feas.sum() < len(feas)          # mixed cyclic / acyclic rows
    assert np.array_equal(finish.numpy()[feas][:, :graph.n], ev.finish[feas])
    assert np.array_equal(q.numpy()[feas][:, :graph.n], ev.q[feas])


@pytest.mark.parametrize("tails", [False, True])
def test_bound_counts_each_operand_once(smoke, operands, tails):
    _, _, graph, dur, mpred, msucc = operands
    _, finish, _, n_done, _ = sdp.sweep(graph, dur, mpred, msucc, tails=tails)
    b, n_b = dur.shape
    bound = smoke.sweep_bound(graph, dur, mpred, msucc, finish, n_done, tails)
    # forward only: dur 8 + mpred 4 in, start 8 + finish 8 + level 4 out per
    # task, n_done per row, the shared predecessor CSR (n_b + 1 offsets and
    # the real links, what the kernel reads) once; no q
    n_links = int((graph.pred_mat >= 0).sum())
    assert n_links == int((graph.succ_mat >= 0).sum())
    want = 32 * b * n_b + 4 * b + 4 * (n_b + 1 + n_links)
    if tails:                                  # msucc in, q out, successor CSR
        want += (4 + 8) * b * n_b + 4 * (n_b + 1 + n_links)
    assert bound["bytes"] == want
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])
    assert bound["bytes_ms"] == want / smoke.HBM_BYTES_PER_S * 1e3
    assert bound["operations"] > 0
    assert bound["bound_by"] in ("bytes", "operations")


def test_bound_operations_follow_the_data(smoke, operands):
    """A cyclic row fires fewer tasks, so it needs fewer operations."""
    _, _, graph, dur, mpred, msucc = operands
    _, finish, _, n_done, _ = sdp.sweep(graph, dur, mpred, msucc, tails=False)
    feas = n_done == graph.n

    def ops(rows):
        return smoke.sweep_bound(graph, dur[rows], mpred[rows], msucc[rows],
                                 finish[rows], n_done[rows], False)["operations"]

    per_feasible = ops(feas) / int(feas.sum())
    per_cyclic = ops(~feas) / int((~feas).sum())
    assert per_cyclic < per_feasible


def test_host_timers_cover_the_round_and_restore_what_they_wrap(smoke):
    before = (BatchEvaluator.evaluate, PackedSolutions.apply_moves,
              port_tabu.memory_update, port_tabu.exact_schedule)
    inst = random_instance(0, n_tasks=40, n_data=90)
    kw = dict(walks=3, seed=0, torch_device="cpu",
              params=TSParams(top_k=10, max_unimproved=10**9, time_limit=10**9, max_iters=5))
    plain = solve(inst, "tabu_multiwalk", **kw)
    with smoke.HostTimers() as log:
        t0 = time.perf_counter()
        rep = solve(inst, "tabu_multiwalk", **kw)
        wall = time.perf_counter() - t0
        host = log.breakdown(wall)
    assert (rep.makespan, rep.history) == (plain.makespan, plain.history)
    assert before == (BatchEvaluator.evaluate, PackedSolutions.apply_moves,
                      port_tabu.memory_update, port_tabu.exact_schedule)
    assert set(host) == set(log.targets) | {"other"}
    for phase in ("evaluate", "backward_tails", "approx_ranking", "memory_update",
                  "exact_schedule", "n7_moves", "change_core_moves"):
        assert host[phase]["calls"] > 0 and host[phase]["s"] > 0, phase
    assert host["other"]["s"] >= 0                 # the phases do not nest
    assert abs(sum(v["s"] for v in host.values()) - wall) < 1e-9
    assert log.max_rows > 0 and log.max_levels > 0
    log.reset()
    assert log.calls["evaluate"] == 0 and log.max_rows == 0


# --------------------------------------------------------------------------- #
# device path: the timers, the parity check, seq_cumsum's operands and bound #
# --------------------------------------------------------------------------- #
def test_device_timers_cover_the_device_run_and_restore_what_they_wrap(smoke):
    from repro_torch.core import api
    from repro_torch.core import device_search as ds

    before = (api.multiwalk_inits, ds.memory_update, ds.exact_schedule, ds._Launch.run,
              ds._Launch._capture)
    inst = random_instance(0, n_tasks=40, n_data=90)
    kw = dict(walks=2, seed=0, torch_device="cpu", device={"sync_every": 4},
              params=TSParams(top_k=10, max_unimproved=10**9, time_limit=10**9, max_iters=9))
    plain = solve(inst, "tabu_device", **kw)
    with smoke.HostTimers(smoke.device_targets()) as log:
        t0 = time.perf_counter()
        rep = solve(inst, "tabu_device", **kw)
        host = log.breakdown(time.perf_counter() - t0)
    assert (rep.makespan, rep.history) == (plain.makespan, plain.history)
    assert before == (api.multiwalk_inits, ds.memory_update, ds.exact_schedule,
                      ds._Launch.run, ds._Launch._capture)
    # Alg-3 on the two inits and at the two syncs before the budget ends
    assert host["memory_update"]["calls"] >= 2 + 2 * 2
    assert host["sync_period"]["calls"] == 3 and host["capture"]["calls"] == 0
    assert host["exact_schedule"]["calls"] > 0 and host["greedy_inits"]["calls"] == 1
    assert smoke.walk_iters_per_s(8, 30, 2.0) == 120.0


def test_same_trajectory_compares_what_parity_means(smoke):
    from repro_torch.core import device_search as ds
    from repro_torch.core.api import multiwalk_inits
    from repro_torch.core.tabu import tabu_multiwalk

    inst = random_instance(2, n_tasks=40, n_data=90)
    inits, _ = multiwalk_inits(inst, 2, 0)
    p = TSParams(top_k=5, max_unimproved=15, time_limit=10**9, max_iters=12, seed=0,
                 mem_update_period=ds.MEM_UPDATE_DISABLED, torch_device="cpu")
    ref = tabu_multiwalk(inst, [s.copy() for s in inits], TSParams(**{
        **{f: getattr(p, f) for f in ("top_k", "max_unimproved", "time_limit", "max_iters",
                                      "seed", "mem_update_period")}, "backend": "numpy"}))
    dev = ds.device_multiwalk(inst, [s.copy() for s in inits], p,
                              config=ds.DeviceConfig(sync_every=8))
    assert smoke.same_trajectory(dev, ref)
    short = ds.device_multiwalk(inst, [s.copy() for s in inits],
                                TSParams(**{**p.__dict__, "max_iters": 6}),
                                config=ds.DeviceConfig(sync_every=8))
    assert not smoke.same_trajectory(short, ref)


@pytest.mark.parametrize("windows, passes", [
    ([(24, 32)], True),                        # the capture's nodes x 8 replays
    ([(23, 32), (24, 32)], True),              # a window that dropped a record, retaken
    ([(0, 0)] * 3, False),                     # the replays ran no K1
    ([(24, 31)] * 3, False),
])
def test_replayed_round_profile_holds_the_launches_to_the_capture(smoke, monkeypatch,
                                                                  windows, passes):
    """The launches the profiler sees in replays must be the captured
    round's nodes times the replays, in one of at most three windows."""
    replayed, seen = [], iter(windows)

    class Launch:
        class graph:
            @staticmethod
            def replay():
                replayed.append(1)

    def breakdown(fn, top):
        fn()
        k1, cs = next(seen)
        return {"by_class": {"K1 schedule_dp": {"launches": k1, "ms": 1.0},
                             "seq_cumsum": {"launches": cs, "ms": 1.0}}}

    monkeypatch.setattr(smoke, "device_breakdown", breakdown)
    stats = {"k1_per_round": 3, "seq_cumsum_per_round": 4}
    if passes:
        prof, counts = smoke.replayed_round_profile(Launch, stats, replays=8)
        assert counts[-1] == {"K1 schedule_dp": 24, "seq_cumsum": 32}
        assert len(counts) == len(windows) and len(replayed) == 8 * len(windows)
    else:
        with pytest.raises(AssertionError, match="the capture recorded"):
            smoke.replayed_round_profile(Launch, stats, replays=8)
        assert len(replayed) == 24


def test_cumsum_operands_and_bound(smoke):
    from repro_torch.instances import pack_instance

    inst = random_instance(0, n_tasks=40, n_data=90)
    ip = pack_instance(inst)
    v = smoke.cumsum_operands(inst, 12, 0, torch.device("cpu"))
    assert v.shape == (12, len(ip.in_idx)) and v.dtype == torch.float64
    e = len(inst.in_idx)
    assert (v[:, :e] > 0).all() and not v[:, e:].any()     # zeros past the real edges
    got = sdp.seq_cumsum(v)
    want = np.concatenate([np.zeros((12, 1)), np.cumsum(v.numpy(), axis=1)], axis=1)
    assert np.array_equal(got.numpy(), want)
    bound = smoke.cumsum_bound(v)
    rows, width = v.shape
    assert bound["bytes"] == 8 * rows * width + 8 * rows * (width + 1)
    assert bound["operations"] == rows * width
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])
    assert bound["bound_by"] == "bytes"


def test_sweep_launch_check_holds_the_device_call_against_the_plain_version(smoke, operands):
    _, _, graph, dur, mpred, msucc = operands
    _, _, _, n_done, _ = sdp.sweep(graph, dur, mpred, msucc, tails=False)
    active = n_done == graph.n
    active[::2] = False
    assert smoke.check_sweep_launch(graph, dur, mpred, msucc, active) == 0.0


# --------------------------------------------------------------------------- #
# model path: K2 / K3 bounds, the plain-version swap, teacher forcing          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,skv,causal,window,qoff", [
    (4096, 4096, True, 2048, 0), (100, 1000, False, None, 0), (100, 1000, True, 300, 900),
    (77, 77, True, 48, 0), (8, 8, True, None, -3)])
def test_flash_pairs_count_the_mask(smoke, sq, skv, causal, window, qoff):
    if sq > 1000:          # the serving shape: 2048 * 2049 / 2 + 2048 * 2048
        assert smoke.flash_pairs(sq, skv, causal, window, qoff) == 6_292_480
        return
    qp = qoff + np.arange(sq)[:, None]
    kp = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    assert smoke.flash_pairs(sq, skv, causal, window, qoff) == int(mask.sum())


def test_flash_bound_at_the_serving_shape(smoke):
    meta = torch.device("meta")
    q = torch.empty((4, 4096, 10, 256), dtype=torch.bfloat16, device=meta)
    k = torch.empty((4, 4096, 1, 256), dtype=torch.bfloat16, device=meta)
    bound = smoke.flash_bound(q, k, k, causal=True, window=2048, q_offset=0)
    assert bound["pairs"] == 6_292_480 * 40
    assert bound["operations"] == 4 * 256 * 6_292_480 * 40           # 257.7 GFLOP
    assert bound["bytes"] == 2 * (2 * q.numel() + 2 * k.numel())     # q, k, v in, out
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == bound["operations"] / 989e12 * 1e3
    lse = smoke.flash_bound(q, k, k, causal=True, window=2048, q_offset=0, with_lse=True)
    assert lse["bytes"] == bound["bytes"] + 4 * 4 * 4096 * 10


def test_rglru_bound_at_the_serving_shape(smoke):
    a = torch.empty((4, 4096, 2560), device="meta")
    bound = smoke.rglru_bound(a, None)
    assert bound["bytes"] == 503_316_480 and bound["bound_by"] == "bytes"
    assert smoke.rglru_bound(a, torch.empty((4, 2560), device="meta"))["bytes"] == \
        503_316_480 + 4 * 4 * 2560


def test_rglru_bound_of_a_decode_step(smoke):
    """One step at batch 4, width 2560: a, x~, h0 read and y written, 16 bytes
    a channel (0.16 MB, ~0.05 us at 3.35 TB/s)."""
    a = torch.empty((4, 1, 2560), device="meta")
    bound = smoke.rglru_bound(a, torch.empty((4, 2560), device="meta"))
    assert bound["bytes"] == 4 * 2560 * 16 == 163_840 and bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == 163_840 / 3.35e12 * 1e3


def test_plain_kernels_swap_the_ops_and_restore_them(smoke):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import ssd

    before = (ops.flash_attention, ops.rglru_scan, ops.ssd_chunked)
    q = torch.randn((1, 9, 2, 8), generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 5, 4), generator=torch.Generator().manual_seed(1))
    sargs = smoke.ssd_operands((1, 70, 2, 8, 1, 8), torch.float32, torch.device("cpu"))
    with smoke.plain_kernels():
        assert all(a is not b for a, b in zip(
            (ops.flash_attention, ops.rglru_scan, ops.ssd_chunked), before))
        assert torch.equal(ops.flash_attention(q, q[:, :, :1], q[:, :, :1], window=3),
                           fa.flash_attention_torch(q, q[:, :, :1], q[:, :, :1], window=3))
        y, h = ops.rglru_scan(x, torch.zeros(4), x.sigmoid(), x.sigmoid())
        want = rg.rglru_scan_torch(x, torch.zeros(4), x.sigmoid(), x.sigmoid())
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])
        assert ops.ssd_chunked is ssd.ssd_chunked_torch
        y, h = ops.ssd_chunked(*sargs)
        assert y.shape == (1, 70, 2, 8) and h.shape == (1, 2, 8, 8)
    assert (ops.flash_attention, ops.rglru_scan, ops.ssd_chunked) == before


def test_teacher_forcing_reproduces_the_served_tokens(smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config("recurrentgemma-2b")
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(5))
    res = serve(cfg, model, prompts, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, prompts, torch.from_numpy(res.ids), "cpu")
    assert len(logits) == 5
    greedy = torch.stack([lg[:, :cfg.vocab_size].argmax(-1) for lg in logits], 1)
    assert np.array_equal(greedy.numpy(), res.ids)
    with smoke.plain_kernels():
        again = smoke.teacher_forced_logits(cfg, model, prompts, torch.from_numpy(res.ids), "cpu")
    assert max(smoke.rel_err(a, b) for a, b in zip(again, logits)) == 0.0


def test_operands_have_the_asked_shapes_and_types(smoke):
    cpu = torch.device("cpu")
    q, k, v, kw = smoke.flash_operands((2, 77, 77, 10, 1, 256, True, 48, 0), torch.bfloat16, cpu)
    assert q.shape == (2, 77, 10, 256) and k.shape == v.shape == (2, 77, 1, 256)
    assert q.dtype == torch.bfloat16 and kw == dict(causal=True, window=48, q_offset=0)
    x, ap, ig, ag, h0 = smoke.rglru_operands((3, 10, 20, False), torch.float32, cpu)
    assert x.shape == ig.shape == ag.shape == (3, 10, 20) and ap.shape == (20,) and h0 is None
    assert ((ig > 0) & (ig < 1)).all()
    x, dt, a_log, bm, cm, d, h0 = smoke.ssd_operands((2, 9, 4, 16, 2, 8), torch.bfloat16, cpu)
    assert x.shape == (2, 9, 4, 16) and dt.shape == (2, 9, 4) and a_log.shape == d.shape == (4,)
    assert bm.shape == cm.shape == (2, 9, 2, 8) and h0.shape == (2, 4, 16, 8)
    assert x.dtype == bm.dtype == cm.dtype == torch.bfloat16
    assert dt.dtype == h0.dtype == torch.float32 and (dt > 0).all()
    assert smoke.ssd_operands((2, 9, 4, 16, 2, 8), torch.float32, cpu, False)[5:] == (None, None)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 256>(Params)", "K2"),
    ("void (anonymous namespace)::flash_fwd_kernel<256>(Params)", "K2"),
    ("void (anonymous namespace)::tc::flash_fwd_mma_kernel<256>(Params, int)", "K2"),
    ("(anonymous namespace)::rglru_scan_kernel(float const*, float const*)", "K3"),
    ("void (anonymous namespace)::rglru_scan_kernel<true>(float const*, float const*)", "K3"),
    ("(anonymous namespace)::rglru_scan_step_kernel(float const*, float const*)", "K3"),
    ("void (anonymous namespace)::ssd_chunk_kernel<__nv_bfloat16>(Params)", "K4"),
    ("(anonymous namespace)::tc::ssd_chunk_mma_kernel(Params, int)", "K4"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void (anonymous namespace)::sweep_kernel<double, true>(int const*, ...)", "K1"),
    ("(anonymous namespace)::seq_cumsum_kernel(double const*, double*, int)", "seq_cumsum")])
def test_profile_classes_name_the_kernels(smoke, name, cls):
    assert smoke._kernel_class(name).startswith(cls)


def test_ssd_bound_at_the_serving_shape(smoke):
    """At the kernel's chunk 64: C B^T once per (batch, group), 4 x 1 x 64
    chunks x 2 q^2 N, and 4 x 48 heads x 64 chunks x (2 q^2 P + 4 q N P):
    32.5 GFLOP, which the bf16 prefill runs on the tensor cores, so its bound
    is the bytes' (x and y in bf16, dt, B, C, h0, h_last: ~225 MB, 0.067 ms).
    At the fp32 rate (C B^T at the bf16 rate, the rest at 67 TFLOP/s) the same
    work takes ~0.48 ms.  The chunked form with C B^T per head is 45.1 GFLOP;
    the TPU kernel's count, per head at chunk 128, is 64.4 GFLOP."""
    meta = torch.device("meta")
    x = torch.empty((4, 4096, 48, 64), dtype=torch.bfloat16, device=meta)
    bm = torch.empty((4, 4096, 1, 128), dtype=torch.bfloat16, device=meta)
    d, h0 = torch.empty(48, device=meta), torch.empty((4, 48, 64, 128), device=meta)
    bound = smoke.ssd_bound(x, bm, d, h0, chunk=64)
    cb = 4 * 1 * 64 * 2 * 64 * 64 * 128
    rest = 4 * 48 * 64 * (2 * 64 * 64 * 64 + 4 * 64 * 128 * 64)
    assert bound["cb_operations"] == cb == 268_435_456
    assert bound["operations"] == cb + rest == 32_480_690_176
    assert bound["kernel_operations"] == rest + 48 * cb == 45_097_156_608
    per_chunk_128 = 2 * 128 * 128 * 128 + 3 * 2 * 128 * 128 * 64
    assert bound["tpu_operations"] == 4 * 48 * 32 * per_chunk_128 == 64_424_509_440
    assert bound["bytes"] == (2 * x.numel() * 2 + 4 * 4096 * 48 * 4 + 2 * bm.numel() * 2
                              + 2 * 48 * 4 + 2 * h0.numel() * 4) == 225_444_224
    assert bound["precision"] == "bf16 tensor cores"
    assert bound["bound_by"] == "bytes" and bound["bound_ms"] == bound["bytes"] / 3.35e12 * 1e3
    assert bound["ops_ms"] == (cb + rest) / 989e12 * 1e3
    assert bound["fp32_rate_bound_by"] == "operations"
    assert bound["fp32_rate_bound_ms"] == (cb / 989e12 + rest / 67e12) * 1e3
    assert round(bound["fp32_rate_bound_ms"], 3) == 0.481
    # in float32 every product runs at the fp32 rate, C B^T too
    bound32 = smoke.ssd_bound(x.float(), bm.float(), d, h0, chunk=64)
    assert bound32["precision"] == "fp32 CUDA cores"
    assert bound32["bound_ms"] == bound32["operations"] / 67e12 * 1e3
    assert bound32["fp32_rate_bound_ms"] == bound32["bound_ms"]


@pytest.mark.parametrize("t,precision", [(1, "fp32 CUDA cores"), (2, "bf16 tensor cores"),
                                         (4096, "bf16 tensor cores")])
def test_ssd_bound_follows_the_kernels_precision(smoke, t, precision):
    """bf16 x/B/C over T >= 2 steps take the tensor-core kernel, whose bound
    counts every product at the bf16 rate; a bf16 decode step (T = 1) keeps
    the CUDA-core kernel and the fp32-rate count.  At the serving shape the
    bf16-rate bound is set by bytes (0.067 ms) and the fp32-rate figure
    (0.481 ms, set by operations) is still reported beside it."""
    from repro_torch.kernels import ssd

    meta = torch.device("meta")
    x = torch.empty((4, t, 48, 64), dtype=torch.bfloat16, device=meta)
    bm = torch.empty((4, t, 1, 128), dtype=torch.bfloat16, device=meta)
    d, h0 = torch.empty(48, device=meta), torch.empty((4, 48, 64, 128), device=meta)
    bound = smoke.ssd_bound(x, bm, d, h0, chunk=ssd.CHUNK)
    assert bound["precision"] == precision
    assert ssd.on_tensor_cores(torch.bfloat16, t) == (precision == "bf16 tensor cores")
    assert not ssd.on_tensor_cores(torch.float32, t)
    if precision == "fp32 CUDA cores":
        assert bound["bound_ms"] == bound["fp32_rate_bound_ms"]
    else:
        assert bound["ops_ms"] == bound["operations"] / 989e12 * 1e3
        assert bound["ops_ms"] <= bound["fp32_rate_ops_ms"]
    if t == 4096:
        assert bound["bound_by"] == "bytes" and round(bound["bound_ms"], 3) == 0.067
        assert bound["fp32_rate_bound_by"] == "operations"
        assert round(bound["fp32_rate_bound_ms"], 3) == 0.481


def test_ssd_bound_of_a_decode_step_is_the_state(smoke):
    meta = torch.device("meta")
    x = torch.empty((4, 1, 48, 64), dtype=torch.bfloat16, device=meta)
    bm = torch.empty((4, 1, 1, 128), dtype=torch.bfloat16, device=meta)
    h0 = torch.empty((4, 48, 64, 128), device=meta)
    bound = smoke.ssd_bound(x, bm, torch.empty(48, device=meta), h0, chunk=64)
    assert bound["bound_by"] == "bytes"
    # h0 and h_last (12.6 MB) and one step of x, y, dt, B, C, a_log, d_skip
    assert bound["bytes"] == 2 * h0.numel() * 4 + 2 * x.numel() * 2 + 4 * 48 * 4 \
        + 2 * bm.numel() * 2 + 2 * 48 * 4 == 12_635_264
    assert abs(bound["bound_ms"] - 0.00377) < 1e-5
    ragged = smoke.ssd_bound(torch.empty((1, 300, 2, 8), device=meta),
                             torch.empty((1, 300, 1, 4), device=meta), None, None, chunk=64)
    qs = (64, 64, 64, 64, 44)
    cb, rest = sum(2 * q * q * 4 for q in qs), sum(2 * q * q * 8 + 4 * q * 4 * 8 for q in qs)
    assert (ragged["cb_operations"], ragged["operations"]) == (cb, cb + 2 * rest)
    assert ragged["kernel_operations"] == 2 * (cb + rest)
    per = [2 * q * q * 4 + 2 * q * q * 8 + 4 * q * 4 * 8 for q in (128, 128, 44)]
    assert ragged["tpu_operations"] == 2 * sum(per)


@pytest.mark.parametrize("arch,want", [
    ("recurrentgemma-2b", {"flash_attention": 8, "rglru_scan": 18 * 32, "ssd_chunked": 0}),
    ("mamba2-780m", {"flash_attention": 0, "rglru_scan": 0, "ssd_chunked": 48 * 32})])
def test_expected_launches_of_each_served_arch(smoke, arch, want):
    from repro_torch.configs import get_config

    assert smoke.expected_launches(get_config(arch), smoke.SERVE_GEN) == want
    assert set(smoke.model_kernel_wrappers()) == set(want)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_6928a1a22tc20flash_fwd_mma_kernelILi256EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_6928a1a22tc20flash_fwd_mma_kernelILi256EEEvNS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_fcb81b1a16ssd_chunk_kernelI13__nv_bfloat16EEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_fcb81b1a16ssd_chunk_kernelI13__nv_bfloat16EEvNS_6ParamsE
    40 bytes stack frame, 36 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_6928a1a216flash_fwd_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 109 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_kernel_function(smoke):
    report = smoke.ptxas_report(PTXAS_LOG)
    assert [f["kernel"] for f in report] == [
        "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_6928a1a22tc20flash_fwd_mma_kernel"
        "ILi256EEEvNS_6ParamsEi",
        "_ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_fcb81b1a16ssd_chunk_kernelI13__nv_bfloat16EEvNS_"
        "6ParamsE",
        "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_6928a1a216flash_fwd_kernelILi64EEEvNS_"
        "6ParamsE"]
    assert report[0] == {"kernel": report[0]["kernel"], "registers": 232, "stack": 0,
                         "spill_stores": 0, "spill_loads": 0, "static_smem": 0}
    assert (report[1]["registers"], report[1]["stack"], report[1]["spill_stores"],
            report[1]["spill_loads"], report[1]["static_smem"]) == (128, 40, 36, 60, 16)
    assert report[2]["registers"] == 109 and report[2]["spill_loads"] == 0


def test_ptxas_gate_refuses_spills_and_stacks_where_it_must(smoke):
    """A tensor-core kernel must not spill; a K1 or K3 kernel must use neither
    spills nor a stack frame; others (here the f32 SSD kernel) may."""
    def fn(kernel, stack=0, spills=0):
        return {"kernel": kernel, "registers": 32, "stack": stack, "spill_stores": spills,
                "spill_loads": spills, "static_smem": 0}

    clean = {"ssd": [fn("ssd_chunk_kernelIfE", 40, 36), fn("tc20ssd_chunk_mma_kernel")],
             "schedule_dp": [fn("sweep_kernelIdLb1E")], "rglru": [fn("rglru_scan_kernelILb1E")]}
    assert smoke.ptxas_faults(clean) == []
    assert smoke.ptxas_faults(smoke_report(smoke)) == []
    for lib, bad in (("schedule_dp", fn("sweep_kernelIdLb0E", stack=24)),
                     ("rglru", fn("rglru_scan_step_kernel", spills=8)),
                     ("ssd", fn("tc20ssd_chunk_mma_kernel", spills=4))):
        faults = smoke.ptxas_faults({**clean, lib: clean[lib] + [bad]})
        assert len(faults) == 1 and bad["kernel"] in faults[0]
    assert set(smoke.NO_STACK_LIBRARIES) == {"schedule_dp", "rglru"}


def smoke_report(smoke):
    """PTXAS_LOG read as the flash_attention and ssd libraries' report."""
    return {"flash_attention": smoke.ptxas_report(PTXAS_LOG)[::2],
            "ssd": smoke.ptxas_report(PTXAS_LOG)[1:2]}


def test_kernels_line_lists_every_kernel_with_its_keys(smoke):
    names = [k[0] for k in smoke.KERNELS]
    assert names == ["schedule_dp", "flash_attention", "rglru_scan", "ssd_chunked",
                     "seq_cumsum"]
    times = {n: {"ms": 1.0 + i, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes",
                 "library_ms": None} for i, n in enumerate(names)}
    entries = smoke.kernel_entries(
        launches=dict(zip(names, (30, 8, 576, 1536, 1000))), errs=dict.fromkeys(names, 0.0),
        times=times, extras={"ssd_chunked": {"decode_step_ms": 0.01}})
    assert [e["name"] for e in entries] == names
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert keys <= set(e) and e["route"] == "cuda"
        assert (ROOT / e["source"]).is_file()
        path, line = e["replaces"].split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line) - 1].startswith("def "), e["replaces"]
        # a helper has no TPU kernel: it names the reference function it
        # replaces, which reaches no pallas_call
        assert ("pallas_call" in (ROOT / path).read_text()) != e.get("helper", False)
    helper = entries[4]
    assert helper["replaces"] == "src/repro/core/device_search.py:199"
    assert helper["tpu_kernel"] is None and "_seq_cumsum" in (ROOT / "src/repro/core/"
                                                              "device_search.py").read_text(
    ).splitlines()[198]
    k4 = entries[3]
    assert k4["replaces"] == "src/repro/kernels/ssd.py:75" and k4["launches"] == 1536
    assert k4["library_ms"] is None and k4["decode_step_ms"] == 0.01
    assert k4["source"] == "src/repro_torch/kernels/csrc/ssd.cu"


def test_teacher_forcing_reproduces_the_served_mamba2_tokens(smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config("mamba2-780m")
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(5))
    res = serve(cfg, model, prompts, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, prompts, torch.from_numpy(res.ids), "cpu")
    greedy = torch.stack([lg[:, :cfg.vocab_size].argmax(-1) for lg in logits], 1)
    assert np.array_equal(greedy.numpy(), res.ids)


def test_plain_ssd_chunk_sums_in_another_order_and_restores(smoke):
    from repro_torch.kernels import ops, ssd

    args = smoke.ssd_operands((1, 100, 2, 8, 1, 8), torch.float32, torch.device("cpu"))
    y64, h64 = ssd.ssd_chunked_torch(*args)
    with smoke.plain_kernels(ssd_chunk=smoke.YARDSTICK_CHUNK):
        y32, h32 = ops.ssd_chunked(*args)
    assert ops.ssd_chunked is ssd.ssd_chunked and ssd.CHUNK == 64
    assert not torch.equal(y32, y64)
    torch.testing.assert_close(y32, y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h32, h64, rtol=1e-5, atol=1e-5)


def test_float32_teacher_forced_check_on_the_cpu(smoke):
    """On the CPU the kernels' route is the plain versions: the reading is 0."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("mamba2-780m")
    prompts = torch.randint(1, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(6))
    ids = torch.randint(1, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(7))
    out = smoke.float32_teacher_forced(cfg, prompts, ids, torch.device("cpu"))
    assert out["float32_teacher_forced_rel_err"] == [0.0, 0.0, 0.0]
    assert out["float32_teacher_forced_limit"] == smoke.FLOAT32_TEACHER_FORCED_LIMIT


def test_checks_hold_the_served_logits_to_their_limits(smoke):
    """The bf16 mamba2 limit is measured in the run: twice the plain versions'
    worst step against themselves at chunk 32 (here on the smoke model, whose
    two chunk lengths differ in float32 rounding only)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import arch_init_params

    cpu = torch.device("cpu")
    cfg = get_smoke_config("mamba2-780m")
    model = arch_init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(9))
    ids = torch.randint(1, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(10))
    plain = smoke.teacher_forced_logits(cfg, model, prompts, ids, cpu)
    out = smoke.check_against_yardstick(cfg, model, prompts, ids, cpu, [0.0] * 3, plain)
    yardstick = out["plain_vs_plain_other_chunk_rel_err"]
    assert len(yardstick) == 3 and 0.0 < max(yardstick) < 1e-5
    assert out["teacher_forced_limit"] == smoke.YARDSTICK_FACTOR * max(yardstick)
    assert out["float32_teacher_forced_rel_err"] == [0.0] * 3
    with pytest.raises(AssertionError, match="more than"):
        smoke.check_against_yardstick(cfg, model, prompts, ids, cpu,
                                      [0.0, 2.5 * max(yardstick), 0.0], plain)
    assert smoke.check_fixed_limit(cfg, model, prompts, ids, cpu, [3e-3], plain) == {
        "teacher_forced_limit": smoke.TEACHER_FORCED_LIMIT}
    with pytest.raises(AssertionError, match="limit"):
        smoke.check_fixed_limit(cfg, model, prompts, ids, cpu, [5e-3], plain)


# --------------------------------------------------------------------------- #
# solve_service: the profile, the parity helper, the lanes on the CPU         #
# --------------------------------------------------------------------------- #
def test_serve_profile_and_trace_are_the_references(smoke):
    from benchmarks import serve_bench

    from repro_torch.core.device_search import MEM_UPDATE_DISABLED

    ref = serve_bench.profile(smoke=False)
    prof = smoke.SERVE_PROFILE
    assert (prof.families, prof.n_requests, prof.walks, prof.rate, prof.batch_sizes,
            prof.sync_every, prof.crit_cap) == (ref.families, ref.n_requests, ref.walks,
                                                ref.rate, ref.batch_sizes, ref.sync_every,
                                                ref.crit_cap)
    assert (ref.budget.max_iters, ref.budget.time_limit, ref.budget.max_evals) == \
        (prof.max_iters, None, None)
    mine, want = smoke.serve_params(), serve_bench.serve_params()
    for f in ("max_unimproved", "time_limit", "top_k", "mem_update_period", "mem_refresh_every",
              "n_change_core_positions", "seed", "max_iters", "max_evals"):
        assert getattr(mine, f) == getattr(want, f), f
    assert mine.mem_update_period == MEM_UPDATE_DISABLED
    items, arrivals = smoke.serve_trace(prof, seed=0)
    ref_items, ref_arrivals = serve_bench.build_trace(ref, 0)
    assert np.array_equal(arrivals, ref_arrivals) and len(items) == 36
    for a, b in zip(items, ref_items):
        assert (a["family"], a["seed"]) == (b["family"], b["seed"])
        for f in ("proc_time", "data_size", "mem_cap", "access_time", "task_edges",
                  "in_idx", "out_idx", "data_mem_ok"):
            assert np.array_equal(getattr(a["instance"], f), getattr(b["instance"], f)), f


def test_same_report_compares_what_parity_means(smoke):
    import dataclasses

    from repro_torch import Budget

    inst = random_instance(0, n_tasks=24, n_data=60)
    kw = dict(walks=2, budget=Budget(max_iters=4), backend="numpy", seed=1)
    a, b = (solve(inst, "tabu_multiwalk", **kw) for _ in range(2))
    assert smoke.same_report(a, b)
    sol = a.solution
    assign = sol.assign.copy()
    assign[0] += 1
    seqs = [list(s) for s in sol.proc_seq]
    moved = next(i for i, s in enumerate(seqs) if s)
    seqs[moved], seqs[(moved + 1) % len(seqs)] = seqs[(moved + 1) % len(seqs)], seqs[moved]
    for changed in (dataclasses.replace(a, makespan=a.makespan + 1e-9),
                    dataclasses.replace(a, history=a.history[:-1]),
                    dataclasses.replace(a, n_exact_evals=a.n_exact_evals + 1),
                    dataclasses.replace(a, solution=dataclasses.replace(sol, assign=assign)),
                    dataclasses.replace(a, solution=dataclasses.replace(sol, proc_seq=seqs))):
        assert not smoke.same_report(changed, b)


def test_launches_by_path_adds_the_service(smoke):
    by = smoke.launches_by_path({"main_path": {"schedule_dp": 30},
                                 "device_path": {"schedule_dp": 177, "seq_cumsum": 236},
                                 "solve_service": {"schedule_dp": 960, "seq_cumsum": 1280}})
    assert by == {"schedule_dp": {"main_path": 30, "device_path": 177, "solve_service": 960},
                  "seq_cumsum": {"device_path": 236, "solve_service": 1280}}


TINY = dict(families=(("random_layered", {"n_tasks": 24, "n_data": 60}),
                      ("out_tree", {"n_tasks": 20}), ("fft", {"width": 4, "stages": 2})),
            walks=2, max_iters=4, rate=50.0, batch_sizes=(1, 2), sync_every=2, crit_cap=32)


def test_service_lane_on_the_cpu(smoke, monkeypatch):
    import asyncio

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    prof = smoke.ServeProfile(n_requests=5, **TINY)
    params = smoke.serve_params()
    items, arrivals = smoke.serve_trace(prof, seed=0)
    started = []
    out = asyncio.run(smoke.run_service(items, arrivals, prof, params, "cpu",
                                        on_start=started.append))
    assert started == [out["service"]] and len(out["outcomes"]) == 5
    smoke.check_served(out["outcomes"])
    assert out["metrics"]["warmup"]["signatures"] == out["signatures"] >= 2
    assert out["rids"] == list(range(5))
    for rr in out["outcomes"]:                                   # no replay on the CPU
        assert rr.metrics["launch_cache"]["k1_replayed"] == 0
    for item, rr in zip(items, out["outcomes"]):
        assert smoke.same_report(rr.report, smoke.solo_solve(item, prof, params, "cpu"))
    with pytest.raises(AssertionError, match="failed"):
        smoke.check_served([ValueError("x")])


def test_fault_lane_on_the_cpu(smoke, monkeypatch):
    """The first requests under the seeded plan of every kind, its hang
    longer than the watchdog: every request ends in one terminal state,
    survivors equal their solo solves, and the plan's patch is undone."""
    from repro_torch.faults import inject as finj

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    prof = smoke.ServeProfile(n_requests=6, **TINY)
    params = smoke.serve_params()
    items, _ = smoke.serve_trace(prof, seed=0)
    solos = [smoke.solo_solve(item, prof, params, "cpu") for item in items]
    fire = finj.fire
    out = smoke.fault_lane(items, prof, params, solos, "cpu",
                           plan_kw={**smoke.FAULT_PLAN, "hang_seconds": 1.5}, watchdog=1.0)
    assert finj.fire is fire
    assert out["requests"] == 6 == out["survivors"] + sum(out["failed"].values())
    assert out["resilience"]["watchdog_kills"] >= 1
    assert out["device_search_sync_fires"].get("compile_hang", 0) >= 1   # key 1 hangs
    assert out["executes"] >= out["executes_raised"]
    assert out["device_lanes_returned"] >= out["survivors_by_backend"].get("device", 0)
    with pytest.raises(ValueError, match="watchdog"):
        smoke.fault_lane(items, prof, params, solos, "cpu", watchdog=9.0)


def test_race_plan_hangs_one_launch_alone(smoke):
    from repro_torch.faults import FaultPlan, would_fire

    kw = smoke.race_plan(12, 2.5)
    plan = FaultPlan(**kw)
    assert kw["hang_seconds"] == 2.5 and plan.kinds == ("compile_hang",)
    fired = {r: would_fire(plan, "fire", "engine.execute.launch", r) for r in range(12)}
    assert {r for r, k in fired.items() if k} == {smoke.RACE_HUNG_RID}
    assert fired[smoke.RACE_HUNG_RID] == "compile_hang"
    assert all(would_fire(plan, "fire", p, 1) is None
               for p in ("device_search.sync", "engine.warmup.compile"))


def test_race_lane_on_the_cpu(smoke, monkeypatch):
    """Requests of one launch shape, one hung at its launch: the stale run
    wakes beside the fresh lane's runs of the same shape, takes (or leaves
    to them) an uncached launch, and every lane equals its solo solve."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    prof = smoke.ServeProfile(n_requests=24, **TINY)
    params = smoke.serve_params()
    items, _ = smoke.serve_trace(prof, seed=0)
    ks = smoke.one_shape(items, prof)[:8]
    assert len(ks) == 8
    items = [items[k] for k in ks]
    solos = [smoke.solo_solve(item, prof, params, "cpu") for item in items]
    out = smoke.race_lane(items, prof, params, solos, "cpu", hang_seconds=1.2, watchdog=1.0)
    # the hung request fails once; a cut slowed past the watchdog on a busy
    # host would fail the same way, and the checks above hold either way
    assert set(out["failed"]) == {"CompileTimeout"}
    assert out["survivors_by_backend"]["device"] + out["failed"]["CompileTimeout"] == 8
    assert out["device_lanes_returned"] > out["survivors"] and out["uncached_launches"] >= 1
    assert out["resilience"]["watchdog_kills"] >= 1


def test_check_sweep_refuses_what_the_phase_must_not_pass(smoke):
    import types

    row = {"name": "a", "certified": True, "makespan": 10.0, "lb": 9.0,
           "initial_makespan": 12.0}
    ok = types.SimpleNamespace(compiles=1, buckets=1, rows=[row])
    smoke.check_sweep(ok, types.SimpleNamespace(rows=[dict(row)]))
    bad = [types.SimpleNamespace(compiles=2, buckets=1, rows=[row]),
           types.SimpleNamespace(compiles=1, buckets=1, rows=[{**row, "makespan": 8.0}]),
           types.SimpleNamespace(compiles=1, buckets=1, rows=[{**row, "certified": False}])]
    for rep in bad:
        with pytest.raises(AssertionError):
            smoke.check_sweep(rep, types.SimpleNamespace(rows=[dict(row)]))
    with pytest.raises(AssertionError, match="starts at"):
        smoke.check_sweep(ok, types.SimpleNamespace(rows=[{**row, "initial_makespan": 11.0}]))
