"""The plumbing of ``chip_smoke.py`` that needs no GPU: its refusal to run
without one, the candidate batches it builds, the byte/operation bounds it
computes (K1 to K4, seq_cumsum), the host-phase timers it wraps around the
search round and the device engine, the device path's parity check and K1
call, the launch counts it expects of each served arch, and its ``kernels``
line."""
import copy
import dataclasses
import importlib.util
import json
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


def test_the_slice_serves_child_fails_without_a_gpu_and_the_phase_raises(smoke):
    """``--slice-serves`` (the MoE, encoder-decoder and vision serves in a
    process of their own) refuses to run without a card, prints no result,
    and the parent's phase raises on its exit code."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--slice-serves"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "GPU" in out.stderr
    with pytest.raises(AssertionError, match="slice's serves failed"):
        smoke.phase_slice_serves()


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
    assert v.is_contiguous()                               # row-major, as the round's
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


@pytest.mark.parametrize("shape_name, heads, kv_heads", [("FLASH_QWEN", 40, 8),
                                                          ("FLASH_CODEQWEN", 32, 32)])
def test_flash_bound_at_the_global_attention_shapes(smoke, shape_name, heads, kv_heads):
    """qwen2.5-14b's prefill: 1.3425e9 unmasked pairs x 4 x 128 operations,
    0.695 ms at 989 TFLOP/s; codeqwen1.5-7b's the same pairs per head."""
    shape = getattr(smoke, shape_name)
    assert shape == (4, 4096, 4096, heads, kv_heads, 128, True, None, 0)
    assert shape in smoke.FLASH_BF16_SHAPES
    meta = torch.device("meta")
    q = torch.empty((4, 4096, heads, 128), dtype=torch.bfloat16, device=meta)
    k = torch.empty((4, 4096, kv_heads, 128), dtype=torch.bfloat16, device=meta)
    bound = smoke.flash_bound(q, k, k, causal=True, window=None, q_offset=0)
    assert bound["pairs"] == 4096 * 4097 // 2 * 4 * heads
    assert bound["operations"] == 4 * 128 * bound["pairs"]
    assert bound["bound_by"] == "operations"
    if heads == 40:
        assert bound["pairs"] == 1_342_504_960
        assert round(bound["bound_ms"], 3) == 0.695


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
    res = serve(cfg, model, {"tokens": prompts}, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts},
                                         torch.from_numpy(res.ids), "cpu")
    assert len(logits) == 5
    greedy = torch.stack([lg[:, :cfg.vocab_size].argmax(-1) for lg in logits], 1)
    assert np.array_equal(greedy.numpy(), res.ids)
    with smoke.plain_kernels():
        again = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts},
                                            torch.from_numpy(res.ids), "cpu")
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
    ("(anonymous namespace)::seq_cumsum_kernel(double const*, double*, int)", "seq_cumsum"),
    ("void (anonymous namespace)::flash_bwd_dkdv_kernel<__nv_bfloat16, 256>(Params)",
     "K2 bwd"),
    ("void (anonymous namespace)::flash_bwd_reduce_kernel<float>(Params)", "K2 bwd"),
    ("void (anonymous namespace)::tc::flash_bwd_dkdv_mma_kernel<256>(Params, int)", "K2 bwd"),
    ("void (anonymous namespace)::tc::flash_bwd_dq_mma_kernel<256>(Params, int)", "K2 bwd"),
    ("void (anonymous namespace)::flash_bwd_delta_kernel<__nv_bfloat16>(Params)", "K2 bwd"),
    ("void (anonymous namespace)::rglru_scan_bwd_kernel<true>(float const*, ...)", "K3 bwd"),
    ("void (anonymous namespace)::rglru_scan_bwd_kernel<8, true>(float const*, ...)", "K3 bwd"),
    ("void (anonymous namespace)::rglru_scan_bwd_kernel<32, false>(float const*, ...)",
     "K3 bwd"),
    ("void at::native::reduce_kernel<512, 1, ...>", "elementwise")])
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


# the MoE's sparse-dispatch wrappers, forward and backward, none launched
NO_MOE_FWD = dict.fromkeys(["moe_order", "moe_permute", "grouped_mm", "moe_swiglu",
                            "moe_combine"], 0)
NO_MOE = {**NO_MOE_FWD, **dict.fromkeys(["moe_permute_bwd", "grouped_mm_wgrad",
                                         "moe_swiglu_bwd", "moe_combine_bwd"], 0)}


@pytest.mark.parametrize("arch,want", [
    ("recurrentgemma-2b", {"flash_attention": 8, "rglru_scan": 18 * 32, "ssd_chunked": 0}),
    ("mamba2-780m", {"flash_attention": 0, "rglru_scan": 0, "ssd_chunked": 48 * 32}),
    ("qwen2.5-14b", {"flash_attention": 48, "rglru_scan": 0, "ssd_chunked": 0}),
    # the sparse dispatch's forward in each of 24 layers at the prefill and
    # at each of the 31 decode steps: two grouped products each
    ("granite-moe-1b-a400m", {"flash_attention": 24, "rglru_scan": 0, "ssd_chunked": 0,
                              "moe_order": 24 * 32, "moe_permute": 24 * 32,
                              "grouped_mm": 2 * 24 * 32, "moe_swiglu": 24 * 32,
                              "moe_combine": 24 * 32}),
    # 24 encoder layers, then 24 decoder layers' self- and cross-attention
    ("whisper-medium", {"flash_attention": 72, "rglru_scan": 0, "ssd_chunked": 0}),
    ("internvl2-26b", {"flash_attention": 48, "rglru_scan": 0, "ssd_chunked": 0})])
def test_expected_launches_of_each_served_arch(smoke, arch, want):
    from repro_torch.configs import get_config

    want = {**NO_MOE_FWD, **want}
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


BWD_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b12tc23flash_bwd_dq_mma_kernelILi256EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b12tc23flash_bwd_dq_mma_kernelILi256EEEvNS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b12tc25flash_bwd_dkdv_mma_kernelILi256EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b12tc25flash_bwd_dkdv_mma_kernelILi256EEEvNS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 242 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b121flash_bwd_dkdv_kernelIfLi256EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_9d6785b121flash_bwd_dkdv_kernelIfLi256EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


@pytest.mark.parametrize("pass_name", ["flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel"])
def test_ptxas_gate_refuses_a_spilling_bwd_mma_kernel(smoke, pass_name):
    """K2 bwd's tensor-core kernels are ``*_mma_kernel``s: the gate refuses a
    spill in either pass, not in its float32 CUDA-core kernels, and the
    profile counts every one of them as K2 bwd."""
    report = smoke.ptxas_report(BWD_PTXAS_LOG)
    assert [f["registers"] for f in report] == [240, 242, 128]
    assert smoke.ptxas_faults({"flash_attention_bwd": report}) == []
    spilled = [dict(f, spill_stores=8, spill_loads=8) if pass_name in f["kernel"] else f
               for f in report]
    faults = smoke.ptxas_faults({"flash_attention_bwd": spilled})
    assert len(faults) == 1 and pass_name in faults[0] and "dkdv_kernelIf" not in faults[0]
    f32_spill = [dict(f, spill_stores=8) if "kernelIf" in f["kernel"] else f for f in report]
    assert smoke.ptxas_faults({"flash_attention_bwd": f32_spill}) == []
    assert all(smoke._kernel_class(f["kernel"]).startswith("K2 bwd") for f in report)
    assert pass_name in smoke.FLASH_BWD_KERNELS


def smoke_report(smoke):
    """PTXAS_LOG read as the flash_attention and ssd libraries' report."""
    return {"flash_attention": smoke.ptxas_report(PTXAS_LOG)[::2],
            "ssd": smoke.ptxas_report(PTXAS_LOG)[1:2]}


def test_kernels_line_lists_every_kernel_with_its_keys(smoke):
    names = [k[0] for k in smoke.KERNELS]
    assert names == ["schedule_dp", "flash_attention", "rglru_scan", "ssd_chunked",
                     "flash_attention_bwd", "rglru_scan_bwd", "ssd_chunked_bwd", "seq_cumsum"]
    times = {n: {"ms": 1.0 + i, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes",
                 "library_ms": None} for i, n in enumerate(names)}
    entries = smoke.kernel_entries(
        launches=dict(zip(names, (30, 8, 576, 1536, 32, 72, 192, 1000))),
        errs=dict.fromkeys(names, 0.0),
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
        # a helper and a backward have no TPU kernel: each names the
        # reference function it replaces, which reaches no pallas_call
        no_tpu = e.get("helper", False) or "backward_of" in e
        assert ("pallas_call" in (ROOT / path).read_text()) != no_tpu
        assert (e["tpu_kernel"] is None) if no_tpu else "tpu_kernel" not in e
    bwd = {e["name"]: e for e in entries if "backward_of" in e}
    assert bwd["flash_attention_bwd"]["backward_of"] == "flash_attention"
    assert bwd["flash_attention_bwd"]["replaces"] == "src/repro/kernels/flash_xla.py:76"
    assert "def _flash_bwd" in (ROOT / "src/repro/kernels/flash_xla.py").read_text(
    ).splitlines()[75]
    assert bwd["rglru_scan_bwd"]["replaces"] == "src/repro/kernels/rglru_xla.py:56"
    assert "def _scan_bwd" in (ROOT / "src/repro/kernels/rglru_xla.py").read_text(
    ).splitlines()[55]
    assert bwd["ssd_chunked_bwd"]["backward_of"] == "ssd_chunked"
    assert bwd["ssd_chunked_bwd"]["replaces"] == "src/repro/kernels/ref.py:205"
    assert bwd["ssd_chunked_bwd"]["source"] == "src/repro_torch/kernels/csrc/ssd_bwd.cu"
    assert "def ssd_chunked_reference" in (ROOT / "src/repro/kernels/ref.py").read_text(
    ).splitlines()[204]
    helper = entries[7]
    assert helper["replaces"] == "src/repro/core/device_search.py:199"
    assert helper["tpu_kernel"] is None and "_seq_cumsum" in (ROOT / "src/repro/core/"
                                                              "device_search.py").read_text(
    ).splitlines()[198]
    k4 = entries[3]
    assert k4["replaces"] == "src/repro/kernels/ssd.py:75" and k4["launches"] == 1536
    assert k4["library_ms"] is None and k4["decode_step_ms"] == 0.01
    assert k4["source"] == "src/repro_torch/kernels/csrc/ssd.cu"


@pytest.mark.parametrize("arch, prompt, extra", [
    ("qwen2.5-14b", 4096, {}), ("granite-moe-1b-a400m", 4096, {}),
    ("whisper-medium", 416, {"frames": (4, 1500, 1024)}),
    ("internvl2-26b", 4096, {"vis_embeds": (4, 256, 6144)})])
def test_serve_batch_of_each_arch(smoke, arch, prompt, extra):
    """The served batch: 4 prompts of 4096 tokens (whisper's decoder: 416,
    so prompt + 32 generated = its 448-token context) and the stub
    frontends' outputs; drawn from the generator after the tokens, so the
    earlier archs' prompts are unchanged."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    assert smoke.serve_prompt_len(cfg) == prompt
    batch = smoke.serve_batch(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in batch.items()} == {"tokens": (4, prompt), **extra}
    tokens = torch.randint(1, cfg.vocab_size, (4, prompt),
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(batch["tokens"], tokens)
    if arch == "whisper-medium":
        assert prompt + smoke.SERVE_GEN == 448


@pytest.mark.parametrize("name, ops_ms", [
    ("granite-moe-1b-a400m", 0.139), ("whisper-medium encoder", 0.0373),
    ("whisper-medium cross", 0.0103), ("whisper-medium decoder self", 0.0014),
    ("internvl2-26b", 0.834)])
def test_flash_bound_at_the_slice_shapes(smoke, name, ops_ms):
    """The operations bounds at 989 TFLOP/s, 4 D operations a visible pair:
    causal pairs s (s + 1) / 2, non-causal Sq x Skv, per batch and q head."""
    b, sq, skv, h, kvh, d, causal, window, qoff = smoke.FLASH_SLICE_SHAPES[name]
    assert smoke.FLASH_SLICE_SHAPES[name] in smoke.FLASH_BF16_SHAPES
    meta = torch.device("meta")
    q = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=meta)
    k = torch.empty((b, skv, kvh, d), dtype=torch.bfloat16, device=meta)
    bound = smoke.flash_bound(q, k, k, causal=causal, window=window, q_offset=qoff)
    per_head = sq * (sq + 1) // 2 if causal else sq * skv
    assert bound["pairs"] == per_head * b * h and bound["operations"] == 4 * d * bound["pairs"]
    assert abs(bound["ops_ms"] - ops_ms) < 0.03 * ops_ms
    # the decoder's self-attention moves more bytes than its pairs take
    assert bound["bound_by"] == ("bytes" if name.endswith("self") else "operations")
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])


@pytest.mark.parametrize("case, want", [
    ((1, 8, 8, 1, 1, 4, True, None, 0), {"is_causal": True}),
    ((1, 8, 20, 1, 1, 4, False, None, 0), {"is_causal": False}),
    ((1, 8, 8, 1, 1, 4, True, 3, 0), "band"),
    ((1, 8, 20, 1, 1, 4, True, None, 12), "offset")])
def test_sdpa_args_follow_the_kernels_mask(smoke, case, want):
    """The library call is timed on K2's own mask: ``is_causal`` (True or
    False) where that is the mask, else the mask itself, equal to the plain
    version's."""
    from repro_torch.kernels import flash_attention as fa

    q, k, _, kw = smoke.flash_operands(case, torch.float32, torch.device("cpu"))
    got = smoke.sdpa_args(q, k, **kw)
    if isinstance(want, dict):
        assert got == want
    else:
        assert torch.equal(got["attn_mask"], fa._mask(q.shape[1], k.shape[1], kw["q_offset"],
                                                      kw["causal"], kw["window"], "cpu"))


def test_teacher_forcing_reproduces_the_served_whisper_tokens(smoke):
    """whisper-medium at its smoke config: the batch carries the frames; the
    prefill encodes them and runs the decoder prompt, the steps read the
    caches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import make_batch, serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config(smoke.ENCDEC_ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch(cfg, 2, 30, torch.Generator().manual_seed(5), device="cpu")
    res = serve(cfg, model, batch, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, batch, torch.from_numpy(res.ids), "cpu")
    greedy = torch.stack([lg[:, :cfg.vocab_size].argmax(-1) for lg in logits], 1)
    assert np.array_equal(greedy.numpy(), res.ids)


def test_memory_reckoning_of_the_slice_serves(smoke):
    """internvl2-26b: the decode cache as qwen2.5-14b's (48 layers, 8 kv heads
    of 128): 3.25 GB; the plain attention's fp32 score block 4 x 48 heads x
    1024 x 4096 x 4 bytes = 3.2 GB.  whisper-medium: the decoder's self cache
    at 448 slots and the cross cache of 1500 frames, 16 heads of 64.
    granite-moe-1b-a400m: the sparse dispatch's gathered rows and gate and
    up products, (4 x 4096 x 8, 1024) each, bf16."""
    import types

    from repro_torch.configs import get_config

    fake = types.SimpleNamespace(parameters=lambda: [
        torch.empty(1000, dtype=torch.bfloat16, device="meta")])
    vlm = smoke.memory_reckoning(get_config(smoke.VLM_ARCH), fake)
    assert vlm["decode_cache_bytes"] == 3_246_391_296
    assert vlm["plain_attention_score_block_bytes"] == 4 * 48 * 1024 * 4096 * 4
    assert vlm["teacher_forced_plain_peak_bytes"] == 2000 + 3_246_391_296 + 3 * 4 * 48 * 1024 \
        * 4096 * 4
    enc = smoke.memory_reckoning(get_config(smoke.ENCDEC_ARCH), fake)
    assert enc["decode_cache_bytes"] == 24 * 2 * 4 * (448 + 1500) * 16 * 64 * 2
    moe = smoke.memory_reckoning(get_config(smoke.MOE_ARCH), fake)
    assert moe["moe_dispatch_bytes"] == 4 * 4096 * 8 * (1024 + 2 * 512) * 2
    assert "moe_dispatch_bytes" not in vlm


def test_teacher_forcing_reproduces_the_served_qwen_tokens(smoke):
    """qwen2.5-14b at its smoke config: global attention (K2 at every prefill
    layer, a linear cache in the decode), biases and an untied head."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config(smoke.QWEN_ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    for layer in model.layers:                      # biases start at zero: draw them
        for name in ("bq", "bk", "bv", "bo"):
            getattr(layer.attn, name).normal_(generator=torch.Generator().manual_seed(6))
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(5))
    res = serve(cfg, model, {"tokens": prompts}, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts},
                                         torch.from_numpy(res.ids), "cpu")
    greedy = torch.stack([lg[:, :cfg.vocab_size].argmax(-1) for lg in logits], 1)
    assert np.array_equal(greedy.numpy(), res.ids)


def test_memory_reckoning_of_the_qwen_serve(smoke):
    """The decode cache of qwen2.5-14b at batch 4 x (4096 + 32): 48 layers x
    k and v x 4 x 4128 x 8 kv heads x 128 x 2 bytes = 3.25 GB; the weights as
    the model stores them (bf16, 14.77 B parameters: 29.5 GB)."""
    import types

    from repro_torch.configs import get_config

    cfg = get_config(smoke.QWEN_ARCH)
    fake = types.SimpleNamespace(parameters=lambda: [
        torch.empty(14_770_279_424, dtype=torch.bfloat16, device="meta")])
    got = smoke.memory_reckoning(cfg, fake)
    assert got["decode_cache_bytes"] == 48 * 2 * 4 * 4128 * 8 * 128 * 2 == 3_246_391_296
    assert got["weights_bytes"] == 2 * 14_770_279_424


def test_crash_plan_loses_the_device_at_a_middle_sync(smoke):
    from repro_torch.faults import FaultPlan, would_fire

    kw, sync = smoke.crash_plan(3)
    plan = FaultPlan(**kw)
    assert sync == 2 and kw["rate"] == smoke.CRASH_RATE == 0.25
    assert [would_fire(plan, "fire", "device_search.sync", k) for k in (1, 2)] == \
        [None, "device_lost"]
    with pytest.raises(ValueError, match="inside"):
        smoke.crash_plan(2)


def test_crash_resume_phase_on_the_cpu(smoke, monkeypatch, tmp_path, capsys):
    """The phase at a small size on the CPU (its round eager, no profiler):
    lost at the middle sync, resumed from the file, equal to the uncrashed
    run; the wrapped ``_Launch.run`` is restored."""
    import json

    from repro_torch.core import TSParams, random_instance
    from repro_torch.core import device_search as ds
    from repro_torch.core.api import multiwalk_inits

    inst = random_instance(0, n_tasks=30, n_data=70)
    params = TSParams(top_k=5, max_unimproved=10**9, time_limit=10**9, max_iters=30,
                      torch_device="cpu")
    ctx = {"inst": inst, "inits": multiwalk_inits(inst, 2, 0)[0], "params": params}
    windows = []

    def no_profiler(fn, top=0):
        fn()
        windows.append(fn)
        return {"by_class": {}}

    monkeypatch.setattr(smoke, "device_breakdown", no_profiler)
    run = ds._Launch.run
    got = smoke.phase_crash_resume(torch.device("cpu"), ctx, tmp_path)
    assert ds._Launch.run is run and len(windows) == 1
    assert got == {"schedule_dp": 0, "seq_cumsum": 0}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "crash_resume" and line["resumed_identical"]
    assert (line["syncs"], line["crash_sync"], line["resumed_from_iteration"]) == (3, 2, 16)
    assert line["iterations"] == 30 and line["first_period"]["rounds"] == 8
    assert (tmp_path / "crash_resume.ckpt.npz").is_file()


def test_same_result_compares_the_best_solution_too(smoke):
    import types

    sol = types.SimpleNamespace(assign=np.array([0, 1]), mem=np.array([1]), proc_seq=[[0], [1]])
    walk = types.SimpleNamespace(history=[(0, 5.0)])
    res = types.SimpleNamespace(best_makespan=5.0, history=[(0, 5.0)], n_exact_evals=3,
                                n_approx_evals=9, iterations=2, stop_reason="max_iters",
                                per_walk=[walk], best=sol)
    assert smoke.same_result(res, res)
    other = types.SimpleNamespace(**{**vars(res), "best": types.SimpleNamespace(
        **{**vars(sol), "mem": np.array([0])})})
    assert smoke.same_trajectory(other, res) and not smoke.same_result(other, res)


def test_teacher_forcing_reproduces_the_served_mamba2_tokens(smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import serve
    from repro_torch.models import arch_init_params

    cfg = get_smoke_config("mamba2-780m")
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(5))
    res = serve(cfg, model, {"tokens": prompts}, 5, device="cpu")
    logits = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts},
                                         torch.from_numpy(res.ids), "cpu")
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
    out = smoke.float32_teacher_forced(cfg, {"tokens": prompts}, ids, torch.device("cpu"))
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
    plain = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts}, ids, cpu)
    out = smoke.check_against_yardstick(cfg, model, {"tokens": prompts}, ids, cpu, [0.0] * 3,
                                        plain)
    yardstick = out["plain_vs_plain_other_chunk_rel_err"]
    assert len(yardstick) == 3 and 0.0 < max(yardstick) < 1e-5
    assert out["teacher_forced_limit"] == smoke.YARDSTICK_FACTOR * max(yardstick)
    assert out["float32_teacher_forced_rel_err"] == [0.0] * 3
    with pytest.raises(AssertionError, match="more than"):
        smoke.check_against_yardstick(cfg, model, {"tokens": prompts}, ids, cpu,
                                      [0.0, 2.5 * max(yardstick), 0.0], plain)
    assert smoke.check_fixed_limit(cfg, model, {"tokens": prompts}, ids, cpu, [3e-3], plain) == {
        "teacher_forced_limit": smoke.TEACHER_FORCED_LIMIT}
    with pytest.raises(AssertionError, match="limit"):
        smoke.check_fixed_limit(cfg, model, {"tokens": prompts}, ids, cpu, [5e-3], plain)


@pytest.mark.parametrize("case", [(2, 300, 300, 10, 2, 32, True, None, 0),
                                  (1, 200, 260, 4, 4, 16, True, None, 60),
                                  (2, 130, 130, 4, 1, 32, True, 64, 0),
                                  (1, 90, 150, 2, 2, 8, False, None, 0)])
def test_tpu_order_attention_is_the_plain_function_in_another_order(smoke, case):
    """The yardstick of the qwen2.5-14b check: the TPU kernel's blockwise
    online softmax (128 keys a block), fp32, equal to the plain version up
    to the order of its sums, at GQA / MHA / MQA, offsets and windows."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = smoke.flash_operands(case, torch.float32, torch.device("cpu"), seed=3)
    got = smoke.tpu_order_attention(q, k, v, **kw)
    want = fa.flash_attention_torch(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if case[2] > smoke.TPU_BLOCK_KV:
        assert not torch.equal(got, want)           # another order of the sums
    with smoke.plain_kernels(flash=smoke.tpu_order_attention):
        from repro_torch.kernels import ops

        assert ops.flash_attention is smoke.tpu_order_attention
    assert ops.flash_attention is fa.flash_attention


def test_attention_yardstick_check_on_the_smoke_qwen(smoke):
    """qwen2.5-14b's limit is measured in the run: twice the plain versions'
    worst step against themselves in the TPU kernel's order; the fixed 4e-3
    is reported beside it, not held."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import arch_init_params

    cpu = torch.device("cpu")
    cfg = get_smoke_config(smoke.QWEN_ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 300), generator=torch.Generator().manual_seed(9))
    ids = torch.randint(1, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(10))
    plain = smoke.teacher_forced_logits(cfg, model, {"tokens": prompts}, ids, cpu)
    out = smoke.check_attention_yardstick(cfg, model, {"tokens": prompts}, ids, cpu, [0.0] * 3,
                                          plain)
    yardstick = out["plain_vs_plain_tpu_order_rel_err"]
    assert len(yardstick) == 3 and 0.0 < max(yardstick) < 1e-5
    assert out["teacher_forced_limit"] == smoke.YARDSTICK_FACTOR * max(yardstick)
    assert out["fixed_limit"] == smoke.TEACHER_FORCED_LIMIT and out["fixed_limit_held"]
    with pytest.raises(AssertionError, match="TPU kernel's order"):
        smoke.check_attention_yardstick(cfg, model, {"tokens": prompts}, ids, cpu,
                                        [0.0, 2.5 * max(yardstick), 0.0], plain)


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


def test_analysis_cli_launch_gate(smoke):
    """The phase fails unless certify's torch backend launched K1 and its
    device backend captured and replayed K1 and seq_cumsum."""
    good = {"torch": {"schedule_dp": 40},
            "device": {"schedule_dp": 90, "schedule_dp_captured": 9, "seq_cumsum": 120,
                       "seq_cumsum_captured": 12}}
    smoke.check_cli_launches(good)
    for path, key in (("torch", "schedule_dp"), ("device", "schedule_dp"),
                      ("device", "schedule_dp_captured"), ("device", "seq_cumsum"),
                      ("device", "seq_cumsum_captured")):
        bad = {k: dict(v) for k, v in good.items()}
        bad[path][key] = 0
        with pytest.raises(AssertionError, match="did not run through"):
            smoke.check_cli_launches(bad)


def test_analysis_cli_phase_on_the_cpu(smoke, monkeypatch, capsys):
    """The phase's plumbing on the CPU (the kernels' plain versions count no
    launch there, so the launch gate is recorded, not applied): selftest,
    lint, and the smoke suite certified on numpy, torch and device, the
    torch rows equal to the numpy rows."""
    import json

    gated = []
    monkeypatch.setattr(smoke, "check_cli_launches", gated.append)
    got = smoke.phase_analysis_cli("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "analysis_cli" and line["torch_device"] == "cpu"
    assert line["lint"]["findings"] == 0 and line["lint"]["suppressed"] >= 5
    assert {"RPR101", "RPR102"} <= set(line["selftest"]["lint_rules"])
    assert line["certify"]["certified"] == {"numpy": 7, "torch": 7, "device": 7}
    assert line["certify"]["makespans"]["torch"] == line["certify"]["makespans"]["numpy"]
    assert set(line["seconds"]) == {"selftest", "lint", "certify numpy", "certify torch",
                                    "certify device"}
    assert gated == [line["launches"]]
    assert got == {"torch": {"schedule_dp": 0},
                   "device": {"schedule_dp": 0, "seq_cumsum": 0}}


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
    # served runs do not reach device_search.sync (the reference's points):
    # rid 1's launch hangs at engine.execute.launch instead
    assert out["device_search_sync_fires"] == {}
    assert out["fires"].get("engine.execute.launch:compile_hang", 0) >= 1
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


def test_stale_run_meets_a_fresh_run_that_holds_its_launch(smoke):
    """A fresh run whose device work ends before the stale run wakes keeps
    its launch until the stale run has asked for one, so the stale run
    finds the shape held (an uncached launch) on any host; the wrapped
    functions are restored after."""
    import threading
    import types

    events, held = [], {"owner": None}

    def get(owner):
        if held["owner"] not in (None, owner):
            events.append(("uncached", owner))
            return
        held["owner"] = owner
        events.append(("get", owner))

    def release(owner):
        if held["owner"] == owner:
            held["owner"] = None
        events.append(("release", owner))

    def fire(point, key=0, *, rid=None):
        if key == 1:
            time.sleep(0.3)                   # the hung launch

    ds = types.SimpleNamespace(_get_launch=get, _release=release)
    inj = types.SimpleNamespace(fire=fire)

    def stale():
        inj.fire("engine.execute.launch", 1)
        ds._get_launch("stale")
        ds._release("stale")

    with smoke.StaleRunMeetsFreshLane(1, timeout=10.0, devsearch=ds, inject=inj) as meet:
        thread = threading.Thread(target=stale)
        thread.start()
        deadline = time.monotonic() + 10.0
        while meet.hung_thread is None and time.monotonic() < deadline:
            time.sleep(0.01)
        ds._get_launch("fresh")               # done long before the stale run wakes
        ds._release("fresh")
        thread.join(10.0)
    assert not thread.is_alive()
    assert events[:2] == [("get", "fresh"), ("uncached", "stale")]
    assert ("release", "fresh") in events
    assert meet.stale_asked.is_set() and meet.waited_s > 0.1
    assert (ds._get_launch, ds._release, inj.fire) == (get, release, fire)


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


def test_flash_bwd_bound_at_the_training_shape(smoke):
    """K2 bwd: 10 D operations per visible pair (the scores again, dP, dV,
    dK, dQ); q, k, v, out and dO read and dq, dk, dv written once, lse read.
    The kernels' design does 14 D a pair: the dk / dv and the dq pass each
    recompute S and dP."""
    meta = torch.device("meta")
    q = torch.empty((1, 4096, 10, 256), dtype=torch.bfloat16, device=meta)
    k = torch.empty((1, 4096, 1, 256), dtype=torch.bfloat16, device=meta)
    bound = smoke.flash_bwd_bound(q, k, k, causal=True, window=2048, q_offset=0)
    assert bound["pairs"] == 6_292_480 * 10
    assert bound["operations"] == 10 * 256 * 6_292_480 * 10          # 161 GFLOP
    assert bound["kernel_operations"] == 14 * 256 * 6_292_480 * 10   # 226 GFLOP
    assert bound["bytes"] == 2 * (4 * q.numel() + 4 * k.numel()) + 4 * 4096 * 10
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(0.1629, rel=1e-3)


def test_rglru_bwd_checks_hold_the_training_grid_bit_for_bit(smoke):
    """The backward's checks take the training shape and its ragged twin,
    T = 1 and batch 4 at the training width, each with and without h0, and
    shapes whose width is no multiple of a group in every group."""
    from repro_torch.kernels import rglru as rg

    shapes = set(smoke.RGLRU_BWD_SHAPES)
    assert set(smoke.RGLRU_SHAPES) <= shapes
    for b, t, d in ((1, 4096, 2560), (1, 4097, 2562), (1, 1, 2560), (4, 4096, 2560)):
        assert {(b, t, d, True), (b, t, d, False)} <= shapes
    assert smoke.RGLRU_TRAIN[:3] + (False,) in shapes
    # the wrapper's pick at the training shape and at batch 4 on an H100
    assert rg.bwd_group(1, 2560, 132) == 8 and rg.bwd_group(4, 2560, 132) == 32
    widths = {d for _, _, d, _ in smoke.RGLRU_BWD_ALL_GROUPS}
    assert any(d % 8 for d in widths) and any(d % 8 == 0 and d % 32 for d in widths)
    assert any(t % 32 for _, t, _, _ in smoke.RGLRU_BWD_ALL_GROUPS)


def test_rglru_bwd_bound_at_the_training_shape(smoke):
    meta = torch.device("meta")
    a = torch.empty((1, 4096, 2560), dtype=torch.float32, device=meta)
    bound = smoke.rglru_bwd_bound(a, None, None)
    assert bound["bytes"] == 5 * a.numel() * 4 + 2560 * 4   # a, y, dy in; dx, da out; dh0
    assert bound["operations"] == 3 * a.numel()
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(0.0626, rel=1e-3)
    with_states = smoke.rglru_bwd_bound(a, a[:, 0], a[:, 0])
    assert with_states["bytes"] == bound["bytes"] + 2 * 2560 * 4


def test_expected_train_launches_follow_the_plan(smoke):
    """recurrentgemma-2b: 8 periods of (rec, rec, attn_local) and 2 tail rec
    layers.  The H100 plan keeps every class (no region): 8 / 8 / 18 / 18 a
    step.  A plan that recomputes: a layer in a period replays twice, a tail
    layer once, unless its kernel class is held."""
    from repro_torch.configs import get_config
    from repro_torch.models.remat import Residency, classes_of

    cfg = get_config("recurrentgemma-2b")
    keep_all = Residency(tuple(classes_of(cfg)))
    assert smoke.expected_train_launches(cfg, 1, keep_all) == {
        "flash_attention": 8, "flash_attention_bwd": 8, "rglru_scan": 18,
        "rglru_scan_bwd": 18, "ssd_chunked": 0, "ssd_chunked_bwd": 0, **NO_MOE}
    got = smoke.expected_train_launches(cfg, 1, Residency(("rec_out",)))
    assert got["flash_attention"] == 8 * 3 and got["rglru_scan"] == 18
    got = smoke.expected_train_launches(cfg, 1, None)
    assert got["flash_attention"] == 8 * 3 and got["rglru_scan"] == 16 * 3 + 2 * 2


def test_expected_train_launches_of_mamba2(smoke):
    """mamba2-780m: 48 SSD layers in one uniform scanned stack.  The H100
    plan keeps every class: K4 and K4 bwd 48 a step.  Recomputing in groups
    of 6 layers, each layer replays twice unless ``ssm_out`` is held."""
    from repro_torch.configs import get_config
    from repro_torch.models.remat import Residency, classes_of

    cfg = get_config("mamba2-780m")
    assert smoke.expected_train_launches(cfg, 6, Residency(tuple(classes_of(cfg)))) == {
        "flash_attention": 0, "flash_attention_bwd": 0, "rglru_scan": 0, "rglru_scan_bwd": 0,
        "ssd_chunked": 48, "ssd_chunked_bwd": 48, **NO_MOE}
    assert smoke.expected_train_launches(cfg, 6, Residency(("ssm_out",)))["ssd_chunked"] == 48
    assert smoke.expected_train_launches(cfg, 6, None)["ssd_chunked"] == 48 * 3


def test_train_memory_reckoning_of_mamba2(smoke):
    """The state (~12.5 GB), the named activations, and K4 bwd's scratch on
    the tensor cores: chunk states and their gradients (2 x 48 x 64 x 64 x
    128 hi + lo bf16 pairs, the bytes of fp32) and the per-chunk da / dD
    partials (2 x 48 x 64 fp32), 0.2 GB; dB / dC leave the chunk pass whole."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-780m")
    r = smoke.train_memory_reckoning(cfg, None)
    assert r["state_bytes"] == 16 * cfg.param_count() and 12.4e9 < r["state_bytes"] < 12.6e9
    assert r["ssd_bwd_scratch_bytes"] == (2 * 48 * 64 * 64 * 128 + 2 * 48 * 64) * 4
    assert "ssd_bwd_scratch_bytes" not in smoke.train_memory_reckoning(
        get_config("recurrentgemma-2b"), None)


def test_model_flops_count_the_ssd(smoke):
    """6 N per token plus three times the SSD's chunked-form operations."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-780m")
    cb, rest = smoke.ssd_operations(4096, 64, 128, 64)
    assert smoke.train_model_flops(cfg) == 6 * cfg.param_count() * 4096 + 3 * 48 * (cb + 48 * rest)


def test_train_phase_on_the_cpu(smoke, monkeypatch, capsys):
    """``phase_train`` for mamba2-780m rehearsed on the CPU at the smoke size
    (the plain versions on both sides of the gate, so it reads 0; no launch
    is counted off the card, and no profiler): the gate, the steps, the
    recovery drill and the printed line."""
    import json

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(launch_train, "get_config", get_smoke_config)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 96)
    monkeypatch.setattr(smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(smoke, "RECOVERY_STEPS", 4)
    monkeypatch.setattr(smoke, "RECOVERY_FAIL_AT", (3,))
    monkeypatch.setattr(smoke, "expected_train_launches",
                        lambda cfg, g, policy: dict.fromkeys(
                            ("flash_attention", "flash_attention_bwd", "rglru_scan",
                             "rglru_scan_bwd", "ssd_chunked", "ssd_chunked_bwd"), 0))
    monkeypatch.setattr(smoke, "device_breakdown", lambda fn, top=0: fn() and {})
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    out = smoke.phase_train(torch.device("cpu"), "mamba2-780m", "train_ssm")
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"phase": "train_ssm"' in ln][-1])
    assert out["arch"] == line["arch"] == "mamba2-780m" and line["layers"] == 4
    assert line["step1_gate"]["loss_rel_err"] == 0.0 and line["step1_gate"]["within_fixed_limits"]
    assert line["step1_gate"]["grad_tensors"] == len(list(
        launch_train.build_trainer(launch_train.parse_args(
            ["--arch", "mamba2-780m", "--smoke", "--device", "cpu"])).model.parameters()))
    assert len(line["losses"]) == 2 and line["step1_loss_reproduced_in_training"]
    assert line["plan"]["save"] and line["profiler_records_after_profile"] is None
    assert line["recovery"]["losses_bit_identical"] and line["recovery"]["restarts"] == 1


def test_train_memory_reckoning_of_recurrentgemma(smoke):
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-2b")
    r = smoke.train_memory_reckoning(cfg, None)
    assert r["state_bytes"] == 16 * cfg.param_count()                # 42.5 GB
    assert r["weight_casts_bytes"] == 2 * cfg.param_count()
    assert r["logits_bytes"] == 4 * 4096 * cfg.padded_vocab + 8 * 1024 * cfg.padded_vocab
    assert 57e9 < r["total_bytes"] < 59e9


def test_plain_training_swaps_the_ops_and_restores_them(smoke):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg

    from repro_torch.kernels import ssd

    orig = ops.flash_attention, ops.rglru_scan, ops.ssd_chunked
    with smoke.plain_training():
        assert ops.flash_attention is fa.flash_attention_torch_grad
        assert ops.rglru_scan is rg.rglru_scan_torch_grad
        assert ops.ssd_chunked is ssd.ssd_chunked_torch_grad
    with smoke.plain_training(yardstick=True):
        q = torch.randn(1, 70, 2, 16, requires_grad=True)
        k = torch.randn(1, 70, 1, 16, requires_grad=True)
        out = ops.flash_attention(q, k, k, causal=True, window=30, name="attn_out")
        want = fa.flash_attention_torch(q, k, k, causal=True, window=30)
        assert float((out - want).abs().max()) < 1e-5
        out.sum().backward()
        assert q.grad is not None and k.grad is not None
        # the SSD at the yardstick's chunk length, differentiable
        args = [a.requires_grad_() if a is not None else a for a in smoke.ssd_operands(
            (1, 100, 2, 8, 1, 8), torch.float32, torch.device("cpu"))]
        y, _ = ops.ssd_chunked(*args, name="ssm_out")
        want, _ = ssd.ssd_chunked_torch(*args, chunk=smoke.YARDSTICK_CHUNK)
        assert torch.equal(y, want)
        y.sum().backward()
        assert all(a.grad is not None for a in args)
    assert (ops.flash_attention, ops.rglru_scan, ops.ssd_chunked) == orig


def test_moe_check_reports_the_float32_readings_on_the_cpu(smoke):
    """granite's check: the bf16 yardstick gate, then the routing readings,
    each held, in bf16 and in float32 (on the CPU the kernels' route is the
    plain versions, so their readings are 0 and they swap nothing)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import make_batch
    from repro_torch.models import arch_init_params

    cpu = torch.device("cpu")
    cfg = get_smoke_config(smoke.MOE_ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    batch = make_batch(cfg, 2, 300, torch.Generator().manual_seed(9), device="cpu")
    ids = torch.randint(1, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(10))
    plain = smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    out = smoke.check_moe_yardstick(cfg, model, batch, ids, cpu, [0.0] * 3, plain)
    assert out["teacher_forced_limit"] == smoke.YARDSTICK_FACTOR * max(
        out["plain_vs_plain_tpu_order_rel_err"])
    # 2 rows x (300 + 2 decode tokens) x the smoke model's layers
    routings = 2 * 302 * cfg.n_layers
    for what in ("routing_bf16", "routing_float32"):
        r = out[what]
        assert r["routings"] == routings
        assert r["pinned_kernels_rel_err"] == [0.0] * 3
        assert r["pinned_kernels_swaps"] == 0
        assert not any(k.startswith("free_") for k in r)
        assert r["pinned_limit"] == smoke.YARDSTICK_FACTOR * max(r["pinned_tpu_order_rel_err"])
    assert 0.0 < max(out["routing_float32"]["pinned_tpu_order_rel_err"]) < 1e-4


def test_pinned_routing_records_counts_and_pins_the_expert_choice(smoke):
    """A recorded run replayed on the same model swaps nothing and gives the
    same logits; on a model whose router moved, the free run counts the
    tokens it routes elsewhere, and the pinned run takes the recorded choice
    (so it differs from the free run) and counts its own layer-local swaps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.model_serve import make_batch
    from repro_torch.models import arch_init_params, blocks

    cpu = torch.device("cpu")
    cfg = get_smoke_config(smoke.MOE_ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    batch = make_batch(cfg, 2, 40, torch.Generator().manual_seed(9), device="cpu")
    ids = torch.randint(1, cfg.vocab_size, (2, 3), generator=torch.Generator().manual_seed(10))
    orig = blocks.moe_route
    routes = []
    with smoke.pinned_routing(routes, "record") as swaps:
        want = smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    assert swaps == [] and len(routes) == 3 * cfg.n_layers
    assert [tuple(r.shape) for r in routes[:cfg.n_layers]] == [(2, 40, cfg.top_k)] * cfg.n_layers
    with smoke.pinned_routing(routes, "pin") as swaps:
        got = smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    assert swaps == [0] * len(routes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    with torch.no_grad():
        for layer in model.layers:
            layer.mlp.router.add_(0.05 * torch.randn(layer.mlp.router.shape,
                                                    generator=torch.Generator().manual_seed(3)))
    with smoke.pinned_routing(routes, "free") as free_swaps:
        free = smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    with smoke.pinned_routing(routes, "pin") as pin_swaps:
        pinned = smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    assert sum(free_swaps) > 0 and sum(pin_swaps) > 0
    assert not all(torch.equal(a, b) for a, b in zip(free, pinned))
    assert blocks.moe_route is orig
    with pytest.raises(AssertionError, match="router calls"):
        with smoke.pinned_routing(routes[:-1], "pin"):
            smoke.teacher_forced_logits(cfg, model, batch, ids, cpu)
    assert blocks.moe_route is orig


@pytest.mark.parametrize("kernels, holds", [(3e-3, True), (4e-3, True), (4.1e-3, False)])
def test_hold_pinned_is_yardstick_factor_times_the_tpu_order_reading(smoke, kernels, holds):
    readings = {"pinned_tpu_order_rel_err": [1e-3, 2e-3], "pinned_kernels_rel_err": [1e-3, kernels]}
    if holds:
        assert smoke.hold_pinned("granite", "bf16", readings)["pinned_limit"] == \
            smoke.YARDSTICK_FACTOR * 2e-3
    else:
        with pytest.raises(AssertionError, match="routing pinned"):
            smoke.hold_pinned("granite", "bf16", readings)


@pytest.mark.parametrize("flag, what, phase", [
    ("--train-moe", "MoE training", "phase_train_moe"),
    ("--train-encdec", "encoder-decoder training", "phase_train_encdec")])
def test_the_training_children_fail_without_a_gpu_and_the_phase_raises(smoke, flag, what,
                                                                       phase):
    """granite-moe-1b-a400m's and whisper-medium's training run in child
    processes of their own (``CHILDREN``); without a card each refuses, prints
    no result, and the parent's phase raises on its exit code."""
    assert smoke.CHILDREN[flag] is getattr(smoke, flag[2:].replace("-", "_"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "GPU" in out.stderr
    with pytest.raises(AssertionError, match=f"the {what} failed"):
        getattr(smoke, phase)()


def test_flash_bwd_shapes_take_granite_and_whisper_training(smoke):
    """K2 bwd is held at granite's causal GQA 16:8 at 4096 and at whisper's
    three d-64 shapes at batch 16 (encoder 1500 x 1500 and cross-attention
    448 x 1500 non-causal, decoder 448 causal), each in both input types."""
    shapes = set(smoke.FLASH_BWD_SHAPES)
    assert {(1, 4096, 4096, 16, 8, 64, True, None, 0),
            (16, 448, 1500, 16, 16, 64, False, None, 0),
            (16, 1500, 1500, 16, 16, 64, False, None, 0),
            (16, 448, 448, 16, 16, 64, True, None, 0)} <= shapes
    assert smoke.FLASH_TRAIN in shapes and len(shapes) == len(smoke.FLASH_BWD_SHAPES)


def test_model_flops_of_granite_count_its_active_parameters_and_global_scores(smoke):
    """granite-moe-1b-a400m: 1.385 B parameters of which 0.48 B are active
    (the non-expert 0.177 B and 8 of 32 experts' 1.208 B); its 24 global
    causal layers' scores, 4 D a visible pair a head, count too."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-1b-a400m")
    experts = 24 * 32 * 3 * 1024 * 512
    active = cfg.param_count() - experts + experts // 4
    assert active == cfg.active_param_count() and 0.479e9 < active < 0.480e9
    pairs = 4096 * 4097 // 2
    scores = 4 * 64 * 16 * pairs * 24
    assert smoke.train_model_flops(cfg) == 6 * active * 4096 + 3 * scores
    # the dense dispatch runs 4x the expert FLOPs credited
    assert cfg.n_experts // cfg.top_k == 4


def test_model_flops_of_whisper_take_its_encoder_over_frames(smoke):
    """whisper-medium at 16 x 448: the encoder's 24 layers (4 d^2 + 4 d
    attention, 2 d d_ff + d_ff + d MLP, two LayerNorms: 12.6 M each) and each
    decoder layer's cross-attention keys and values (2 d^2 + 2 d) over 16 x
    1500 frames; the rest (decoder layers, final norms, the tied embedding
    and the 32,768 learned positions) over 16 x 448 tokens; scores of the
    encoder (1500^2), the causal decoder and the cross-attention (448 x
    1500)."""
    import math

    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium")
    d, f = 1024, 4096
    attn, mlp, norm = 4 * d * d + 4 * d, 2 * d * f + f + d, 2 * d
    kv = 2 * d * d + 2 * d
    frames_p = 24 * (attn + mlp + 2 * norm) + norm + 24 * kv
    tokens_p = 24 * (2 * attn - kv + mlp + 3 * norm) + norm + (51968 + 32768) * d
    assert smoke.encdec_param_split(cfg) == {"frames": frames_p, "tokens": tokens_p}
    assert 0.792e9 < frames_p + tokens_p < 0.793e9
    per_pair = 4 * 64 * 16 * 16
    scores = per_pair * (24 * 1500 * 1500 + 24 * (448 * 449 // 2 + 448 * 1500))
    want = 6 * (frames_p * 16 * 1500 + tokens_p * 16 * 448) + 3 * scores
    assert smoke.train_model_flops(cfg, 16, 448) == want
    assert math.isclose(want, 8.395e13, rel_tol=1e-3)                 # 84 TFLOP a step


def test_encdec_param_split_is_the_models_own_count(smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import EncDec

    cfg = get_smoke_config("whisper-medium")
    split = smoke.encdec_param_split(cfg)
    model = EncDec(cfg, device="cpu")
    assert split["frames"] + split["tokens"] == sum(p.numel() for p in model.parameters())
    enc = sum(p.numel() for p in model.enc_layers.parameters()) + 2 * cfg.d_model
    cross_kv = sum(p.numel() for layer in model.dec_layers
                   for n, p in layer.cross_attn.named_parameters() if n in ("wk", "wv", "bk",
                                                                           "bv"))
    assert split["frames"] == enc + cross_kv


def test_expected_train_launches_of_whisper(smoke):
    """whisper-medium: every one of its 24 encoder and 24 decoder layers in a
    recompute region whatever the plan (the reference hands the
    encoder-decoder none): K2 144 a step (72 calls, each again in its
    layer's replay), K2 bwd 72."""
    from repro_torch.configs import get_config
    from repro_torch.models.remat import Residency, classes_of

    cfg = get_config("whisper-medium")
    want = {"flash_attention": 144, "flash_attention_bwd": 72, "rglru_scan": 0,
            "rglru_scan_bwd": 0, "ssd_chunked": 0, "ssd_chunked_bwd": 0, **NO_MOE}
    assert smoke.expected_train_launches(cfg, 2, Residency(tuple(classes_of(cfg)))) == want
    assert smoke.expected_train_launches(cfg, 2, None) == want


def test_expected_train_launches_of_granite(smoke):
    """granite-moe-1b-a400m: the H100 plan keeps every class (no region), so
    K2 and K2 bwd run 24 times a step; recomputing, each layer replays
    once (scan group 1) unless attn_out is held."""
    from repro_torch.configs import get_config
    from repro_torch.models.remat import Residency, classes_of

    cfg = get_config("granite-moe-1b-a400m")
    got = smoke.expected_train_launches(cfg, 1, Residency(tuple(classes_of(cfg))))
    assert got["flash_attention"] == 24 and got["flash_attention_bwd"] == 24
    assert smoke.expected_train_launches(cfg, 1, None)["flash_attention"] == 48
    assert smoke.expected_train_launches(cfg, 1, Residency(("attn_out",)))[
        "flash_attention"] == 24


def test_train_memory_reckoning_of_granite_holds_the_dense_dispatch(smoke):
    """Granite with GELU experts, which take the dense dispatch on the card
    too: per layer g, u and the hidden (1, 4096, 32, 512) bf16 at 134 MB
    each and the experts' outputs (1, 4096, 32, 1024) at 268 MB: 0.67 GB a
    layer, 16.1 GB over 24, where the planner's top-k moe_hidden is 0.8 GB."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), act="gelu")
    r = smoke.train_memory_reckoning(cfg, None)
    per_layer = 3 * 4096 * 32 * 512 * 2 + 4096 * 32 * 1024 * 2
    assert per_layer == 671_088_640 and r["moe_dense_dispatch_bytes"] == 24 * per_layer
    assert r["planner_moe_hidden_bytes"] == 24 * 4096 * 512 * 8 * 2
    assert r["state_bytes"] == 16 * cfg.param_count()
    assert r["total_bytes"] == sum(v for k, v in r.items()
                                   if k not in ("total_bytes", "planner_moe_hidden_bytes"))
    assert 40e9 < r["total_bytes"] < 45e9


def test_train_memory_reckoning_of_granite_holds_the_sparse_dispatch(smoke):
    """Per layer the sparse dispatch's saved rows, 1 x 4096 x 8 of them: the
    gathered rows and the experts' outputs (d_model 1024), the gate and up
    products (2 x 512) and the hidden (512), bf16, and two int32 indices:
    235 MB a layer, 5.6 GB over 24, in place of the dense dispatch's 16.1 GB."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-1b-a400m")
    r = smoke.train_memory_reckoning(cfg, None)
    per_layer = 4096 * 8 * (2 * (2 * 1024 + 3 * 512) + 8)
    assert per_layer == 235_143_168 and r["moe_sparse_dispatch_bytes"] == 24 * per_layer
    assert "moe_dense_dispatch_bytes" not in r
    dense = smoke.train_memory_reckoning(dataclasses.replace(cfg, act="gelu"), None)
    assert r["total_bytes"] == dense["total_bytes"] - dense["moe_dense_dispatch_bytes"] \
        + 24 * per_layer


def test_expected_train_launches_of_granite_count_the_sparse_dispatch(smoke):
    """granite's 24 MoE blocks on the sparse dispatch: the order, the gather,
    SwiGLU and the combine once a forward, the grouped products twice a
    forward and twice a backward, the weight gradients twice a backward;
    recomputing, each layer's forward runs again in its replay."""
    from repro_torch.configs import get_config
    from repro_torch.models.remat import Residency, classes_of

    cfg = get_config("granite-moe-1b-a400m")
    got = smoke.expected_train_launches(cfg, 1, Residency(tuple(classes_of(cfg))))
    assert {k: got[k] for k in NO_MOE} == {
        "moe_order": 24, "moe_permute": 24, "grouped_mm": 96, "moe_swiglu": 24,
        "moe_combine": 24, "moe_permute_bwd": 24, "grouped_mm_wgrad": 48,
        "moe_swiglu_bwd": 24, "moe_combine_bwd": 24}
    got = smoke.expected_train_launches(cfg, 1, Residency(("attn_out",)))
    assert got["moe_order"] == 48 and got["grouped_mm"] == 2 * 48 + 2 * 24
    assert got["grouped_mm_wgrad"] == 48 and got["moe_combine_bwd"] == 24
    # the float32 copy takes the dense dispatch
    f32 = smoke.expected_train_launches(dataclasses.replace(cfg, dtype="float32"), 1, None)
    assert {k: f32[k] for k in NO_MOE} == NO_MOE
    assert set(smoke.train_wrappers()) == set(got) | {"schedule_dp"}


def test_plain_versions_take_the_dense_dispatch(smoke):
    """``plain_kernels`` and ``plain_training`` send a MoE block that would
    take the sparse dispatch's kernels to the dense one, and leave the
    others' branch alone."""
    from repro_torch.models import blocks

    calls = []
    orig = blocks.moe_branch
    blocks.moe_branch = lambda cfg, p, x: calls.append(x) or x
    try:
        for ctx in (smoke.plain_kernels(), smoke.plain_training(),
                    smoke.plain_training(yardstick=True)):
            with ctx:
                assert [blocks.moe_branch(None, None, b) for b in ("sparse", "dense", "bmm")] \
                    == ["dense", "dense", "bmm"]
            assert blocks.moe_branch(None, None, "sparse") == "sparse"
    finally:
        blocks.moe_branch = orig


def test_train_memory_reckoning_of_whisper(smoke):
    """The model's own 0.79 B parameters' state, each layer's input held by
    its region, and the encoder layer's working set at 16 x 1500 frames."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-medium")
    n = 789_000_000
    r = smoke.train_memory_reckoning(cfg, None, 16, 448, n)
    assert r["state_bytes"] == 16 * n and "named_activations_bytes" not in r
    assert r["region_inputs_bytes"] == 2 * 1024 * (24 * 16 * 1500 + 24 * 16 * 448 + 16 * 1500)
    assert r["layer_working_set_bytes"] == 2 * 24000 * (6 * 1024 + 2 * 4096) + 4 * 24000 * 16
    assert r["logits_bytes"] == 4 * 16 * 448 * 51968 + 8 * 1024 * 51968


def _rehearse(smoke, monkeypatch, arch, batch, seq):
    """``phase_train`` of ``arch`` rehearsed on the CPU at the smoke size (the
    plain versions on both sides of the gate, so it reads 0; no launch is
    counted off the card, and no profiler)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(launch_train, "get_config", get_smoke_config)
    monkeypatch.setattr(smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(smoke, "RECOVERY_STEPS", 4)
    monkeypatch.setattr(smoke, "RECOVERY_FAIL_AT", (3,))
    monkeypatch.setattr(smoke, "expected_train_launches",
                        lambda cfg, g, policy: dict.fromkeys(
                            ("flash_attention", "flash_attention_bwd", "rglru_scan",
                             "rglru_scan_bwd", "ssd_chunked", "ssd_chunked_bwd"), 0))
    monkeypatch.setattr(smoke, "device_breakdown",
                        lambda fn, top=0: fn() and {} or {"device_busy_ms": 10.0})
    monkeypatch.setattr(smoke, "cuda_median_ms", lambda fn, reps, warmup: fn() or 1.0)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    return smoke.timed_train(torch.device("cpu"), arch, "rehearsal", batch, seq)


def test_moe_train_phase_on_the_cpu(smoke, monkeypatch, capsys):
    """granite's phase at the smoke size: the gate on the plain run's expert
    choice (no swap on the CPU, where both sides are the plain versions),
    the unpinned run counted, the MoE block timed, the drill."""
    import json

    out = _rehearse(smoke, monkeypatch, "granite-moe-1b-a400m", 1, 96)
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"phase": "rehearsal"' in ln][-1])
    routing = line["step1_gate"]["routing"]
    assert routing["pinned"] and routing["router_calls"] == 4
    assert routing["routings"] == 4 * 96
    assert routing["pinned_kernels_swaps"] == routing["unpinned_kernels_swaps"] == 0
    assert routing["unpinned_loss_rel_err"] == 0.0
    assert line["step1_gate"]["loss_rel_err"] == 0.0 and line["step1_gate"]["gated"]
    assert line["step1_float32_gate"] is None
    assert line["moe"]["block_fwd_bwd_ms"] == 1.0 and line["moe"]["layers"] == 4
    # the CPU's float32 smoke config takes the dense dispatch: 4 experts, top 2
    assert line["moe"]["computed_over_routed_expert_flops"] == 2
    assert "moe_dense_dispatch_bytes" in line["memory_reckoned"]
    assert len(line["losses"]) == 2 and line["recovery"]["losses_bit_identical"]
    assert out["phase_seconds"]["rehearsal"] > 0


def test_encdec_train_phase_on_the_cpu(smoke, monkeypatch, capsys):
    """whisper's phase at the smoke size: frames in every batch, frames/s,
    the plan printed as not applied, the bf16 gate printed ungated and the
    float32 gate (the same gate on a float32 copy), the drill."""
    import json

    _rehearse(smoke, monkeypatch, "whisper-medium", 2, 40)
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"phase": "rehearsal"' in ln][-1])
    assert line["batch"] == 2 and line["seq"] == 40 and line["frames"] == 32
    assert line["frames_per_s"] == pytest.approx(line["tokens_per_s"] * 32 / 40, rel=1e-12)
    assert line["plan"]["applied"] is False and line["step1_gate"]["routing"] is None
    assert line["step1_gate"]["loss_rel_err"] == 0.0 and len(line["losses"]) == 2
    assert line["step1_gate"]["gated"] is False        # (the smoke config is float32 too)
    assert line["model_params"] > line["params"]          # the learned positions and more
    gate32 = line["step1_float32_gate"]
    assert gate32["gated"] and gate32["dtype"] == "float32"
    assert gate32["loss_rel_err"] == 0.0 and gate32["grad_rel_err_max"] == 0.0
    assert gate32["within_fixed_limits"] and gate32["yardstick_loss_rel_err"] < 1e-5
    assert gate32["limits"]["loss"] == smoke.FLOAT32_TRAIN_LOSS_LIMIT
    assert line["recovery"]["params_bit_identical"]


@pytest.mark.parametrize("rope", [None, 10000.0])
def test_grad_errors_hold_a_key_bias_to_its_blocks_wk_without_rope(smoke, rope):
    """Without RoPE a key bias's exact gradient is zero, so its reading is
    its error over its block's max |wk grad|; with RoPE, over its own."""
    import types

    cfg = types.SimpleNamespace(rope_theta=rope)
    want = {"a.wk": torch.tensor([4.0, -8.0]), "a.bk": torch.tensor([1e-6, -2e-6]),
            "a.wq": torch.tensor([2.0, 1.0])}
    got = {"a.wk": torch.tensor([4.0, -7.0]), "a.bk": torch.tensor([3e-6, -2e-6]),
           "a.wq": torch.tensor([2.0, 1.5])}
    errs = smoke.grad_errors(cfg, got, want)
    assert errs["a.wk"] == pytest.approx(1 / 8) and errs["a.wq"] == pytest.approx(0.5 / 2)
    assert errs["a.bk"] == pytest.approx(2e-6 / 8 if rope is None else 2e-6 / 2e-6)


def test_step1_gate_prints_an_ungated_reading_and_raises_a_gated_one(smoke, monkeypatch):
    """The same readings pass ungated and raise gated: a loss 10x its limit
    with a yardstick of 0."""
    import types

    cfg = types.SimpleNamespace(n_experts=0, arch_id="x", dtype="float32", rope_theta=None)
    losses = iter([1.0, 1.0, 1.1] * 2)
    monkeypatch.setattr(smoke, "grads_of", lambda tr, batch: (next(losses),
                                                              {"w": torch.ones(2)}))
    monkeypatch.setattr(smoke, "train_wrappers", lambda: {})
    tr = types.SimpleNamespace(cfg=cfg, model=torch.nn.Linear(1, 1),
                               batch_at=lambda step: {"tokens": torch.zeros(1, 2)})
    out = smoke.train_step1_gate(tr, torch.device("cpu"), 1e-2, 1e-3, gated=False)
    assert out["gated"] is False and out["loss_rel_err"] == pytest.approx(0.1)
    assert not out["within_fixed_limits"]
    with pytest.raises(AssertionError, match=r"x \(float32\) step 1 differs"):
        smoke.train_step1_gate(tr, torch.device("cpu"), 1e-2, 1e-3)


def test_the_distributed_child_fails_without_a_gpu_and_the_phase_raises(smoke):
    """``--distributed`` (the multi-device phase) refuses to run without a
    card and prints no result; the parent's phase raises on its exit code."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--distributed"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "GPU" in out.stderr
    with pytest.raises(AssertionError, match="multi-device phase failed"):
        smoke.phase_distributed({}, {}, {})


def test_dry_run_specs_cover_the_trained_configs_and_the_production_cell(smoke):
    specs = smoke.calibration_specs()
    assert set(specs) == {"train", "train_ssm", "train_moe", "train_encdec"}
    assert smoke.PRODUCTION_DRY_RUN == {"arch": "llama3-405b", "cell": "train_4k",
                                        "multi_pod": True}
    assert specs["train_moe"] == {"arch": "granite-moe-1b-a400m", "cell": "train_1x4096",
                                  "batch": 1, "seq": 4096, "multi_pod": False,
                                  "mesh_shape": [1, 1], "plan": True}
    assert (specs["train_encdec"]["batch"], specs["train_encdec"]["seq"]) == (16, 448)


def test_sharded_train_on_the_cpu_equals_the_unsharded_step(smoke):
    """(a) at the smoke size on a one-rank gloo (1, 1) mesh: every parameter
    a DTensor, step 1 bit-equal to the unsharded step on the recorded expert
    choice, then two finite sharded steps (the launch gate is the card's)."""
    out = smoke.sharded_train(torch.device("cpu"), arch=smoke.DIST_ARCH, batch=2, seq=64,
                              smoke=True)
    assert out["backend"] == "gloo" and out["all_params_dtensors"]
    assert out["step1_bit_equal"] and out["step1_routing_swaps"] == 0
    assert out["step1_loss_rel_err"] == out["step1_grad_rel_err_max"] == 0.0
    assert len(out["losses"]) == smoke.DIST_STEPS and all(np.isfinite(out["losses"]))
    assert out["rules"]["params"]["embed"] == "data"
    assert out["sample_placements"] == "(Replicate(), Replicate())"   # a mesh of one rank


def test_the_dry_run_child_on_the_cpu(smoke):
    """``--dry-run SPEC`` at the smoke size, under the planner's plan, on a
    fake (1, 1) mesh: the record's keys as the last line, status ok."""
    spec = {"arch": smoke.MOE_ARCH, "cell": "train_2x64", "batch": 2, "seq": 64,
            "multi_pod": False, "mesh_shape": [1, 1], "plan": True, "smoke": True}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dry-run",
                          json.dumps(spec)], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["mesh"] == {"data": 1, "model": 1}
    assert rec["remat_policy"].startswith("Residency(")
    assert rec["memory_analysis"]["peak_bytes"] >= rec["memory_analysis"][
        "argument_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert sum(rec["collectives"]["counts"].values()) == 0     # one rank: nothing crosses


def test_calibration_holds_each_dry_run_beside_its_measured_step(smoke):
    dry, trains = {}, {}
    for i, (phase, arch, batch, seq) in enumerate(smoke.CALIBRATION):
        dry[phase] = {"memory_analysis": {"peak_bytes": 2e9 * (i + 1),
                                          "argument_size_in_bytes": 1e9},
                      "cost_analysis": {"flops": 3e12, "bytes accessed": 5e11},
                      "time_step_s": 10.0}
        trains[phase] = {"max_memory_allocated_bytes": 4e9, "step_ms_steady": 100.0}
    got = smoke.calibration(dry, trains)
    assert list(got) == [c[0] for c in smoke.CALIBRATION]
    assert got["train"]["peak_ratio"] == 0.5 and got["train_encdec"]["peak_ratio"] == 2.0
    moe = got["train_moe"]
    assert moe["train_model_flops"] == smoke.train_model_flops(
        smoke_config(smoke.MOE_ARCH), smoke.TRAIN_BATCH, smoke.TRAIN_SEQ)
    assert moe["flops_ratio"] == 3e12 / moe["train_model_flops"]


def smoke_config(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


def test_multi_rank_on_gloo_ranks_holds_each_case_to_its_gate(smoke, tmp_path):
    """(d) on 8 gloo ranks of this CPU, as the card's machine runs it under
    its torch: each case sharded against unsharded from the same parameters,
    within the gloo tests' gates."""
    out = smoke.collect_multi_rank(smoke.start_multi_rank(logs=tmp_path), logs=tmp_path)
    assert out["backend"] == "gloo" and out["world"] == 8 and out["torch"] == torch.__version__
    assert out["gates"] == smoke.MULTI_RANK_GATES and "not the device path" in out["check"]
    assert (out["heads_tp"]["tp"], out["heads_tp"]["mesh"]) == ("heads", [4, 2])
    assert (out["qseq_tp"]["tp"], out["qseq_tp"]["mesh"]) == ("q-sequence", [1, 8])
    assert out["qseq_tp"]["seq_axis"] == "model" and out["heads_tp"]["seq_axis"] is None
    assert out["seq_sharded_decode"]["cache_sharded"] and out["seq_sharded_decode"]["steps"] == 16
    for case in ("heads_tp", "qseq_tp", "seq_sharded_decode", "pipeline"):
        read = {k: v for k, v in out[case].items() if k in smoke.MULTI_RANK_GATES}
        assert read and all(v < smoke.MULTI_RANK_GATES[k] for k, v in read.items()), case


def _multi_rank_readings():
    return {"heads_tp": {"loss_abs_err": 0.0, "grad_norm_rel_err": 1e-7},
            "qseq_tp": {"loss_abs_err": 5e-7, "grad_norm_rel_err": 0.0},
            "seq_sharded_decode": {"decode_rel_err": 6e-7, "cache_sharded": True},
            "pipeline": {"pipeline_out_err": 0.0, "pipeline_grad_err": 1.4e-6},
            "rank_seconds": 12.0}


@pytest.mark.parametrize("case, key, value", [
    ("qseq_tp", "loss_abs_err", 2e-3), ("heads_tp", "grad_norm_rel_err", float("nan")),
    ("seq_sharded_decode", "decode_rel_err", 3e-3), ("seq_sharded_decode", "cache_sharded", False),
    ("pipeline", "pipeline_grad_err", 2e-4)])
def test_a_multi_rank_case_outside_its_gate_fails_the_phase(smoke, case, key, value):
    assert smoke.check_multi_rank(_multi_rank_readings())["gates"] == smoke.MULTI_RANK_GATES
    bad = copy.deepcopy(_multi_rank_readings())
    bad[case][key] = value
    with pytest.raises(AssertionError, match=case):
        smoke.check_multi_rank(bad)


def test_a_missing_case_or_a_failed_rank_fails_the_multi_rank_wait(smoke, tmp_path):
    readings = _multi_rank_readings()
    del readings["pipeline"]
    with pytest.raises(AssertionError, match="cases missing.*pipeline"):
        smoke.check_multi_rank(readings)
    (tmp_path / "rank1.err").write_text("the rank's error")
    procs = {0: subprocess.Popen([sys.executable, "-c", "pass"]),
             1: subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])}
    with pytest.raises(AssertionError, match="rank 1 failed.*the rank's error"):
        smoke.collect_multi_rank(procs, logs=tmp_path)


def test_strict_fold_dry_runs_run_beside_training_and_print_per_device(smoke):
    """(e): the cells that stopped on the card's torch; granite's t cell on 4
    x 2 run here as a ``--dry-run`` child, read as the phase reads it."""
    specs = smoke.FOLD_DRY_RUNS
    assert specs["qseq_production"] == {"arch": "qwen2.5-14b", "cell": "train_4k",
                                        "multi_pod": False}
    assert [specs[k]["mesh_shape"] for k in ("granite_t_4x2", "granite_t_2x2x2")] == \
        [[4, 2], [2, 2, 2]]
    rec = smoke.collect_dry_runs(smoke.start_dry_runs(
        {"granite_t_4x2": specs["granite_t_4x2"]}))["granite_t_4x2"]
    line = smoke.per_device(rec)
    assert line["status"] == "ok" and line["n_devices"] == 8
    assert line["mesh"] == {"data": 4, "model": 2} and line["cell"] == "t"
    assert set(line) == {"arch", "cell", "mesh", "n_devices", "status",
                         "argument_bytes_per_device", "peak_bytes_per_device",
                         "flops_per_device", "bytes_accessed_per_device",
                         "wire_bytes_per_device", "collective_counts", "wire_bytes_by_kind",
                         "dry_run_seconds"}
    assert line["peak_bytes_per_device"] >= line["argument_bytes_per_device"] > 0
    assert line["wire_bytes_per_device"] > 0


def test_a_failing_dry_run_fails_the_phase(smoke):
    procs = smoke.start_dry_runs({"bad": {"arch": "no-such-arch", "cell": "train_4k",
                                          "multi_pod": False}})
    with pytest.raises(AssertionError, match="dry run bad failed"):
        smoke.collect_dry_runs(procs)
