"""The plumbing of ``chip_smoke.py`` that needs no GPU: its refusal to run
without one, the candidate batches it builds, the byte/operation bound it
computes and the host-phase timers it wraps around the search round."""
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
    # task, n_done per row, the shared predecessor matrix once; no q
    want = 32 * b * n_b + 4 * b + 4 * graph.pred_mat.numel()
    if tails:                                  # msucc in, q out, successor matrix
        want += (4 + 8) * b * n_b + 4 * graph.succ_mat.numel()
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


def test_plain_kernels_swap_the_ops_and_restore_them(smoke):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg

    before = (ops.flash_attention, ops.rglru_scan)
    q = torch.randn((1, 9, 2, 8), generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 5, 4), generator=torch.Generator().manual_seed(1))
    with smoke.plain_kernels():
        assert (ops.flash_attention, ops.rglru_scan) != before
        assert torch.equal(ops.flash_attention(q, q[:, :, :1], q[:, :, :1], window=3),
                           fa.flash_attention_torch(q, q[:, :, :1], q[:, :, :1], window=3))
        y, h = ops.rglru_scan(x, torch.zeros(4), x.sigmoid(), x.sigmoid())
        want = rg.rglru_scan_torch(x, torch.zeros(4), x.sigmoid(), x.sigmoid())
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert (ops.flash_attention, ops.rglru_scan) == before


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


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 256>(Params)", "K2"),
    ("(anonymous namespace)::rglru_scan_kernel(float const*, float const*)", "K3"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise")])
def test_profile_classes_name_the_kernels(smoke, name, cls):
    assert smoke._kernel_class(name).startswith(cls)
