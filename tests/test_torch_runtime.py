"""The port's runtime (``repro_torch.runtime``): the reference's runtime tests
(tests/test_runtime.py) on the port — optimizers, gradient compression,
checkpoint round trip, bitwise-deterministic failure recovery, checkpointer
GC and atomicity, mesh shrinking, straggler rebalancing, data determinism
and sharding — and the data pipeline against the reference's batches."""
import os

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

from repro.runtime import SyntheticLM as RefSyntheticLM
from repro.runtime import elastic as ref_elastic

from repro_torch.configs import get_smoke_config
from repro_torch.models import arch_init_params
from repro_torch.runtime import (
    SyntheticLM, TrainState, adafactor, adamw, checkpoint as ck, make_train_step,
)
from repro_torch.runtime.elastic import (
    FailureInjector, run_with_recovery, shrink_mesh_plan, straggler_rebalance,
)
from repro_torch.runtime.optimizer import compress_decompress, global_norm


@pytest.mark.parametrize("make_opt", [lambda: adamw(lr=0.1), lambda: adafactor(lr=0.5)])
def test_optimizer_minimizes_quadratic(make_opt):
    opt = make_opt()
    params = {"w": torch.full((256, 256), 3.0), "b": torch.full((256,), -2.0)}
    init_norm = float(global_norm(params))
    state = opt.init(params)
    for step in range(150):
        grads = {k: 2 * p for k, p in params.items()}
        params, state, _ = opt.apply(params, grads, state, step)
    assert float(global_norm(params)) < 0.1 * init_norm


def test_adamw_master_fp32_tracks_plain_adamw():
    w = torch.randn((64, 64), generator=torch.Generator().manual_seed(0))
    p32, p16 = {"w": w.clone()}, {"w": w.to(torch.bfloat16)}
    o32, o16 = adamw(lr=0.05, weight_decay=0.0), adamw(lr=0.05, weight_decay=0.0,
                                                        master_fp32=True)
    s32, s16 = o32.init(p32), o16.init(p16)
    for i in range(30):
        g = {"w": 2 * p32["w"]}
        p32, s32, _ = o32.apply(p32, g, s32, i)
        p16, s16, _ = o16.apply(p16, {"w": g["w"].clone()}, s16, i)
    np.testing.assert_allclose(s16["master"]["w"].numpy(), p32["w"].numpy(), atol=0.01)
    assert p16["w"].dtype == torch.bfloat16


def test_adamw_bias_correction_first_step():
    opt = adamw(lr=1.0, b1=0.9, b2=0.999, eps=0.0, weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.zeros(4)}
    new, _, _ = opt.apply(params, {"w": torch.full((4,), 0.5)}, opt.init(params), 0)
    np.testing.assert_allclose(new["w"].numpy(), -1.0, rtol=1e-5)


def test_gradient_compression_error_feedback():
    g = torch.tensor(np.random.default_rng(0).normal(size=(512,)).astype(np.float32)) * 1e-3
    resid, acc, exact = torch.zeros_like(g), torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        wire, resid = compress_decompress(g, resid, "int8")
        acc, exact = acc + wire, exact + g
    assert float(torch.linalg.norm(acc - exact) / torch.linalg.norm(exact)) < 0.02
    wire, _ = compress_decompress(g, torch.zeros_like(g), "bf16")
    assert torch.equal(wire, g.to(torch.bfloat16).float())


def test_adafactor_memory_factored():
    st = adafactor().init({"big": torch.zeros((512, 512)), "small": torch.zeros((4, 4)),
                           "vec": torch.zeros(512)})
    assert set(st["slots"]["big"]) == {"vr", "vc"}
    assert set(st["slots"]["small"]) == {"v"} and set(st["slots"]["vec"]) == {"v"}
    assert st["slots"]["big"]["vr"].shape == (512,) and st["slots"]["big"]["vc"].shape == (512,)


def _setup(arch="qwen2.5-14b", lr=1e-2):
    cfg = get_smoke_config(arch)
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    opt = adamw(lr=lr, weight_decay=0.01)
    params = dict(model.named_parameters())
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    data = SyntheticLM(cfg, batch=4, seq_len=32, seed=0)
    return cfg, state, make_train_step(cfg, opt, model), data.batch_at


def test_checkpoint_roundtrip(tmp_path):
    _, state, ts, batch_at = _setup()
    for i in range(3):
        state, _ = ts(state, batch_at(i))
    ck.save(str(tmp_path), 3, state)
    assert ck.latest_step(str(tmp_path)) == 3
    _, fresh, _, _ = _setup()
    restored, meta = ck.restore(str(tmp_path), fresh)
    assert meta["step"] == 3 and restored.step == 3
    for k, p in state.params.items():
        assert torch.equal(p, restored.params[k])
        assert torch.equal(state.opt_state["m"][k], restored.opt_state["m"][k])
    # restored in place: the fresh model's own parameters now hold the values
    assert all(restored.params[k] is p for k, p in fresh.params.items())


def test_checkpoint_keeps_bf16_and_scalars(tmp_path):
    tree = {"a": torch.randn(5).to(torch.bfloat16), "b": [np.arange(3), 7], "c": 2.5}
    ck.save(str(tmp_path), 1, tree)
    like = {"a": torch.zeros(5, dtype=torch.bfloat16), "b": [np.zeros(3, np.int64), 0],
            "c": 0.0}
    got, _ = ck.restore(str(tmp_path), like)
    assert torch.equal(got["a"], tree["a"]) and got["b"][1] == 7 and got["c"] == 2.5
    assert np.array_equal(got["b"][0], np.arange(3))


def test_failure_recovery_is_bitwise_deterministic(tmp_path):
    """Two runs from the same seed, one failing twice: the same losses and
    the same parameters, bit for bit (data is a function of the step)."""
    runs = []
    for name, inj in (("clean", None), ("failing", FailureInjector(fail_at=(7, 13)))):
        _, state, ts, batch_at = _setup("recurrentgemma-2b", lr=3e-3)
        losses = {}
        out, restarts = run_with_recovery(
            init_state=state, train_step=ts, batch_at=batch_at, n_steps=16,
            ckpt_dir=str(tmp_path / name), ckpt_every=5, injector=inj,
            on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        runs.append((out, restarts, losses))
    (a, r0, la), (b, r1, lb) = runs
    assert r0 == 0 and r1 == 2 and la == lb and a.step == b.step == 16
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_failure_before_any_checkpoint_needs_reinit(tmp_path):
    _, state, ts, batch_at = _setup()
    with pytest.raises(RuntimeError, match="injected"):
        run_with_recovery(init_state=state, train_step=ts, batch_at=batch_at, n_steps=3,
                          ckpt_dir=str(tmp_path), ckpt_every=10,
                          injector=FailureInjector(fail_at=(1,)))


def test_checkpointer_gc_and_atomicity(tmp_path):
    cp = ck.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cp.save_async(s, {"x": torch.arange(10)})
    cp.wait()
    cp._gc()
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(tmp_path) if p.startswith("step_"))
    assert steps == [3, 4]
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_shrink_mesh_plan():
    p = shrink_mesh_plan(384)
    assert p["mesh_shape"] == (24, 16) and p["devices_used"] == 384
    p = shrink_mesh_plan(12)
    assert p["mesh_shape"][1] <= 12 and p["devices_used"] <= 12
    for n in (1, 12, 40, 384):
        assert shrink_mesh_plan(n) == ref_elastic.shrink_mesh_plan(n)


def test_straggler_rebalance_shrinks_slow_stage():
    lc, som, mt = np.ones(24), np.repeat(np.arange(4), 6), np.array([1.0, 1.0, 3.0, 1.0])
    nm = straggler_rebalance(lc, som, mt)
    sizes = np.bincount(nm, minlength=4)
    assert sizes[2] < 6 and sizes.sum() == 24 and (np.diff(nm) >= 0).all()
    assert np.array_equal(nm, ref_elastic.straggler_rebalance(lc, som, mt))


def test_data_pipeline_determinism_and_sharding():
    cfg = get_smoke_config("qwen2.5-14b")
    d1 = SyntheticLM(cfg, batch=8, seq_len=32, seed=5)
    b1, b2 = d1.batch_at(17), SyntheticLM(cfg, batch=8, seq_len=32, seed=5).batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    h0 = d1.batch_at(3, host_index=0, host_count=2)
    h1 = d1.batch_at(3, host_index=1, host_count=2)
    assert h0["tokens"].shape[0] == 4 and not np.array_equal(h0["tokens"], h1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    ref = RefSyntheticLM(cfg, batch=8, seq_len=32, seed=5)
    for step in (0, 17):
        for host in (0, 1):
            want = ref.batch_at(step, host_index=host, host_count=2)
            got = d1.batch_at(step, host_index=host, host_count=2)
            assert all(np.array_equal(got[k], want[k]) for k in want)
