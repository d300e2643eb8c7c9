"""Training in the port against the reference, on the CPU at the smoke size.

* The train step: recurrentgemma-2b's smoke config (float32), the
  reference's parameters carried over by ``convert.model_params_from_arrays``
  and the same ``SyntheticLM`` batch: the loss within 1e-5 relative, every
  gradient within 1e-4 of its max |grad|.  The gradients are compared
  directly, not through an optimizer step (AdamW's first step is
  ``lr * sign(g)``, which turns a difference near zero into 2 lr).
* The optimizers, held apart: the same gradients into both packages' AdamW
  (with and without ``master_fp32``) and Adafactor (factored and not) give
  the same parameters within 1e-6.
* The residency plan's lowering (``models.remat``): per activation class a
  keep, an offload and a remat plan give the loss and gradients of the
  forward without recomputation bit for bit; the kernel outputs computed per
  class are layers x (1 + replays) as the plan implies; offloaded outputs go
  through pinned host memory.
* The launcher: ``train_main`` plans, trains and recovers from an injected
  failure; the training state of each arch is sized before anything is
  allocated.  mamba2-780m's training (K4's gradient, its step, ``ssm_out``'s
  residency, its launcher run) is held in ``tests/test_torch_ssd_train.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_forward as ref_arch_forward
from repro.models import arch_init_params as ref_arch_init_params
from repro.models import cross_entropy_loss as ref_cross_entropy_loss
from repro.runtime import SyntheticLM as RefSyntheticLM
from repro.runtime import adafactor as ref_adafactor
from repro.runtime import adamw as ref_adamw

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import train_main, training_bytes
from repro_torch.models import Decoder, arch_forward, arch_init_params, cross_entropy_loss
from repro_torch.models.decoder import kernel_forwards
from repro_torch.models.remat import Residency, classes_of
from repro_torch.runtime import SyntheticLM, adafactor, adamw

ARCH = "recurrentgemma-2b"
LOSS_TOL, GRAD_TOL, OPT_TOL = 1e-5, 1e-4, 1e-6


def _ref_loss_and_grads(cfg, params, batch):
    def loss_fn(p):
        logits = ref_arch_forward(cfg, p, batch)
        return ref_cross_entropy_loss(cfg, logits, batch["labels"])

    return jax.value_and_grad(loss_fn)(params)


def test_train_step_matches_the_reference_in_float32():
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    assert cfg.dtype == "float32" and dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    params = ref_arch_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    np_batch = RefSyntheticLM(ref_cfg, batch=2, seq_len=64, seed=3).batch_at(0)
    assert all(np.array_equal(v, SyntheticLM(cfg, batch=2, seq_len=64, seed=3).batch_at(0)[k])
               for k, v in np_batch.items())
    loss, grads = _ref_loss_and_grads(ref_cfg, params,
                                      {k: jnp.asarray(v) for k, v in np_batch.items()})

    model = Decoder(cfg, device="cpu", master=True)
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    batch = {k: torch.as_tensor(v).long() for k, v in np_batch.items()}
    got = cross_entropy_loss(cfg, arch_forward(cfg, model, batch), batch["labels"])
    got.backward()
    assert abs(float(got.detach()) - float(loss)) / abs(float(loss)) < LOSS_TOL
    got_tree = convert.model_params_to_arrays(cfg, {k: p.grad for k, p in
                                                    model.named_parameters()})
    want = jax.tree_util.tree_leaves_with_path(grads)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(got_leaves) == len(want)
    for path, w in want:
        w = np.asarray(w)
        err = np.max(np.abs(got_leaves[path] - w)) / (np.max(np.abs(w)) + 1e-30)
        assert err < GRAD_TOL, (jax.tree_util.keystr(path), err)


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"big": (256, 192), "small": (4, 6), "vec": (130,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adamw_master", "adafactor", "adafactor_unfactored"])
def test_optimizers_match_the_reference_on_the_same_gradients(name):
    make = {
        "adamw": (lambda: ref_adamw(lr=0.05), lambda: adamw(lr=0.05)),
        "adamw_master": (lambda: ref_adamw(lr=0.05, master_fp32=True),
                         lambda: adamw(lr=0.05, master_fp32=True)),
        "adafactor": (lambda: ref_adafactor(lr=0.3), lambda: adafactor(lr=0.3)),
        "adafactor_unfactored": (lambda: ref_adafactor(lr=0.3, min_dim_size_to_factor=512),
                                 lambda: adafactor(lr=0.3, min_dim_size_to_factor=512)),
    }[name]
    ref_opt, opt = make[0](), make[1]()
    params, grads = _opt_inputs(1)
    master = name == "adamw_master"
    rp = {k: jnp.asarray(v, jnp.bfloat16 if master else jnp.float32) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16 if master else torch.float32)
          for k, v in params.items()}
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for step, g in enumerate(grads):
        rp, rs, rm = ref_opt.apply(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs,
                                   jnp.int32(step))
        tp, ts, tm = opt.apply(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, step)
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) < 1e-5 * float(
            rm["grad_norm"])
    for k in params:
        if master:
            # the fp32 masters are the parameters; the stored bf16 copies are
            # each package's master rounded once (an fp32 difference of 1e-7
            # can straddle a bf16 rounding boundary: one unit, <= 2^-7 relative)
            np.testing.assert_allclose(ts["master"][k].numpy(), np.asarray(rs["master"][k]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            assert torch.equal(tp[k], ts["master"][k].to(torch.bfloat16))
            np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(rp[k], np.float32),
                                       rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]), rtol=OPT_TOL,
                                       atol=OPT_TOL)
    if name == "adafactor":
        assert set(ts["slots"]["big"]) == {"vr", "vc"} and set(ts["slots"]["vec"]) == {"v"}
    if name == "adafactor_unfactored":
        assert set(ts["slots"]["big"]) == {"v"}


# ---- the residency plan's lowering -----------------------------------------
def _loss_and_grads(cfg, model, batch, policy, scan_group=None):
    for p in model.parameters():
        p.grad = None
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, batch, remat_policy=policy,
                                                scan_group=scan_group), batch["labels"])
    loss.backward()
    if policy is not None:
        policy.clear()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke_config(ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg, batch=2, seq_len=80, seed=1).batch_at(0).items()}
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), model, batch, None)
    return cfg, model, batch, base


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _kernel_layers(cfg) -> dict:
    return {"attn_out": cfg.kinds.count("attn_local"), "rec_out": cfg.kinds.count("rec")}


@pytest.mark.parametrize("name", ["attn_q", "attn_kv", "attn_out", "mlp_hidden", "rec_out",
                                  "resid_mid", "resid_out"])
@pytest.mark.parametrize("tier", ["keep", "offload", "remat"])
def test_each_class_keep_offload_remat_is_exact_and_counted(smoke_model, name, tier):
    """The smoke model has two (rec, rec, attn_local) periods and no tail, so
    a recomputed layer runs three times (first forward, the period's replay,
    its own); a held kernel output is computed once and replayed twice."""
    cfg, model, batch, base = smoke_model
    others = tuple(sorted(classes_of(cfg) - {name}))
    policy = {"keep": Residency((name,)), "offload": Residency((), (name,)),
              "remat": Residency(others)}[tier]
    got = _loss_and_grads(cfg, model, batch, policy)
    assert _same(got, base)
    for cls, n in _kernel_layers(cfg).items():
        held = (cls == name) == (tier != "remat")
        assert policy.computed[cls] == (n if held else 3 * n), cls
        assert policy.replayed[cls] == (2 * n if held else 0), cls
        assert policy.seen[cls] == 3 * n
    assert {k: policy.computed[k] for k in _kernel_layers(cfg)} == \
        {k: v for k, v in kernel_forwards(cfg, None, policy).items() if k != "ssm_out"}
    if tier == "offload" and name in ("attn_out", "rec_out"):
        per_layer = {"attn_out": (2 * 80 * 4 * 32 + 2 * 80 * 4) * 4,   # out + lse, fp32
                     "rec_out": 2 * 80 * 128 * 4}[name]
        assert policy.offloaded_bytes == per_layer * _kernel_layers(cfg)[name]
    else:
        assert policy.offloaded_bytes == 0


def test_a_plan_that_keeps_everything_recomputes_nothing(smoke_model):
    cfg, model, batch, base = smoke_model
    policy = Residency(tuple(classes_of(cfg)))
    assert policy.recomputes_nothing(cfg)
    assert _same(_loss_and_grads(cfg, model, batch, policy), base)
    assert dict(policy.computed) == _kernel_layers(cfg) and not policy.replayed


def test_no_plan_saves_nothing_and_recomputes_every_layer(smoke_model):
    cfg, model, batch, base = smoke_model
    counting = Residency()        # what remat_policy=None lowers to, with its counts
    assert _same(_loss_and_grads(cfg, model, batch, counting), base)
    assert _same(_loss_and_grads(cfg, model, batch, None), base)
    assert dict(counting.computed) == {k: 3 * n for k, n in _kernel_layers(cfg).items()}


@pytest.mark.parametrize("scan_group,replays", [(1, 1), (2, 2)])
def test_uniform_stack_regions_follow_the_scan_group(scan_group, replays):
    cfg = get_smoke_config("qwen2.5-14b")
    model = arch_init_params(cfg, torch.Generator().manual_seed(2), device="cpu", master=True)
    tokens = torch.randint(1, 500, (2, 40), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens}
    base = _loss_and_grads(dataclasses.replace(cfg, remat="none"), model, batch, None)
    policy = Residency(("resid_out",))
    assert _same(_loss_and_grads(cfg, model, batch, policy, scan_group=scan_group), base)
    assert policy.computed["attn_out"] == cfg.n_layers * (1 + replays)


def test_launcher_plans_trains_and_recovers(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "6", "--device", "cpu", "--batch", "2",
            "--seq", "64", "--log-every", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "a")]
    seen = []
    clean = train_main(argv, on_step=lambda s, m, dt: seen.append(float(m["loss"])))
    out = capsys.readouterr().out
    assert clean.step == 6 and "[plan] planner=greedy" in out and "[done] steps=6" in out
    assert "restarts=0" in out
    failed = []
    drill = train_main(argv[:-1] + [str(tmp_path / "b"), "--fail-at", "3", "5"],
                       on_step=lambda s, m, dt: failed.append((s, float(m["loss"]))))
    assert "restarts=2" in capsys.readouterr().out
    replayed = dict(failed)        # a step run again after a restore keeps its loss
    assert len(failed) == 8 and [replayed[s] for s in range(1, 7)] == seen
    for k, p in clean.params.items():
        assert torch.equal(p, drill.params[k]), k
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002", "step_00000004",
                                                  "step_00000006"]


def test_launcher_refuses_ssm_and_sizes_the_state():
    """The state sizing (the SSM kind is no longer refused: mamba2-780m
    trains, tests/test_torch_ssd_train.py): fp32 parameters + gradients +
    AdamW moments; the default arch does not fit one 80 GB card,
    recurrentgemma-2b and mamba2-780m (~12.5 GB) do."""
    assert training_bytes(get_config("qwen2.5-14b"), "adamw") > 200e9
    assert 40e9 < training_bytes(get_config(ARCH), "adamw") < 45e9
    mamba2 = get_config("mamba2-780m")
    assert training_bytes(mamba2, "adamw") == 16 * mamba2.param_count()
    assert 12.4e9 < training_bytes(mamba2, "adamw") < 12.6e9
