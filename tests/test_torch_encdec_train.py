"""Training the port's encoder-decoder (whisper-medium) against the reference,
on the CPU in float32 at the smoke config (2 encoder and 4 decoder layers,
d 128, 32 frames, LayerNorm, a biased GELU MLP, tied embeddings, learned
decoder positions).

* The step: the reference's tree drawn at each layer's own fan-in
  (``torch_port_helpers.init_per_layer``) with every bias nonzero, the
  reference's ``SyntheticLM`` tokens and labels and seeded stub-frontend
  frames; the loss within 1e-5 relative and every gradient leaf (the
  LayerNorms' fp32 biases, the MLP and attention biases, the learned
  positions) within 1e-4 of its max |grad| against ``jax.value_and_grad``
  of the reference; then one AdamW step against the reference's AdamW on
  the same gradients.
* The per-layer recompute regions: the loss and gradients bit-equal with
  and without them (``cfg.remat == "none"``); K2's forward runs
  2 x (encoder + 2 x decoder layers) times a step with them (each layer's
  replay runs it again: the reference hands the encoder-decoder no
  residency plan) and half that without; K2's backward encoder + 2 x
  decoder layers times; ``kernel_forwards`` says the same.
* ``batch_to`` keeps the frames float; the launcher draws them from
  (seed, step), plans, trains, checkpoints and recovers."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (draw_biases, grad_leaf_errors, init_per_layer,
                                port_loss_and_grads, ref_loss_and_grads)

from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_model_defs as ref_arch_model_defs
from repro.runtime import SyntheticLM as RefSyntheticLM
from repro.runtime import adamw as ref_adamw

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.train import build_trainer, parse_args, train_main
from repro_torch.models import EncDec, arch_forward, arch_init_params, cross_entropy_loss
from repro_torch.models.decoder import kernel_forwards
from repro_torch.models.remat import classes_of
from repro_torch.runtime import SyntheticLM, TrainState, adamw, make_train_step
from repro_torch.runtime.train import batch_to

torch.set_num_threads(1)

ARCH = "whisper-medium"
B, SEQ = 2, 40
LOSS_TOL, GRAD_TOL, OPT_TOL = 1e-5, 1e-4, 1e-6
BIAS_STD = 0.5
LR = 1e-2


def _batch(cfg, rng) -> dict:
    batch = RefSyntheticLM(cfg, batch=B, seq_len=SEQ, seed=3).batch_at(0)
    batch["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def pair():
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    assert cfg.dtype == "float32" and dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.n_frames) == (2, 4, 32)
    rng = np.random.default_rng(1)
    params = draw_biases(init_per_layer(ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)),
                         rng, BIAS_STD)
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(cfg, rng)
    model = EncDec(cfg, device="cpu", master=True)
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    got_loss, got = port_loss_and_grads(cfg, model, batch)
    want_loss, want = ref_loss_and_grads(ref_cfg, params, batch)
    return cfg, params, model, batch, (got_loss, got), (float(want_loss), want)


def test_masters_are_fp32_and_require_gradients():
    """``EncDec(master=True)`` in the published bf16: every parameter an fp32
    master; a working-type parameter read as an attribute is cast at use,
    the norms are read as they are stored."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    assert isinstance(model, EncDec)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    layer = model.dec_layers[0]
    assert layer.cross_attn.wq.dtype == torch.bfloat16 and layer.mlp.bi.dtype == torch.bfloat16
    assert layer.ln_x_b.dtype == torch.float32 and model.master("tok_emb").dtype == torch.float32
    tokens = torch.randint(1, cfg.vocab_size, (B, SEQ), generator=torch.Generator().manual_seed(1))
    frames = torch.randn((B, cfg.n_frames, cfg.d_model), generator=torch.Generator().manual_seed(2))
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, {"tokens": tokens, "frames": frames}),
                              tokens)
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        # the key biases' exact gradient is zero (see the next test); rows
        # of pos_emb past SEQ are read by no token
        if not name.endswith(("bk", "pos_emb")):
            assert bool(p.grad.abs().max() > 0), name
    pos = model.master("pos_emb").grad
    assert not pos[SEQ:].any() and pos[:SEQ].abs().max() > 0


def test_loss_and_every_gradient_match_the_reference(pair):
    """Every leaf within GRAD_TOL of its max |grad|, but the key biases:
    with no RoPE a bias added to every key moves each row's scores by one
    constant, which the softmax drops, so their exact gradient is zero and
    both packages give rounding noise (~3e-8 against ~0.3 for ``wk``).
    Those are held within GRAD_TOL of the max |grad| of their block's
    ``wk``."""
    cfg, _, _, _, (got_loss, got), (want_loss, want) = pair
    assert abs(got_loss - want_loss) / abs(want_loss) < LOSS_TOL
    errs = grad_leaf_errors(got, want)
    key_biases = [k for k in errs if k.endswith("['bk']")]
    assert len(key_biases) == 3                       # encoder, decoder self, cross
    rest = {k: v for k, v in errs.items() if k not in key_biases}
    worst = max(rest, key=rest.get)
    assert rest[worst] < GRAD_TOL, (worst, rest[worst])
    leaves = {jax.tree_util.keystr(p): (g, np.asarray(w)) for (p, g), (_, w) in
              zip(jax.tree_util.tree_leaves_with_path(got),
                  jax.tree_util.tree_leaves_with_path(want))}
    for k in key_biases:
        g, w = leaves[k]
        scale = np.abs(leaves[k.replace("['bk']", "['wk']")][1]).max()
        assert np.abs(g - w).max() < GRAD_TOL * scale and np.abs(w).max() < GRAD_TOL * scale, k
    assert any(k.endswith("['ln_x_b']") for k in errs) and "['pos_emb']" in errs


def test_one_adamw_step_matches_the_reference_optimizer(pair):
    """The port's train step (``batch_to``, the loss, its backward, AdamW)
    against the reference's AdamW on the same gradients, within 1e-6."""
    cfg, params, model, batch, (got_loss, got), _ = pair
    opt = adamw(lr=LR)
    named = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    state, metrics = make_train_step(cfg, opt, model)(
        TrainState(params=named, opt_state=opt.init(named), step=0), batch)
    assert state.step == 1 and float(metrics["loss"]) == got_loss
    ref_opt = ref_adamw(lr=LR)
    want, _, _ = ref_opt.apply(params, jax.tree.map(jnp.asarray, got), ref_opt.init(params),
                               jnp.int32(0))
    new = dict(jax.tree_util.tree_leaves_with_path(
        convert.model_params_to_arrays(cfg, dict(model.named_parameters()))))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(new[path], np.asarray(w), rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(before[k])


def _counted_step(cfg, model, batch, monkeypatch):
    """Loss, gradients, and K2's forward and backward calls of one step (on
    the CPU: the plain versions the kernels' wrappers run there)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.flash_attention, fa.flash_attention_bwd_torch

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_torch", count_bwd)
    for p in model.parameters():
        p.grad = None
    tb = batch_to(batch, "cpu")
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, tb), tb["labels"])
    loss.backward()
    monkeypatch.undo()
    return loss.detach(), [p.grad.clone() for p in model.parameters()], calls


def test_per_layer_regions_are_exact_and_counted(pair, monkeypatch):
    cfg, _, model, batch, _, _ = pair
    assert cfg.remat != "none"
    flat = dataclasses.replace(cfg, remat="none")
    loss, grads, calls = _counted_step(cfg, model, batch, monkeypatch)
    loss0, grads0, calls0 = _counted_step(flat, model, batch, monkeypatch)
    assert torch.equal(loss, loss0) and all(torch.equal(a, b) for a, b in zip(grads, grads0))
    layers = cfg.encoder_layers + 2 * cfg.n_layers
    assert calls == {"fwd": 2 * layers, "bwd": layers} and calls0 == {"fwd": layers,
                                                                     "bwd": layers}
    assert kernel_forwards(cfg)["attn_out"] == 2 * layers
    assert kernel_forwards(flat)["attn_out"] == layers
    assert kernel_forwards(cfg, 2, object())["attn_out"] == 2 * layers   # no plan applies
    assert classes_of(cfg) == {"enc_resid", "dec_resid", "attn_q", "attn_kv", "attn_out",
                               "mlp_hidden"}


def test_batch_to_keeps_floating_entries_float():
    rng = np.random.default_rng(0)
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "labels": torch.arange(6, dtype=torch.int32).reshape(2, 3),
             "frames": rng.standard_normal((2, 4, 8)).astype(np.float32) + 0.5,
             "vis_embeds": torch.randn(2, 3, 8, dtype=torch.bfloat16)}
    got = batch_to(batch, "cpu")
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    assert got["frames"].dtype == torch.float32 and got["vis_embeds"].dtype == torch.bfloat16
    assert np.array_equal(got["frames"].numpy(), batch["frames"])
    assert torch.equal(got["vis_embeds"], batch["vis_embeds"])


def test_trainer_batches_carry_frames_from_seed_and_step():
    """Tokens and labels are the reference's ``SyntheticLM`` arrays; the
    frames are unit normals, the same for the same (seed, step), and others
    for another step or seed."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "24"]
    tr = build_trainer(parse_args(args + ["--seed", "5"]))
    cfg = tr.cfg
    b0, again, b1 = tr.batch_at(0), tr.batch_at(0), tr.batch_at(1)
    want = SyntheticLM(cfg, batch=2, seq_len=24, seed=5).batch_at(0)
    assert all(np.array_equal(b0[k], want[k]) for k in ("tokens", "labels"))
    assert b0["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    assert b0["frames"].dtype == torch.float32 and torch.equal(b0["frames"], again["frames"])
    assert not torch.equal(b0["frames"], b1["frames"])
    other = build_trainer(parse_args(args + ["--seed", "6"])).batch_at(0)
    assert not torch.equal(b0["frames"], other["frames"])
    assert abs(float(b0["frames"].std()) - 1.0) < 0.1


def test_launcher_plans_trains_and_recovers_the_encdec(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--device", "cpu", "--batch", "2",
            "--seq", "48", "--log-every", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "a")]
    seen = []
    clean = train_main(argv, on_step=lambda s, m, dt: seen.append(float(m["loss"])))
    out = capsys.readouterr().out
    assert clean.step == 4 and "[plan] planner=greedy" in out and "restarts=0" in out
    assert all(np.isfinite(seen))
    failed = []
    drill = train_main(argv[:-1] + [str(tmp_path / "b"), "--fail-at", "3"],
                       on_step=lambda s, m, dt: failed.append((s, float(m["loss"]))))
    assert "restarts=1" in capsys.readouterr().out
    replayed = dict(failed)
    assert len(failed) == 5 and [replayed[s] for s in range(1, 5)] == seen
    for k, p in clean.params.items():
        assert torch.equal(p, drill.params[k]), k
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002", "step_00000004"]
