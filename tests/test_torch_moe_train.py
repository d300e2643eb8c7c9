"""Training the port's MoE decoders (granite-moe-1b-a400m, mixtral-8x7b with
its sliding window), its vision-token decoder (internvl2-26b) and a decoder
with LayerNorm and a biased GELU MLP against the reference, on the CPU in
float32 at the smoke configs.

The reference's parameter tree is drawn at each layer's own fan-in
(``torch_port_helpers.init_per_layer``), with every bias nonzero
(``draw_biases``), and loaded into a model of fp32 masters; the batch is the
reference's ``SyntheticLM`` batch (and seeded unit-normal vision
embeddings).  The loss is held at 1e-5 relative and every gradient leaf at
1e-4 of its max |grad| against ``jax.value_and_grad`` of the reference's
``arch_forward`` + ``cross_entropy_loss``; then one AdamW step of the port's
train step against the reference's AdamW on the same gradients.  For the
MoE each token's k-th and (k+1)-th router logits are more than
``TOPK_GAP`` apart on the drawn inputs, so no routing flip can hide inside
the tolerance.  The launcher plans, trains, checkpoints and recovers
granite-moe-1b-a400m at the smoke size."""
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
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.train import train_main
from repro_torch.models import Decoder, arch_init_params, blocks
from repro_torch.models.decoder import check_supported
from repro_torch.runtime import TrainState, adamw, make_train_step

torch.set_num_threads(1)

B, SEQ = 2, 80
LOSS_TOL, GRAD_TOL, OPT_TOL = 1e-5, 1e-4, 1e-6
BIAS_STD = 0.5
LR = 1e-2
# the smallest gap allowed between a token's k-th and (k+1)-th router logits
TOPK_GAP = 1e-4


def _variant(cfg):
    return dataclasses.replace(cfg, norm="layernorm", mlp_bias=True, glu=False, act="gelu")


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_every_ported_arch_builds_fp32_masters_for_training(arch):
    """``check_supported`` holds serving and training alike: every ported
    arch passes it at full width and at the smoke size, and its smoke model
    of masters holds fp32 parameters that require gradients."""
    check_supported(get_config(arch))
    check_supported(get_smoke_config(arch))
    model = arch_init_params(get_smoke_config(arch), torch.Generator(), device="cpu",
                             master=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())


CASES = {
    "granite-moe-1b-a400m": lambda get: get("granite-moe-1b-a400m"),
    "mixtral-8x7b": lambda get: get("mixtral-8x7b"),
    "internvl2-26b": lambda get: get("internvl2-26b"),
    "qwen2.5-14b-layernorm-bias-nonglu": lambda get: _variant(get("qwen2.5-14b")),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    ref_cfg, cfg = (CASES[request.param](get) for get in (ref_get_smoke_config,
                                                            get_smoke_config))
    assert cfg.dtype == "float32" and dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    rng = np.random.default_rng(1)
    params = draw_biases(init_per_layer(ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)),
                         rng, BIAS_STD)
    tree = jax.tree.map(np.asarray, params)
    batch = RefSyntheticLM(ref_cfg, batch=B, seq_len=SEQ, seed=3).batch_at(0)
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    model = Decoder(cfg, device="cpu", master=True)
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    routes = []
    orig = blocks.moe_route

    def record(cfg_, p, x):
        logits, top_i = orig(cfg_, p, x)
        routes.append(logits.detach())
        return logits, top_i

    blocks.moe_route = record
    try:
        got_loss, got = port_loss_and_grads(cfg, model, batch)
    finally:
        blocks.moe_route = orig
    want_loss, want = ref_loss_and_grads(ref_cfg, params, batch)
    return ref_cfg, cfg, params, model, batch, (got_loss, got), (float(want_loss), want), routes


def test_loss_and_every_gradient_match_the_reference(case):
    _, cfg, _, model, _, (got_loss, got), (want_loss, want), _ = case
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    assert abs(got_loss - want_loss) / abs(want_loss) < LOSS_TOL
    errs = grad_leaf_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])
    if cfg.mlp_bias or cfg.norm == "layernorm":
        # the biases and the LayerNorms' fp32 biases get gradients into their masters
        names = [k for k in errs if k.endswith(("['bi']", "['bo']", "_b']"))]
        assert names and all(np.abs(np.asarray(_leaf(got, k))).max() > 0 for k in names)


def _leaf(tree, keystr):
    return dict((jax.tree_util.keystr(p), v)
                for p, v in jax.tree_util.tree_leaves_with_path(tree))[keystr]


def test_moe_routing_has_no_near_tie_on_the_drawn_inputs(case):
    """The k-th and (k+1)-th router logits of every token in every layer are
    more than TOPK_GAP apart: a flip of the top-k set between the packages
    would need a logit to move by that much, far past the tolerance."""
    _, cfg, _, _, _, _, _, routes = case
    if not cfg.n_experts:
        assert routes == []
        return
    # the first forward's n_layers router calls, then the recompute regions'
    # replays of them
    assert len(routes) >= cfg.n_layers and len(routes) % cfg.n_layers == 0
    for logits in routes:
        top = torch.topk(logits, cfg.top_k + 1, dim=-1).values
        gap = top[..., cfg.top_k - 1] - top[..., cfg.top_k]
        assert float(gap.min()) > TOPK_GAP, float(gap.min())


def test_one_adamw_step_matches_the_reference_optimizer(case):
    """The port's train step (``make_train_step``: ``batch_to``, the loss,
    its backward, AdamW) against the reference's AdamW applied to the same
    gradients: the parameters within 1e-6.  (The gradients are held to the
    reference's in the test above; AdamW's first step is ``lr * sign(g)``,
    which would turn a difference near zero into 2 lr.)"""
    _, cfg, params, model, batch, (got_loss, got), _, _ = case
    opt = adamw(lr=LR)
    named = dict(model.named_parameters())
    step = make_train_step(cfg, opt, model)
    before = {k: p.detach().clone() for k, p in named.items()}
    state, metrics = step(TrainState(params=named, opt_state=opt.init(named), step=0), batch)
    assert state.step == 1 and float(metrics["loss"]) == got_loss
    ref_opt = ref_adamw(lr=LR)
    want, _, ref_metrics = ref_opt.apply(params, jax.tree.map(jnp.asarray, got),
                                         ref_opt.init(params), jnp.int32(0))
    # the norm that clips the step, against the gradients' norm in float64
    # (the reference sums its stacked leaves in float32: 2e-5 off here)
    norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(got))))
    assert abs(float(metrics["grad_norm"]) - norm) < 1e-6 * norm
    assert abs(float(ref_metrics["grad_norm"]) - norm) < 1e-4 * norm
    new = convert.model_params_to_arrays(cfg, dict(model.named_parameters()))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(_leaf(new, jax.tree_util.keystr(path)), np.asarray(w),
                                   rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():                 # the module's model goes back as it was
        for k, p in named.items():
            p.copy_(before[k])


def test_launcher_plans_trains_and_recovers_the_moe(tmp_path, capsys):
    arch = "granite-moe-1b-a400m"
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--device", "cpu", "--batch", "2",
            "--seq", "64", "--log-every", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "a")]
    seen = []
    clean = train_main(argv, on_step=lambda s, m, dt: seen.append(float(m["loss"])))
    out = capsys.readouterr().out
    assert clean.step == 4 and "[plan] planner=greedy" in out and "moe_hidden" in out
    assert "restarts=0" in out and all(np.isfinite(seen))
    failed = []
    drill = train_main(argv[:-1] + [str(tmp_path / "b"), "--fail-at", "3"],
                       on_step=lambda s, m, dt: failed.append((s, float(m["loss"]))))
    assert "restarts=1" in capsys.readouterr().out
    replayed = dict(failed)
    assert len(failed) == 5 and [replayed[s] for s in range(1, 5)] == seen
    for k, p in clean.params.items():
        assert torch.equal(p, drill.params[k]), k
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002", "step_00000004"]
