"""The port's vision-language decoder (internvl2-26b) and the decoder's
LayerNorm / biased non-GLU form against the reference: the same parameters
(the reference's initialiser at each layer's own fan-in,
``torch_port_helpers.init_per_layer``, carried over as arrays, every bias
drawn nonzero), the same prompts and the same stub-frontend vision
embeddings go through ``repro``'s forward, prefill and 8 decode steps and
the port's, on the CPU in float32, and the logits agree within 1e-4 of max
|logit|.

internvl2-26b at its smoke config: 4 layers of global attention (4 heads, 4
kv heads), d 128, 8 vision tokens replacing the first 8 prompt positions.
The decoder form: qwen2.5-14b's smoke config with ``norm="layernorm"``,
``mlp_bias``, ``glu=False`` and GELU, the blocks whisper's decoder is made
of, inside the decoder-only stack."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import draw_biases, init_per_layer, init_readings, rel_close

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_decode_step as ref_decode_step
from repro.models import arch_forward as ref_forward
from repro.models import arch_model_defs as ref_arch_model_defs
from repro.models.common import ParamDef as RefParamDef
from repro.models.common import init_tree as ref_init_tree
from repro.models.common import layer_norm as ref_layer_norm
from repro.runtime import make_prefill_step as ref_make_prefill_step

from repro_torch import convert
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.model_serve import make_batch, serve, serve_main
from repro_torch.launch.train import training_bytes
from repro_torch.models import Decoder, arch_decode_step, arch_forward, arch_init_params
from repro_torch.models.common import layer_norm
from repro_torch.models.decoder import Layer, check_supported
from repro_torch.runtime import make_prefill_step

torch.set_num_threads(1)

VLM = "internvl2-26b"
B, PROMPT, STEPS = 2, 48, 8
TOL = 1e-4
BIAS_STD = 0.5
# the port's forward against the reference's within this many times what one
# float32 unit in the parameters does to the logits (torch_port_helpers.init_readings)
UNIT_FACTOR = 4


def _variant(cfg):
    return dataclasses.replace(cfg, norm="layernorm", mlp_bias=True, glu=False, act="gelu")


CASES = {
    VLM: lambda get: get(VLM),
    "qwen2.5-14b-layernorm-bias-nonglu": lambda get: _variant(get("qwen2.5-14b")),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    ref_cfg, cfg = (CASES[request.param](get) for get in (ref_get_smoke_config,
                                                            get_smoke_config))
    rng = np.random.default_rng(1)
    params = init_per_layer(ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0))
    params = draw_biases(params, rng, BIAS_STD)
    tree = jax.tree.map(np.asarray, params)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    batch = {"tokens": tokens[:, :PROMPT]}
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, params, tree, model, tokens, batch


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_matches_reference_and_serves_but_does_not_train():
    assert VLM in PORTED_ARCH_IDS
    assert dataclasses.asdict(get_config(VLM)) == dataclasses.asdict(ref_get_config(VLM))
    assert dataclasses.asdict(get_smoke_config(VLM)) == dataclasses.asdict(
        ref_get_smoke_config(VLM))
    # (the name is older than vision-token training: one check_supported
    # holds serving and training, and the arch and the LayerNorm / biased /
    # non-GLU variant now train, tests/test_torch_moe_train.py;
    # internvl2-26b's fp32 state does not fit one 80 GB card, which the
    # launcher says from training_bytes)
    check_supported(get_config(VLM))
    cfg = get_config(VLM)
    assert training_bytes(cfg, "adamw") == 16 * cfg.param_count() > 300e9
    variant = _variant(get_smoke_config("qwen2.5-14b"))
    check_supported(variant)


def test_decoder_holds_the_reference_tree_at_full_width():
    """internvl2-26b's 19.9 B parameters, one layer built on the meta device."""
    cfg = get_config(VLM)
    layer = Layer(cfg, "attn", torch.bfloat16, "meta")
    n_params = (2 * cfg.padded_vocab * cfg.d_model + cfg.d_model
                + cfg.n_layers * sum(p.numel() for p in layer.parameters()))
    ref_defs = jax.tree.leaves(ref_arch_model_defs(ref_get_config(VLM)),
                               is_leaf=lambda d: isinstance(d, RefParamDef))
    assert n_params == sum(int(np.prod(d.shape)) for d in ref_defs)
    assert round(n_params / 1e9, 1) == 19.9


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = ref_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    rel_close(got.numpy(), want, 1e-6, "layer_norm")
    half = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b))
    assert half.dtype == torch.bfloat16                  # statistics in fp32, result in x's type


def test_params_round_trip_through_the_reference_layout(pair):
    _, cfg, _, tree, model, _, _ = pair
    back = convert.model_params_to_arrays(cfg, model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), jax.tree_util.keystr(path)
    if cfg.norm == "layernorm":
        assert back["ln_f_b"].any() and back["layers"]["mlp"]["bi"].shape == (4, cfg.d_ff)
        assert "wg" not in back["layers"]["mlp"]


def test_forward_matches_reference(pair):
    ref_cfg, cfg, params, _, model, _, batch = pair
    want = ref_forward(ref_cfg, params, _ref(batch))
    got = arch_forward(cfg, model, _port(batch))
    rel_close(got.numpy(), want, TOL, "forward")


def test_prefill_and_decode_match_reference(pair):
    ref_cfg, cfg, params, _, model, tokens, batch = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(params, _ref(batch))
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(model, _port(batch))
    rel_close(logits.numpy(), ref_logits, TOL, "prefill")
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        rel_close(logits.numpy(), ref_logits, TOL, f"decode step {i}")


def test_vision_embeddings_replace_the_first_positions():
    """The logits at every position see the vision embeddings (causal
    attention from the first positions), and the token ids under them are
    never read."""
    cfg = get_smoke_config(VLM)
    model = arch_init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    batch = make_batch(cfg, 2, 24, torch.Generator().manual_seed(7), device="cpu")
    nv = cfg.n_vis_tokens
    got = arch_forward(cfg, model, batch)
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :nv] = (other["tokens"][:, :nv] + 7) % cfg.vocab_size
    assert torch.equal(arch_forward(cfg, model, other), got)
    plain = arch_forward(cfg, model, {"tokens": batch["tokens"]})
    assert (plain - got).abs().amax(dim=(0, 2)).min() > 0


def test_serve_draws_vision_embeddings():
    cfg = get_smoke_config(VLM)
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch(cfg, 2, 20, torch.Generator().manual_seed(5), device="cpu")
    assert batch["vis_embeds"].shape == (2, cfg.n_vis_tokens, cfg.d_model)
    assert "frames" not in batch
    res = serve(cfg, model, batch, 4, device="cpu")
    assert res.ids.shape == (2, 4) and (res.ids < cfg.vocab_size).all()


def test_serve_main_runs_the_vlm_smoke_model(capsys):
    ids = serve_main(["--arch", VLM, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--seed", "3"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config(VLM).vocab_size).all()
    assert f"[serve] {VLM} on cpu: prefill 2x16" in capsys.readouterr().out


@pytest.mark.parametrize("init", ["stacked", "per_layer"])
def test_rounding_sensitivity_at_each_init(init):
    """Why the parity tests draw ``init_per_layer``: at the reference's own
    stacked initialiser (each stacked leaf's fan-in taken from the layer
    axis) one float32 unit in the parameters moves the forward logits by more
    than a tenth of TOL, so TOL stands too close to rounding to tell a fault
    from it; at each layer's own fan-in by less.  At either, the port stays
    within UNIT_FACTOR times that reading of the reference."""
    ref_cfg, cfg = ref_get_smoke_config(VLM), get_smoke_config(VLM)
    defs, key = ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    params = init_per_layer(defs, key) if init == "per_layer" else ref_init_tree(defs, key)
    params = draw_biases(params, rng, BIAS_STD)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32),
             "vis_embeds": rng.standard_normal(
                 (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)}
    err, unit = init_readings(ref_cfg, cfg, params, batch)
    assert err < UNIT_FACTOR * unit, (err, unit)
    assert (unit > TOL / 10) if init == "stacked" else (unit < TOL / 10), unit
