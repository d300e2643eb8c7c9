"""The port's MoE decoders (granite-moe-1b-a400m, mixtral-8x7b) against the
reference: the same parameters (the reference's initialiser at each layer's
own fan-in, ``torch_port_helpers.init_per_layer``, carried over as arrays)
and the same prompts go through ``repro``'s forward, prefill and
8 decode steps and the port's, on the CPU in float32 at each arch's smoke
config (4 layers, d 128, 4 experts top 2, GLU experts; granite global
attention, mixtral a 64-slot sliding-window ring that the 80-token prompt
wraps), and the logits agree within 1e-4 of max |logit|.

The blocks alone, on the same seeded inputs, at 1e-5: the top-k MoE with
the reference's dense dispatch, and the dense MLP in each of its forms (GLU
or not, biased or not) against ``repro.models.blocks``."""
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
from repro.models import blocks as ref_blocks
from repro.models.common import ParamDef as RefParamDef
from repro.models.common import init_tree as ref_init_tree
from repro.models.decoder import model_defs as ref_model_defs
from repro.runtime import make_prefill_step as ref_make_prefill_step

from repro_torch import convert
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.model_serve import serve_main
from repro_torch.launch.train import training_bytes
from repro_torch.models import (Decoder, arch_cache_defs, arch_decode_step, arch_forward,
                                arch_init_cache, blocks)
from repro_torch.models.common import DefModule
from repro_torch.models.decoder import Layer, check_supported
from repro_torch.runtime import make_prefill_step

torch.set_num_threads(1)

ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b")
B, PROMPT, STEPS = 2, 80, 8
TOL = 1e-4
BLOCK_TOL = 1e-5
# the port's forward against the reference's within this many times what one
# float32 unit in the parameters does to the logits (torch_port_helpers.init_readings)
UNIT_FACTOR = 4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    assert ref_cfg.uniform and ref_cfg.scan_layers and cfg.n_experts == 4 and cfg.top_k == 2
    params = init_per_layer(ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, cfg, params, tree, model, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_and_serves_but_does_not_train(arch):
    assert arch in PORTED_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        ref_get_smoke_config(arch))
    # (the name is older than MoE training: both now serve and train, and one
    # check_supported holds both; which fits one card is the launcher's
    # question, training_bytes)
    check_supported(get_config(arch))
    cfg = get_config(arch)
    assert training_bytes(cfg, "adamw") == 16 * cfg.param_count()
    assert training_bytes(cfg, "adafactor") == 8 * cfg.param_count()
    assert {"granite-moe-1b-a400m": 22.16e9 < training_bytes(cfg, "adamw") < 22.17e9,
            "mixtral-8x7b": training_bytes(cfg, "adamw") > 700e9}[arch]


@pytest.mark.parametrize("arch, billions", [("granite-moe-1b-a400m", 1.39),
                                            ("mixtral-8x7b", 46.7)])
def test_decoder_holds_the_reference_tree_at_full_width(arch, billions):
    """One full-width layer built on the meta device (no memory): the
    reference's parameter tree, expert stacks and router included."""
    cfg = get_config(arch)
    layer = Layer(cfg, cfg.kinds[0], torch.bfloat16, "meta")
    n_params = ((1 if cfg.tie_embeddings else 2) * cfg.padded_vocab * cfg.d_model
                + cfg.d_model + cfg.n_layers * sum(p.numel() for p in layer.parameters()))
    ref_defs = jax.tree.leaves(ref_model_defs(ref_get_config(arch)),
                               is_leaf=lambda d: isinstance(d, RefParamDef))
    assert n_params == sum(int(np.prod(d.shape)) for d in ref_defs)
    assert round(n_params / 1e9, 2) == billions
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert {n: tuple(p.shape) for n, p in layer.mlp.named_parameters()} == {
        "router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    assert layer.mlp.router.dtype == torch.float32 and layer.mlp.wi.dtype == torch.bfloat16


def test_params_round_trip_through_the_reference_layout(pair):
    _, cfg, _, tree, model, _ = pair
    back = convert.model_params_to_arrays(cfg, model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), jax.tree_util.keystr(path)
    assert back["layers"]["mlp"]["wi"].shape == (cfg.n_layers, 4, cfg.d_model, cfg.d_ff)
    assert back["layers"]["mlp"]["router"].shape == (cfg.n_layers, cfg.d_model, 4)


def test_forward_matches_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    want = ref_forward(ref_cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    got = arch_forward(cfg, model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    rel_close(got.numpy(), want, TOL, "forward")


def test_prefill_and_decode_match_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    rel_close(logits.numpy(), ref_logits, TOL, "prefill")
    slots = min(max_len, cfg.attn_window or max_len)
    assert [tuple(c["k"].shape) for c in cache] == [(B, slots, cfg.n_kv_heads, 32)] * 4
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        rel_close(logits.numpy(), ref_logits, TOL, f"decode step {i}")


def test_cache_defs_match_the_prefill_cache(pair):
    _, cfg, _, _, model, tokens = pair
    max_len = PROMPT + STEPS
    _, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    zero = arch_init_cache(cfg, B, max_len, device="cpu")
    defs = arch_cache_defs(cfg, B, max_len)
    assert len(cache) == len(zero) == len(defs) == cfg.n_layers
    for got, z, d in zip(cache, zero, defs):
        assert set(got) == set(z) == set(d) == {"k", "v"}
        for name, (shape, _) in d.items():
            assert tuple(got[name].shape) == tuple(z[name].shape) == shape


def _block_pair(cfg, defs_ref, defs_port, seed):
    """The same random block parameters on both sides (the reference's init,
    biases drawn nonzero) and a seeded input (2, 24, d)."""
    tree = jax.tree.map(np.asarray, ref_init_tree(defs_ref, jax.random.PRNGKey(seed)))
    tree = jax.tree.map(np.asarray, draw_biases(tree, np.random.default_rng(seed), 0.5))
    mod = DefModule(defs_port, torch.float32, "cpu")
    mod.load_state_dict({k: torch.tensor(v) for k, v in tree.items()})
    x = np.random.default_rng(seed + 1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return tree, mod, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("glu", [True, False])
def test_moe_block_matches_reference(arch, glu):
    """Dense dispatch: every expert on every token, weighted by the top-k
    softmax of the fp32 router logits; the SiLU GLU of the published configs
    and the non-GLU form."""
    cfg = dataclasses.replace(get_smoke_config(arch), glu=glu)
    ref_cfg = dataclasses.replace(ref_get_smoke_config(arch), glu=glu)
    tree, mod, x = _block_pair(cfg, ref_blocks.moe_defs(ref_cfg), blocks.moe_defs(cfg), 3)
    want = ref_blocks.moe(ref_cfg, tree, jnp.asarray(x))
    got = blocks.moe(cfg, mod, torch.from_numpy(x))
    rel_close(got.numpy(), want, BLOCK_TOL, "moe")


def test_moe_equals_a_sparse_dispatch():
    """Each token through only its top-k experts, one at a time, weighted by
    the softmax of its top-k fp32 router logits: the value the dense
    dispatch must give."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    _, mod, x = _block_pair(cfg, ref_blocks.moe_defs(ref_get_smoke_config(cfg.arch_id)),
                            blocks.moe_defs(cfg), 5)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    top_v, top_i = torch.topk(xt @ mod.router, cfg.top_k, dim=-1)
    gate = torch.softmax(top_v, dim=-1)
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.top_k):
            e = int(top_i[t, j])
            h = torch.nn.functional.silu(xt[t] @ mod.wg[e]) * (xt[t] @ mod.wi[e])
            want[t] += gate[t, j] * (h @ mod.wo[e])
    got = blocks.moe(cfg, mod, torch.from_numpy(x)).reshape(-1, cfg.d_model)
    rel_close(got.numpy(), want.numpy(), BLOCK_TOL, "moe vs sparse dispatch")


@pytest.mark.parametrize("glu, bias, act", [(True, False, "silu"), (False, True, "gelu"),
                                            (True, True, "gelu"), (False, False, "relu")])
def test_mlp_forms_match_reference(glu, bias, act):
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"), glu=glu, mlp_bias=bias, act=act)
    ref_cfg = dataclasses.replace(ref_get_smoke_config("qwen2.5-14b"), glu=glu, mlp_bias=bias,
                                  act=act)
    tree, mod, x = _block_pair(cfg, ref_blocks.mlp_defs(ref_cfg), blocks.mlp_defs(cfg), 7)
    assert set(tree) == {"wi", "wo"} | ({"wg"} if glu else set()) | \
        ({"bi", "bo"} if bias else set())
    want = ref_blocks.mlp(ref_cfg, tree, jnp.asarray(x))
    got = blocks.mlp(cfg, mod, torch.from_numpy(x))
    rel_close(got.numpy(), want, BLOCK_TOL, "mlp")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_smoke_model(arch, capsys):
    ids = serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "70", "--gen", "3", "--seed", "2"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config(arch).vocab_size).all()
    assert f"[serve] {arch} on cpu: prefill 2x70" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("init", ["stacked", "per_layer"])
def test_rounding_sensitivity_at_each_init(arch, init):
    """Why the parity tests draw ``init_per_layer``: at the reference's own
    stacked initialiser (each stacked leaf's fan-in taken from the layer
    axis) one float32 unit in the parameters moves the forward logits by more
    than a tenth of TOL, so TOL stands too close to rounding to tell a fault
    from it; at each layer's own fan-in by less.  At either, the port stays
    within UNIT_FACTOR times that reading of the reference."""
    ref_cfg = ref_get_smoke_config(arch)
    defs, key = ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)
    params = init_per_layer(defs, key) if init == "per_layer" else ref_init_tree(defs, key)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, ref_cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    err, unit = init_readings(ref_cfg, get_smoke_config(arch), params, {"tokens": tokens})
    assert err < UNIT_FACTOR * unit, (err, unit)
    assert (unit > TOL / 10) if init == "stacked" else (unit < TOL / 10), unit
