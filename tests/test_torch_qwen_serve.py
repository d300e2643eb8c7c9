"""The port's global-attention decoders (qwen2.5-14b, codeqwen1.5-7b,
qwen1.5-32b) against the reference: the same parameters (the reference's
initialisation, carried over as arrays, with nonzero qkv and output biases
drawn here: the reference starts them at zero) and the same prompts go
through ``repro``'s forward, prefill and decode step and the port's, on the
CPU in float32, at each arch's smoke config (4 layers of global attention
and a GLU MLP, d 128, 4 heads of 32, untied ``lm_head``), and the logits
agree.  The smoke configs are MHA (4 kv heads); qwen2.5-14b is also run
with 2 kv heads, the grouped form its published 40:8 heads take.

Tolerance 1e-4 of max |logit| (tests/test_torch_model_serve.py's): the two
sides sum in different orders (XLA and PyTorch's CPU kernels), over 4 layers
and 8 decode steps against a linear cache."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_decode_step as ref_decode_step
from repro.models import arch_forward as ref_forward
from repro.models import arch_init_params as ref_init_params
from repro.models.common import ParamDef as RefParamDef
from repro.models.decoder import model_defs as ref_model_defs
from repro.runtime import make_prefill_step as ref_make_prefill_step

from repro_torch import convert
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.model_serve import serve_main
from repro_torch.models import (Decoder, arch_cache_defs, arch_decode_step, arch_forward,
                                arch_init_cache)
from repro_torch.models.attention import decode_attention
from repro_torch.models.decoder import Layer, check_supported
from repro_torch.runtime import make_prefill_step

torch.set_num_threads(1)

ARCHS = ("qwen2.5-14b", "codeqwen1.5-7b", "qwen1.5-32b")
B, PROMPT, STEPS = 2, 80, 8
TOL = 1e-4
BIAS_STD = 0.5


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, f"{what}: max |diff| / max |logit| = {err:.3g}"


def _cfgs(case):
    arch, kvh = case
    ref, port = ref_get_smoke_config(arch), get_smoke_config(arch)
    if kvh is not None:
        ref, port = (dataclasses.replace(c, n_kv_heads=kvh) for c in (ref, port))
    return ref, port


CASES = [(a, None) for a in ARCHS] + [("qwen2.5-14b", 2)]
IDS = [a if k is None else f"{a}-kv{k}" for a, k in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    ref_cfg, cfg = _cfgs(request.param)
    assert ref_cfg.uniform and ref_cfg.scan_layers and ref_cfg.qkv_bias
    assert not ref_cfg.tie_embeddings and ref_cfg.kinds == ("attn",) * 4
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    attn = dict(params["layers"]["attn"])
    for name in ("bq", "bk", "bv", "bo"):
        assert not np.asarray(attn[name]).any()        # the reference's zeros
        attn[name] = jnp.asarray(
            BIAS_STD * rng.standard_normal(attn[name].shape), attn[name].dtype)
    params = {**params, "layers": {**params["layers"], "attn": attn}}
    tree = jax.tree.map(np.asarray, params)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, cfg, params, tree, model, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_by_field(arch):
    assert arch in PORTED_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        ref_get_smoke_config(arch))
    check_supported(get_config(arch))


@pytest.mark.parametrize("arch, billions", [("qwen2.5-14b", 14.77), ("codeqwen1.5-7b", 8.19),
                                            ("qwen1.5-32b", 35.2)])
def test_decoder_holds_the_reference_tree_at_full_width(arch, billions):
    """The full-width model's size, one layer built on the meta device (no
    memory): the reference's parameter tree, its biases and untied head
    included."""
    cfg = get_config(arch)
    layer = Layer(cfg, "attn", torch.bfloat16, "meta")
    n_params = (2 * cfg.padded_vocab * cfg.d_model + cfg.d_model
                + cfg.n_layers * sum(p.numel() for p in layer.parameters()))
    ref_defs = jax.tree.leaves(ref_model_defs(ref_get_config(arch)),
                               is_leaf=lambda d: isinstance(d, RefParamDef))
    assert n_params == sum(int(np.prod(d.shape)) for d in ref_defs)
    assert round(n_params / 1e9, 2) == billions
    assert {n for n, _ in layer.attn.named_parameters()} == {
        "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}
    assert layer.attn.bo.shape == (cfg.d_model,) and layer.attn.bq.dtype == torch.bfloat16


def test_params_round_trip_through_the_reference_layout(pair):
    _, cfg, _, tree, model, _ = pair
    assert model.lm_head.shape == (cfg.d_model, cfg.padded_vocab)
    back = convert.model_params_to_arrays(cfg, model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), jax.tree_util.keystr(path)
    assert back["layers"]["attn"]["bo"].shape == (cfg.n_layers, cfg.d_model)


def test_forward_matches_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    want = ref_forward(ref_cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    got = arch_forward(cfg, model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    _close(got.numpy(), want, "forward")


def test_prefill_and_decode_on_a_linear_cache_match_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    _close(logits.numpy(), ref_logits, "prefill")
    kvh = cfg.n_kv_heads
    assert [tuple(c["k"].shape) for c in cache] == [(B, max_len, kvh, 32)] * cfg.n_layers
    for c, layer in zip(cache, np.asarray(ref_cache["layers"]["k"])):
        _close(c["k"].numpy(), layer, "prefill cache k")
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        _close(logits.numpy(), ref_logits, f"decode step {i}")
    # the last step filled the linear cache's last slot
    assert cache[0]["k"][:, -1].abs().sum() > 0
    with pytest.raises(ValueError, match="past the linear cache"):
        arch_decode_step(cfg, model, cache, torch.from_numpy(tok), max_len)


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
        for name, (shape, fp32) in d.items():
            assert tuple(got[name].shape) == tuple(z[name].shape) == shape
            assert shape[1] == max_len and not fp32
            assert got[name].dtype == z[name].dtype and not z[name].any()


def test_decode_attention_keeps_a_ring_only_with_a_window():
    """The same cache and position: with a window the token's slot wraps
    (pos % S_max) and every slot is live; without one a position past the
    cache is refused."""
    cfg = get_smoke_config("qwen2.5-14b")
    layer = Layer(cfg, "attn", torch.float32, "cpu")
    for p in layer.attn.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    cache = {k: torch.zeros(1, 4, cfg.n_kv_heads, 32) for k in ("k", "v")}
    _, ring = decode_attention(cfg, layer.attn, x, {k: v.clone() for k, v in cache.items()},
                               5, window=4)
    assert ring["k"][:, 1].abs().sum() > 0 and ring["k"][:, [0, 2, 3]].abs().sum() == 0
    _, lin = decode_attention(cfg, layer.attn, x, {k: v.clone() for k, v in cache.items()}, 3)
    assert lin["k"][:, 3].abs().sum() > 0 and lin["k"][:, :3].abs().sum() == 0
    with pytest.raises(ValueError, match="past the linear cache"):
        decode_attention(cfg, layer.attn, x, cache, 4)


def test_serve_main_defaults_to_qwen2_5_14b(capsys):
    ids = serve_main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                      "--gen", "3", "--seed", "3"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config("qwen2.5-14b").vocab_size).all()
    out = capsys.readouterr().out
    assert "[serve] qwen2.5-14b on cpu: prefill 2x16" in out and "tok/s" in out
    again = serve_main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "16", "--gen", "3", "--seed", "3"])
    assert np.array_equal(ids, again)


def test_serve_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        serve_main(["--smoke"])
