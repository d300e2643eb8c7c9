"""The port's mamba2-780m serving path against the reference: the same
parameters (the reference's initialisation, carried over as arrays) and the
same prompts go through ``repro``'s forward, prefill and decode step and the
port's, on the CPU in float32, at the smoke config (4 SSM layers, d 128, 16
SSD heads of 16, state 16), and the logits agree.

Tolerance 1e-4 of max |logit|: the two sides sum in different orders (XLA's
chunked SSD at chunk 128 against the port's plain version at chunk 64, and
the CPU kernels of the two frameworks), over 4 layers and 8 decode steps."""
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
from repro_torch.kernels import ssd as port_ssd
from repro_torch.launch.model_serve import serve_main
from repro_torch.models import (Decoder, arch_cache_defs, arch_decode_step, arch_forward,
                                arch_init_cache, arch_init_params)
from repro_torch.models.decoder import Layer, check_supported
from repro_torch.runtime import make_prefill_step

torch.set_num_threads(1)

ARCH = "mamba2-780m"
B, PROMPT, STEPS = 2, 256, 8     # 256 > 128: the reference takes its chunked SSD
TOL = 1e-4


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, f"{what}: max |diff| / max |logit| = {err:.3g}"


@pytest.fixture(scope="module")
def pair():
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    assert ref_cfg.uniform and ref_cfg.scan_layers
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, cfg, params, tree, model, tokens


def test_config_matches_reference_field_by_field():
    assert ARCH in PORTED_ARCH_IDS
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    smoke = get_smoke_config(ARCH)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(ref_get_smoke_config(ARCH))
    assert (smoke.n_layers, smoke.d_model, smoke.n_ssm_heads, smoke.ssm_head_dim,
            smoke.ssm_state, smoke.dtype) == (4, 128, 16, 16, 16, "float32")


def test_decoder_holds_the_reference_tree_and_no_mlp():
    cfg = get_config(ARCH)
    check_supported(cfg)
    # the full-width model's size, one layer built on the meta device (no memory)
    layer = Layer(cfg, "ssm", torch.bfloat16, "meta")
    n_params = cfg.padded_vocab * cfg.d_model + cfg.d_model + cfg.n_layers * sum(
        p.numel() for p in layer.parameters())
    ref_defs = jax.tree.leaves(ref_model_defs(ref_get_config(ARCH)),
                               is_leaf=lambda d: isinstance(d, RefParamDef))
    assert n_params == sum(int(np.prod(d.shape)) for d in ref_defs) == 780_382_464
    smoke = Decoder(get_smoke_config(ARCH), device="cpu")
    names = {k.split(".", 2)[-1] for k in smoke.state_dict() if k.startswith("layers.")}
    assert names == {"ln1_w"} | {f"ssm.{k}" for k in (
        "wz", "wx", "wB", "wC", "wdt", "dt_bias", "a_log", "d_skip", "conv_w", "conv_b",
        "norm_w", "wo")}
    assert all(layer.mlp is None for layer in smoke.layers)
    fp32 = {k.split(".")[-1] for k, v in smoke.state_dict().items() if v.dtype == torch.float32}
    assert {"dt_bias", "a_log", "d_skip", "norm_w", "ln1_w", "ln_f_w"} <= fp32
    assert layer.ssm.wz.dtype == torch.bfloat16 and layer.ssm.a_log.dtype == torch.float32


def test_params_round_trip_through_the_reference_layout(pair):
    _, cfg, _, tree, model, _ = pair
    back = convert.model_params_to_arrays(cfg, model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), jax.tree_util.keystr(path)


def test_forward_matches_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    want = ref_forward(ref_cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    got = arch_forward(cfg, model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    _close(got.numpy(), want, "forward")


def test_prefill_and_decode_match_reference(pair):
    ref_cfg, cfg, params, _, model, tokens = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    _close(logits.numpy(), ref_logits, "prefill")
    for i in range(cfg.n_layers):      # the prefill's states themselves, same measure
        for name in ("h", "conv"):
            _close(cache[i][name].numpy(), ref_cache["layers"][name][i], f"layer {i} {name}")
    before = port_ssd.ssd_chunked.launches
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = ref_decode_step(ref_cfg, params, ref_cache,
                                                jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        _close(logits.numpy(), ref_logits, f"decode step {i}")
    assert port_ssd.ssd_chunked.launches == before      # CPU tensors: the plain version


def test_cache_defs_match_the_prefill_cache(pair):
    _, cfg, _, _, model, tokens = pair
    _, cache = make_prefill_step(cfg, max_len=PROMPT + STEPS, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :64])})
    zero = arch_init_cache(cfg, B, PROMPT + STEPS, device="cpu")
    defs = arch_cache_defs(cfg, B, PROMPT + STEPS)
    assert len(cache) == len(zero) == len(defs) == cfg.n_layers
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    for got, z, d in zip(cache, zero, defs):
        assert d == {"h": ((B, 16, 16, 16), True), "conv": ((B, 3, conv_ch), False)}
        assert set(got) == set(z) == set(d)
        for name, (shape, fp32) in d.items():
            assert tuple(got[name].shape) == tuple(z[name].shape) == shape
            assert got[name].dtype == z[name].dtype
            assert not z[name].any() and (not fp32 or z[name].dtype == torch.float32)


def test_serve_main_on_the_cpu(capsys):
    ids = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "70", "--gen", "3", "--seed", "3"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config(ARCH).vocab_size).all()
    out = capsys.readouterr().out
    assert "mamba2-780m on cpu" in out and "prefill 2x70" in out and "tok/s" in out


def test_smoke_model_draws_its_parameters_from_the_generator():
    cfg = get_smoke_config(ARCH)
    a = arch_init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = arch_init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    c = arch_init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.ssm.wz"], sc["layers.0.ssm.wz"])
    assert (sa["layers.0.ssm.d_skip"] == 1).all() and not sa["layers.0.ssm.dt_bias"].any()
