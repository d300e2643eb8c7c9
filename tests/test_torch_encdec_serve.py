"""The port's encoder-decoder (whisper-medium) against the reference: the
same parameters (the reference's initialiser at each layer's own fan-in,
``torch_port_helpers.init_per_layer``, carried over as arrays, with every
bias drawn nonzero: the reference starts them at zero), the same
stub-frontend frames and the same decoder prompts go through ``repro``'s
``encdec_forward``, prefill and 8 decode steps and the port's, on the CPU in
float32 at the smoke config (2 encoder and 4 decoder layers, d 128, 4 heads
of 32, 32 frames, LayerNorm, a biased GELU MLP, tied embeddings, learned
decoder positions, no RoPE), and the logits agree within 1e-4 of max
|logit|.  Cross-attention alone (``kv_x``, non-causal, no RoPE, Sq != Skv)
is held against ``repro.models.attention.attention`` at 1e-5."""
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
from repro.models.attention import attention as ref_attention
from repro.models.attention import attn_defs as ref_attn_defs
from repro.models.common import ParamDef as RefParamDef
from repro.models.common import init_tree as ref_init_tree
from repro.models.encdec import encdec_model_defs as ref_model_defs
from repro.runtime import make_prefill_step as ref_make_prefill_step

from repro_torch import convert
from repro_torch.configs import PORTED_ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.model_serve import make_batch, serve, serve_main
from repro_torch.launch.train import training_bytes
from repro_torch.models import encdec
from repro_torch.models import (Decoder, EncDec, arch_cache_defs, arch_decode_step,
                                arch_forward, arch_init_cache, arch_init_params)
from repro_torch.models.attention import attention, attn_defs
from repro_torch.models.common import DefModule
from repro_torch.models.decoder import check_supported
from repro_torch.runtime import make_prefill_step

torch.set_num_threads(1)

ARCH = "whisper-medium"
B, PROMPT, STEPS = 2, 40, 8
TOL = 1e-4
BIAS_STD = 0.5
# the port's forward against the reference's within this many times what one
# float32 unit in the parameters does to the logits (torch_port_helpers.init_readings)
UNIT_FACTOR = 4


@pytest.fixture(scope="module")
def pair():
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.n_frames) == (2, 4, 32)
    rng = np.random.default_rng(1)
    params = draw_biases(init_per_layer(ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)),
                         rng, BIAS_STD)
    tree = jax.tree.map(np.asarray, params)
    model = EncDec(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, params, tree, model, tokens, frames


def test_config_matches_reference_and_serves_but_does_not_train():
    assert ARCH in PORTED_ARCH_IDS
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        ref_get_smoke_config(ARCH))
    # (the name is older than encoder-decoder training: it now serves and
    # trains, tests/test_torch_encdec_train.py, and one check_supported
    # holds both)
    check_supported(get_config(ARCH))
    model = arch_init_params(get_smoke_config(ARCH), torch.Generator(), device="cpu",
                             master=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    # the state training_bytes reckons from the reference's analytic count,
    # 0.66 B parameters (10.5 GB with AdamW); the model holds 0.79 B, with the
    # cross-attention, the 32,768 learned positions and the biases that count
    # leaves out (12.6 GB)
    cfg = get_config(ARCH)
    assert training_bytes(cfg, "adamw") == 16 * cfg.param_count()
    assert 10.51e9 < training_bytes(cfg, "adamw") < 10.52e9
    with pytest.raises(ValueError, match="encoder-decoder"):
        Decoder(get_smoke_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        EncDec(get_smoke_config("qwen2.5-14b"), device="cpu")


def test_encdec_holds_the_reference_tree_at_full_width(monkeypatch):
    """The full-width model built on the meta device (no memory): every
    leaf of the reference's tree at its shape, 0.79 B parameters with the
    reference's 32,768 learned decoder positions."""
    cfg = get_config(ARCH)
    monkeypatch.setattr(encdec, "resolve_device", torch.device)
    model = EncDec(cfg, device="meta")
    ref_defs = ref_model_defs(ref_get_config(ARCH))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(d.shape) for path, d in
            jax.tree_util.tree_leaves_with_path(
                ref_defs, is_leaf=lambda d: isinstance(d, RefParamDef))}
    per_layer, got = {}, {}
    for name, p in model.state_dict().items():
        head, *rest = name.split(".")
        if head in ("enc_layers", "dec_layers"):    # stacked on a leading axis of layers
            key = "/".join([head] + rest[1:])
            n, shape = per_layer.get(key, (0, tuple(p.shape)))
            per_layer[key] = (n + 1, shape)
        else:
            got[name] = tuple(p.shape)
    got.update({key: (n, *shape) for key, (n, shape) in per_layer.items()})
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s)) for s in want.values())
    assert round(n_params / 1e9, 2) == 0.79
    assert model.pos_emb.shape == (32_768, cfg.d_model)
    layer = model.dec_layers[0]
    assert {n for n, _ in layer.cross_attn.named_parameters()} == {
        "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}
    assert layer.ln_x_b.dtype == torch.float32 and layer.mlp.bi.dtype == torch.bfloat16
    assert len(model.enc_layers) == len(model.dec_layers) == 24


def test_params_round_trip_through_the_reference_layout(pair):
    _, cfg, _, tree, model, _, _ = pair
    back = convert.model_params_to_arrays(cfg, model.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(flat_got[path], leaf), jax.tree_util.keystr(path)
    assert back["enc_layers"]["attn"]["bq"].shape == (2, 4, 32)
    assert back["dec_layers"]["cross_attn"]["wk"].shape == (4, cfg.d_model, 4, 32)
    assert back["dec_layers"]["ln_x_b"].any() and back["ln_enc_f_b"].any()


def test_forward_matches_reference(pair):
    ref_cfg, cfg, params, _, model, tokens, frames = pair
    want = ref_forward(ref_cfg, params, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                                         "frames": jnp.asarray(frames)})
    got = arch_forward(cfg, model, {"tokens": torch.from_numpy(tokens[:, :PROMPT]),
                                    "frames": torch.from_numpy(frames)})
    rel_close(got.numpy(), want, TOL, "forward")


def test_prefill_and_decode_match_reference(pair):
    ref_cfg, cfg, params, _, model, tokens, frames = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT]), "frames": jnp.asarray(frames)})
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT]),
                "frames": torch.from_numpy(frames)})
    rel_close(logits.numpy(), ref_logits, TOL, "prefill")
    for i, entry in enumerate(cache):
        rel_close(entry["cross_k"].numpy(), ref_cache["cross_k"][i], 1e-5, "cross k")
        rel_close(entry["k"].numpy(), ref_cache["self"]["k"][i], 1e-5, "self k")
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        rel_close(logits.numpy(), ref_logits, TOL, f"decode step {i}")
    assert cache[0]["k"][:, -1].abs().sum() > 0


def test_the_kernel_runs_only_in_the_prefill(pair, monkeypatch):
    """K2 once per encoder layer and twice per decoder layer (self, cross)
    at the prefill: non-causal over the frames, causal over the prompt,
    non-causal from the prompt over the frames; a decode step reads its
    caches in PyTorch and calls no kernel (not even its plain version)."""
    _, cfg, _, _, model, tokens, frames = pair
    calls = []
    plain = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    _, cache = make_prefill_step(cfg, max_len=PROMPT + 1, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT]),
                "frames": torch.from_numpy(frames)})
    f = cfg.n_frames
    assert calls == [(f, f, False)] * 2 + [(PROMPT, PROMPT, True), (PROMPT, f, False)] * 4
    monkeypatch.setattr(ops, "flash_attention", None)
    logits, _ = arch_decode_step(cfg, model, cache, torch.from_numpy(tokens[:, PROMPT:PROMPT + 1]),
                                 PROMPT)
    assert bool(torch.isfinite(logits).all())


def test_cache_defs_match_the_prefill_cache(pair):
    _, cfg, _, _, model, tokens, frames = pair
    max_len = PROMPT + STEPS
    _, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT]),
                "frames": torch.from_numpy(frames)})
    zero = arch_init_cache(cfg, B, max_len, device="cpu")
    defs = arch_cache_defs(cfg, B, max_len)
    assert len(cache) == len(zero) == len(defs) == cfg.n_layers
    for got, z, d in zip(cache, zero, defs):
        assert set(got) == set(z) == set(d) == {"k", "v", "cross_k", "cross_v"}
        for name, (shape, fp32) in d.items():
            assert tuple(got[name].shape) == tuple(z[name].shape) == shape and not fp32
        assert d["cross_k"][0] == (B, cfg.n_frames, 4, 32) and d["k"][0] == (B, max_len, 4, 32)


@pytest.mark.parametrize("causal, rope", [(False, False), (True, False), (True, True)])
def test_attention_with_a_kv_source_matches_reference(causal, rope):
    """Queries from x (B, 24, E), keys and values from kv_x (B, 24 or 40, E),
    biases drawn nonzero: cross-attention (non-causal, no RoPE, Sq != Skv) and
    self-attention over the same rows with and without RoPE."""
    cfg = get_smoke_config(ARCH)
    ref_cfg = ref_get_smoke_config(ARCH)
    if rope:
        cfg, ref_cfg = (dataclasses.replace(c, rope_theta=10_000.0) for c in (cfg, ref_cfg))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(np.asarray, draw_biases(
        ref_init_tree(ref_attn_defs(ref_cfg), jax.random.PRNGKey(3)), rng, BIAS_STD))
    mod = DefModule(attn_defs(cfg), torch.float32, "cpu")
    mod.load_state_dict({k: torch.tensor(v) for k, v in tree.items()})
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    kv = x if causal else rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(kv.shape[1])
    kw = dict(causal=causal, rope=rope)
    if not causal:
        kw["kv_x"] = kv
    want = ref_attention(ref_cfg, tree, jnp.asarray(x), positions=jnp.asarray(pos),
                         **{k: jnp.asarray(v) if k == "kv_x" else v for k, v in kw.items()})
    got = attention(cfg, mod, torch.from_numpy(x), positions=torch.from_numpy(pos),
                    **{k: torch.from_numpy(v) if k == "kv_x" else v for k, v in kw.items()})
    rel_close(got.numpy(), want, 1e-5, "attention")


def test_serve_draws_frames_and_decodes_from_the_cache():
    """``make_batch`` draws the frames from the generator; ``serve`` encodes
    them once and reproduces its ids from the same seed."""
    cfg = get_smoke_config(ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch(cfg, 2, 20, torch.Generator().manual_seed(5), device="cpu")
    assert batch["frames"].shape == (2, cfg.n_frames, cfg.d_model) and "vis_embeds" not in batch
    res = serve(cfg, model, batch, 5, device="cpu")
    again = serve(cfg, model, make_batch(cfg, 2, 20, torch.Generator().manual_seed(5),
                                         device="cpu"), 5, device="cpu")
    assert res.ids.shape == (2, 5) and np.array_equal(res.ids, again.ids)


def test_serve_main_runs_the_whisper_smoke_model(capsys):
    ids = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--seed", "3"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config(ARCH).vocab_size).all()
    assert f"[serve] {ARCH} on cpu: prefill 2x16" in capsys.readouterr().out


@pytest.mark.parametrize("init", ["stacked", "per_layer"])
def test_rounding_sensitivity_at_each_init(init):
    """Why the parity tests draw ``init_per_layer``: at the reference's own
    stacked initialiser (each stacked leaf's fan-in taken from the layer
    axis) one float32 unit in the parameters moves the forward logits by more
    than a tenth of TOL, so TOL stands too close to rounding to tell a fault
    from it; at each layer's own fan-in by less.  At either, the port stays
    within UNIT_FACTOR times that reading of the reference."""
    ref_cfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    defs, key = ref_arch_model_defs(ref_cfg), jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    params = init_per_layer(defs, key) if init == "per_layer" else ref_init_tree(defs, key)
    params = draw_biases(params, rng, BIAS_STD)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32),
             "frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    err, unit = init_readings(ref_cfg, cfg, params, batch)
    assert err < UNIT_FACTOR * unit, (err, unit)
    assert (unit > TOL / 10) if init == "stacked" else (unit < TOL / 10), unit
