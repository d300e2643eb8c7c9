"""The port's recurrentgemma-2b serving path against the reference: the same
parameters (the reference's initialisation, carried over as arrays) and the
same prompts go through ``repro``'s prefill / decode step and the port's, on
the CPU in float32, and the logits agree.

Tolerance 1e-4 of max |logit|: the two sides sum in different orders (XLA and
PyTorch's CPU kernels), over 8 layers and 8 decode steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_decode_step as ref_decode_step
from repro.models import arch_init_params as ref_init_params
from repro.models import arch_forward as ref_forward
from repro.runtime import make_prefill_step as ref_make_prefill_step

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.model_serve import serve, serve_main
from repro_torch.launch.train import training_bytes
from repro_torch.models.decoder import check_supported
from repro_torch.models import (Decoder, arch_cache_defs, arch_decode_step, arch_forward,
                                arch_init_cache, arch_init_params)
from repro_torch.runtime import make_prefill_step, make_serve_step, next_token

torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
B, PROMPT, STEPS = 2, 80, 8
TOL = 1e-4


def _cfgs():
    # 8 layers: two (rec, rec, attn_local) periods plus a 2-layer rec tail,
    # which is the shape of the full 26-layer stack
    ref = dataclasses.replace(ref_get_smoke_config(ARCH), n_layers=8)
    port = dataclasses.replace(get_smoke_config(ARCH), n_layers=8)
    return ref, port


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err < TOL, f"{what}: max |diff| / max |logit| = {err:.3g}"


@pytest.fixture(scope="module")
def pair():
    ref_cfg, cfg = _cfgs()
    assert ref_cfg.period_scan and ref_cfg.tail_kinds == ("rec", "rec")
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_arrays(cfg, tree))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, PROMPT + STEPS)).astype(np.int32)
    return ref_cfg, cfg, params, tree, model, tokens


def test_config_matches_reference_field_by_field():
    want = dataclasses.asdict(ref_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert got == want
    assert dataclasses.asdict(get_smoke_config(ARCH)) == dataclasses.asdict(
        ref_get_smoke_config(ARCH))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-moe-1b-a400m", "whisper-medium",
                                  "internvl2-26b", "llama3-405b", "no-such-arch"])
def test_other_archs_raise_a_clear_key_error(arch):
    """An unknown arch raises a ``KeyError``.  Every other config is the
    reference's and both serves and trains (its config and its smoke config
    pass ``check_supported``, which holds both); the size of the fp32
    training state, ``training_bytes``, is what keeps all but
    granite-moe-1b-a400m and whisper-medium off one 80 GB card."""
    if arch == "no-such-arch":
        with pytest.raises(KeyError, match="unknown arch"):
            get_config(arch)
        return
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(arch))
    check_supported(cfg)
    check_supported(get_smoke_config(arch))
    assert training_bytes(cfg, "adamw") == 16 * cfg.param_count()
    fits = arch in ("granite-moe-1b-a400m", "whisper-medium")
    assert (training_bytes(cfg, "adamw") < 80e9) == fits


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


def test_prefill_and_decode_across_the_ring_wrap_match_reference(pair):
    """80 prompt tokens > window 64, so the ring wraps before the first step."""
    ref_cfg, cfg, params, _, model, tokens = pair
    max_len = PROMPT + STEPS
    ref_logits, ref_cache = ref_make_prefill_step(ref_cfg, max_len=max_len)(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    logits, cache = make_prefill_step(cfg, max_len=max_len, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    _close(logits.numpy(), ref_logits, "prefill")
    assert [tuple(c["k"].shape) for c in cache if "k" in c] == [(B, 64, 1, 32)] * 2
    for i in range(STEPS):           # teacher-forced: both sides read the same tokens
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        ref_logits, ref_cache = ref_decode_step(ref_cfg, params, ref_cache,
                                                jnp.asarray(tok), jnp.int32(PROMPT + i))
        logits, cache = arch_decode_step(cfg, model, cache, torch.from_numpy(tok), PROMPT + i)
        _close(logits.numpy(), ref_logits, f"decode step {i}")


def test_cache_defs_match_the_prefill_cache(pair):
    _, cfg, _, _, model, tokens = pair
    _, cache = make_prefill_step(cfg, max_len=PROMPT + STEPS, device="cpu")(
        model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    zero = arch_init_cache(cfg, B, PROMPT + STEPS, device="cpu")
    defs = arch_cache_defs(cfg, B, PROMPT + STEPS)
    assert len(cache) == len(zero) == len(defs) == cfg.n_layers
    for got, z, d in zip(cache, zero, defs):
        assert set(got) == set(z) == set(d)
        for name, (shape, fp32) in d.items():
            assert tuple(got[name].shape) == tuple(z[name].shape) == shape
            assert got[name].dtype == z[name].dtype
            assert not z[name].any() and (not fp32 or z[name].dtype == torch.float32)


def test_greedy_next_token_never_picks_padded_vocab():
    cfg = get_smoke_config(ARCH)
    logits = torch.zeros((3, cfg.padded_vocab))
    logits[:, cfg.vocab_size:] = 100.0            # padding would win if not masked
    logits[torch.arange(3), torch.tensor([5, 7, 11])] = 1.0
    assert next_token(cfg, logits).tolist() == [5, 7, 11]
    with pytest.raises(ValueError, match="Generator"):
        next_token(cfg, logits, temperature=1.0)
    g = torch.Generator().manual_seed(0)
    assert (next_token(cfg, logits, 1.0, g) < cfg.vocab_size).all()


def test_serve_is_the_steps_it_is_made_of():
    """serve(): the prefill's greedy pick, then gen - 1 serve steps."""
    cfg = get_smoke_config(ARCH)
    model = arch_init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    prompts = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(2))
    res = serve(cfg, model, {"tokens": prompts}, 4, device="cpu")
    assert res.ids.shape == (2, 4) and res.steps == 3
    logits, cache = make_prefill_step(cfg, max_len=74, device="cpu")(model, {"tokens": prompts})
    tok = next_token(cfg, logits)[:, None]
    want = [tok]
    step = make_serve_step(cfg, device="cpu")
    for i in range(3):
        tok, cache = step(model, cache, tok, 70 + i)
        want.append(tok)
    assert np.array_equal(res.ids, torch.cat(want, dim=1).numpy())


def test_serve_main_on_the_cpu(capsys):
    ids = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--seed", "3"])
    assert ids.shape == (2, 3) and (ids < get_smoke_config(ARCH).vocab_size).all()
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "tok/s" in out and "[sample ids]" in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    cfg = get_smoke_config(ARCH)
    for call in (lambda: arch_init_params(cfg, torch.Generator()), lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg), lambda: serve_main(["--smoke"]),
                 lambda: Decoder(cfg)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
