"""The plain reference against the port at the port's smoke configurations
on the CPU (float32, the benchmark's weights in both), and the pieces of
the reference a run leans on."""
from __future__ import annotations

import json

import pytest
import torch

from bench.harness import port, spec, weights
from bench.harness.arch import arch_of
from bench.reference import decoder, prefill
from bench.reference import train as ref_train
from bench.tests import smoke

torch.set_num_threads(1)
CONFIGS = [c["name"] for c in spec.load()["configs"]]


def smoke_arch(name):
    config = smoke.smoke_config(json.loads((spec.ROOT / f"bench/configs/{name}.json").read_text()))
    return config, arch_of(config)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_equal_the_ports(name):
    from repro_torch.models.decoder import forward

    config, a = smoke_arch(name)
    cfg, model = port.build_server(config, a, 5, "cpu")
    tokens = weights.token_rows(5, "test", 0, 2, 40, a.vocab, "cpu")
    with torch.no_grad():
        got = forward(cfg, model, tokens)[..., :a.vocab]
        want = decoder.forward(a, ref_train.initial_params(a, 5, "cpu"), tokens, remat=False,
                               block=16)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_streamed_prefill_equals_the_whole_forward(name):
    _, a = smoke_arch(name)
    prompts = [weights.token_rows(3, "p", i, 1, n, a.vocab, "cpu")[0]
               for i, n in ((0, 33), (1, 20))]
    (last,) = prefill.last_logits(a, 3, prompts, "cpu", block=8)
    params = ref_train.initial_params(a, 3, "cpu")
    for p, lg in zip(prompts, last):
        with torch.no_grad():
            whole = decoder.forward(a, params, p[None], remat=False)[0, -1]
        torch.testing.assert_close(lg, whole, rtol=1e-5, atol=1e-5)


def test_recompute_regions_leave_gradients_unchanged():
    _, a = smoke_arch("granite-moe-1b-a400m")
    params = ref_train.initial_params(a, 4, "cpu")
    tokens = weights.token_rows(4, "t", 0, 2, 17, a.vocab, "cpu")
    grads = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = decoder.loss(decoder.forward(a, leaves, tokens[:, :-1], remat=remat),
                           tokens[:, 1:], 1e-4)
        grads.append(torch.autograd.grad(out, list(leaves.values())))
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)


def test_weights_are_drawn_again_bit_for_bit():
    _, a = smoke_arch("qwen2.5-14b")
    one = weights.layer_weights(a, 2 ** 31 + 9, 2, "cpu")
    two = weights.layer_weights(a, 2 ** 31 + 9, 2, "cpu")
    other = weights.layer_weights(a, 2 ** 31 + 9, 3, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["wq"], other["wq"])


def test_fp8_products_round_and_differentiate():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=gen).requires_grad_(True)
    w = torch.randn(32, 8, generator=gen).requires_grad_(True)
    y = decoder.fp8_matmul(x, w)
    exact = x @ w
    err = float((y - exact).detach().abs().max() / exact.detach().abs().max())
    assert 1e-3 < err < 0.2               # e4m3 keeps 3 mantissa bits
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    torch.testing.assert_close(w.grad, x.detach().T @ torch.ones(6, 8), rtol=0.15, atol=0.3)
