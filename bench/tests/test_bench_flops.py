"""The frozen operation and byte counts, on shapes worked by hand, and the
parameter count against the port's own."""
from __future__ import annotations

import json

import pytest

from bench.harness import flops, spec
from bench.harness.arch import Arch, arch_of

# 2 layers, d 8, 2 heads of 4 over 1 kv head, ff 16, vocabulary 10 (padded 256)
TINY = dict(n_layers=2, d=8, heads=2, kv_heads=1, head_dim=4, ff=16, experts=0, top_k=0,
            vocab=10, eps=1e-6, theta=1e4, qkv_bias=False, tied=False, attn_scale=0.5,
            emb_mult=1.0, res_mult=1.0, logit_div=1.0, dtype="bfloat16")


@pytest.mark.parametrize("args, pairs", [
    ((4, 4, True), 10),                 # 1 + 2 + 3 + 4
    ((3, 5, False), 15),                # every pair
    ((4, 4, True, 2), 7),               # window 2: 1 + 2 + 2 + 2
    ((2, 4, True, None, 2), 7),         # rows 2, 3 of 4: 3 + 4
])
def test_flash_pairs(args, pairs):
    assert flops.flash_pairs(*args) == pairs


def test_flash_bounds_by_hand():
    # b 1, 4 x 4 causal, 2 heads over 1 kv head, d 8: 20 pairs
    fwd = flops.flash_bound(1, 4, 4, 2, 1, 8, True, "bfloat16")
    assert fwd["operations"] == 4 * 8 * 20
    assert fwd["bytes"] == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2      # q and out, k and v
    assert fwd["seconds"] == max(640 / 989e12, 384 / 3.35e12)
    bwd = flops.flash_bwd_bound(1, 4, 4, 2, 1, 8, True, "bfloat16")
    assert bwd["operations"] == 10 * 8 * 20
    assert bwd["bytes"] == (4 * 64 + 4 * 32) * 2 + 4 * 2 * 4         # q out dO dq, k v dk dv, lse
    assert bwd["bound_by"] == "bytes"


def test_model_flops_by_hand():
    a = Arch(**TINY)
    per_layer = 8 * 4 * (2 + 2) + 2 * 4 * 8 + 2 * 8 + 3 * 8 * 16    # qkv, o, norms, mlp
    assert flops.param_count(a) == 2 * 256 * 8 + 2 * per_layer
    # 6 per parameter per token + 3 x attention (4 D per pair, per head and layer)
    attn = 4 * 4 * 2 * 1 * 2 * 10
    assert flops.train_model_flops(a, 1, 4) == 6 * flops.param_count(a) * 4 + 3 * attn
    assert flops.prefill_model_flops(a, 4) == 2 * 2 * per_layer * 4 + attn
    moe = Arch(**{**TINY, "experts": 4, "top_k": 2})
    assert flops.param_count(moe) - flops.active_param_count(moe) == 2 * 2 * 3 * 8 * 16


@pytest.mark.parametrize("name", [c["name"] for c in spec.load()["configs"]])
def test_parameter_count_is_the_ports(name):
    from repro_torch.configs.registry import get_config

    config = json.loads((spec.ROOT / f"bench/configs/{name}.json").read_text())
    a = arch_of(config)
    cfg = get_config(config["port_arch"])
    assert flops.param_count(a) == cfg.param_count()
    assert flops.active_param_count(a) == cfg.active_param_count()
    assert a.padded_vocab == cfg.padded_vocab
