"""The reference's prefill: float32 logits of prompts under the benchmark's
served weights (bf16 values, upcast a layer at a time, so the reference
holds one layer in fp32 beside the hidden states of its prompts).

``last_logits`` gives each prompt's last-position logits, against which a
served first token and the prefill step's logits are judged; given more
precisions than the reference's (the control, :data:`.decoder.FP8`), it
runs each beside it in the same pass over the layers.
"""
from __future__ import annotations

import torch

from ..harness import weights
from ..harness.arch import Arch
from . import decoder


@torch.no_grad()
def last_logits(a: Arch, seed: int, prompts: list, device, precs: tuple = (decoder.FP32,),
                block: int = 1024) -> list:
    """Per precision in ``precs``, each prompt's (vocab,) float32 logits at
    its last position."""
    with decoder.exact_matmuls():
        top = {k: v.float() for k, v in weights.top_weights(a, seed, device).items()}
        xs = [[decoder.embed(a, top["embed"], p[None], prec) for p in prompts] for prec in precs]
        tables = {}
        for i in range(a.n_layers):
            lw = {k: v.float() for k, v in weights.layer_weights(a, seed, i, device).items()}
            for j, prec in enumerate(precs):
                for n, x in enumerate(xs[j]):
                    s = x.shape[1]
                    if s not in tables:
                        tables[s] = decoder.rope_tables(a, s, device)
                    xs[j][n] = decoder.layer(a, lw, x, *tables[s], prec, block)
            del lw
        return [[decoder.logits(a, top, x[0, -1:], prec)[0] for x in xp]
                for prec, xp in zip(precs, xs)]
