"""The benchmark's inputs, made on the device from ``--seed``: the weights,
the training batches and the prompts.

Weights are unit normals, one draw per layer and one per top-level tensor,
each from a generator seeded by (seed, part), then scaled: a matrix by
``1 / sqrt(fan_in)``, the router by 0.02, the embedding by 1, a norm weight as
``1 + 0.1 z`` and a bias as ``0.1 z``.  Any part can be made again alone, bit
for bit on the same device, so the reference draws one layer at a time
instead of holding a copy, and the program and the reference read the same
values.  The layout is the benchmark's own (matrices as ``(in, out)``, an
expert's as ``(experts, in, out)``); ``harness/port.py`` maps it onto the
port's parameters.

Types: training weights are fp32 masters; served weights are in the
configuration's type, but for the norms and the router, which stay fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from .arch import Arch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
_FP32_NAMES = ("attn_norm", "mlp_norm", "final_norm", "router")


def part_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed for one part, from the run's seed and tags
    (strings or whole numbers)."""
    words = [int(seed) % 2 ** 64]
    for t in tags:
        words.append(t if isinstance(t, int) else int.from_bytes(str(t).encode(), "little"))
    a, b = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(part_seed(seed, *tags))


def layer_shapes(a: Arch) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of one layer's tensors, in draw order."""
    q, kv = a.heads * a.head_dim, a.kv_heads * a.head_dim
    out = [("attn_norm", (a.d,), "norm", 0.1),
           ("wq", (a.d, q), "mat", a.d ** -0.5),
           ("wk", (a.d, kv), "mat", a.d ** -0.5),
           ("wv", (a.d, kv), "mat", a.d ** -0.5),
           ("wo", (q, a.d), "mat", q ** -0.5)]
    if a.qkv_bias:
        out += [("bq", (q,), "mat", 0.1), ("bk", (kv,), "mat", 0.1), ("bv", (kv,), "mat", 0.1)]
    out.append(("mlp_norm", (a.d,), "norm", 0.1))
    if a.experts:
        e = a.experts
        out += [("router", (a.d, e), "mat", 0.02),
                ("w_gate", (e, a.d, a.ff), "mat", a.d ** -0.5),
                ("w_up", (e, a.d, a.ff), "mat", a.d ** -0.5),
                ("w_down", (e, a.ff, a.d), "mat", a.ff ** -0.5)]
    else:
        out += [("w_gate", (a.d, a.ff), "mat", a.d ** -0.5),
                ("w_up", (a.d, a.ff), "mat", a.d ** -0.5),
                ("w_down", (a.ff, a.d), "mat", a.ff ** -0.5)]
    return out


def top_shapes(a: Arch) -> list[tuple[str, tuple, str, float]]:
    out = [("embed", (a.vocab, a.d), "mat", 1.0)]
    if not a.tied:
        out.append(("lm_head", (a.d, a.vocab), "mat", a.d ** -0.5))
    out.append(("final_norm", (a.d,), "norm", 0.1))
    return out


def _dtype(a: Arch, name: str, master: bool) -> torch.dtype:
    return torch.float32 if master or name in _FP32_NAMES else _DTYPES[a.dtype]


def _draw(a: Arch, shapes, z: torch.Tensor, master: bool) -> dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape, init, scale in shapes:
        n = int(np.prod(shape))
        piece = z[off:off + n].view(shape) * scale
        if init == "norm":
            piece = piece + 1.0
        out[name] = piece.to(_dtype(a, name, master))
        off += n
    return out


def layer_weights(a: Arch, seed: int, i: int, device, master: bool = False) -> dict:
    """Layer ``i``'s tensors (one draw of all of them)."""
    shapes = layer_shapes(a)
    total = sum(int(np.prod(s)) for _, s, _, _ in shapes)
    z = torch.randn(total, generator=generator(device, seed, "layer", i), device=device)
    return _draw(a, shapes, z, master)


def top_weights(a: Arch, seed: int, device, master: bool = False) -> dict:
    """The embedding, the output head (unless tied) and the final norm, one
    draw each (so no draw holds both large tables at once)."""
    out = {}
    for part in top_shapes(a):
        z = torch.randn(int(np.prod(part[1])), generator=generator(device, seed, part[0]),
                        device=device)
        out.update(_draw(a, [part], z, master))
        del z
    return out


def token_rows(seed: int, tag: str, index: int, rows: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """``rows`` x ``length`` uniform token ids in [0, vocab) for unit
    ``index`` of stream ``tag`` (a training step, a request)."""
    return torch.randint(0, vocab, (rows, length), generator=generator(device, seed, tag, index),
                         device=device)
