"""The reference's training steps: float32 forward and backward of
:mod:`.decoder` from the benchmark's weights, and AdamW as the traffic file
states it (global-norm clipping, bias-corrected moments, decoupled weight
decay on every leaf).

``steps`` returns what the program's run is held to: each step's loss, the
norm of each leaf's first gradient (before clipping) and the norm of each
leaf's change after the last step.
"""
from __future__ import annotations

import torch

from ..harness import weights
from ..harness.arch import Arch
from . import decoder


def initial_params(a: Arch, seed: int, device) -> dict:
    """Every leaf in fp32, by the benchmark's names: ``embed``, ``lm_head``,
    ``final_norm``, ``layers.{i}.<name>``."""
    out = dict(weights.top_weights(a, seed, device, master=True))
    for i in range(a.n_layers):
        for k, v in weights.layer_weights(a, seed, i, device, master=True).items():
            out[f"layers.{i}.{k}"] = v
    return out


def change_norms(a: Arch, seed: int, params: dict) -> dict:
    """``||w - w0||`` per leaf (``params`` by the benchmark's names, each in
    its own layout or the benchmark's), w0 drawn again a part at a time."""
    device = next(iter(params.values())).device

    def norm(w, w0):
        return float(torch.linalg.vector_norm(w.detach().reshape(w0.shape) - w0))

    out = {k: norm(params[k], v) for k, v in weights.top_weights(a, seed, device, True).items()}
    for i in range(a.n_layers):
        for k, v in weights.layer_weights(a, seed, i, device, True).items():
            out[f"layers.{i}.{k}"] = norm(params[f"layers.{i}.{k}"], v)
    return out


class AdamW:
    def __init__(self, params: dict, hp: dict):
        self.hp = hp
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, t: int) -> float:
        hp = self.hp
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(hp["clip_norm"] / torch.clamp_min(gnorm, 1e-9), max=1.0)
        c1, c2 = 1.0 - hp["b1"] ** t, 1.0 - hp["b2"] ** t
        for k, w in params.items():
            g = grads[k] * scale
            self.m[k].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
            self.v[k].mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + hp["eps"]) \
                + hp["weight_decay"] * w
            w.sub_(hp["lr"] * upd)
        return float(gnorm)


def steps(a: Arch, seed: int, batches: list, hp: dict, z_loss: float, device,
          prec: decoder.Precision = decoder.FP32, rows: slice | None = None) -> dict:
    """Train from the benchmark's weights over ``batches`` ((tokens, labels)
    pairs on ``device``); ``rows`` keeps only those rows of each batch (a
    fault: half the batch left out).  Returns ``losses``, ``grad_norms``
    (step 1, per leaf, before clipping), ``grad_norm`` (step 1, global) and
    ``change_norms`` (per leaf, after the last step)."""
    params = initial_params(a, seed, device)
    for v in params.values():
        v.requires_grad_(True)
    opt = AdamW(params, hp)
    names = list(params)
    out = {"losses": []}
    with decoder.exact_matmuls():
        for t, (tokens, labels) in enumerate(batches, 1):
            if rows is not None:
                tokens, labels = tokens[rows], labels[rows]
            lv = decoder.loss(decoder.forward(a, params, tokens, prec), labels, z_loss)
            grads = dict(zip(names, torch.autograd.grad(lv, [params[k] for k in names])))
            out["losses"].append(float(lv.detach()))
            if t == 1:
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                     for k, g in grads.items()}
            gnorm = opt.step(params, grads, t)
            if t == 1:
                out["grad_norm"] = gnorm
            del grads, lv
    with torch.no_grad():
        out["change_norms"] = change_norms(a, seed, params)
    return out
