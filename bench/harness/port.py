"""The benchmark's one door into the program, ``repro_torch`` (the PyTorch
and CUDA port; never the JAX package beside it): the port's configuration
held against the configuration file, the launcher's trainer, the served
model, and the benchmark's weights copied into the port's parameters.
"""
from __future__ import annotations

import inspect
import time

import torch

from . import weights
from .arch import Arch

# the port's names of a layer's tensors, against the benchmark's
_ATTN = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo",
         "bq": "attn.bq", "bk": "attn.bk", "bv": "attn.bv"}
_MLP = {"router": "mlp.router", "w_gate": "mlp.wg", "w_up": "mlp.wi", "w_down": "mlp.wo"}
_NORMS = {"attn_norm": "ln1_w", "mlp_norm": "ln2_w"}
_TOP = {"embed": "tok_emb", "lm_head": "lm_head", "final_norm": "ln_f_w"}


def port_config(config: dict, a: Arch):
    """The port's ``ModelConfig`` of ``config`` (its smoke variant where the
    file says ``"port_variant": "smoke"``), refused unless it computes what
    the file states."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import common

    arch = config["port_arch"]
    cfg = get_smoke_config(arch) if config.get("port_variant") == "smoke" else get_config(arch)
    port_eps = inspect.signature(common.rms_norm).parameters["eps"].default
    want = {"n_layers": a.n_layers, "d_model": a.d, "n_heads": a.heads,
            "n_kv_heads": a.kv_heads, "resolved_head_dim": a.head_dim, "d_ff": a.ff,
            "vocab_size": a.vocab, "n_experts": a.experts, "top_k": a.top_k,
            "qkv_bias": a.qkv_bias, "rope_theta": a.theta, "tie_embeddings": a.tied,
            "dtype": a.dtype, "kinds": ("attn",) * a.n_layers, "norm": "rmsnorm",
            "act": "silu", "glu": True, "mlp_bias": False, "emb_scale": False,
            "encoder_layers": 0, "n_vis_tokens": 0, "rms_eps": a.eps,
            "attn_scale": a.attn_scale, "residual_multiplier": a.res_mult,
            "embedding_multiplier": a.emb_mult, "logits_scaling": a.logit_div}
    have = {k: getattr(cfg, k) for k in want if hasattr(cfg, k)}
    have.update(rms_eps=port_eps, attn_scale=cfg.resolved_head_dim ** -0.5,
                residual_multiplier=1.0, embedding_multiplier=1.0, logits_scaling=1.0)
    wrong = {k: (have[k], v) for k, v in want.items() if have[k] != v}
    if wrong:
        raise ValueError(f"{config['name']}: the port's {arch} is not the file's "
                         f"(port, file): {wrong}")
    return cfg


def _port_names(a: Arch, i: int) -> dict:
    out = {k: f"layers.{i}.{v}" for k, v in _NORMS.items()}
    out.update({k: f"layers.{i}.{v}" for k, v in _ATTN.items()})
    out.update({k: f"layers.{i}.{v}" for k, v in _MLP.items()})
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, a: Arch, seed: int, device, master: bool) -> None:
    """Copy the benchmark's weights into ``model``'s parameters, a layer at a
    time; the padded vocabulary's rows (which no id reaches and the loss and
    the sampler mask) and the output bias the published model lacks are
    zero.  Every parameter of the model must be written."""
    params = dict(model.named_parameters())
    written = set()

    def put(name, value):
        p = params[name]
        if name in ("tok_emb", "lm_head") and p.shape != value.shape:
            p.zero_()
            (p[:value.shape[0]] if name == "tok_emb" else p[:, :value.shape[1]]).copy_(value)
        else:
            p.copy_(value.reshape(p.shape))
        written.add(name)

    for k, v in weights.top_weights(a, seed, device, master).items():
        put(_TOP[k], v)
    for i in range(a.n_layers):
        names = _port_names(a, i)
        for k, v in weights.layer_weights(a, seed, i, device, master).items():
            put(names[k], v)
        bo = f"layers.{i}.attn.bo"
        if bo in params:
            params[bo].zero_()
            written.add(bo)
    missed = sorted(set(params) - written)
    if missed:
        raise ValueError(f"parameters the benchmark does not make: {missed[:8]}")


def leaf_view(a: Arch, model: torch.nn.Module, tensors: dict) -> dict:
    """``tensors`` (by the port's parameter names, such as the optimizer's
    moments) by the benchmark's leaf names, the padded vocabulary cut off and
    the output bias the published model lacks left out."""
    out = {}
    for bench, port in _TOP.items():
        if port in tensors:
            t = tensors[port]
            out[bench] = t[:a.vocab] if port == "tok_emb" else (
                t[:, :a.vocab] if port == "lm_head" else t)
    for i in range(a.n_layers):
        for bench, port in _port_names(a, i).items():
            if port in tensors:
                out[f"layers.{i}.{bench}"] = tensors[port]
    return out


def build_trainer(config: dict, traffic: dict, a: Arch, seed: int, device, spans: dict):
    """The launcher's trainer (``launch.train.build_trainer``) for the cell,
    the planner timed into ``spans["plan_s"]``; the benchmark's weights are
    then copied over the model's.  The benchmark drives ``step_fn`` itself,
    so nothing writes a checkpoint."""
    from repro_torch.launch import train as launch

    opt = traffic["optimizer"]
    if opt["name"] != "adamw":
        raise ValueError(f"optimizer {opt['name']!r}: the launcher's adamw only")
    argv = ["--arch", config["port_arch"], "--planner", traffic["planner"],
            "--optimizer", "adamw", "--lr", repr(opt["lr"]), "--batch", str(traffic["batch"]),
            "--seq", str(traffic["seq"]), "--seed", str(seed % 2 ** 63), "--device", str(device)]
    if config.get("port_variant") == "smoke":
        argv.append("--smoke")
    port_config(config, a)
    planner = launch.plan_residency

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return planner(*args, **kw)
        finally:
            spans["plan_s"] = time.perf_counter() - t0

    launch.plan_residency = timed
    try:
        tr = launch.build_trainer(launch.parse_args(argv))
    finally:
        launch.plan_residency = planner
    load_weights(tr.model, a, seed, device, master=True)
    return tr


def adamw_defaults() -> dict:
    """The port's AdamW hyperparameters (those the launcher does not set)."""
    from repro_torch.runtime.optimizer import adamw

    sig = inspect.signature(adamw).parameters
    return {k: sig[k].default for k in ("b1", "b2", "eps", "weight_decay", "clip_norm")}


def build_server(config: dict, a: Arch, seed: int, device):
    """The port's decoder for serving, holding the benchmark's weights."""
    from repro_torch.models.decoder import Decoder

    cfg = port_config(config, a)
    model = Decoder(cfg, device=device, master=False)
    load_weights(model, a, seed, device, master=False)
    return cfg, model


def first_tokens(cfg, model, tokens: torch.Tensor, device) -> tuple[list, torch.Tensor]:
    """One request, ``tokens`` (B, P), through the launcher's ``serve``
    (the prefill and the first token, synchronised): each row's token id,
    and the last-position logits (B, padded vocabulary) that ``serve``'s
    prefill step (``runtime.serve.make_prefill_step``) returned and the
    tokens were picked from."""
    from repro_torch.launch import model_serve

    make, seen = model_serve.make_prefill_step, []

    def recording(*args, **kw):
        step = make(*args, **kw)

        def prefill_step(model, batch):
            out = step(model, batch)
            seen.append(out[0])
            return out
        return prefill_step

    model_serve.make_prefill_step = recording
    try:
        ids = model_serve.serve(cfg, model, {"tokens": tokens}, gen=1, device=device).ids
    finally:
        model_serve.make_prefill_step = make
    if len(seen) != 1:
        raise RuntimeError(f"serve ran its prefill step {len(seen)} times, not once")
    return ids[:, 0].tolist(), seen[0]
