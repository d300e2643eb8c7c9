"""The decoder-only LM of the port: RecurrentGemma's pattern of RG-LRU
blocks ("rec") and sliding-window attention ("attn_local"), each followed by
a GLU MLP; Mamba-2's stack of SSD blocks ("ssm"), which have no MLP; and
stacks of global ("attn") or sliding-window attention layers, each followed
by a dense MLP (GLU or not, with or without biases) or a top-k MoE (granite,
mixtral).  Norms are RMSNorm, or LayerNorm with biases.  Embeddings are tied,
or untied with an ``lm_head (d_model, padded_vocab)``; a vision-language
model's stub-frontend embeddings (``vis_embeds``) replace its first
positions (internvl2).  The encoder-decoder is :mod:`.encdec`.

The reference stacks whole pattern periods (or, for a uniform stack, all
layers) for ``lax.scan``; here the layers are one ``nn.ModuleList`` in order,
and ``repro_torch.convert`` maps between the layouts.  The decode cache is a
list with one dict per layer: {"k", "v"} for attention, a ring of
``min(max_len, window)`` slots for "attn_local" and a linear cache of
``max_len`` slots for "attn"; {"h" (fp32), "conv"} for a recurrent or SSM
layer.

Training (:func:`forward` with gradients on a model of fp32 masters,
``Decoder(cfg, master=True)``) runs the layers under a residency plan
(:mod:`.remat`): recompute regions per layer nested in regions per pattern
period or scan group, as the reference's nested ``jax.checkpoint``, unless
the plan keeps every class.  :func:`cross_entropy_loss` is the reference's
(padded vocabulary masked, ``z_loss``).  Training runs everything serving
runs: every kind, RMSNorm or LayerNorm, the dense MLP in each form, the MoE
(autograd through the reference's dense dispatch; the router's gradient
reaches it through the top-k logits and their softmax) and vision tokens.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..sharding import shard
from ..sharding.partitioning import is_dtensor, product
from . import blocks, remat
from .attention import attention, attn_defs, decode_attention, kv_cache_defs
from .common import DefModule, ParamDef, embedding, layer_norm, recompute, rms_norm, tag

__all__ = [
    "KINDS",
    "Decoder",
    "check_supported",
    "working_dtype",
    "forward",
    "prefill",
    "decode_step",
    "cache_defs",
    "init_cache",
    "cross_entropy_loss",
    "default_scan_group",
    "kernel_calls",
    "kernel_forwards",
    "layer_replays",
]

KINDS = ("rec", "attn_local", "ssm", "attn")
_ATTN = ("attn", "attn_local")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def working_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def has_mlp(cfg: ModelConfig, kind: str) -> bool:
    """The reference's rule: a layer has an MLP unless it is an SSM layer or
    the config has none."""
    return cfg.d_ff > 0 and kind != "ssm"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's models do not run, served or trained (which
    arch fits one card for training is the launcher's question,
    ``launch.train.training_bytes``)."""
    missing = [k for k in sorted(set(cfg.kinds)) if k not in KINDS]
    if missing:
        raise NotImplementedError(f"{cfg.arch_id}: layer kinds {missing} are not ported "
                                  f"(the port runs {KINDS})")
    if "attn_local" in cfg.kinds and cfg.attn_window is None:
        raise NotImplementedError(f"{cfg.arch_id}: not ported: no attention window")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"{cfg.arch_id}: not ported: norm {cfg.norm!r}")
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"{cfg.arch_id}: working type {cfg.dtype!r} not ported")


def norm_defs(cfg: ModelConfig, name: str) -> dict[str, ParamDef]:
    """``{name}_w`` (ones), and ``{name}_b`` (zeros) for a LayerNorm; fp32, as
    the reference reads them."""
    defs = {f"{name}_w": ParamDef((cfg.d_model,), ("embed",), init="ones", fp32=True)}
    if cfg.norm == "layernorm":
        defs[f"{name}_b"] = ParamDef((cfg.d_model,), ("embed",), init="zeros", fp32=True)
    return defs


def apply_norm(cfg: ModelConfig, mod, name: str, x: torch.Tensor) -> torch.Tensor:
    """The config's norm with ``mod``'s ``{name}_w`` (and ``{name}_b``)."""
    if cfg.norm == "layernorm":
        return recompute(layer_norm, x, getattr(mod, f"{name}_w"), getattr(mod, f"{name}_b"))
    return recompute(rms_norm, x, getattr(mod, f"{name}_w"))


def ffn(cfg: ModelConfig, p, x: torch.Tensor, rules=None) -> torch.Tensor:
    """The layer's feed-forward block: the MoE where the config has experts,
    else the dense MLP."""
    return blocks.moe(cfg, p, x, rules) if cfg.n_experts else blocks.mlp(cfg, p, x, rules)


def ffn_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    return blocks.moe_defs(cfg) if cfg.n_experts else blocks.mlp_defs(cfg)


class Layer(DefModule):
    """One layer: ln1 -> mixer (rec, attn or ssm) -> residual, then, where the
    layer has one, ln2 -> mlp (dense or MoE) -> residual."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, master: bool = False):
        mlp = has_mlp(cfg, kind)
        norms = {**norm_defs(cfg, "ln1"), **(norm_defs(cfg, "ln2") if mlp else {})}
        super().__init__(norms, dtype, device, master)
        self.kind = kind
        if kind == "rec":
            self.rec = DefModule(blocks.rec_defs(cfg), dtype, device, master)
        elif kind == "ssm":
            self.ssm = DefModule(blocks.ssm_defs(cfg), dtype, device, master)
        else:
            self.attn = DefModule(attn_defs(cfg), dtype, device, master)
        self.mlp = DefModule(ffn_defs(cfg), dtype, device, master) if mlp else None


class Decoder(DefModule):
    """Embedding, the layers, the final norm, and the output projection: the
    embedding's transpose where the config ties them, else ``lm_head``.
    ``master=True``: fp32 master parameters that require gradients, cast to
    the working type at use (training)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 master: bool = False):
        check_supported(cfg)
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.arch_id} is an encoder-decoder: build it with "
                             "models.encdec.EncDec (or models.arch_init_params)")
        dtype = working_dtype(cfg)
        device = resolve_device(device)
        defs = {"tok_emb": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                                    scale=1.0)}
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
        super().__init__({**defs, **norm_defs(cfg, "ln_f")}, dtype, device, master)
        self.cfg = cfg
        self.layers = nn.ModuleList(Layer(cfg, kind, dtype, device, master)
                                    for kind in cfg.kinds)

    def forward(self, tokens: torch.Tensor,
                vis_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, vis_embeds=vis_embeds)


def _embed(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor,
           vis_embeds: torch.Tensor | None = None) -> torch.Tensor:
    # gathered from the stored table, then cast (the reference's take-then-cast:
    # a training model scatters the gradient into its fp32 master)
    x = embedding(model.master("tok_emb"), tokens).to(working_dtype(cfg))
    if cfg.emb_scale:
        # the scale is rounded to the working type first, as the reference does
        # (50.5 in bf16 for d 2560), on the host: no copy to the card, no wait
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if vis_embeds is not None:
        # the stub vision frontend's embeddings replace the first positions
        x = torch.cat([vis_embeds.to(x.dtype), x[:, vis_embeds.shape[1]:]], dim=1)
    return x


def _tied(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bse,ve->bsv", x, table)


def _untied(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bse,ev->bsv", x, head)


def _logits(cfg: ModelConfig, model: Decoder, x: torch.Tensor, rules=None) -> torch.Tensor:
    x = apply_norm(cfg, model, "ln_f", x)
    f, w = (_tied, model.tok_emb) if cfg.tie_embeddings else (_untied, model.lm_head)
    return shard(product(f, x, w), ("batch", "seq", "vocab"), rules)


def _ring_from_full(k: torch.Tensor, window: int) -> torch.Tensor:
    """Arrange the last ``window`` positions of (B,S,KVH,D) into ring slots
    (position p in slot p % window)."""
    s = k.shape[1]
    if s >= window:
        tail = k[:, s - window:]
        shift = (s - window) % window
        return torch.roll(tail, shifts=shift, dims=1) if shift else tail.clone()
    pad = torch.zeros((k.shape[0], window - s, *k.shape[2:]), dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _pad_cache(k: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,S,KVH,D) -> a linear cache of ``max_len`` slots (position p in slot p)."""
    s = k.shape[1]
    if s == max_len:
        return k
    pad = torch.zeros((k.shape[0], max_len - s, *k.shape[2:]), dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _window(cfg: ModelConfig, kind: str) -> int | None:
    """The attention window of a layer kind: none for global attention."""
    return cfg.attn_window if kind == "attn_local" else None


def _layer(cfg: ModelConfig, layer: Layer, x: torch.Tensor, positions, max_len, rules=None):
    """One layer over the whole sequence; with ``max_len`` also its cache entry."""
    h = apply_norm(cfg, layer, "ln1", x)
    entry = None
    if layer.kind in _ATTN:
        win = _window(cfg, layer.kind)
        out, (k, v) = attention(cfg, layer.attn, h, positions=positions, causal=True,
                                window=win, return_kv=True, rules=rules)
        if max_len is not None and win is not None:
            slots = min(max_len, win)
            entry = {"k": _ring_from_full(k, slots), "v": _ring_from_full(v, slots)}
        elif max_len is not None:
            entry = {"k": _pad_cache(k, max_len), "v": _pad_cache(v, max_len)}
    else:
        state = None
        if max_len is not None:   # prefill starts from a zero state, as a decode would
            state = _zeros(_STATE_DEFS[layer.kind](cfg, x.shape[0]), x.dtype, x.device)
        block = blocks.rec_block if layer.kind == "rec" else blocks.ssm_block
        out, entry = block(cfg, getattr(layer, layer.kind), h, rules, state)
    x = tag(x + out, "resid_mid")
    if layer.mlp is not None:
        x = x + ffn(cfg, layer.mlp, apply_norm(cfg, layer, "ln2", x), rules)
    return tag(x, "resid_out"), entry


def default_scan_group(cfg: ModelConfig) -> int:
    """sqrt(L)-ish remat group size that divides n_layers (the reference's)."""
    L = cfg.n_layers
    for g in range(max(1, int(math.sqrt(L))), 0, -1):
        if L % g == 0:
            return g
    return 1


def _groups(cfg: ModelConfig, scan_group: int | None) -> list[list[int]]:
    """The layers' outer recompute regions, as the reference nests its
    checkpoints: pattern periods then single tail layers (``period_scan``),
    groups of ``scan_group`` layers (a uniform scanned stack), else single
    layers."""
    if cfg.period_scan:
        per = len(cfg.layer_pattern)
        periods = [list(range(p * per, (p + 1) * per)) for p in range(cfg.n_periods)]
        return periods + [[i] for i in range(cfg.n_periods * per, cfg.n_layers)]
    if cfg.uniform and cfg.scan_layers:
        g = scan_group or default_scan_group(cfg)
        if cfg.n_layers % g:
            raise ValueError(f"scan_group {g} does not divide {cfg.n_layers} layers")
        return [list(range(i, i + g)) for i in range(0, cfg.n_layers, g)]
    return [[i] for i in range(cfg.n_layers)]


def layer_replays(cfg: ModelConfig, scan_group: int | None = None,
                  remat_policy=None) -> list[int]:
    """How many times each layer's forward runs again in the backward of a
    training step under ``remat_policy`` (see :mod:`.remat`): none where the
    plan recomputes nothing, two for a layer in a period or group of more
    than one layer (the group's replay, then its own), else one."""
    plan = remat_policy if remat_policy is not None else remat.Residency()
    out = [0] * cfg.n_layers
    if cfg.remat == "none" or plan.recomputes_nothing(cfg):
        return out
    for idx in _groups(cfg, scan_group):
        for i in idx:
            out[i] = 2 if len(idx) > 1 else 1
    return out


def kernel_calls(cfg: ModelConfig) -> dict:
    """Kernel calls of one forward, by output class: one per layer of the
    kind, and for the encoder-decoder K2 in each encoder layer and twice in
    each decoder layer (self- and cross-attention).  A training step's
    backward runs each kernel's backward this often."""
    if cfg.encoder_layers:
        return {"attn_out": cfg.encoder_layers + 2 * cfg.n_layers, "rec_out": 0, "ssm_out": 0}
    return {"attn_out": sum(k in _ATTN for k in cfg.kinds), "rec_out": cfg.kinds.count("rec"),
            "ssm_out": cfg.kinds.count("ssm")}


def kernel_forwards(cfg: ModelConfig, scan_group: int | None = None,
                    remat_policy=None) -> dict:
    """Kernel outputs computed in one training step, by class: each of
    :func:`kernel_calls` once, plus once per replay unless the plan holds
    its output class (kept or offloaded).  The encoder-decoder takes no plan
    (the reference passes it none): each call runs once more in its layer's
    replay unless ``cfg.remat`` is "none"."""
    if cfg.encoder_layers:
        calls = kernel_calls(cfg)
        return {k: n * (1 if cfg.remat == "none" else 2) for k, n in calls.items()}
    out = {"attn_out": 0, "rec_out": 0, "ssm_out": 0}
    plan = remat_policy if remat_policy is not None else remat.Residency()
    held = set(plan.save_names) | set(plan.offload_names)
    for kind, n in zip(cfg.kinds, layer_replays(cfg, scan_group, remat_policy)):
        name = {"attn": "attn_out", "attn_local": "attn_out", "rec": "rec_out",
                "ssm": "ssm_out"}[kind]
        out[name] += 1 + (0 if name in held else n)
    return out


def _region(plan: remat.Residency, fn, x: torch.Tensor) -> torch.Tensor:
    return torch_checkpoint.checkpoint(fn, x, use_reentrant=False, context_fn=plan.contexts,
                                       preserve_rng_state=False)


def _train_layers(cfg: ModelConfig, model: Decoder, x: torch.Tensor, positions,
                  scan_group: int | None, plan: remat.Residency, rules=None) -> torch.Tensor:
    """The layers of a training forward under ``plan`` (see :mod:`.remat`);
    a uniform stack's group carries are constrained to ``seq_carry``, as the
    reference's."""
    def one(i):
        def run(xc):
            with plan.layer(i):
                return _layer(cfg, model.layers[i], xc, positions, None, rules)[0]
        return run

    if plan.recomputes_nothing(cfg):
        for i in range(cfg.n_layers):
            x = one(i)(x)
        return x

    carry = cfg.uniform and cfg.scan_layers

    def group(idx):
        def run(xc):
            for i in idx:
                xc = _region(plan, one(i), xc)
            return shard(xc, ("batch", "seq_carry", "embed"), rules) if carry else xc
        return run

    with torch_checkpoint.set_checkpoint_early_stop(False):
        for idx in _groups(cfg, scan_group):
            x = _region(plan, group(idx) if len(idx) > 1 else one(idx[0]), x)
    return x


def forward(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor, *,
            vis_embeds: torch.Tensor | None = None, scan_group: int | None = None,
            remat_policy=None, rules=None) -> torch.Tensor:
    """Token logits (B, S, padded_vocab); ``vis_embeds (B, Nv, E)`` replace
    the first Nv positions' embeddings.  With gradients enabled and a model
    of fp32 masters (training) the layers run under the residency plan
    ``remat_policy`` (a :class:`~.remat.Residency`; None saves nothing beyond
    the period and layer carries, unless ``cfg.remat == "none"``), in regions
    of ``scan_group`` layers for a uniform stack.  ``rules`` constrain the
    activations to their logical axes (DTensor parameters and inputs)."""
    x = shard(_embed(cfg, model, tokens, vis_embeds), ("batch", "seq", "embed"), rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    training = torch.is_grad_enabled() and model.master("tok_emb").requires_grad
    if training and cfg.remat != "none":
        plan = remat_policy if remat_policy is not None else remat.Residency()
        x = _train_layers(cfg, model, x, positions, scan_group, plan, rules)
    else:
        for layer in model.layers:
            x, _ = _layer(cfg, layer, x, positions, None, rules)
    return _logits(cfg, model, x, rules)


class _CrossEntropy(torch.autograd.Function):
    """The reference's loss over (rows, padded_vocab) logits, a block of rows
    at a time in fp32: the forward keeps only the logits (which the caller
    holds anyway) and each row's log-partition; the backward recomputes the
    softmax a block at a time and writes the gradient in the logits' type."""

    ROWS = 512

    @staticmethod
    def forward(ctx, logits, labels, vocab_size: int, z_loss: float):
        n, v = logits.shape
        dead = torch.arange(v, device=logits.device) >= vocab_size
        mask = (labels >= 0).to(torch.float32)
        gold_ix = labels.clamp_min(0)[:, None]
        logz = torch.empty(n, dtype=torch.float32, device=logits.device)
        nll = torch.empty(n, dtype=torch.float32, device=logits.device)
        for r0 in range(0, n, _CrossEntropy.ROWS):
            lf = logits[r0:r0 + _CrossEntropy.ROWS].to(torch.float32, copy=True).masked_fill_(
                dead, -1e30)
            lz = torch.logsumexp(lf, dim=-1)
            row = lz - torch.gather(lf, 1, gold_ix[r0:r0 + _CrossEntropy.ROWS])[:, 0]
            if z_loss:
                row = row + z_loss * torch.square(lz)
            logz[r0:r0 + len(lz)], nll[r0:r0 + len(lz)] = lz, row
        denom = torch.clamp_min(mask.sum(), 1.0)
        ctx.save_for_backward(logits, labels, logz, mask, denom)
        ctx.vocab_size, ctx.z_loss = vocab_size, z_loss
        return (nll * mask).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz, mask, denom = ctx.saved_tensors
        n, v = logits.shape
        dead = torch.arange(v, device=logits.device) >= ctx.vocab_size
        scale = g * mask / denom                                        # (n,)
        grad = torch.empty_like(logits)
        for r0 in range(0, n, _CrossEntropy.ROWS):
            r1 = min(n, r0 + _CrossEntropy.ROWS)
            # softmax of the block, in place in one fp32 buffer
            p = logits[r0:r1].to(torch.float32, copy=True).masked_fill_(dead, -1e30)
            p.sub_(logz[r0:r1, None]).exp_()
            if ctx.z_loss:
                p.mul_(1.0 + 2.0 * ctx.z_loss * logz[r0:r1, None])
            p.scatter_add_(1, labels[r0:r1].clamp_min(0)[:, None],
                           -torch.ones((r1 - r0, 1), device=p.device))
            grad[r0:r1] = p.mul_(scale[r0:r1, None])
        return grad, None, None, None


def cross_entropy_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not -1, with
    the padded vocabulary masked out of the softmax and ``z_loss * logz^2``
    added, as the reference's ``cross_entropy_loss``.  logits (B, S, V).
    For DTensor logits each rank takes its rows (its batch and sequence
    shards, the vocabulary gathered) and the mean is over every rank's
    labels."""
    if is_dtensor(logits):
        return _sharded_loss(cfg, logits, labels, float(z_loss))
    v = logits.shape[-1]
    return _CrossEntropy.apply(logits.reshape(-1, v), labels.reshape(-1).long(),
                               cfg.vocab_size, float(z_loss))


def _sharded_loss(cfg: ModelConfig, logits, labels, z_loss: float):
    """:func:`cross_entropy_loss` on each rank's rows (``local_map``): its
    batch and sequence shards, so q-sequence TP's logits stay split.  The
    rank's sum of losses and its count of labels are partial sums over the
    mesh axes that split the rows, and their ratio is the global mean."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..sharding import shard_map

    mesh, v = logits.device_mesh, logits.shape[-1]
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim < 2 else Replicate()
                 for pl in logits.placements)
    part = tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in rows)

    def local(lg, lb):
        lb = lb.reshape(-1).long()
        count = (lb >= 0).sum().float()
        mean = _CrossEntropy.apply(lg.reshape(-1, v), lb, cfg.vocab_size, z_loss)
        return mean * torch.clamp_min(count, 1.0), count

    total, count = shard_map(local, mesh=mesh, in_specs=(rows, rows), out_specs=[part, part])(
        logits, labels)
    return total / torch.clamp_min(count.redistribute(mesh, [Replicate()] * mesh.ndim), 1.0)


def prefill(cfg: ModelConfig, model: Decoder, tokens: torch.Tensor, *,
            vis_embeds: torch.Tensor | None = None, max_len: int | None = None, rules=None):
    """Forward the prompt (its first positions replaced by ``vis_embeds``, if
    given) and build the decode cache.  Returns (last-position logits
    (B, padded_vocab), cache)."""
    s = tokens.shape[1]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    x = shard(_embed(cfg, model, tokens, vis_embeds), ("batch", "seq", "embed"), rules)
    positions = torch.arange(s, device=tokens.device)
    cache = []
    for layer in model.layers:
        x, entry = _layer(cfg, layer, x, positions, max_len, rules)
        cache.append(entry)
    return _logits(cfg, model, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, model: Decoder, cache: list, tokens: torch.Tensor,
                pos: int, *, rules=None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.  Returns
    (logits (B, padded_vocab), the new cache); attention caches are updated in
    place."""
    x = _embed(cfg, model, tokens)
    new_cache = []
    for layer, entry in zip(model.layers, cache):
        h = apply_norm(cfg, layer, "ln1", x)
        if layer.kind in _ATTN:
            out, entry = decode_attention(cfg, layer.attn, h, entry, pos,
                                          window=_window(cfg, layer.kind), rules=rules)
        elif layer.kind == "rec":
            out, entry = blocks.rec_decode(cfg, layer.rec, h, entry, rules)
        else:
            out, entry = blocks.ssm_decode(cfg, layer.ssm, h, entry, rules)
        x = x + out
        if layer.mlp is not None:
            x = x + ffn(cfg, layer.mlp, apply_norm(cfg, layer, "ln2", x), rules)
        new_cache.append(entry)
    return _logits(cfg, model, x)[:, 0], new_cache


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> list[dict]:
    """Per layer, name -> (shape, fp32?) of the decode cache (sliding-window
    layers get rings of ``min(max_len, window)`` slots, global attention
    layers linear caches of ``max_len``)."""
    return [kv_cache_defs(cfg, batch, min(max_len, _window(cfg, kind) or max_len))
            if kind in _ATTN else _STATE_DEFS[kind](cfg, batch)
            for kind in cfg.kinds]


# the decode state of the recurrent kinds: name -> (shape, fp32?)
_STATE_DEFS = {"rec": blocks.rec_cache_defs, "ssm": blocks.ssm_cache_defs}


def _zeros(defs: dict, dtype, device) -> dict:
    return {name: torch.zeros(shape, dtype=torch.float32 if fp32 else dtype, device=device)
            for name, (shape, fp32) in defs.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list[dict]:
    """A zero decode cache on ``device``."""
    return [_zeros(d, working_dtype(cfg), device) for d in cache_defs(cfg, batch, max_len)]
