"""Optimizers of the port: the reference's AdamW and Adafactor as functions
over dicts of tensors (the reference's are functions over pytrees).

* AdamW — configurable state type (fp32 / bf16 states), optional fp32 master
  copy (``master_fp32``: the stored parameters in a narrower type, the fp32
  masters in the state) and optional gradient compression with error feedback.
* Adafactor — factored second moments for >= 2-D parameters whose last two
  dims are at least ``min_dim_size_to_factor``, the update clipped by its RMS,
  the relative step size of the paper's section 8.
* Global-norm clipping and decoupled weight decay in both.

Parameters may be DTensors (``models.distribute_params``): the states are
made with each parameter's placements, the gradients are brought to them
first, the global norm sums every rank's shards (one all-reduce), AdamW
updates each rank's local shard only, and Adafactor's factored statistics
(means across a sharded dim) run as DTensor ops.

``apply(params, grads, state, step)`` returns ``(params, state, metrics)``
like the reference's, but updates the parameters and the state in place, a
parameter at a time (a step of a 2.7 B-parameter model would otherwise need
another copy of the parameters and of the state on the card); ``params`` are
usually a model's own parameters.  The arithmetic is the reference's, in
fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..sharding.partitioning import is_dtensor

__all__ = [
    "Optimizer", "adamw", "adafactor", "global_norm", "compress_decompress",
    "adafactor_factored",
]


def adafactor_factored(shape: tuple[int, ...], min_dim: int = 128) -> bool:
    """Which shapes get factored second moments."""
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _match(t, like):
    """``t`` with the placements of ``like`` (DTensors), else ``t``."""
    if is_dtensor(t) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def _zeros(p, shape=None, dtype=torch.float32, drop: int | None = None):
    """Zeros like ``p`` (its placements, for a DTensor), of ``shape`` with
    dim ``drop`` of ``p`` dropped (Adafactor's factored slots)."""
    if not is_dtensor(p):
        return torch.zeros(p.shape if shape is None else shape, dtype=dtype, device=p.device)
    if drop is None:
        return torch.zeros_like(p, dtype=dtype)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros

    drop %= p.ndim
    pl = [Replicate() if isinstance(x, Shard) and x.dim == drop
          else Shard(x.dim - 1) if isinstance(x, Shard) and x.dim > drop else x
          for x in p.placements]
    return dzeros(shape, dtype=dtype, device_mesh=p.device_mesh, placements=pl)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (fp32).  For
    DTensors, each rank sums its shards' squares (a replicated shard over
    its number of copies) and one all-reduce adds the ranks' sums; the
    result is a plain tensor."""
    leaves = list(tree.values())
    total = torch.zeros((), dtype=torch.float32, device=_local(leaves[0]).device)
    sharded, mesh = torch.zeros_like(total), None
    for leaf in leaves:
        if is_dtensor(leaf):
            from torch.distributed.tensor import Replicate

            copies = 1
            for i, pl in enumerate(leaf.placements):
                copies *= leaf.device_mesh.size(i) if isinstance(pl, Replicate) else 1
            sharded = sharded + torch.sum(torch.square(leaf.to_local().float())) / copies
            mesh = leaf.device_mesh
        else:
            total = total + torch.sum(torch.square(leaf.float()))
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        total = total + DTensor.from_local(sharded, mesh, [Partial()] * mesh.ndim,
                                           run_check=False).full_tensor()
    return torch.sqrt(total)


def _clip_scale(grads: dict, max_norm: float):
    gnorm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0), gnorm


def compress_decompress(g: torch.Tensor, residual: torch.Tensor, mode: str):
    """Error-feedback gradient compression: ``(wire value decompressed, new
    residual)``; the quantisation error is carried in ``residual`` and added
    back next step."""
    gf = g.float() + residual
    if mode == "bf16":
        wire = gf.to(torch.bfloat16).float()
    elif mode == "int8":
        scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
        wire = torch.clamp(torch.round(gf / scale), -127, 127) * scale
    else:
        raise ValueError(mode)
    return wire, gf - wire


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: float(lr))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], dict]
    apply: Callable[[dict, dict, dict, int], tuple[dict, dict, dict]]
    name: str = "opt"


def adamw(
    lr: float | Callable[[int], float] = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    state_dtype: torch.dtype = torch.float32,
    compression: str | None = None,
    master_fp32: bool = False,
) -> Optimizer:
    """AdamW.  ``master_fp32=True``: the state carries an fp32 copy of every
    parameter, updated in fp32; the parameters take it rounded to their own
    type."""
    lr_fn = _lr_fn(lr)

    def init(params: dict) -> dict:
        st = {"m": {k: _zeros(p, dtype=state_dtype) for k, p in params.items()},
              "v": {k: _zeros(p, dtype=state_dtype) for k, p in params.items()}}
        if master_fp32:
            st["master"] = {k: p.detach().float().clone() for k, p in params.items()}
        if compression:
            st["residual"] = {k: _zeros(p) for k, p in params.items()}
        return st

    @torch.no_grad()
    def apply(params: dict, grads: dict, state: dict, step: int):
        grads = {k: _match(grads[k], p) for k, p in params.items()}
        scale, gnorm = _clip_scale(grads, clip_norm)
        t = float(step) + 1.0
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        lr_t = lr_fn(step)
        masters = state.get("master", params)
        for k, p in params.items():
            p = _local(p)       # each rank updates its own shard
            gf = _local(grads[k]).float() * scale
            if compression:
                gf, residual = compress_decompress(gf, _local(state["residual"][k]), compression)
                _local(state["residual"][k]).copy_(residual)
            m, v, w = (_local(x) for x in (state["m"][k], state["v"][k], masters[k]))
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            step_v = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + weight_decay * w.float()
            w_new = w.float() - lr_t * step_v
            m.copy_(m_new)
            v.copy_(v_new)
            if master_fp32:
                w.copy_(w_new)
            p.copy_(w_new)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, apply=apply, name="adamw_master" if master_fp32 else "adamw")


def adafactor(
    lr: float | Callable[[int], float] = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    clip_norm: float = 1.0,
    min_dim_size_to_factor: int = 128,
    master_fp32: bool = False,
    relative_step: bool = True,
    eps_scale: float = 1e-3,
) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) without momentum, as the reference's:
    the second moment factored into row and column statistics for large
    matrices; ``relative_step``: the step ``lr * max(eps_scale, RMS(w))``."""
    lr_fn = _lr_fn(lr)

    def factored(p) -> bool:
        return adafactor_factored(tuple(p.shape), min_dim_size_to_factor)

    def init(params: dict) -> dict:
        def one(p):
            if factored(p):
                return {"vr": _zeros(p, p.shape[:-1], drop=-1),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:], drop=-2)}
            return {"v": _zeros(p)}

        st: dict[str, Any] = {"slots": {k: one(p) for k, p in params.items()}}
        if master_fp32:
            st["master"] = {k: p.detach().float().clone() for k, p in params.items()}
        return st

    @torch.no_grad()
    def apply(params: dict, grads: dict, state: dict, step: int):
        grads = {k: _match(grads[k], p) for k, p in params.items()}
        scale, gnorm = _clip_scale(grads, clip_norm)
        t = float(step) + 1.0
        beta2 = 1.0 - t ** -decay
        lr_t = lr_fn(step)
        masters = state.get("master", params)
        for k, p in params.items():
            gf = grads[k].float() * scale
            slot, w = state["slots"][k], masters[k]
            g2 = gf * gf + eps
            if "vr" in slot:
                vr = beta2 * slot["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * slot["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
                u = gf * torch.rsqrt(vr[..., None] / denom[..., None] + eps) \
                    * torch.rsqrt(vc[..., None, :] + eps)
                slot["vr"].copy_(_match(vr, slot["vr"]))
                slot["vc"].copy_(_match(vc, slot["vc"]))
            else:
                v = beta2 * slot["v"] + (1 - beta2) * g2
                u = gf * torch.rsqrt(v + eps)
                slot["v"].copy_(_match(v, slot["v"]))
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            wf = w.float()
            alpha = lr_t
            if relative_step:
                rms_w = torch.sqrt(torch.mean(torch.square(wf)) + 1e-30)
                alpha = lr_t * torch.clamp_min(rms_w, eps_scale)
            w_new = _match(wf - alpha * (u + weight_decay * wf), p)
            if master_fp32:
                w.copy_(w_new)
            p.copy_(w_new)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, apply=apply,
                     name="adafactor_master" if master_fp32 else "adafactor")
