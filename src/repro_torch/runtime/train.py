"""The training step of the port: value and gradient of the loss, then the
optimizer's update (the reference's ``make_train_step``).

``TrainState.params`` is the model's own parameters by name (fp32 masters,
``Decoder(cfg, master=True)``); the step updates them and the optimizer
state in place and returns the state with the step counter advanced.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import arch_forward, cross_entropy_loss
from .optimizer import Optimizer

__all__ = ["TrainState", "make_train_step", "batch_to"]


@dataclasses.dataclass
class TrainState:
    params: dict           # name -> the model's parameter (updated in place)
    opt_state: Any
    step: int


def batch_to(batch: dict, device) -> dict:
    """A batch of arrays (NumPy or torch) as tensors on ``device``: integer
    entries (``tokens``, ``labels``) as int64, floating ones (the stub
    frontends' ``frames`` / ``vis_embeds``) in their own type, which the
    model casts to its working type."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    model: torch.nn.Module,
    *,
    scan_group: int | None = None,
    remat_policy=None,
    z_loss: float = 1e-4,
):
    """``train_step(state, batch) -> (state, metrics)`` for ``model`` (whose
    parameters are ``state.params``); metrics hold ``loss`` and
    ``grad_norm`` (0-d tensors on the model's device) and ``lr``."""
    device = next(model.parameters()).device

    def loss_fn(batch):
        logits = arch_forward(cfg, model, batch, scan_group=scan_group,
                              remat_policy=remat_policy)
        return cross_entropy_loss(cfg, logits, batch["labels"], z_loss=z_loss)

    def train_step(state: TrainState, batch: dict):
        batch = batch_to(batch, device)
        for p in state.params.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        if remat_policy is not None:
            remat_policy.clear()
        grads = {k: p.grad for k, p in state.params.items()}
        params, opt_state, opt_metrics = optimizer.apply(state.params, grads, state.opt_state,
                                                         state.step)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss.detach(), **opt_metrics}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
