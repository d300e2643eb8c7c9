"""The training step of the port: value and gradient of the loss, then the
optimizer's update (the reference's ``make_train_step``).

``TrainState.params`` is the model's own parameters by name (fp32 masters,
``Decoder(cfg, master=True)``); the step updates them and the optimizer
state in place and returns the state with the step counter advanced.

With ``rules`` and a mesh (``sharding.set_mesh``) the parameters are
DTensors (``models.distribute_params``): a plain batch is placed by its
logical axes (:data:`INPUT_AXES`), the step runs sharded, each gradient is
brought to its parameter's placements before the update, and the metrics
come back as plain tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import tracing
from ..configs.base import ModelConfig
from ..models import arch_forward, cross_entropy_loss
from ..models.common import placements
from ..sharding import get_mesh
from ..sharding.partitioning import active, is_dtensor, spec_of
from .optimizer import Optimizer

__all__ = ["TrainState", "make_train_step", "batch_to", "shard_batch", "INPUT_AXES"]

# the logical axes of each model input (the reference's ``input_specs``)
INPUT_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "frames": ("batch", None, None), "vis_embeds": ("batch", None, None)}


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
        if is_dtensor(v):          # placed already (sharded inputs)
            out[k] = v
            continue
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def shard_batch(batch: dict, mesh, rules) -> dict:
    """A batch as DTensors on ``mesh``, each entry placed by its logical
    axes (:data:`INPUT_AXES`) through ``rules``; every rank holds the whole
    batch and keeps its shard.  DTensor entries pass as they are."""
    from torch.distributed.tensor import distribute_tensor

    return {k: v if is_dtensor(v) else
            distribute_tensor(v, mesh, placements(spec_of(INPUT_AXES[k], rules.acts), mesh))
            for k, v in batch.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    model: torch.nn.Module,
    *,
    rules=None,
    scan_group: int | None = None,
    remat_policy=None,
    z_loss: float = 1e-4,
):
    """``train_step(state, batch) -> (state, metrics)`` for ``model`` (whose
    parameters are ``state.params``); metrics hold ``loss`` and
    ``grad_norm`` (0-d tensors on the model's device) and ``lr``.  With
    ``rules`` (and a mesh set) the step runs sharded.  Under a profiler the
    step is the unit ``repro.train.step`` (:mod:`..tracing`), its phases the
    spans ``repro.train.forward``, ``.backward`` and ``.optimizer``."""
    first = next(model.parameters())
    device = (first.to_local() if is_dtensor(first) else first).device

    def loss_fn(batch):
        logits = arch_forward(cfg, model, batch, rules=rules, scan_group=scan_group,
                              remat_policy=remat_policy)
        return cross_entropy_loss(cfg, logits, batch["labels"], z_loss=z_loss)

    def train_step(state: TrainState, batch: dict):
        with tracing.unit("train.step", device), active(rules):
            batch = batch_to(batch, device)
            if rules is not None and get_mesh() is not None:
                batch = shard_batch(batch, get_mesh(), rules)
            for p in state.params.values():
                p.grad = None
            with tracing.span("train.forward"):
                loss = loss_fn(batch)
            with tracing.span("train.backward"):
                loss.backward()
            if remat_policy is not None:
                remat_policy.clear()
            grads = {k: p.grad for k, p in state.params.items()}
            with tracing.span("train.optimizer"):
                params, opt_state, opt_metrics = optimizer.apply(state.params, grads,
                                                                 state.opt_state, state.step)
            for p in params.values():
                p.grad = None
        metrics = {"loss": _plain(loss.detach()), **opt_metrics}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
