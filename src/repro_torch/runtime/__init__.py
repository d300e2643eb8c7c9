"""Step factories of the port: serving and training, with the optimizers,
the synthetic data, checkpointing and recovery."""
from . import checkpoint, elastic
from .data import DataState, SyntheticLM
from .optimizer import Optimizer, adafactor, adamw, global_norm
from .serve import make_prefill_step, make_serve_step, next_token
from .train import TrainState, make_train_step

__all__ = [
    "Optimizer", "adafactor", "adamw", "global_norm",
    "TrainState", "make_train_step", "make_prefill_step", "make_serve_step", "next_token",
    "DataState", "SyntheticLM", "checkpoint", "elastic",
]
