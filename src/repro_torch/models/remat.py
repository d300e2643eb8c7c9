"""A residency plan lowered onto the training forward.

The reference lowers the planner's keep / offload / remat choice per named
activation class (``plan.ACT_CLASSES``) to a ``jax.checkpoint`` policy and
nests ``jax.checkpoint`` per layer and per pattern period (or scan group).
PyTorch has no counterpart of ``save_only_these_names``; the port lowers the
plan as follows (:class:`Residency`):

* A plan that holds every class the model produces (each one kept on the
  card) recomputes nothing: the forward runs with no recompute region, and
  autograd holds what it saves.
* Otherwise (some class recomputed, or offloaded), every layer runs in a
  non-reentrant ``torch.utils.checkpoint`` region, nested in a region per
  pattern period (or scan group of more than one layer), as the reference
  nests its checkpoints; a region's backward replays its whole forward (early
  stopping off, so the count of replays is fixed: two for a layer inside a
  period or group, one for a layer outside).  In those replays a kernel whose
  output class the plan holds is not launched again: the output of the first
  forward is handed back (:mod:`..kernels.replay`), from the card for a kept
  class or copied back from pinned host memory for an offloaded one.  These
  are the classes produced by a hand-written kernel with its own backward
  (``attn_out``: K2's output and log-sum-exp; ``rec_out``: K3's states;
  ``ssm_out``: K4's output and last state); every
  other class inside a region is recomputed whatever the plan says, since its
  producer has no backward that could start from the held value (as
  PyTorch's selective checkpointing, too, re-runs every op it does not
  cache).
* No plan (``remat_policy=None``) saves nothing beyond the period and layer
  carries, as the reference's ``None`` policy does.

:class:`Residency` counts what happened: ``seen`` (tags per class, first
forward and replays), ``computed`` (kernel outputs computed per class: the
launches on the card), ``replayed`` and ``offloaded_bytes``.
"""
from __future__ import annotations

import collections
import contextlib

import torch

__all__ = ["HELD_CLASSES", "Residency", "classes_of"]

# classes produced by a hand-written kernel with its own backward: the ones a
# plan can hold across a recomputation
HELD_CLASSES = ("attn_out", "rec_out", "ssm_out")


def classes_of(cfg) -> set:
    """The activation classes a model of ``cfg`` produces: a decoder's, or an
    encoder-decoder's (its layers' carries ``enc_resid`` / ``dec_resid``,
    attention's and the dense MLP's)."""
    if cfg.encoder_layers:
        return {"enc_resid", "dec_resid", "attn_q", "attn_kv", "attn_out", "mlp_hidden"}
    out = {"resid_mid", "resid_out"}
    for kind in set(cfg.kinds):
        if kind in ("attn", "attn_local"):
            out |= {"attn_q", "attn_kv", "attn_out"}
        elif kind == "rec":
            out.add("rec_out")
        elif kind == "ssm":
            out.add("ssm_out")
        if cfg.d_ff > 0 and kind != "ssm":
            out.add("moe_hidden" if cfg.n_experts else "mlp_hidden")
    return out


class Residency:
    """Keep (``save_names``) / offload (``offload_names``) / recompute (every
    other class), lowered as the module docstring says; also the kernels'
    keeper (:mod:`..kernels.replay`), installed while a layer runs, which
    :func:`.common.tag` counts classes with."""

    def __init__(self, save_names=(), offload_names=()):
        self.save_names = tuple(save_names)
        self.offload_names = tuple(offload_names)
        overlap = set(self.save_names) & set(self.offload_names)
        if overlap:
            raise ValueError(f"classes both kept and offloaded: {sorted(overlap)}")
        self.seen = collections.Counter()
        self.computed = collections.Counter()
        self.replayed = collections.Counter()
        self.offloaded_bytes = 0
        self._held: dict = {}
        self._layer = None
        self._replaying = 0

    def __repr__(self):
        return (f"Residency(save_names={self.save_names}, "
                f"offload_names={self.offload_names})")

    def tier(self, name: str) -> str:
        if name in self.save_names:
            return "keep"
        return "offload" if name in self.offload_names else "remat"

    def recomputes_nothing(self, cfg) -> bool:
        """Whether every class of ``cfg``'s model is kept on the card."""
        return classes_of(cfg) <= set(self.save_names)

    # ---- the model's side ------------------------------------------------
    @contextlib.contextmanager
    def layer(self, index: int):
        """Run layer ``index`` (its kernels' outputs are held under it)."""
        from ..kernels import replay

        prev = self._layer
        self._layer = index
        try:
            with replay.installed(self):
                yield
        finally:
            self._layer = prev

    def contexts(self):
        """``context_fn`` of a recompute region: (first-forward, replay)."""
        return contextlib.nullcontext(), self._replay()

    @contextlib.contextmanager
    def _replay(self):
        self._replaying += 1
        try:
            yield
        finally:
            self._replaying -= 1

    def clear(self) -> None:
        """Drop every held output (after a backward)."""
        self._held.clear()

    # ---- the kernels' side (the keeper protocol) -------------------------
    def key(self, name: str):
        return (self._layer, name)

    def lookup(self, key):
        if not self._replaying:
            return None
        held = self._held.get(key)
        if held is None:
            return None
        self.replayed[key[1]] += 1
        values, device = held
        if device is None:
            return values
        return tuple(v.to(device, non_blocking=True) for v in values)

    def keep(self, key, values) -> None:
        name = key[1]
        self.computed[name] += 1
        tier = self.tier(name)
        if self._replaying or tier == "remat" or name not in HELD_CLASSES:
            return
        if tier == "keep":
            self._held[key] = (values, None)
            return
        device = values[0].device
        host = []
        for v in values:
            h = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                            pin_memory=device.type == "cuda")
            h.copy_(v, non_blocking=True)
            host.append(h)
            self.offloaded_bytes += v.numel() * v.element_size()
        self._held[key] = (tuple(host), device)

    def release(self, key) -> None:
        self._held.pop(key, None)
