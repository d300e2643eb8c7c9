"""Checkpointing: atomic, async-capable save / restore with step resume (the
reference's layout).

Layout:  ``<dir>/step_<N>/arrays.npz`` (flat path -> array) + ``meta.json``.
Writes go to a temporary directory, then ``os.replace``: a crash mid-save
never corrupts the latest checkpoint.  A state is any nest of dicts, lists,
dataclasses (a ``TrainState``), tensors, arrays and numbers; its paths are
the keys joined by ``::``.  bf16 tensors are stored as float32 (exact) and
restored to their type.

The paths are the port's own (its parameters are named by the module, e.g.
``params::layers.0.attn.wq``; the reference's by its parameter tree), so a
checkpoint of either package resumes only in that package.
:func:`restore` copies into the tensors of ``like`` in place (a training
state's parameters are the model's own) and returns the state.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_SEP = "::"


def _items(tree, prefix=()):
    """(path, leaf) pairs in a fixed order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), prefix + (f.name,))
    elif isinstance(tree, dict):
        for k in tree:
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _items(tree)}


def save(ckpt_dir: str, step: int, tree, extra_meta: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)
    flat = tree if isinstance(tree, _Flat) else _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": int(step), "keys": sorted(flat), **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and ".tmp." not in d
        and os.path.exists(os.path.join(ckpt_dir, d, "meta.json"))
    ]
    return max(steps) if steps else None


def _fill(like, data, prefix=()):
    """``like`` with every leaf replaced by the stored array: tensors are
    copied into in place, other leaves rebuilt."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _fill(getattr(like, f.name), data, prefix + (f.name,))
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _fill(v, data, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, data, prefix + (str(i),)) for i, v in enumerate(like))
    arr = data[_SEP.join(prefix)]
    if torch.is_tensor(like):
        with torch.no_grad():
            like.copy_(torch.from_numpy(np.asarray(arr)).to(like.dtype))
        return like
    if isinstance(like, np.ndarray):
        return np.asarray(arr, dtype=like.dtype)
    return type(like)(arr.item() if isinstance(arr, np.ndarray) else arr)


def restore(ckpt_dir: str, like, step: int | None = None):
    """Restore the checkpoint of ``step`` (the latest by default) into the
    structure of ``like``; returns ``(state, meta)``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _fill(like, data), meta


class _Flat(dict):
    """A state already flattened to host arrays (a snapshot)."""


class Checkpointer:
    """Async checkpointer: snapshot to host, write on a worker thread; keeps
    the last ``keep`` checkpoints.  ``wait()`` before process exit."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree, extra_meta: dict | None = None) -> None:
        host = _Flat(_flatten(tree))  # snapshot before the state moves on
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(step, host, extra_meta),
                                        daemon=True)
        self._thread.start()

    def _write(self, step, host, extra_meta):
        save(self.ckpt_dir, step, host, extra_meta)
        self._gc()

    def _gc(self):
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and ".tmp." not in d
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
