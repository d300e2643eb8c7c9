"""State carried across packages as plain NumPy arrays.

An :class:`~repro_torch.core.mdfg.Instance` or
:class:`~repro_torch.core.solution.Solution` built elsewhere — by another
implementation of the same model, or loaded from disk — enters the port as a
dict of arrays and scalars and leaves it the same way.  The field names are
the dataclass's own, so ``{f: getattr(obj, f) for f in INSTANCE_FIELDS}`` on
any object with the same attributes is a valid input.

A solution's per-processor order (a list of lists) travels as a CSR pair:
``proc_seq_indptr (n_procs + 1,)`` and ``proc_seq_idx (n_tasks,)``.

A model's parameters travel as the reference's nested parameter tree of
arrays: heterogeneous stacks as ``periods/slot_j/...`` stacked on a leading
axis of pattern periods plus unrolled ``tail_XXX`` layers, uniform stacks as
``layers/...`` stacked on a leading axis of layers, otherwise
``layer_XXX``; ``tok_emb`` and ``ln_f_w`` (``ln_f_b``) at the top.  The
port's state dict names layer ``i`` ``layers.{i}.<path>``
(:mod:`repro_torch.models.decoder`).  An encoder-decoder's tree stacks
``enc_layers/...`` and ``dec_layers/...`` on a leading axis of layers, with
``tok_emb``, ``pos_emb`` and the final norms at the top; the port names
``enc_layers.{i}.<path>`` and ``dec_layers.{i}.<path>``
(:mod:`repro_torch.models.encdec`).  MoE expert stacks ``(E, d, f)``, the
router and every bias travel as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.mdfg import Instance
from .core.solution import Solution

__all__ = [
    "INSTANCE_FIELDS",
    "SOLUTION_FIELDS",
    "instance_from_arrays",
    "instance_to_arrays",
    "solution_from_arrays",
    "solution_to_arrays",
    "model_params_from_arrays",
    "model_params_to_arrays",
]

# the constructor fields; the pred/succ CSR closure is re-derived from them
INSTANCE_FIELDS = (
    "n_tasks", "n_data", "task_edges", "producer",
    "cons_indptr", "cons_idx", "in_indptr", "in_idx", "out_indptr", "out_idx",
    "proc_time", "data_size", "mem_cap", "access_time", "mem_level",
    "data_mem_ok", "name",
)
_INSTANCE_SCALARS = {"n_tasks": int, "n_data": int, "name": str}
SOLUTION_FIELDS = ("assign", "mem", "proc_seq_indptr", "proc_seq_idx")


def instance_from_arrays(fields: dict) -> Instance:
    """Build an :class:`Instance` from a field dict (arrays are copied, so
    the two sides never share memory).  ``name`` is optional; unknown keys
    (for example the derived ``pred_*``/``succ_*`` arrays) are ignored."""
    missing = [f for f in INSTANCE_FIELDS if f not in fields and f != "name"]
    if missing:
        raise KeyError(f"instance fields missing: {', '.join(missing)}")
    kw = {}
    for f in INSTANCE_FIELDS:
        if f not in fields:
            continue
        cast = _INSTANCE_SCALARS.get(f)
        kw[f] = cast(fields[f]) if cast else np.array(fields[f], copy=True)
    return Instance(**kw)


def instance_to_arrays(inst: Instance) -> dict:
    """The inverse of :func:`instance_from_arrays` (copies)."""
    out = {}
    for f in INSTANCE_FIELDS:
        v = getattr(inst, f)
        out[f] = v if f in _INSTANCE_SCALARS else np.array(v, copy=True)
    return out


def solution_from_arrays(fields: dict) -> Solution:
    """Build a :class:`Solution` from ``assign``, ``mem`` and the CSR form of
    the per-processor order."""
    indptr = np.asarray(fields["proc_seq_indptr"], dtype=np.int64)
    idx = np.asarray(fields["proc_seq_idx"], dtype=np.int64)
    proc_seq = [[int(t) for t in idx[indptr[p]:indptr[p + 1]]]
                for p in range(len(indptr) - 1)]
    return Solution(assign=np.array(fields["assign"], copy=True),
                    mem=np.array(fields["mem"], copy=True),
                    proc_seq=proc_seq)


def solution_to_arrays(sol: Solution) -> dict:
    """The inverse of :func:`solution_from_arrays` (copies)."""
    lens = np.array([len(s) for s in sol.proc_seq], dtype=np.int64)
    indptr = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    idx = np.array([t for s in sol.proc_seq for t in s], dtype=np.int64)
    return {"assign": np.array(sol.assign, copy=True),
            "mem": np.array(sol.mem, copy=True),
            "proc_seq_indptr": indptr, "proc_seq_idx": idx}


def _stacks(cfg) -> dict:
    """The port's layer lists by name (its state dict's prefix), each with,
    for every layer index, the path of its subtree in the reference's tree
    and its index on the stacked axis (None if unstacked)."""
    if cfg.encoder_layers:
        return {"enc_layers": [(("enc_layers",), i) for i in range(cfg.encoder_layers)],
                "dec_layers": [(("dec_layers",), i) for i in range(cfg.n_layers)]}
    return {"layers": _layer_sources(cfg)}


def _layer_sources(cfg):
    """For each layer index of a decoder: the path of its subtree in the
    reference's parameter tree and its index on the stacked axis (None if
    unstacked)."""
    if cfg.uniform and cfg.scan_layers:
        return [(("layers",), i) for i in range(cfg.n_layers)]
    if cfg.period_scan:
        per = len(cfg.layer_pattern)
        out = [(("periods", f"slot_{j}"), p) for p in range(cfg.n_periods) for j in range(per)]
        return out + [((f"tail_{j:03d}",), None) for j in range(len(cfg.tail_kinds))]
    return [((f"layer_{i:03d}",), None) for i in range(cfg.n_layers)]


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def model_params_from_arrays(cfg, tree: dict) -> dict:
    """The reference's parameter tree of a model (arrays) -> the port's state
    dict (CPU tensors, copies, in the arrays' type); load it with the model's
    ``load_state_dict``, which casts to each parameter's type."""
    stacks = _stacks(cfg)
    roots = {path[0] for sources in stacks.values() for path, _ in sources}
    sd = _flatten({k: v for k, v in tree.items() if k not in roots})
    for prefix, sources in stacks.items():
        for i, (path, idx) in enumerate(sources):
            sub = tree
            for key in path:
                sub = sub[key]
            for name, arr in _flatten(sub).items():
                sd[f"{prefix}.{i}.{name}"] = arr if idx is None else np.asarray(arr)[idx]
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def model_params_to_arrays(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`model_params_from_arrays`: the port's state dict
    -> the reference's parameter tree, as float32 NumPy arrays."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    stacks = _stacks(cfg)
    layer_of: dict = {}
    tree: dict = {}
    for name, t in state_dict.items():
        prefix = name.split(".", 1)[0]
        if prefix in stacks:
            _, i, rest = name.split(".", 2)
            layer_of.setdefault((prefix, int(i)), {})[rest] = arr(t)
        else:
            tree[name] = arr(t)
    stacked: dict = {}
    for prefix, sources in stacks.items():
        for i, (path, idx) in enumerate(sources):
            _place(tree, stacked, path, idx, layer_of[(prefix, i)])
    for (path, rest), by_idx in stacked.items():
        node = tree
        for key in (*path, *rest.split(".")[:-1]):
            node = node.setdefault(key, {})
        node[rest.split(".")[-1]] = np.stack([by_idx[j] for j in sorted(by_idx)])
    return tree


def _place(tree: dict, stacked: dict, path: tuple, idx, layer: dict) -> None:
    """Put one layer's arrays at ``path`` of ``tree`` (unstacked), or gather
    them by stacked index into ``stacked``."""
    for rest, a in layer.items():
        if idx is None:
            node = tree
            for key in (*path, *rest.split(".")[:-1]):
                node = node.setdefault(key, {})
            node[rest.split(".")[-1]] = a
        else:
            stacked.setdefault((path, rest), {})[idx] = a
