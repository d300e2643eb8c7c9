"""Logical-axis partitioning rules (MaxText-style) for the production
meshes, on ``torch.distributed``'s DTensor.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod
(a ``DeviceMesh`` with those ``mesh_dim_names``, ``launch.mesh``).

Parameter logical axes:
  embed   -> "data"      FSDP / ZeRO-3: gathered per layer during compute
  ff      -> "model"     tensor parallel (Megatron MLP split)
  heads   -> "model"     TP over attention heads (only when divisible)
  vocab   -> "model"     sharded embedding / LM head
  experts -> None        expert weights: TP inside each expert (ff -> model)
  layers / state / window / conv / head_dim -> replicated

Activation logical axes:
  batch   -> ("pod", "data")
  seq     -> None  (or "model" in q-seq/context-parallel attention)
  kv_seq  -> "model" for the distributed decode cache

The rules are the reference's dicts, as they are.  A spec (one mesh-axis
entry per tensor dim, the reference's ``PartitionSpec``) becomes DTensor
placements through ``models.common.placements``: :func:`shard` is
``DTensor.redistribute`` to them (the reference's
``with_sharding_constraint``), and :func:`shard_map` is ``local_map``, which
hands a function each rank's local shards.

No view of a DTensor folds a sharded dim into a dim before it: torch 2.13
tracks such a dim as a ``_StridedShard``, torch 2.11 refuses the view.  A
product over the rows of an activation split along its sequence (q-sequence
TP) folds (batch, seq) into one row dim, so :func:`product` runs it on
each rank's rows instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "ShardingRules", "make_rules", "shard", "shard_map", "set_mesh", "get_mesh",
    "param_rules", "activation_rules", "spec_of", "placements_of", "is_dtensor", "active",
    "like", "local_start", "local_shape", "group_slice", "split_grad", "rows_split",
    "on_rows", "unsplit_grad", "product", "matmul",
]

_MESH = None


def set_mesh(mesh) -> None:
    """The mesh :func:`shard` constrains to (a ``DeviceMesh``, or None)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    params: dict[str, Any]
    acts: dict[str, Any]


def make_rules(
    *,
    multi_pod: bool = False,
    shard_heads: bool = True,
    qseq_tp: bool = False,
    fsdp: bool = True,
    batch_axes: tuple[str, ...] | None = None,
    moe_ep: bool = False,
    carry_seq_tp: bool = False,
) -> ShardingRules:
    """``batch_axes`` overrides the data-parallel axes (e.g. () for batch=1
    long-context cells where the batch cannot be sharded).  ``moe_ep`` moves
    the model axis from the expert-FFN hidden dim onto the expert dim
    (expert parallelism — requires n_experts % model_size == 0)."""
    if batch_axes is None:
        batch_axes = ("pod", "data") if multi_pod else ("data",)
    batch = (batch_axes if len(batch_axes) > 1 else
             (batch_axes[0] if batch_axes else None))
    params = {
        "embed": "data" if fsdp else None,
        "ff": None if moe_ep else "model",
        "heads": "model" if shard_heads else None,
        "kv_heads": None,       # GQA kv counts rarely divide the model axis
        "vocab": "model",
        "experts": "model" if moe_ep else None,
        "lru": "model",
        "lru_in": "data" if fsdp else None,
        "ssm_inner": "model",
        "state": None,
        "layers": None,
        "head_dim": None,
        "conv": None,
        "frames": None,
    }
    acts = {
        "batch": batch,
        "seq": "model" if qseq_tp else None,
        "kv_seq": "model",
        "embed": None,
        "heads": "model" if shard_heads else None,
        "kv_heads": None,
        # q-seq (context-parallel) mode: the seq dim owns the model axis, so
        # feature dims must stay unsharded in activation constraints
        # (a mesh axis shards one tensor dim at most)
        "ff": None if (qseq_tp or moe_ep) else "model",
        "vocab": None if qseq_tp else "model",
        "experts": "model" if moe_ep else None,
        "lru": None if qseq_tp else "model",
        "ssm_inner": None if qseq_tp else "model",
        "state": None,
        "head_dim": None,
        "layers": None,
        # saved scan-group carries: optionally seq-sharded over `model`
        # (Megatron-SP-style) to shrink remat-saved residual memory
        "seq_carry": "model" if carry_seq_tp else None,
    }
    return ShardingRules(params=params, acts=acts)


def spec_of(axes: tuple[str | None, ...], table: dict[str, Any]) -> tuple:
    """Logical axes -> a spec through one rules dict (``rules.acts`` or
    ``rules.params``)."""
    return tuple(table.get(a) if a is not None else None for a in axes)


def placements_of(axes: tuple[str | None, ...], rules: ShardingRules, mesh) -> tuple:
    """The DTensor placements of an activation with logical ``axes``."""
    from ..models.common import placements

    return placements(spec_of(axes, rules.acts), mesh)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a sharded or replicated tensor on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, axes: tuple[str | None, ...], rules: ShardingRules | None):
    """Redistribute a DTensor to its logical activation ``axes`` (the
    reference's ``with_sharding_constraint``).  A no-op without a mesh or
    rules, and for a plain tensor (it is not sharded)."""
    if rules is None or _MESH is None or not is_dtensor(x):
        return x
    want = placements_of(axes, rules, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def _as_placements(spec, mesh):
    """A spec (mesh-axis names per tensor dim) -> placements; a sequence of
    placements passes as it is; None (a non-tensor) stays None."""
    from torch.distributed.tensor.placement_types import Placement

    from ..models.common import placements

    if spec is None:
        return None
    if all(isinstance(p, Placement) for p in spec) and len(spec) == mesh.ndim:
        return tuple(spec)
    return placements(tuple(spec), mesh)


def shard_map(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """Run ``f`` on each rank's local shards (``local_map``): the DTensor
    arguments are redistributed to ``in_specs`` first, the outputs are
    DTensors with ``out_specs``.  A spec is mesh-axis names per tensor dim,
    as the reference's, or DTensor placements themselves (where an output
    is ``Partial``); ``in_grad_specs`` are the placements of the inputs'
    gradients (by default their ``in_specs``)."""
    from torch.distributed.tensor.experimental import local_map

    def tree(specs):
        # local_map reads a tuple as one entry per output, a list as one output's
        if isinstance(specs, list):
            return tuple(_as_placements(s, mesh) for s in specs)
        return list(_as_placements(specs, mesh))

    return local_map(
        f,
        out_placements=tree(out_specs),
        in_placements=tuple(_as_placements(s, mesh) for s in in_specs),
        in_grad_placements=(None if in_grad_specs is None
                            else tuple(_as_placements(s, mesh) for s in in_grad_specs)),
        device_mesh=mesh,
        redistribute_inputs=True,
    )


def param_rules(rules: ShardingRules) -> dict[str, Any]:
    return rules.params


def activation_rules(rules: ShardingRules) -> dict[str, Any]:
    return rules.acts


def _block(mesh, place: tuple, dim: int, size: int, coord) -> tuple[int, int]:
    """(first index, length) of a rank's block of tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    start, length = 0, size
    for i, p in enumerate(place):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            step = -(-length // n)
            start += min(coord[i] * step, length)
            length = max(0, min(step, length - coord[i] * step))
    return start, length


def local_start(mesh, place: tuple, dim: int, size: int) -> int:
    """The first index along tensor dim ``dim`` (of global length ``size``)
    of this rank's shard under placements ``place``: the mesh dims that
    shard ``dim`` split it in turn, major to minor, in ``torch.chunk``'s
    sizes (DTensor's)."""
    return _block(mesh, place, dim, size, mesh.get_coordinate())[0]


def local_shape(shape: tuple, mesh, place: tuple) -> tuple:
    """This rank's shard shape of a tensor of global ``shape`` placed
    ``place`` (the reference's ``NamedSharding.shard_shape`` on rank 0)."""
    coord = mesh.get_coordinate()
    return tuple(_block(mesh, place, d, n, coord)[1] for d, n in enumerate(shape))


def group_slice(n_local: int, first: int, n_heads: int, n_groups: int) -> slice:
    """The groups (kv heads, SSD groups) that the heads ``first ..
    first + n_local - 1`` of ``n_heads`` read, ``n_heads / n_groups`` heads
    a group.  Raises where a group straddles two ranks."""
    per = n_heads // n_groups
    if n_local == n_heads:
        return slice(0, n_groups)
    if n_local % per == 0 and first % per == 0:
        return slice(first // per, (first + n_local) // per)
    if per % n_local == 0:
        return slice(first // per, first // per + 1)
    raise ValueError(f"{n_local} heads a rank split groups of {per} heads across ranks")


def active(rules: ShardingRules | None):
    """The context a sharded step runs in: with rules and a mesh, plain
    tensors made inside it take part in DTensor ops as replicated values
    (``implicit_replication``); else nothing.  Re-entrant.  The flag is
    thread-local and the autograd engine runs a CUDA backward on its own
    threads, so code that a backward replays (recompute regions) makes its
    plain tensors DTensors itself (:func:`like`)."""
    import contextlib

    if rules is None or _MESH is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor made from no sharded input: positions, pads) as
    a replicated DTensor on ``ref``'s mesh where ``ref`` is a DTensor."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def split_grad(place: tuple, split: tuple) -> tuple:
    """The placements of the gradient of a ``local_map`` input placed
    ``place`` when the work is split as ``split`` (the main input's
    placements): a rank's gradient of an input replicated over a mesh dim
    that splits the work is its part of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if isinstance(p, Replicate) and isinstance(s, Shard) else p
                 for p, s in zip(place, split))


def rows_split(x) -> bool:
    """Whether ``x`` is a DTensor split along a dim after its first and
    before its last (q-sequence TP's sequence): a product over its rows
    would fold that dim into the first."""
    from torch.distributed.tensor import Shard

    return is_dtensor(x) and any(isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
                                 for p in x.placements)


def on_rows(f, x, *ws):
    """``f(x, *ws)`` on each rank's rows of the DTensor ``x`` (``local_map``):
    ``x`` keeps its shards of every dim but the last (gathered there), each
    ``w`` comes whole, and the output is placed as ``x``'s rows.  The ``w``
    gradients are partial sums over the mesh dims that split the rows
    (:func:`split_grad`), brought to the weights' placements by autograd.
    Nothing is folded, forward or backward: a gradient that arrives split
    otherwise is brought to ``x``'s rows first."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
                 for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    return shard_map(f, mesh=mesh, in_specs=(rows,) + (whole,) * len(ws), out_specs=rows,
                     in_grad_specs=(rows,) + (split_grad(whole, rows),) * len(ws))(x, *ws)


class _UnsplitGrad(torch.autograd.Function):
    """The identity, whose backward brings a gradient split along a row dim
    (:func:`rows_split`) to the forward's placements on those mesh dims (a
    shard of another dim, else replicated) before the op that made the
    forward's value takes it."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = tuple(y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if not rows_split(g):
            return g
        from torch.distributed.tensor import Replicate, Shard

        want = [p if not (isinstance(p, Shard) and 0 < p.dim < g.ndim - 1)
                else (f if isinstance(f, (Shard, Replicate)) else Replicate())
                for p, f in zip(g.placements, ctx.placements)]
        return g.redistribute(g.device_mesh, want)


def unsplit_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient reaches the op that made it split along no row
    dim (DTensor may hand a product's output gradient back split along the
    sequence, which the product's backward would fold).  A plain tensor
    passes as it is."""
    return _UnsplitGrad.apply(y) if is_dtensor(y) else y


def product(f, x: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    """``f(x, *ws)``, a product over the rows of ``x``: on each rank's rows
    (:func:`on_rows`) where ``x`` is split inside them (:func:`rows_split`),
    else with its gradient brought to no row split (:func:`unsplit_grad`)."""
    return on_rows(f, x, *ws) if rows_split(x) else unsplit_grad(f(x, *ws))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as a :func:`product`."""
    return product(torch.matmul, x, w)
