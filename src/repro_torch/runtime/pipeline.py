"""Pipeline-parallel executor: GPipe-style fill/drain over a ``stage`` mesh
axis, each rank running its stage on its local shard (``local_map``) and
rotating microbatch activations one stage on with a point-to-point
permute (the reference's ``ppermute``).

The layer→stage map and the microbatch order come from the HDATS planner
(``repro_torch.plan.plan_pipeline``); this executor realizes the schedule on
a mesh.  Stages hold equal layer counts.

Differentiable: the permute's backward is the reverse permute, so a
backward through :func:`pipeline_apply` runs the pipeline's backward (fill
and drain reversed), as the reference's transpose rule gives it.  Every
tick's activation stays in the graph on every rank (the reference's
``where``s), so all ranks run the same reverse permutes in the same order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..sharding import shard_map
from ..sharding.partitioning import is_dtensor

__all__ = ["pipeline_apply"]


class _Permute(torch.autograd.Function):
    """Send ``x`` to the stage ``shift`` on in the ring of ``group`` and
    return what the stage ``shift`` back sent; the backward permutes the
    gradient the other way."""

    @staticmethod
    def forward(ctx, x, group, shift: int):
        ctx.group, ctx.shift = group, shift
        return _ring(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring(g.contiguous(), ctx.group, -ctx.shift), None, None


def _ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (me + shift) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def pipeline_apply(
    mesh,
    stage_params: Any,          # tree of tensors, leaves stacked (n_stages, ...)
    x_mb: torch.Tensor,         # (n_micro, mb, ...) microbatched inputs
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run all microbatches through the stage pipeline; returns outputs
    (n_micro, mb, ...) as produced by the LAST stage.  ``mesh`` is a
    ``DeviceMesh`` with a ``stage_axis``; plain inputs are taken as
    replicated on it (and a plain output comes back), DTensor inputs keep
    their placements.  Each rank holds its stage's slice of
    ``stage_params``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    axis = mesh.mesh_dim_names.index(stage_axis)
    n_stages = mesh.size(axis)
    n_micro = x_mb.shape[0]
    n_ticks = n_micro + n_stages - 1
    group = mesh.get_group(stage_axis)
    plain = not is_dtensor(x_mb)

    def on_mesh(t):
        if is_dtensor(t):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    stage = tuple(Shard(0) if i == axis else Replicate() for i in range(mesh.ndim))
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    x_grad = tuple(Partial() if i == axis else Replicate() for i in range(mesh.ndim))

    def shard_fn(x_local, *params_local):
        sid = mesh.get_local_rank(stage_axis)
        leaves = iter(params_local)
        p_local = _tree_map(lambda _: next(leaves)[0], stage_params)
        buf = torch.zeros_like(x_local[0])                 # in-flight activation
        outs = torch.zeros_like(x_local)
        for t in range(n_ticks):
            # stage 0 injects microbatch t (when in range)
            x_in = x_local[min(t, n_micro - 1)]
            buf = torch.where(torch.tensor(sid == 0 and t < n_micro), x_in, buf)
            y = stage_fn(p_local, buf)
            # the last stage emits microbatch t - (n_stages - 1)
            emit = t - (n_stages - 1)
            hit = torch.zeros(n_micro, dtype=torch.bool, device=y.device)
            if sid == n_stages - 1 and emit >= 0:
                hit[emit] = True
            hit = hit.reshape(-1, *([1] * y.dim()))
            outs = torch.where(hit, y.unsqueeze(0).expand_as(outs), outs)
            if t + 1 < n_ticks:
                # rotate activations forward one stage
                buf = _Permute.apply(y, group, 1)
        return outs[None]                                  # (1, n_micro, mb, ...) per stage

    leaves = [on_mesh(t) for t in _leaves(stage_params)]
    out = shard_map(shard_fn, mesh=mesh, in_specs=(rep,) + (stage,) * len(leaves),
                    out_specs=stage, in_grad_specs=(x_grad,) + (stage,) * len(leaves))(
        on_mesh(x_mb), *leaves)
    # (n_stages, n_micro, ...): only the LAST stage's slot holds real outputs
    out = out[-1]
    return out.full_tensor() if plain else out
