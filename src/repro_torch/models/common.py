"""Shared model machinery of the port: parameter definitions and their
initialisation from a ``torch.Generator``, norms (RMSNorm, LayerNorm), RoPE,
activations.

A module lists its parameters as :class:`ParamDef`s (shape, logical axes,
initialiser, whether the value stays fp32) and :class:`DefModule` registers
them, in one of two layouts:

* serving (``master=False``): matmul weights, embeddings and biases are held
  in the working type, cast once when they are set (the reference keeps fp32
  masters and casts at every use, which gives the same values); norm weights
  and ``a_param`` stay fp32, as the reference reads them in fp32.  Serving
  needs no gradients, so the parameters do not require them.
* training (``master=True``): every parameter is an fp32 master that
  requires a gradient, and reading a working-type parameter as an attribute
  (``p.wq``) casts it at that use, as the reference does, so the gradient
  flows back to the fp32 master (an AdamW step is not lost to bf16
  rounding).  :meth:`DefModule.master` reads the fp32 tensor itself.

:func:`tag` names an activation class (the reference's ``checkpoint_name``)
for a residency plan (:mod:`.remat`).

The logical axes name each dimension ("embed", "heads", "ff", ...), as the
reference's do; :func:`spec_tree` maps them to mesh-axis names through a
rules dict (``repro_torch.sharding``), and :func:`placements` turns such a
spec into DTensor placements on a ``DeviceMesh``.  A decode cache's entries
are :class:`CacheDef`s: a ``(shape, fp32)`` pair that carries its axes too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing

__all__ = [
    "ParamDef",
    "CacheDef",
    "DefModule",
    "param_defs",
    "embedding",
    "spec_tree",
    "placements",
    "init_params_",
    "rms_norm",
    "layer_norm",
    "rope_table",
    "apply_rope",
    "activation",
    "gelu_tanh",
    "recompute",
    "tag",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]    # logical sharding axes per dim
    init: str = "normal"            # normal | zeros | ones | small
    scale: float | None = None      # overrides fan-in scaling
    fp32: bool = False              # kept in fp32 whatever the working type

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class CacheDef(tuple):
    """One decode-cache entry: the pair ``(shape, fp32)`` (fp32, else the
    working type), with its logical ``axes`` as an attribute."""

    def __new__(cls, shape: tuple[int, ...], fp32: bool, axes: tuple[str | None, ...]):
        assert len(shape) == len(axes), (shape, axes)
        self = super().__new__(cls, (tuple(shape), fp32))
        self.axes = tuple(axes)
        return self

    @property
    def shape(self) -> tuple[int, ...]:
        return self[0]

    @property
    def fp32(self) -> bool:
        return self[1]


def _is_def(x) -> bool:
    return isinstance(x, (ParamDef, CacheDef))


def spec_tree(defs, rules: dict):
    """Logical axes -> a spec per dimension (a mesh-axis name, a tuple of
    them, or None) through a rules dict, over a tree (dicts, lists) of
    :class:`ParamDef` / :class:`CacheDef` leaves; the reference's
    ``spec_tree`` with tuples in place of ``PartitionSpec``s."""
    if _is_def(defs):
        return tuple(rules.get(a) if a is not None else None for a in defs.axes)
    if isinstance(defs, dict):
        return {k: spec_tree(v, rules) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(spec_tree(v, rules) for v in defs)
    raise TypeError(f"spec_tree: {type(defs).__name__} is not a def tree")


def placements(spec: tuple, mesh) -> tuple:
    """A spec (one entry per tensor dim) -> DTensor placements on ``mesh``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names (a tuple entry
    such as ("pod", "data") shards one tensor dim over several mesh dims,
    major to minor in the mesh's order), ``Replicate()`` on the others.  A
    mesh dim of one rank replicates (a shard of one is the whole tensor, and
    DTensor will not reshape a dim it holds sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    taken = set()
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax not in names:
                raise ValueError(f"spec {spec} names mesh axis {ax!r}, not in {names}")
            if ax in taken:
                raise ValueError(f"spec {spec} puts mesh axis {ax!r} on two dims")
            taken.add(ax)
            i = names.index(ax)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


class DefModule(nn.Module):
    """A module whose parameters are given by ``defs`` (name -> ParamDef):
    in the working type for serving, fp32 masters cast at use for training
    (``master=True``)."""

    def __init__(self, defs: dict[str, ParamDef], dtype: torch.dtype, device,
                 master: bool = False):
        super().__init__()
        self.defs = defs
        # working-type parameters read through a cast (training only)
        self._cast = {name: dtype for name, d in defs.items()
                      if master and not d.fp32 and dtype != torch.float32}
        for name, d in defs.items():
            dt = torch.float32 if (d.fp32 or master) else dtype
            self.register_parameter(
                name, nn.Parameter(torch.empty(d.shape, dtype=dt, device=device),
                                   requires_grad=master))

    def __getattr__(self, name: str):
        value = super().__getattr__(name)
        cast = self.__dict__.get("_cast")
        if cast and name in cast:
            return value.to(cast[name])
        return value

    def master(self, name: str) -> torch.Tensor:
        """The stored parameter ``name`` itself (no cast at use)."""
        return self._parameters[name]


def param_defs(model: nn.Module) -> dict[str, ParamDef]:
    """Every :class:`DefModule` parameter of ``model`` by its state-dict
    name -> its :class:`ParamDef`."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, DefModule):
            for name, d in mod.defs.items():
                out[f"{prefix}.{name}" if prefix else name] = d
    return out


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (V, E).  For DTensors a vocabulary-parallel
    lookup on each rank's shard (``local_map``): a rank whose table holds
    the vocabulary rows ``v0 ..`` looks up the ids in its range and gives
    zeros for the rest, a partial sum over the mesh dims that shard the
    vocabulary (the ids gathered there); the embedding dim is gathered.  A
    table that holds the whole vocabulary takes ``table[ids]`` itself."""
    from ..sharding.partitioning import is_dtensor

    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..sharding import shard_map
    from ..sharding.partitioning import local_start, split_grad

    mesh, v = table.device_mesh, table.shape[0]
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    t_in = tuple(p if voc else Replicate() for p, voc in zip(table.placements, vocab))
    i_in = tuple(Replicate() if voc else p for p, voc in zip(ids.placements, vocab))
    out = tuple(Partial() if voc else p for p, voc in zip(i_in, vocab))

    def local(t, i):
        if t.shape[0] == v:
            return t[i]
        rel = i - local_start(mesh, t_in, 0, v)
        hit = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, t.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))

    return shard_map(local, mesh=mesh, in_specs=(t_in, i_in), out_specs=out,
                     in_grad_specs=(split_grad(t_in, i_in), i_in))(table, ids)


def _draw(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    z = torch.randn(d.shape, generator=gen, device=device, dtype=torch.float32)
    if d.init == "small":
        return 0.1 * z
    fan_in = d.shape[0] if len(d.shape) > 1 else max(1, d.shape[-1])
    return (d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)) * z


@torch.no_grad()
def init_params_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every :class:`DefModule` parameter of ``model`` in fp32 from
    ``gen`` (whose device must be the parameters'), in module order, and store
    it in the parameter's type."""
    for mod in model.modules():
        if isinstance(mod, DefModule):
            for name, d in mod.defs.items():
                p = mod.master(name)
                p.copy_(_draw(d, gen, p.device))
    return model


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    with tracing.span("norm"):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return ((xf * torch.rsqrt(var + eps)) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with its statistics in fp32 (the
    reference's ``layer_norm``)."""
    with tracing.span("norm"):
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * weight.float() + bias.float()).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) absolute token positions."""
    from ..sharding.partitioning import like   # a DTensor x: replicated tables

    with tracing.span("rope"):
        d = x.shape[-1]
        cos, sin = rope_table(positions, d, theta)
        cos, sin = like(cos[None, :, None, :], x), like(sin[None, :, None, :], x)
        xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
        out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
        return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's GELU everywhere is the tanh form."""
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": gelu_tanh, "relu": F.relu}[name]


def recompute(fn, *args):
    """``fn(*args)``; when a gradient is being taken, as a recompute region
    (a non-reentrant ``torch.utils.checkpoint``): only the inputs are held and
    ``fn`` runs again in the backward.  For the elementwise work the reference
    leaves unnamed inside its layer checkpoints (norms, gates, the GLU
    product), which its residency policies never save."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """Name ``x`` as activation class ``name`` (``plan.ACT_CLASSES``), as the
    reference's ``checkpoint_name`` does: the residency plan of the running
    layer, if any, counts it (:mod:`.remat`).  Returns ``x``."""
    from ..kernels import replay

    plan = replay.current()
    if plan is not None:
        plan.seen[name] += 1
    return x
