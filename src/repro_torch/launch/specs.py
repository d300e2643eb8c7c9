"""Abstract input / state / cache stand-ins for a dry run: DTensors on fake
tensors (the reference's ``ShapeDtypeStruct``s with a ``NamedSharding``).

No allocation happens here: every stand-in is a DTensor whose local shard
is a ``FakeTensor`` of this rank's shard shape, placed by the logical-axis
rules, so a step run on them (``launch.dryrun``) exercises the full
production partitioning without touching device memory.  The tensors are
made in the active ``FakeTensorMode`` (one is entered if none is).
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from ..configs.base import SHAPE_CELLS, ModelConfig, ShapeCell
from ..models import arch_cache_defs, param_defs, shard_grads
from ..models.common import DefModule, placements, spec_tree
from ..runtime.optimizer import adafactor, adafactor_factored, adamw
from ..sharding import ShardingRules, make_rules
from ..sharding.partitioning import local_shape, spec_of

__all__ = [
    "CELLS", "batch_axes_for", "arch_rules", "input_specs", "param_specs",
    "train_state_specs", "cache_specs", "stand_in", "mesh_axes", "argument_bytes",
    "model_stand_in", "adafactor_factored",
]

CELLS: dict[str, ShapeCell] = {c.name: c for c in SHAPE_CELLS}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


_MODE: list = []   # the fake mode of stand-ins made outside any


@contextlib.contextmanager
def _fake():
    """The active ``FakeTensorMode``, or else this module's own (one mode,
    so that stand-ins made by separate calls can meet in one op)."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if active_fake_mode() is not None:
        yield
        return
    if not _MODE:
        _MODE.append(FakeTensorMode())
    with _MODE[0]:
        yield


def stand_in(shape, dtype, mesh, spec) -> torch.Tensor:
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh`` whose
    local shard is a fake tensor of this rank's shard shape."""
    from torch.distributed.tensor import DTensor

    pl = placements(tuple(spec) + (None,) * (len(shape) - len(spec)), mesh)
    with _fake():
        local = torch.empty(local_shape(tuple(shape), mesh, pl), dtype=dtype,
                            device=mesh.device_type)
        stride = torch.empty(tuple(shape), device="meta").stride()
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=stride)


def argument_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (dicts,
    lists, tuples, a ``TrainState``'s fields)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.to_local().numel() * tree.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(argument_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(argument_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(argument_bytes(getattr(tree, f)) for f in tree.__dataclass_fields__)
    return 0


def batch_axes_for(global_batch: int, mesh) -> tuple[str, ...]:
    """Largest prefix of (pod, data) whose product divides the batch."""
    axes = mesh_axes(mesh)
    chosen: list[str] = []
    prod = 1
    for a in ("pod", "data"):
        if a in axes and global_batch % (prod * axes[a]) == 0:
            chosen.append(a)
            prod *= axes[a]
    return tuple(chosen)


def arch_rules(cfg: ModelConfig, cell: ShapeCell, mesh, *, moe_ep: bool = False,
               carry_seq_tp: bool = False) -> ShardingRules:
    """Per-(arch, cell) partitioning decisions:

    * heads-TP when n_heads divides the model axis;
    * q-sequence TP (context parallel) for indivisible-head attention archs
      on train/prefill (decode shards the KV cache over `model` instead);
    * recurrent archs never shard seq (the scan is sequential in time);
    * batch axes shrink when the cell's global batch cannot be split.
    """
    axes = mesh_axes(mesh)
    model_size = axes["model"]
    multi = "pod" in axes
    has_attn = cfg.n_heads > 0
    shard_heads = has_attn and cfg.n_heads % model_size == 0
    recurrent = any(k in ("rec", "ssm") for k in cfg.kinds)
    qseq = (
        has_attn and not shard_heads and not recurrent
        and cell.kind in ("train", "prefill")
        and cell.seq_len % model_size == 0
    )
    if moe_ep and (not cfg.n_experts or cfg.n_experts % model_size != 0):
        raise ValueError(f"moe_ep needs n_experts % {model_size} == 0")
    return make_rules(
        multi_pod=multi,
        shard_heads=shard_heads,
        qseq_tp=qseq,
        fsdp=True,
        batch_axes=batch_axes_for(cell.global_batch, mesh),
        moe_ep=moe_ep,
        carry_seq_tp=carry_seq_tp and cell.seq_len % model_size == 0,
    )


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh, rules: ShardingRules) -> dict[str, Any]:
    """Stand-ins for every model input of this cell (int32 tokens and
    labels, as the reference's)."""
    gb, s = cell.global_batch, cell.seq_len
    emb_dt = _DTYPES[cfg.dtype]
    tok = spec_of(("batch", "seq"), rules.acts)
    rows = spec_of(("batch", None, None), rules.acts)
    if cell.kind == "decode":
        batch = {"tokens": stand_in((gb, 1), torch.int32, mesh, (tok[0], None))}
    else:
        batch = {"tokens": stand_in((gb, s), torch.int32, mesh, tok)}
        if cell.kind == "train":
            batch["labels"] = stand_in((gb, s), torch.int32, mesh, tok)
    if cfg.encoder_layers and cell.kind != "decode":
        batch["frames"] = stand_in((gb, cfg.n_frames, cfg.d_model), emb_dt, mesh, rows)
    if cfg.n_vis_tokens and cell.kind == "train":
        batch["vis_embeds"] = stand_in((gb, cfg.n_vis_tokens, cfg.d_model), emb_dt, mesh, rows)
    return batch


def model_stand_in(cfg: ModelConfig, mesh, rules: ShardingRules, *, param_dtype=None):
    """The arch's model (fp32 masters cast at use, as the reference lowers
    its fp32 parameters) with every parameter a stand-in placed by
    ``spec_tree(defs, rules.params)``, in ``param_dtype`` (default fp32)."""
    from ..models import Decoder, EncDec

    dtype = param_dtype or torch.float32
    with _fake():
        model = (EncDec if cfg.encoder_layers else Decoder)(cfg, device="cpu", master=True)
        for mod in model.modules():
            if isinstance(mod, DefModule):
                for name, d in mod.defs.items():
                    mod._parameters[name] = shard_grads(torch.nn.Parameter(
                        stand_in(d.shape, dtype, mesh, spec_tree(d, rules.params))))
    return model


def param_specs(cfg: ModelConfig, mesh, rules: ShardingRules, *, param_dtype=None):
    """(defs, stand-ins, specs) by parameter name; the model that holds the
    stand-ins is ``model_stand_in``'s."""
    model = model_stand_in(cfg, mesh, rules, param_dtype=param_dtype)
    defs = param_defs(model)
    return defs, dict(model.named_parameters()), spec_tree(defs, rules.params)


def train_state_specs(
    cfg: ModelConfig,
    mesh,
    rules: ShardingRules,
    *,
    optimizer: str = "adamw",
    compression: bool = False,
    state_dtype=torch.float32,
):
    """(TrainState of stand-ins, the model that holds its parameters).  The
    optimizer state is the optimizer's own ``init`` on the stand-ins: AdamW
    (fp32, or bf16 states for "adamw_bf16") with or without an fp32 master
    copy ("_master": bf16 parameters), or Adafactor's factored ``vr`` /
    ``vc`` slots (``adafactor_factored``), each placed as its parameter with
    the factored dim dropped.  The step counter is an int (the reference's
    int32 scalar: 4 bytes, which ``dryrun`` counts)."""
    from ..runtime.train import TrainState

    master = optimizer.endswith("_master")
    base = optimizer.removesuffix("_master")
    model = model_stand_in(cfg, mesh, rules, param_dtype=torch.bfloat16 if master else None)
    params = dict(model.named_parameters())
    if base.startswith("adamw"):
        opt = adamw(state_dtype=torch.bfloat16 if base == "adamw_bf16" else state_dtype,
                    compression="bf16" if compression else None, master_fp32=master)
    elif base == "adafactor":
        opt = adafactor(master_fp32=master)
    else:
        raise ValueError(optimizer)
    with _fake(), torch.no_grad():
        opt_state = opt.init(params)
    return TrainState(params=params, opt_state=opt_state, step=0), model


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh, rules: ShardingRules) -> list[dict]:
    """The decode cache of the cell as stand-ins (one dict per layer),
    placed by its logical axes through ``rules.acts``."""
    dtype = _DTYPES[cfg.dtype]
    return [{name: stand_in(d.shape, torch.float32 if d.fp32 else dtype, mesh,
                            spec_tree(d, rules.acts))
             for name, d in layer.items()}
            for layer in arch_cache_defs(cfg, cell.global_batch, cell.seq_len)]
