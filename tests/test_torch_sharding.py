"""The port's sharding rules, logical axes and stand-ins against the
reference (``repro.sharding``, ``repro.launch.specs``), exactly:

* ``make_rules`` over every flag combination gives the reference's dicts;
* ``arch_rules`` gives the reference's rules for every arch x shape cell x
  mesh shape in {(16, 16), (2, 16, 16), (4, 2), (2, 2, 2), (1, 8)} (duck-
  typed meshes);
* the ``ParamDef`` axes of every arch's model, and of its decode cache,
  equal the reference's leaf by leaf (a stacked leaf's less its "layers");
* rank 0's local shard shapes of the stand-ins under a fake process group
  of 8 equal the reference's ``NamedSharding.shard_shape`` (its side runs
  with 8 host devices in a subprocess), at full width;
* the argument bytes of ``train_state_specs`` plus ``input_specs`` (a train
  cell; parameters, cache and inputs for a decode cell) equal the sum of the
  reference's ``ShapeDtypeStruct`` shard bytes, byte for byte, for
  granite-moe-1b-a400m and qwen2.5-14b at the reference test's cells on
  (4, 2) and (2, 2, 2);
* the kernels' shape-only implementations (``kernels.fake``): under
  ``FakeTensorMode`` K2, K3 and K4 and their backwards give the shapes and
  types of the real calls and ``FlopCounterMode`` counts their formulas
  (the plain versions are not run).
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from torch_dist_helpers import run_reference

from repro.configs.base import SHAPE_CELLS as REF_SHAPE_CELLS
from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.launch.specs import arch_rules as ref_arch_rules
from repro.models import arch_cache_defs as ref_arch_cache_defs
from repro.models import arch_model_defs as ref_arch_model_defs
from repro.sharding import make_rules as ref_make_rules

from repro_torch import convert
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Decoder, EncDec, arch_cache_defs, param_defs
from repro_torch.sharding import make_rules

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((1, 8), ("data", "model"))]
FLAGS = ("multi_pod", "shard_heads", "qseq_tp", "fsdp", "moe_ep", "carry_seq_tp")
SHARD_ARCHS = ("qwen2.5-14b", "granite-moe-1b-a400m", "mamba2-780m", "recurrentgemma-2b",
               "whisper-medium", "llama3-405b")
ARG_CELLS = {"t": ShapeCell("t", 64, 8, "train"), "d": ShapeCell("d", 128, 8, "decode")}


@pytest.mark.parametrize("batch_axes", [None, (), ("data",), ("pod", "data")])
def test_make_rules_equals_the_reference_for_every_flag(batch_axes):
    for values in itertools.product((False, True), repeat=len(FLAGS)):
        kw = dict(zip(FLAGS, values), batch_axes=batch_axes)
        got, want = make_rules(**kw), ref_make_rules(**kw)
        assert got.params == want.params and got.acts == want.acts, kw


@pytest.mark.parametrize("shape, axes", MESHES)
def test_arch_rules_equal_the_reference(shape, axes):
    from repro_torch.launch.specs import arch_rules

    port_mesh = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    ref_mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in REF_SHAPE_CELLS]
    for arch, cell, carry in itertools.product(ARCH_IDS, SHAPE_CELLS, (False, True)):
        cfg = get_config(arch)
        got = arch_rules(cfg, cell, port_mesh, carry_seq_tp=carry)
        want = ref_arch_rules(cfg, cell, ref_mesh, carry_seq_tp=carry)
        assert (got.params, got.acts) == (want.params, want.acts), (arch, cell.name, carry)
        if cfg.n_experts and cfg.n_experts % shape[-1] == 0:
            got = arch_rules(cfg, cell, port_mesh, moe_ep=True)
            want = ref_arch_rules(cfg, cell, ref_mesh, moe_ep=True)
            assert (got.params, got.acts) == (want.params, want.acts), (arch, cell.name)


def _ref_axes_by_name(cfg, tree, stacked_root_of) -> dict:
    """The reference's def tree -> {port name: axes}, a stacked leaf's axes
    less the leading "layers" (which is checked)."""
    stacks = convert._stacks(cfg)
    roots = {path[0] for sources in stacks.values() for path, _ in sources}
    out = {k: d.axes for k, d in convert._flatten({k: v for k, v in tree.items()
                                                     if k not in roots}).items()}
    for prefix, sources in stacks.items():
        for i, (path, idx) in enumerate(sources):
            sub = tree
            for key in path:
                sub = sub[key]
            for name, d in convert._flatten(sub).items():
                if idx is not None:
                    assert d.axes[0] == "layers", (path, name, d.axes)
                out[f"{prefix}.{i}.{name}"] = d.axes if idx is None else d.axes[1:]
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_the_reference(arch):
    cfg, ref_cfg = get_smoke_config(arch), ref_get_smoke_config(arch)
    model = (EncDec if cfg.encoder_layers else Decoder)(cfg, device="cpu")
    got = {k: d.axes for k, d in param_defs(model).items()}
    assert got == _ref_axes_by_name(cfg, ref_arch_model_defs(ref_cfg), None)
    assert set(got) == {k for k, _ in model.named_parameters()}
    # the decode cache: one dict per layer in the port, stacked in the reference
    b, max_len = 2, 96
    cache, ref = arch_cache_defs(cfg, b, max_len), ref_arch_cache_defs(ref_cfg, b, max_len)
    if cfg.encoder_layers:
        want = [{**{k: d.axes[1:] for k, d in ref["self"].items()},
                 "cross_k": ref["cross_k"].axes[1:], "cross_v": ref["cross_v"].axes[1:]}
                for _ in range(cfg.n_layers)]
        assert ref["cross_k"].axes[0] == "layers"
    else:
        want = []
        for path, idx in convert._layer_sources(cfg):
            sub = ref
            for key in path:
                sub = sub[key]
            want.append({k: d.axes if idx is None else d.axes[1:] for k, d in sub.items()})
    assert [{k: d.axes for k, d in layer.items()} for layer in cache] == want
    assert all(tuple(d.shape) == d[0] and d.fp32 == d[1] for layer in cache for d in layer.values())


_REF = """
import dataclasses
import numpy as np
import jax
from repro.configs.base import ShapeCell, SHAPE_CELLS
from repro.configs.registry import get_config
from repro.launch.specs import (arch_rules, cache_specs, input_specs, param_specs,
                                train_state_specs)
from repro.models import arch_model_defs
from repro.models.common import ParamDef

def shard_bytes(tree):
    return int(sum(np.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
                   for l in jax.tree.leaves(tree)))

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out

cells = {"t": ShapeCell("t", 64, 8, "train"), "d": ShapeCell("d", 128, 8, "decode")}
shapes, args = {}, {}
for mesh_shape, axes in (((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    m = jax.make_mesh(mesh_shape, axes)
    key = "x".join(map(str, mesh_shape))
    train = [c for c in SHAPE_CELLS if c.name == "train_4k"][0]
    for arch in ARCHS:
        cfg = get_config(arch)
        rules = arch_rules(cfg, train, m)
        _, p, _ = param_specs(cfg, m, rules)
        shapes[key + "/" + arch] = {k: list(v.sharding.shard_shape(v.shape))
                                    for k, v in flat(p).items()}
    for arch in ("granite-moe-1b-a400m", "qwen2.5-14b"):
        cfg = get_config(arch)
        for name, cell in cells.items():
            rules = arch_rules(cfg, cell, m)
            batch = input_specs(cfg, cell, m, rules)
            if cell.kind == "train":
                state, _ = train_state_specs(cfg, m, rules)
                n = shard_bytes(state) + shard_bytes(batch)
            else:
                _, p, _ = param_specs(cfg, m, rules)
                c, _ = cache_specs(cfg, cell, m, rules)
                n = shard_bytes(p) + shard_bytes(c) + shard_bytes(batch)
            args[key + "/" + arch + "/" + name] = n
result({"shapes": shapes, "args": args})
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(f"ARCHS = {SHARD_ARCHS!r}\n" + _REF)


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 8 ranks (this process rank 0) for the
    module's stand-ins, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world as make

    make(8)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake_mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, device_type="cpu")


def _stacked_name(cfg, name: str):
    """The reference's flat name and stacked index of a port parameter."""
    prefix, rest = name.split(".", 1) if "." in name else (name, None)
    stacks = convert._stacks(cfg)
    if prefix not in stacks:
        return name, None
    i, leaf = rest.split(".", 1)
    path, idx = stacks[prefix][int(i)]
    return ".".join((*path, leaf)), idx


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
def test_rank0_shard_shapes_equal_the_references(ref, fake_world, shape):
    from repro_torch.launch.specs import CELLS, arch_rules, param_specs

    mesh = _fake_mesh(shape)
    key = "x".join(map(str, shape))
    for arch in SHARD_ARCHS:
        cfg = get_config(arch)
        _, params, _ = param_specs(cfg, mesh, arch_rules(cfg, CELLS["train_4k"], mesh))
        want = ref["shapes"][key + "/" + arch]
        seen = set()
        for name, p in params.items():
            rname, idx = _stacked_name(cfg, name)
            seen.add(rname)
            local = list(p.to_local().shape)
            assert local == (want[rname] if idx is None else want[rname][1:]), (arch, name)
        assert seen == set(want), arch


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
def test_argument_bytes_equal_the_references(ref, fake_world, shape):
    from repro_torch.launch.specs import (arch_rules, argument_bytes, cache_specs,
                                          input_specs, param_specs, train_state_specs)

    mesh = _fake_mesh(shape)
    key = "x".join(map(str, shape))
    for arch in ("granite-moe-1b-a400m", "qwen2.5-14b"):
        cfg = get_config(arch)
        for name, cell in ARG_CELLS.items():
            rules = arch_rules(cfg, cell, mesh)
            batch = input_specs(cfg, cell, mesh, rules)
            if cell.kind == "train":
                state, _ = train_state_specs(cfg, mesh, rules)
                got = argument_bytes(state) + 4 + argument_bytes(batch)    # + the int32 step
            else:
                _, params, _ = param_specs(cfg, mesh, rules)
                got = argument_bytes(params) + argument_bytes(cache_specs(cfg, cell, mesh, rules)) \
                    + argument_bytes(batch)
            assert got == ref["args"][f"{key}/{arch}/{name}"], (arch, name)


def test_adafactor_slots_drop_the_factored_dims_placement(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.specs import CELLS, arch_rules, train_state_specs

    mesh = _fake_mesh((4, 2))
    cfg = dataclasses.replace(get_config("llama3-405b"), n_layers=1)
    state, _ = train_state_specs(cfg, mesh, arch_rules(cfg, CELLS["train_4k"], mesh),
                                 optimizer="adafactor")
    p, slot = state.params["layers.0.mlp.wi"], state.opt_state["slots"]["layers.0.mlp.wi"]
    assert tuple(p.placements) == (Shard(0), Shard(1))        # (embed -> data, ff -> model)
    assert tuple(slot["vr"].placements) == (Shard(0), Replicate())
    assert tuple(slot["vc"].placements) == (Replicate(), Shard(0))
    assert slot["vr"].shape == p.shape[:-1] and slot["vc"].shape == p.shape[1:]
    small = state.opt_state["slots"]["layers.0.ln1_w"]
    assert set(small) == {"v"} and tuple(small["v"].placements) == tuple(
        state.params["layers.0.ln1_w"].placements)


def _flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return out, fc.get_total_flops()


def test_kernels_run_shape_only_under_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.kernels import fake, ops
    from repro_torch.kernels.ssd import CHUNK

    b, s, h, kvh, d = 2, 256, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, s, h, d, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(b, s, kvh, d, dtype=torch.bfloat16, requires_grad=True)
        v = torch.empty(b, s, kvh, d, dtype=torch.bfloat16, requires_grad=True)
        out, fl = _flops(lambda: ops.flash_attention(q, k, v, causal=True, q_offset=128))
        assert isinstance(out, FakeTensor) and out.shape == q.shape and out.dtype == q.dtype
        pairs = fake.flash_pairs(s, s, True, None, 128)
        assert fl == 4 * d * b * h * pairs
        _, fl = _flops(lambda: out.float().sum().backward())
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        assert fl >= 10 * d * b * h * pairs

        t, w = 64, 32
        xs = [torch.empty(b, t, w, requires_grad=True) for _ in range(3)]
        a_param = torch.empty(w, requires_grad=True)
        (y, h_last), fl = _flops(lambda: ops.rglru_scan(xs[0], a_param, xs[1], xs[2]))
        assert y.shape == (b, t, w) and h_last.shape == (b, w) and fl >= 2 * b * t * w

        hh, p, g, n = 4, 16, 1, 16
        x = torch.empty(b, t, hh, p, requires_grad=True)
        dt = torch.empty(b, t, hh, requires_grad=True)
        a_log = torch.empty(hh, requires_grad=True)
        bm = torch.empty(b, t, g, n, requires_grad=True)
        cm = torch.empty(b, t, g, n, requires_grad=True)
        (y, h_last), fl = _flops(lambda: ops.ssd_chunked(x, dt, a_log, bm, cm))
        cb, rest = fake.ssd_operations(t, p, n, CHUNK)
        assert y.shape == x.shape and h_last.shape == (b, hh, p, n)
        assert fl == b * g * cb + b * hh * rest
        _, fl = _flops(lambda: y.sum().backward())
        cb, rest = fake.ssd_bwd_operations(t, p, n, CHUNK)
        assert fl >= b * g * cb + b * hh * rest
        assert x.grad.shape == x.shape and bm.grad.shape == bm.shape and a_log.grad.shape == (hh,)
