"""The port's multi-device layer (``repro_torch.sharding``, ``launch.mesh``,
``launch.specs``, ``launch.dryrun``, ``runtime.pipeline``) against the
reference's four distributed tests (``tests/test_distributed.py``), on the
CPU: the port's ranks are gloo subprocesses, the reference's multi-device
side runs with 8 host devices in a subprocess.

* The sharded train step: qwen2.5-14b's smoke config, batch 8 x 32, the
  reference's parameters carried over by ``convert``; DTensor parameters on
  a 4 x 2 ("data", "model") mesh under heads-TP, and on 1 x 8, where the 4
  heads do not divide "model" and K2 (its plain version here) runs on each
  rank's q rows with ``q_offset``.  The loss within 1e-3 of the reference's
  single-device loss (the reference's own tolerance), the global gradient
  norm within 1e-3 relative.
* The sequence-sharded decode: llama3-405b's smoke config on 1 x 8, the KV
  cache sharded along its sequence over "model", 16 steps: within 2e-3 (of
  max |logit|) of the port's full forward and of the reference's decode.
* The pipeline: 4 stages on a ("stage", "data") 4 x 2 mesh, the reference
  test's W and x drawn from a NumPy seed: outputs within 1e-5 of the
  reference's ``pipeline_apply``, gradients within 1e-4.
* The dry run: granite-moe-1b-a400m (two layers) at the reference test's
  cells ``t`` (train, 64 x 8) and ``d`` (decode, 128 x 8) on 4 x 2 and
  2 x 2 x 2 return ``status: ok``, and their argument bytes equal the sum
  of the reference's ``ShapeDtypeStruct`` shard bytes, byte for byte.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from torch_dist_helpers import REPO, _env, _result, run_ranks, run_reference

from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_cache_defs as ref_arch_cache_defs
from repro.models import arch_decode_step as ref_arch_decode_step
from repro.models import arch_init_params as ref_arch_init_params
from repro.models.common import init_tree as ref_init_tree
from repro.runtime import SyntheticLM as RefSyntheticLM
from repro.runtime import TrainState as RefTrainState
from repro.runtime import adamw as ref_adamw
from repro.runtime import make_train_step as ref_make_train_step

from repro_torch import convert

LOSS_TOL, NORM_TOL, DECODE_TOL, PP_TOL, PP_GRAD_TOL = 1e-3, 1e-3, 2e-3, 1e-5, 1e-4

_REF = """
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.runtime.pipeline import pipeline_apply
from repro.configs.base import ShapeCell
from repro.configs.registry import get_config
from repro.launch.specs import (arch_rules, cache_specs, input_specs, param_specs,
                                train_state_specs)

n_stages, lps, d = 4, 2, 16
rng = np.random.default_rng(0)
W = jnp.asarray((rng.standard_normal((n_stages, lps, d, d)) / np.sqrt(d)).astype(np.float32))
x = jnp.asarray(rng.standard_normal((6, 4, d)).astype(np.float32))

def stage_fn(p, xx):
    for i in range(lps):
        xx = jnp.tanh(xx @ p[i])
    return xx

# Auto axes: the sharding-in-types default of this JAX refuses the
# reference's indexing of the shard_map's stage-sharded result
mesh = jax.make_mesh((4, 2), ("stage", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
with mesh:
    out = pipeline_apply(mesh, W, x, stage_fn)
def loss(W):
    with mesh:
        return (pipeline_apply(mesh, W, x, stage_fn) ** 2).sum()
grad = jax.grad(loss)(W)

def shard_bytes(tree):
    return int(sum(np.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
                   for l in jax.tree.leaves(tree)))

cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
args = {}
for mesh_shape, axes in (((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    m = jax.make_mesh(mesh_shape, axes)
    for cell in (ShapeCell("t", 64, 8, "train"), ShapeCell("d", 128, 8, "decode")):
        rules = arch_rules(cfg, cell, m)
        batch = input_specs(cfg, cell, m, rules)
        if cell.kind == "train":
            state, _ = train_state_specs(cfg, m, rules)
            n = shard_bytes(state) + shard_bytes(batch)
        else:
            _, p, _ = param_specs(cfg, m, rules)
            c, _ = cache_specs(cfg, cell, m, rules)
            n = shard_bytes(p) + shard_bytes(c) + shard_bytes(batch)
        args["x".join(map(str, mesh_shape)) + "/" + cell.name] = n
result({"out": np.asarray(out).tolist(), "grad": np.asarray(grad).tolist(), "args": args})
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(_REF)


def _save_params(path, cfg, params) -> str:
    sd = convert.model_params_from_arrays(cfg, jax.tree.map(np.asarray, params))
    torch.save(sd, path)
    return str(path)


_TRAIN = """
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Decoder, distribute_params
from repro_torch.runtime import TrainState, SyntheticLM, adamw, make_train_step
from repro_torch.sharding import make_rules, set_mesh

cfg = get_smoke_config("qwen2.5-14b")
shape = tuple(json.loads(os.environ["MESH"]))
mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
rules = make_rules(shard_heads=cfg.n_heads % shape[1] == 0,
                   qseq_tp=cfg.n_heads % shape[1] != 0, batch_axes=("data",))
set_mesh(mesh)
model = Decoder(cfg, device="cpu", master=True)
model.load_state_dict(torch.load(os.environ["PARAMS"]))
distribute_params(model, mesh, rules)
params = dict(model.named_parameters())
opt = adamw(lr=1e-2)
batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(cfg, batch=8, seq_len=32,
                                                       seed=0).batch_at(0).items()}
_, m = make_train_step(cfg, opt, model, rules=rules)(
    TrainState(params=params, opt_state=opt.init(params), step=0), batch)
result({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "q_placements": str(params["layers.0.attn.wq"].placements)})
"""


@pytest.mark.parametrize("mesh, tp", [((4, 2), "heads"), ((1, 8), "q-sequence")])
def test_sharded_train_step_matches_the_reference(tmp_path, mesh, tp):
    cfg = ref_get_smoke_config("qwen2.5-14b")
    params = ref_arch_init_params(cfg, jax.random.PRNGKey(0))
    opt = ref_adamw(lr=1e-2)
    batch = {k: jnp.asarray(v) for k, v in
             RefSyntheticLM(cfg, batch=8, seq_len=32, seed=0).batch_at(0).items()}
    st = RefTrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0))
    _, m0 = jax.jit(ref_make_train_step(cfg, opt))(st, batch)
    got = run_ranks(_TRAIN, world=8, PARAMS=_save_params(tmp_path / "p.pt", cfg, params),
                    MESH=json.dumps(mesh))
    assert (cfg.n_heads % mesh[1] == 0) == (tp == "heads")
    assert abs(got["loss"] - float(m0["loss"])) < LOSS_TOL, (got, float(m0["loss"]))
    gn = float(m0["grad_norm"])
    assert abs(got["grad_norm"] - gn) / gn < NORM_TOL, (got, gn)


_DECODE = """
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Decoder, arch_decode_step, arch_forward, arch_init_cache
from repro_torch.sharding import make_rules, set_mesh
from repro_torch.sharding.partitioning import is_dtensor

cfg = get_smoke_config("llama3-405b")
model = Decoder(cfg, device="cpu")
model.load_state_dict(torch.load(os.environ["PARAMS"]))
tokens = torch.as_tensor(np.load(os.environ["TOKENS"]))
want = torch.as_tensor(np.load(os.environ["REF_LOGITS"]))
b, s = tokens.shape
with torch.no_grad():
    full = arch_forward(cfg, model, {"tokens": tokens})
mesh = make_mesh((1, 8), ("data", "model"), device_type="cpu")
rules = make_rules(shard_heads=False, batch_axes=())
set_mesh(mesh)
cache = arch_init_cache(cfg, b, 32, device="cpu")
worst_full = worst_ref = 0.0
with torch.no_grad():
    for t in range(s):
        lg, cache = arch_decode_step(cfg, model, cache, tokens[:, t:t + 1], t, rules=rules)
        worst_full = max(worst_full, float((lg - full[:, t]).abs().max()))
        worst_ref = max(worst_ref, float((lg - want[t]).abs().max()))
scale = float(full.abs().max())
result({"vs_full": worst_full / scale, "vs_ref": worst_ref / scale,
        "sharded": all(is_dtensor(c["k"]) and str(c["k"].placements) ==
                       "(Replicate(), Shard(dim=1))" for c in cache)})
"""


def test_sequence_sharded_decode_matches_the_full_forward_and_the_reference(tmp_path):
    cfg = ref_get_smoke_config("llama3-405b")
    params = ref_arch_init_params(cfg, jax.random.PRNGKey(0))
    b, s = 2, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    cache = ref_init_tree(ref_arch_cache_defs(cfg, b, max_len=32), jax.random.PRNGKey(0))
    logits = []
    for t in range(s):
        lg, cache = ref_arch_decode_step(cfg, params, cache, jnp.asarray(tokens[:, t:t + 1]),
                                         jnp.int32(t))
        logits.append(np.asarray(lg))
    np.save(tmp_path / "tok.npy", tokens)
    np.save(tmp_path / "ref.npy", np.stack(logits))
    got = run_ranks(_DECODE, world=8, PARAMS=_save_params(tmp_path / "p.pt", cfg, params),
                    TOKENS=tmp_path / "tok.npy", REF_LOGITS=tmp_path / "ref.npy")
    assert got["sharded"], got
    assert got["vs_full"] < DECODE_TOL and got["vs_ref"] < DECODE_TOL, got


_PIPELINE = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.pipeline import pipeline_apply

n_stages, lps, d = 4, 2, 16
rng = np.random.default_rng(0)
W = torch.tensor((rng.standard_normal((n_stages, lps, d, d)) / np.sqrt(d)).astype(np.float32),
                 requires_grad=True)
x = torch.tensor(rng.standard_normal((6, 4, d)).astype(np.float32))

def stage_fn(p, xx):
    for i in range(lps):
        xx = torch.tanh(xx @ p[i])
    return xx

mesh = make_mesh((4, 2), ("stage", "data"), device_type="cpu")
out = pipeline_apply(mesh, W, x, stage_fn)
(out ** 2).sum().backward()
result({"out": out.detach().tolist(), "grad": W.grad.tolist()})
"""


def test_pipeline_executor_matches_the_reference(ref):
    got = run_ranks(_PIPELINE, world=8)
    assert np.max(np.abs(np.array(got["out"]) - np.array(ref["out"]))) < PP_TOL
    assert np.max(np.abs(np.array(got["grad"]) - np.array(ref["grad"]))) < PP_GRAD_TOL


_DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as dr

dr.CELLS["t"] = ShapeCell("t", 64, 8, "train")
dr.CELLS["d"] = ShapeCell("d", 128, 8, "decode")
cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
shape = tuple(json.loads(sys.argv[1]))
out = {}
for cell in ("t", "d"):
    rec = dr.run_cell("granite-moe-1b-a400m", cell, multi_pod=len(shape) == 3,
                      mesh_shape=shape, out_dir=sys.argv[2], force=True, cfg_override=cfg)
    out[cell] = {k: rec.get(k) for k in ("status", "error", "memory_analysis",
                                         "cost_analysis", "collectives", "n_devices")}
print("RESULT " + json.dumps(out))
"""


@pytest.mark.parametrize("mesh", [(4, 2), (2, 2, 2)])
def test_dry_run_cells_are_ok_with_the_references_argument_bytes(ref, tmp_path, mesh):
    run = subprocess.run([sys.executable, "-c", _DRYRUN, json.dumps(mesh), str(tmp_path)],
                         capture_output=True, text=True, env=_env(), timeout=240, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    got = _result(run.stdout)
    for cell, rec in got.items():
        assert rec["status"] == "ok", rec["error"]
        assert rec["n_devices"] == int(np.prod(mesh))
        key = "x".join(map(str, mesh)) + "/" + cell
        assert rec["memory_analysis"]["argument_size_in_bytes"] == ref["args"][key], (cell, rec)
        assert rec["cost_analysis"]["flops"] > 0 and rec["memory_analysis"]["peak_bytes"] > 0
    # the train step gathers the FSDP-sharded weights and reduce-scatters their gradients
    counts = got["t"]["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] + counts["all-reduce"] > 0
