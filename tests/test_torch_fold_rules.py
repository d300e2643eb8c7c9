"""The port's sharded paths under torch 2.11's view rule, emulated here
(``torch_dist_helpers.strict_fold``): a view that flattens a dim sharded on
some mesh dim into a dim before it raises, where torch 2.13 tracks the
folded dim as a ``_StridedShard``.  No view of the port's train steps and
dry runs folds a sharded dim, forward or backward, so they mean the same on
both torch versions:

* the guard itself: ``x @ w`` over a (B, S, E) DTensor with ``Shard(1)``
  raises under it, and runs without it; ``sharding.partitioning.matmul``
  runs under it and equals the plain product;
* the sharded train step of qwen2.5-14b's smoke config under q-sequence TP
  (1 x 8: its 4 heads do not divide "model") and under heads-TP (4 x 2):
  the loss within 1e-3 of the reference's single-device loss, the global
  gradient norm within 1e-3 relative (``tests/test_torch_distributed.py``'s
  gates and rank script);
* the dry run of granite-moe-1b-a400m (two layers) at the cells ``t``
  (train, 64 x 8) and ``d`` (decode, 128 x 8) on 4 x 2 and 2 x 2 x 2:
  status ok, argument bytes equal to the reference's; the MoE's dispatch
  hands the router logits' gradient back split along the sequence;
* a two-layer qwen2.5-14b train cell on a fake 2 x 16 mesh (16 does not
  divide its 40 heads: q-sequence TP) is ok.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from test_torch_distributed import _DRYRUN, _REF, _TRAIN, LOSS_TOL, NORM_TOL, _save_params
from torch_dist_helpers import (FOLD_ERROR, REPO, STRICT_FOLD_PRELUDE, _env, _result,
                                run_ranks, run_reference)

from repro.configs.registry import get_smoke_config as ref_get_smoke_config
from repro.models import arch_init_params as ref_arch_init_params
from repro.runtime import SyntheticLM as RefSyntheticLM
from repro.runtime import TrainState as RefTrainState
from repro.runtime import adamw as ref_adamw
from repro.runtime import make_train_step as ref_make_train_step

_GUARD = """
import torch_dist_helpers
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.partitioning import matmul

mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
rng = np.random.default_rng(0)
x_full = torch.tensor(rng.standard_normal((4, 8, 16)).astype(np.float32))
w_full = torch.tensor(rng.standard_normal((16, 12)).astype(np.float32))
x = distribute_tensor(x_full, mesh, [Replicate(), Shard(1)])
w = distribute_tensor(w_full, mesh, [Replicate(), Replicate()])
out = {"free": str((x @ w).placements)}
with torch_dist_helpers.strict_fold():
    try:
        x @ w
        out["strict"] = "ran"
    except RuntimeError as e:
        out["strict"] = str(e)
    y = matmul(x, w)
out["matmul"] = str(y.placements)
out["err"] = float((y.full_tensor() - x_full @ w_full).abs().max())
result(out)
"""


def test_the_emulated_rule_refuses_a_product_over_split_rows():
    got = run_ranks("import sys; sys.path.insert(0, %r)\n" % (REPO + "/tests") + _GUARD,
                    world=2)
    assert got["free"] == "(Replicate(), Shard(dim=1))"       # torch 2.13 takes the fold
    assert got["strict"].startswith(FOLD_ERROR + " 1 being sharded"), got
    assert got["matmul"] == "(Replicate(), Shard(dim=1))" and got["err"] < 1e-5, got


@pytest.fixture(scope="module")
def reference_step(tmp_path_factory):
    """The reference's single-device train step on qwen2.5-14b's smoke config
    (its loss and gradient norm) and its parameters saved for the ranks."""
    cfg = ref_get_smoke_config("qwen2.5-14b")
    params = ref_arch_init_params(cfg, jax.random.PRNGKey(0))
    opt = ref_adamw(lr=1e-2)
    batch = {k: jnp.asarray(v) for k, v in
             RefSyntheticLM(cfg, batch=8, seq_len=32, seed=0).batch_at(0).items()}
    st = RefTrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0))
    _, m0 = jax.jit(ref_make_train_step(cfg, opt))(st, batch)
    path = _save_params(tmp_path_factory.mktemp("fold") / "p.pt", cfg, params)
    return float(m0["loss"]), float(m0["grad_norm"]), path, cfg.n_heads


@pytest.mark.parametrize("mesh, tp", [((1, 8), "q-sequence"), ((4, 2), "heads")])
def test_sharded_train_step_under_the_strict_rule_matches_the_reference(reference_step,
                                                                        mesh, tp):
    loss, norm, path, heads = reference_step
    assert (heads % mesh[1] == 0) == (tp == "heads")
    got = run_ranks(_TRAIN, world=8, strict_fold=1, PARAMS=path, MESH=json.dumps(mesh))
    assert abs(got["loss"] - loss) < LOSS_TOL, (got, loss)
    assert abs(got["grad_norm"] - norm) / norm < NORM_TOL, (got, norm)


@pytest.fixture(scope="module")
def ref_args():
    return run_reference(_REF)["args"]


def _dry_run(script: str, *argv) -> dict:
    run = subprocess.run([sys.executable, "-c", STRICT_FOLD_PRELUDE + script, *argv],
                         capture_output=True, text=True, env=_env(), timeout=240, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    return _result(run.stdout)


@pytest.mark.parametrize("mesh", [(4, 2), (2, 2, 2)])
def test_granite_dry_run_cells_under_the_strict_rule(ref_args, tmp_path, mesh):
    got = _dry_run(_DRYRUN, json.dumps(mesh), str(tmp_path))
    for cell, rec in got.items():
        assert rec["status"] == "ok", rec["error"]
        key = "x".join(map(str, mesh)) + "/" + cell
        assert rec["memory_analysis"]["argument_size_in_bytes"] == ref_args[key], (cell, rec)


_QWEN_DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.specs import arch_rules

cell = dr.CELLS["t"] = ShapeCell("t", 64, 8, "train")
cfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=2)
rec = dr.run_cell("qwen2.5-14b", "t", multi_pod=False, mesh_shape=(2, 16), out_dir=sys.argv[1],
                  force=True, cfg_override=cfg)
mesh = type("M", (), {"mesh_dim_names": ("data", "model"), "shape": (2, 16)})
print("RESULT " + json.dumps({"seq": arch_rules(cfg, cell, mesh).acts["seq"],
                              **{k: rec.get(k) for k in ("status", "error", "cost_analysis",
                                                         "memory_analysis", "n_devices")}}))
"""


def test_qwen_train_cell_under_q_sequence_tp_on_2x16_is_ok(tmp_path):
    got = _dry_run(_QWEN_DRYRUN, str(tmp_path))
    assert got["seq"] == "model"                       # 16 does not divide 40 heads
    assert got["status"] == "ok", got["error"]
    assert got["n_devices"] == 32 and got["cost_analysis"]["flops"] > 0
    assert got["memory_analysis"]["peak_bytes"] > got["memory_analysis"][
        "argument_size_in_bytes"] > 0
