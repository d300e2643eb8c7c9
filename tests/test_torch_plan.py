"""The port's planner (``repro_torch.plan``) against the reference's
(``repro.plan``): the same MDFG instances at the reference's TPU constants
(``np.array_equal``), the same plans from the greedy, tabu (NumPy engine, no
time limit) and load-balancing solves, the residency / pipeline instance
families, and the reference's behavioural tests of ``tests/test_planner.py``
on the port."""
import dataclasses

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

from repro.configs.base import ShapeCell as RefShapeCell
from repro.configs.registry import get_config as ref_get_config
from repro.core import TSParams as RefTSParams
from repro.instances import suites as ref_suites
from repro.plan import extract as ref_extract
from repro.plan import plan_pipeline as ref_plan_pipeline
from repro.plan import plan_residency as ref_plan_residency
from repro.plan import plan_residency_lb as ref_plan_residency_lb

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell
from repro_torch.core import TSParams, exact_schedule, memory_feasible, solve
from repro_torch.instances import suites
from repro_torch.plan import (
    H100, TPU_V5E, contiguous_stage_map, hbm_activation_budget, layer_costs,
    param_state_bytes, pipeline_instance, plan_pipeline, plan_residency,
    plan_residency_lb, residency_instance,
)
from torch_port_helpers import same_instance

ARCHS = ("llama3-405b", "mamba2-780m", "recurrentgemma-2b")
TRAIN = SHAPE_CELLS[0]
REF_TRAIN = RefShapeCell("train_4k", 4096, 256, "train")
# tabu with no time limit, so both packages stop at the same iteration
NO_LIMIT = dict(max_unimproved=8, time_limit=1e9, top_k=6)


def _same_plan(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_residency_and_pipeline_instances_equal_the_reference(arch):
    for g in (1, 2):
        mine, meta = residency_instance(get_config(arch), TRAIN, scan_group=g, hw=TPU_V5E)
        ref, ref_meta = ref_extract.residency_instance(ref_get_config(arch), REF_TRAIN,
                                                       scan_group=g)
        assert same_instance(mine, ref)
        assert meta["block_meta"] == ref_meta["block_meta"]
        assert meta["budget"] == ref_meta["budget"]
    mine, meta = pipeline_instance(get_config(arch), TRAIN, n_stages=4, n_microbatches=6,
                                   hw=TPU_V5E)
    ref, ref_meta = ref_extract.pipeline_instance(ref_get_config(arch), REF_TRAIN,
                                                  n_stages=4, n_microbatches=6)
    assert same_instance(mine, ref)
    assert np.array_equal(meta["stage_map"], ref_meta["stage_map"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_and_lb_plans_equal_the_reference(arch):
    opt = "adafactor" if arch == "llama3-405b" else "adamw"
    mine = plan_residency(get_config(arch), TRAIN, optimizer=opt, use_tabu=False, hw=TPU_V5E)
    ref = ref_plan_residency(ref_get_config(arch), REF_TRAIN, optimizer=opt, use_tabu=False)
    assert _same_plan(mine, ref)
    mine = plan_residency_lb(get_config(arch), TRAIN, optimizer=opt, hw=TPU_V5E)
    ref = ref_plan_residency_lb(ref_get_config(arch), REF_TRAIN, optimizer=opt)
    assert _same_plan(mine, ref)


def test_tabu_plan_equals_the_reference():
    """The port's tabu search on its NumPy engine with no time limit takes
    the reference's trajectory, so the plans agree field for field (the
    pipeline plan below runs the torch engine on the CPU: the same)."""
    arch = "recurrentgemma-2b"
    mine = plan_residency(get_config(arch), TRAIN, optimizer="adamw", hw=TPU_V5E,
                          ts_params=TSParams(**NO_LIMIT, backend="numpy"))
    ref = ref_plan_residency(ref_get_config(arch), REF_TRAIN, optimizer="adamw",
                             ts_params=RefTSParams(**NO_LIMIT, backend="numpy"))
    assert _same_plan(mine, ref)


def test_pipeline_plan_equals_the_reference():
    arch = "recurrentgemma-2b"
    mine = plan_pipeline(get_config(arch), TRAIN, n_stages=4, n_microbatches=4, hw=TPU_V5E,
                         ts_params=TSParams(**NO_LIMIT), torch_device="cpu")
    ref = ref_plan_pipeline(ref_get_config(arch), REF_TRAIN, n_stages=4, n_microbatches=4,
                            ts_params=RefTSParams(**NO_LIMIT, backend="numpy"))
    assert mine.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(mine[k], ref[k]) if isinstance(ref[k], np.ndarray) \
            else mine[k] == ref[k], k


@pytest.mark.parametrize("name", ["model_derived", "smoke"])
def test_model_derived_families_build_the_reference_instances(name):
    mine, ref = suites.get_suite(name).build(), ref_suites.get_suite(name).build()
    assert [i.family for i in mine] == [i.family for i in ref]
    assert {"residency", "pipeline"} <= {i.family for i in mine}
    for a, b in zip(ref, mine):
        assert a.name == b.name
        assert same_instance(a, b), a.name


def test_h100_constants_are_the_data_sheet_values():
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert TPU_V5E.peak_flops == 197e12 and TPU_V5E.hbm_bytes == 16 * 1024 ** 3
    cfg = get_config("recurrentgemma-2b")
    one = ShapeCell("train_cfg", 4096, 1, "train")
    fast = layer_costs(cfg, one, n_data_shards=1, n_model_shards=1, hw=H100)
    slow = layer_costs(cfg, one, n_data_shards=1, n_model_shards=1, hw=TPU_V5E)
    assert fast[0].time_fwd * 989 == pytest.approx(slow[0].time_fwd * 197)


def test_one_h100_keeps_every_recurrentgemma_class():
    """The launcher's plan for the card: one device, batch 1 x 4096, AdamW.
    The fp32 state leaves ~35 GB of the 80 for activations, which hold every
    class, so the plan keeps them all and the step recomputes nothing."""
    cfg = get_config("recurrentgemma-2b")
    plan = plan_residency(cfg, ShapeCell("train_cfg", 4096, 1, "train"), n_devices=1,
                          n_data_shards=1, n_model_shards=1, optimizer="adamw",
                          use_tabu=False, hw=H100)
    assert set(plan.save_names) == {"attn_kv", "attn_out", "attn_q", "mlp_hidden",
                                    "rec_out", "resid_mid", "resid_out"}
    assert plan.offload_names == () and plan.scan_group == 1
    assert plan.policy().recomputes_nothing(cfg)
    assert 30e9 < plan.hbm_budget < 40e9


# ---- the reference's behavioural tests (tests/test_planner.py), on the port --
def test_layer_costs_scale_with_width():
    cs = layer_costs(get_config("granite-moe-1b-a400m"), TRAIN)
    cb = layer_costs(get_config("qwen2.5-14b"), TRAIN)
    assert sum(c.flops_fwd for c in cb) > 5 * sum(c.flops_fwd for c in cs)
    for c in cs + cb:
        assert c.flops_fwd > 0
        assert all(v >= 0 for v in c.act_bytes.values())


def test_param_state_bytes_optimizer_choice():
    cfg = get_config("llama3-405b")
    assert param_state_bytes(cfg, optimizer="adafactor") < \
        0.6 * param_state_bytes(cfg, optimizer="adamw")
    assert hbm_activation_budget(cfg, optimizer="adamw", hw=TPU_V5E) < \
        hbm_activation_budget(cfg, optimizer="adafactor", hw=TPU_V5E)


def test_residency_instance_is_valid_hdats():
    inst, meta = residency_instance(get_config("mixtral-8x7b"), TRAIN, scan_group=4)
    assert inst.n_tasks == 2 * meta["n_groups"]
    rep = solve(inst, "greedy:slack_first")
    sched = exact_schedule(inst, rep.solution)
    assert sched is not None and memory_feasible(inst, rep.solution, sched)
    assert inst.access_time[0, 2] > inst.access_time[0, 0]


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_plan_beats_or_matches_lb(arch):
    cfg = get_config(arch)
    plan = plan_residency(cfg, TRAIN, optimizer="adamw", hw=TPU_V5E,
                          ts_params=TSParams.fast(), torch_device="cpu")
    lb = plan_residency_lb(cfg, TRAIN, optimizer="adamw", hw=TPU_V5E)
    assert plan.est_step_time <= lb.est_step_time * 1.02
    assert plan.scan_group >= 1 and cfg.n_layers % plan.scan_group == 0


def test_plan_policy_lowers_and_trains():
    """The winning plan's policy runs a training step of the smoke model."""
    import torch

    from repro_torch.models import arch_forward, arch_init_params, cross_entropy_loss

    cfg = get_smoke_config("qwen2.5-14b")
    plan = plan_residency(get_config("qwen2.5-14b"), TRAIN, use_tabu=False, hw=TPU_V5E)
    model = arch_init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                             master=True)
    tokens = torch.zeros((2, 32), dtype=torch.long)
    loss = cross_entropy_loss(cfg, arch_forward(cfg, model, {"tokens": tokens},
                                                remat_policy=plan.policy(), scan_group=2),
                              tokens)
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None for p in model.parameters())


def test_contiguous_stage_map_balances():
    sm = contiguous_stage_map(np.ones(24), np.ones(4), 4)
    assert (np.bincount(sm) == 6).all()
    sm2 = contiguous_stage_map(np.ones(24), np.array([1.0, 1.0, 2.0, 1.0]), 4)
    assert np.bincount(sm2, minlength=4)[2] < 6
    assert (np.diff(sm2) >= 0).all()


def test_pipeline_plan_schedules_all_microbatches():
    cfg = get_config("recurrentgemma-2b")
    out = plan_pipeline(cfg, TRAIN, n_stages=4, n_microbatches=6, use_tabu=False)
    assert len(out["stage_of_layer"]) == cfg.n_layers
    for order in out["microbatch_order"]:
        assert sorted(set(order)) == list(range(6))
        assert len(order) == 12
    assert out["est_step_time"] > 0
    assert np.bincount(out["stage_of_layer"]).sum() == cfg.n_layers


def test_pipeline_tabu_not_worse_than_lb():
    out = plan_pipeline(get_config("granite-moe-1b-a400m"), TRAIN, n_stages=4,
                        n_microbatches=6, ts_params=TSParams.fast(), torch_device="cpu")
    assert out["est_step_time"] <= out["lb_step_time"] * 1.05
