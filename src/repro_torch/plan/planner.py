"""The HDATS planner — the paper's algorithms driving the port's training
forward.

``plan_residency`` runs greedy + tabu search over the residency MDFG for a
menu of scan-group sizes and projects the winning data allocation onto the
three residency classes (keep / offload / remat per named activation class),
returning a ``ResidencyPlan`` whose ``policy()`` is the port's lowering of it
(``models.remat.Residency``, the counterpart of the reference's
``jax.checkpoint`` policy) and whose ``scan_group`` feeds the grouped
forward.  The solves run through the port's ``core.solve``: the tabu search's
exact evaluations on ``torch_device`` (the schedule-DP kernel on the card by
default), the greedy construction on the host.  ``plan_pipeline`` maps layers onto heterogeneous pipeline stages.
``plan_residency_lb`` is the paper's load-balancing baseline on the same
instance (the comparison surfaces in benchmarks/planner_tpu.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ModelConfig, ShapeCell
from ..core import TSParams, solve
from .cost import H100, Hardware
from .extract import MEM_HBM, MEM_HOST, MEM_REMAT, pipeline_instance, residency_instance

__all__ = ["ResidencyPlan", "plan_residency", "plan_residency_lb", "plan_pipeline"]


@dataclasses.dataclass
class ResidencyPlan:
    arch_id: str
    cell: str
    scan_group: int
    save_names: tuple[str, ...]      # keep in HBM
    offload_names: tuple[str, ...]   # host offload
    est_step_time: float             # planner makespan (s)
    hbm_budget: float
    planner: str = "tabu"

    def policy(self):
        """The plan lowered for the training forward: a
        ``models.remat.Residency`` (kept classes stay on the card, offloaded
        ones go to pinned host memory, the rest are recomputed), or None when
        the plan keeps and offloads nothing (save nothing beyond the period
        and group carries, as the reference's ``None`` policy)."""
        from ..models.remat import Residency

        if self.save_names or self.offload_names:
            return Residency(self.save_names, self.offload_names)
        return None


def _project_plan(inst, meta, sol, makespan_ms, cfg, cell, g, planner) -> ResidencyPlan:
    """Majority-vote the per-(group, class) allocation down to class level
    (the JAX policy is class-global across the scanned groups)."""
    votes: dict[str, np.ndarray] = {}
    for d, (grp, name) in enumerate(meta["block_meta"]):
        votes.setdefault(name, np.zeros(3))
        votes[name][sol.mem[d]] += inst.data_size[d]
    save, offload = [], []
    for name, v in votes.items():
        tier = int(np.argmax(v))
        if tier == MEM_HBM:
            save.append(name)
        elif tier == MEM_HOST:
            offload.append(name)
        # MEM_REMAT -> neither (recomputed)
    return ResidencyPlan(
        arch_id=cfg.arch_id,
        cell=cell.name,
        scan_group=g,
        save_names=tuple(sorted(save)),
        offload_names=tuple(sorted(offload)),
        est_step_time=makespan_ms * meta["time_unit"],
        hbm_budget=meta["budget"],
        planner=planner,
    )


def _group_menu(cfg: ModelConfig) -> list[int]:
    L = cfg.n_layers
    menu = sorted({g for g in (1, 2, 3, 4, 6, 7, 8, 9, 12, 14, 16) if L % g == 0})
    return menu or [1]


def plan_residency(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    n_devices: int = 256,
    n_data_shards: int = 16,
    n_model_shards: int = 16,
    optimizer: str = "adafactor",
    ts_params: TSParams | None = None,
    use_tabu: bool = True,
    hw: Hardware = H100,
    torch_device: str | None = None,
) -> ResidencyPlan:
    """``hw``: the device's constants; ``torch_device``: where the tabu
    search's exact evaluations run (``ts_params.torch_device`` by default,
    ``"cuda"``; ``ts_params.backend`` picks the engine)."""
    ts_params = ts_params or TSParams(max_unimproved=60, time_limit=10.0, top_k=6)
    best: ResidencyPlan | None = None
    for g in _group_menu(cfg):
        inst, meta = residency_instance(
            cfg, cell, scan_group=g, n_devices=n_devices,
            n_data_shards=n_data_shards, n_model_shards=n_model_shards,
            optimizer=optimizer, hw=hw,
        )
        if use_tabu and inst.n_tasks > 2:
            res = solve(inst, "tabu", params=ts_params, init="slack_first",
                        torch_device=torch_device)
        else:
            res = solve(inst, "greedy:slack_first", refine_memory=True)
        sol, mk = res.solution, res.makespan
        plan = _project_plan(inst, meta, sol, mk, cfg, cell, g, "tabu" if use_tabu else "greedy")
        if best is None or plan.est_step_time < best.est_step_time:
            best = plan
    assert best is not None
    return best


def plan_residency_lb(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    n_devices: int = 256,
    n_data_shards: int = 16,
    n_model_shards: int = 16,
    optimizer: str = "adafactor",
    hw: Hardware = H100,
) -> ResidencyPlan:
    """Load-balancing baseline (paper §V-C) on the same instance."""
    best: ResidencyPlan | None = None
    for g in _group_menu(cfg):
        inst, meta = residency_instance(
            cfg, cell, scan_group=g, n_devices=n_devices,
            n_data_shards=n_data_shards, n_model_shards=n_model_shards,
            optimizer=optimizer, hw=hw,
        )
        res = solve(inst, "load_balance")
        plan = _project_plan(inst, meta, res.solution, res.makespan, cfg, cell, g, "lb")
        if best is None or plan.est_step_time < best.est_step_time:
            best = plan
    assert best is not None
    return best


def plan_pipeline(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    n_stages: int = 4,
    n_microbatches: int = 8,
    stage_speed: np.ndarray | None = None,
    use_tabu: bool = True,
    ts_params: TSParams | None = None,
    hw: Hardware = H100,
    torch_device: str | None = None,
) -> dict:
    """Pipeline plan: contiguous layer→stage map (bottleneck-min DP over
    heterogeneous stage speeds) + HDATS tabu search over the *microbatch
    schedule* on the (stage × microbatch) MDFG — the search discovers
    1F1B-like orders; the memory tiers decide which stashes offload."""
    inst, meta = pipeline_instance(
        cfg, cell, n_stages=n_stages, n_microbatches=n_microbatches,
        stage_speed=stage_speed, hw=hw,
    )
    lb_res = solve(inst, "load_balance")
    if use_tabu:
        # multi-start tabu: a better init does not imply a better final
        # schedule (the LB basin can trap the search), so run from both the
        # greedy and the LB order and keep the better result
        tp = ts_params or TSParams(max_unimproved=80, time_limit=8.0, top_k=6)
        best_res = None
        for init in ("slack_first", lb_res.solution):
            res = solve(inst, "tabu", params=tp, init=init, torch_device=torch_device)
            if best_res is None or res.makespan < best_res.makespan:
                best_res = res
        sol, mk = best_res.solution, best_res.makespan
    else:
        res = solve(inst, "greedy:slack_first", refine_memory=True)
        sol, mk = res.solution, res.makespan
        if lb_res.makespan < mk:
            sol, mk = lb_res.solution, lb_res.makespan
    # per-stage microbatch order of forward tasks (the schedule artifact)
    S, M = meta["n_stages"], meta["n_microbatches"]
    order = []
    for s in range(S):
        seq = sol.proc_seq[s]
        order.append([t // (2 * S) for t in seq])  # microbatch ids in run order
    n_host = int(sum(1 for d in range(inst.n_data) if sol.mem[d] == inst.n_mems - 1))
    return {
        "stage_of_layer": np.asarray(meta["stage_map"], dtype=int),
        "microbatch_order": order,
        "stash_offloaded": n_host,
        "est_step_time": mk * meta["time_unit"],
        "lb_step_time": lb_res.makespan * meta["time_unit"],
        "n_stages": n_stages,
        "n_microbatches": n_microbatches,
    }
