"""Model step graph -> HDATS MDFG extraction.

Two planner problems are materialized as paper-form Instances:

1. **Residency** (`residency_instance`): the training step on one device.
   Tasks = per-group forward ops then reverse-order backward ops (chain
   precedence, the autodiff DAG).  Data blocks = named activation classes per
   group, produced by the fwd task, consumed by the matching bwd task.
   Processors = {compute core, DMA engine} — heterogeneous: bwd tasks only run
   on the core, offload traffic prices via the DMA "memory access" times.
   Memories = {HBM (capacity = post-params budget), host (∞, slow),
   remat (∞, access cost = recompute time amortized per byte)}.

2. **Pipeline** (`pipeline_instance`): layers as tasks on `n_stages`
   heterogeneous processors (per-stage speed factors, e.g. measured straggler
   slowdowns), chain precedence, activations as inter-stage data blocks.

The paper's algorithms (greedy / TS / LB) run on these unchanged.  The
device's constants come in as ``hw`` (``cost.H100`` by default, ``cost.TPU_V5E``
gives the reference's instances).
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig, ShapeCell
from ..core.mdfg import Instance, _csr
from .cost import H100, Hardware, LayerCost, hbm_activation_budget, layer_costs

__all__ = ["residency_instance", "pipeline_instance", "contiguous_stage_map", "ACT_CLASSES"]

ACT_CLASSES = (
    "resid_out", "resid_mid", "attn_q", "attn_kv", "attn_out",
    "mlp_hidden", "moe_hidden", "rec_out", "ssm_out",
)

# memory tier indices in the residency instance
MEM_HBM, MEM_HOST, MEM_REMAT = 0, 1, 2


def _build_instance(n_tasks, n_data, task_edges, producer, cons_pairs, out_pairs,
                    proc_time, data_size, mem_cap, access_time, mem_level,
                    data_mem_ok, name) -> Instance:
    cons_arr = np.asarray(cons_pairs, dtype=np.int64).reshape(-1, 2)
    out_arr = np.asarray(out_pairs, dtype=np.int64).reshape(-1, 2)
    cons_indptr, cons_idx = _csr(n_data, cons_arr)
    in_indptr, in_idx = _csr(n_tasks, cons_arr[:, ::-1])
    out_indptr, out_idx = _csr(n_tasks, out_arr)
    return Instance(
        n_tasks=n_tasks, n_data=n_data,
        task_edges=np.asarray(task_edges, dtype=np.int64).reshape(-1, 2),
        producer=producer, cons_indptr=cons_indptr, cons_idx=cons_idx,
        in_indptr=in_indptr, in_idx=in_idx, out_indptr=out_indptr, out_idx=out_idx,
        proc_time=proc_time, data_size=data_size, mem_cap=mem_cap,
        access_time=access_time, mem_level=mem_level, data_mem_ok=data_mem_ok,
        name=name,
    )


def residency_instance(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    scan_group: int,
    n_data_shards: int = 16,
    n_model_shards: int = 16,
    n_devices: int = 256,
    optimizer: str = "adafactor",
    time_unit: float = 1e-3,     # instance time units = ms
    hw: Hardware = H100,
) -> tuple[Instance, dict]:
    """Training-step residency MDFG (per device), grouped by scan_group."""
    lcs = layer_costs(cfg, cell, n_data_shards=n_data_shards, n_model_shards=n_model_shards,
                      hw=hw)
    L = len(lcs)
    g = scan_group
    n_groups = (L + g - 1) // g
    groups: list[list[LayerCost]] = [lcs[i * g : (i + 1) * g] for i in range(n_groups)]

    # tasks: fwd_0..fwd_{G-1}, bwd_{G-1}..bwd_0  (chain)
    n_tasks = 2 * n_groups
    fwd = lambda i: i
    bwd = lambda i: 2 * n_groups - 1 - i     # bwd of group i
    task_edges = [(t, t + 1) for t in range(n_tasks - 1)]

    # processors: [core, dma]; fwd/bwd run on core only (dma engine exists to
    # price offload concurrency in the schedule; tasks stay on the core)
    proc_time = np.full((n_tasks, 2), np.inf)
    for i, grp in enumerate(groups):
        tf = sum(lc.time_fwd for lc in grp) / time_unit
        tb = sum(lc.time_bwd for lc in grp) / time_unit
        proc_time[fwd(i), 0] = tf
        proc_time[bwd(i), 0] = tb

    # data blocks: one per (group, activation class) with nonzero bytes
    data_size = []
    producer = []
    cons_pairs = []
    out_pairs = []
    block_meta: list[tuple[int, str]] = []
    for i, grp in enumerate(groups):
        class_bytes: dict[str, float] = {}
        for lc in grp:
            for name, b in lc.act_bytes.items():
                class_bytes[name] = class_bytes.get(name, 0.0) + b
        for name, b in class_bytes.items():
            if b <= 0:
                continue
            d_id = len(data_size)
            data_size.append(b)
            producer.append(fwd(i))
            out_pairs.append((fwd(i), d_id))
            cons_pairs.append((d_id, bwd(i)))
            block_meta.append((i, name))
    n_data = len(data_size)
    data_size = np.asarray(data_size, dtype=np.float64)
    producer = np.asarray(producer, dtype=np.int64)

    budget = hbm_activation_budget(cfg, n_devices=n_devices, optimizer=optimizer, hw=hw)
    mem_cap = np.array([budget, np.inf, np.inf])
    # access time per byte (in time units):
    #   HBM: 1/hbm_bw        host: 1/host_bw
    #   remat: recompute cost amortized per byte — group fwd time / group act bytes
    total_act = float(data_size.sum())
    total_fwd = sum(lc.time_fwd for lc in lcs)
    remat_per_byte = (total_fwd / max(total_act, 1.0)) / time_unit
    access_time = np.array([
        [1.0 / hw.hbm_bw / time_unit, 1.0 / hw.host_bw / time_unit, remat_per_byte],
        [1.0 / hw.hbm_bw / time_unit, 1.0 / hw.host_bw / time_unit, remat_per_byte],
    ])  # rows: (core, dma) × cols: (HBM, host, remat)
    mem_level = np.array([0, 1, 2])
    data_mem_ok = np.ones((n_data, 3), dtype=bool)

    inst = _build_instance(
        n_tasks, n_data, task_edges, producer, cons_pairs, out_pairs,
        proc_time, data_size, mem_cap, access_time, mem_level, data_mem_ok,
        name=f"residency[{cfg.arch_id}:{cell.name}:g{scan_group}]",
    )
    meta = {
        "block_meta": block_meta,
        "n_groups": n_groups,
        "budget": budget,
        "time_unit": time_unit,
        "total_fwd_time": total_fwd,
    }
    return inst, meta


def contiguous_stage_map(costs: np.ndarray, speeds: np.ndarray, n_stages: int) -> np.ndarray:
    """Contiguous layer partition minimizing the bottleneck stage time
    (costs × per-stage speed), via DP.  speeds > 1 ⇒ slower stage."""
    L = len(costs)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    INF = float("inf")
    best = np.full((n_stages + 1, L + 1), INF)
    cut = np.zeros((n_stages + 1, L + 1), dtype=int)
    best[0, 0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(s, L - (n_stages - s) + 1):
            for i in range(s - 1, j):
                cost = (prefix[j] - prefix[i]) * speeds[s - 1]
                val = max(best[s - 1, i], cost)
                if val < best[s, j]:
                    best[s, j] = val
                    cut[s, j] = i
    stage_map = np.zeros(L, dtype=int)
    j = L
    for s in range(n_stages, 0, -1):
        i = cut[s, j]
        stage_map[i:j] = s - 1
        j = i
    return stage_map


def pipeline_instance(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    n_stages: int = 4,
    n_microbatches: int = 8,
    stage_speed: np.ndarray | None = None,   # >1 = slower (straggler feedback)
    stage_map: np.ndarray | None = None,
    n_data_shards: int = 16,
    n_model_shards: int = 16,
    stage_hbm_frac: float = 0.35,
    time_unit: float = 1e-3,
    hw: Hardware = H100,
) -> tuple[Instance, dict]:
    """Pipeline schedule MDFG: tasks = (stage × microbatch) fwd + bwd cells.

    Precedence per microbatch: fwd(0)→…→fwd(S−1)→bwd(S−1)→…→bwd(0).
    Each stage is one processor (tasks are stage-bound: the weights live
    there), so the tabu search's N7 neighborhood optimizes the *microbatch
    order* per stage — the degrees of freedom that separate GPipe from 1F1B.
    Stashed activations (fwd(s,m) → bwd(s,m)) are data blocks bound to the
    stage-local HBM tier (capacity-limited) or host (∞): exactly the paper's
    per-memory capacity constraints."""
    lcs = layer_costs(cfg, cell, n_data_shards=n_data_shards, n_model_shards=n_model_shards,
                      hw=hw)
    speed = np.ones(n_stages) if stage_speed is None else np.asarray(stage_speed, float)
    costs = np.array([lc.time_fwd for lc in lcs])
    if stage_map is None:
        stage_map = contiguous_stage_map(costs, speed, n_stages)
    S, M = n_stages, n_microbatches
    stage_fwd = np.array([costs[stage_map == s].sum() for s in range(S)]) * speed / M
    stage_act = np.array(
        [sum(sum(lc.act_bytes.values()) for i, lc in enumerate(lcs) if stage_map[i] == s)
         for s in range(S)]
    ) / M

    # tasks: fwd(s,m) = m*2S + s ; bwd(s,m) = m*2S + (2S-1-s)
    n_tasks = 2 * S * M
    fwd = lambda s, m: m * 2 * S + s
    bwd = lambda s, m: m * 2 * S + (2 * S - 1 - s)
    task_edges = []
    for m in range(M):
        for t in range(2 * S - 1):
            task_edges.append((m * 2 * S + t, m * 2 * S + t + 1))

    proc_time = np.full((n_tasks, S), np.inf)
    for m in range(M):
        for s in range(S):
            proc_time[fwd(s, m), s] = stage_fwd[s] / time_unit
            proc_time[bwd(s, m), s] = 2.0 * stage_fwd[s] / time_unit

    # stashed activations: block per (s, m), HBM_s or host
    data_size, producer, cons_pairs, out_pairs = [], [], [], []
    block_meta = []
    for m in range(M):
        for s in range(S):
            d_id = len(data_size)
            data_size.append(stage_act[s])
            producer.append(fwd(s, m))
            out_pairs.append((fwd(s, m), d_id))
            cons_pairs.append((d_id, bwd(s, m)))
            block_meta.append((s, m))
    n_data = len(data_size)

    mem_cap = np.concatenate([np.full(S, hw.hbm_bytes * stage_hbm_frac), [np.inf]])
    access_time = np.empty((S, S + 1))
    access_time[:, :S] = 1.0 / hw.hbm_bw / time_unit
    access_time[:, S] = 1.0 / hw.host_bw / time_unit
    mem_level = np.arange(S + 1)
    data_mem_ok = np.zeros((n_data, S + 1), dtype=bool)
    for d_id, (s, m) in enumerate(block_meta):
        data_mem_ok[d_id, s] = True      # stage-local HBM only
        data_mem_ok[d_id, S] = True      # host fallback

    inst = _build_instance(
        n_tasks, n_data, task_edges,
        np.asarray(producer, dtype=np.int64), cons_pairs, out_pairs,
        proc_time, np.asarray(data_size, dtype=np.float64),
        mem_cap, access_time, mem_level, data_mem_ok,
        name=f"pipeline[{cfg.arch_id}:{cell.name}:s{n_stages}x{n_microbatches}]",
    )
    meta = {
        "n_stages": S, "n_microbatches": M, "time_unit": time_unit,
        "stage_map": stage_map, "stage_fwd": stage_fwd, "block_meta": block_meta,
    }
    return inst, meta
