"""Registered workload families.

Every family produces a paper-form :class:`~repro_torch.core.mdfg.Instance` on the
same heterogeneous platform recipe (Table II: 2 fast + 8 general cores, two
finite fast tiers + an unbounded slow tier, 1 : ``access_ratio`` fast/slow
access times), so makespans differ by *graph structure*, not by platform
lottery:

* ``random_layered`` — the paper's benchmark recipe (§V, Table II),
  vectorized: the DAG wiring is array ops, not a per-datum Python loop.
* ``out_tree`` / ``in_tree`` — tree-structured task graphs with tunable
  fan-out and depth-indexed data-weight profiles, the shape studied by
  Eyraud-Dubois et al., "Parallel scheduling of task trees with limited
  memory" (memory pressure concentrates at the root for in-trees / the
  frontier for out-trees).
* ``fft`` — the FFT-butterfly DAG (the paper's motivating DSP domain):
  ``stages`` levels of ``width`` tasks, each consuming its two butterfly
  predecessors' blocks.
* ``stencil`` — a 1-D stencil / series-parallel layered graph: ``steps``
  rows of ``width`` tasks, each consuming its ``2·radius + 1`` neighbors'
  blocks from the previous row.

The model-derived ``residency`` / ``pipeline`` families need the model
configs and the plan extractor and are registered once those modules exist
in this package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.mdfg import Instance, _csr
from .registry import register_family

__all__ = [
    "random_layered",
    "out_tree",
    "in_tree",
    "fft",
    "stencil",
]


# --------------------------------------------------------------------------- #
# shared platform recipe (Table II ratios)                                     #
# --------------------------------------------------------------------------- #
def _assemble(
    rng: np.random.Generator,
    *,
    n_tasks: int,
    n_data: int,
    task_edges: np.ndarray,
    producer: np.ndarray,
    cons_pairs: np.ndarray,      # (Ec, 2) (data, consumer-task)
    out_pairs: np.ndarray,       # (Eo, 2) (task, data)
    data_size: np.ndarray,
    name: str,
    n_fast_cores: int = 2,
    n_slow_cores: int = 8,
    tin_tproc_tout: Sequence[float] = (7.0, 15.0, 5.0),
    access_ratio: float = 1.2,
    fast_mem_fraction: float = 0.2,
    n_fast_tiers: int = 2,
    slow_core_factor: tuple[float, float] = (1.4, 2.2),
    core_restrict_prob: float = 0.1,
    ddr_only_prob: float = 0.05,
) -> Instance:
    """Wrap a task/data graph in the paper's platform (cores, tiers, AT)."""
    n_procs = n_fast_cores + n_slow_cores
    cons_arr = np.asarray(cons_pairs, dtype=np.int64).reshape(-1, 2)
    out_arr = np.asarray(out_pairs, dtype=np.int64).reshape(-1, 2)
    cons_indptr, cons_idx = _csr(n_data, cons_arr)
    in_indptr, in_idx = _csr(n_tasks, cons_arr[:, ::-1])
    out_indptr, out_idx = _csr(n_tasks, out_arr)

    tin, tproc, _ = tin_tproc_tout
    base_proc = rng.uniform(0.5 * tproc, 1.5 * tproc, size=n_tasks)
    speed = np.concatenate(
        [
            np.ones(n_fast_cores),
            rng.uniform(slow_core_factor[0], slow_core_factor[1], size=n_slow_cores),
        ]
    )
    jitter = rng.uniform(0.9, 1.1, size=(n_tasks, n_procs))
    proc_time = base_proc[:, None] * speed[None, :] * jitter
    # some tasks only run on fast (synergistic) cores — heterogeneity constraint
    restricted = rng.random(n_tasks) < core_restrict_prob
    proc_time[restricted, n_fast_cores:] = np.inf

    # tiers: [highType2 (global fast), highType1 (local fast), ...] + slow DDR
    total_vol = float(data_size.sum())
    n_mems = n_fast_tiers + 1
    mem_cap = np.empty(n_mems)
    frac_each = fast_mem_fraction / max(1, n_fast_tiers)
    mem_cap[:n_fast_tiers] = frac_each * total_vol
    mem_cap[-1] = np.inf
    mem_level = np.arange(n_mems)

    # access time per size-unit: calibrated so that mean t_in ≈ `tin` on the
    # fast tier given mean #inputs per task and mean block size
    mean_inputs = max(1e-9, len(cons_arr) / n_tasks)
    mean_size = float(data_size.mean())
    at_fast = tin / (mean_inputs * mean_size)
    access_time = np.empty((n_procs, n_mems))
    access_time[:, :n_fast_tiers] = at_fast
    access_time[:, -1] = at_fast * access_ratio
    # NUMA jitter: each core is slightly closer to one fast tier than the other
    access_time *= rng.uniform(0.95, 1.05, size=access_time.shape)

    data_mem_ok = np.ones((n_data, n_mems), dtype=bool)
    # a small fraction of blocks are DDR-only (e.g. DMA buffers)
    ddr_only = rng.random(n_data) < ddr_only_prob
    data_mem_ok[ddr_only, :n_fast_tiers] = False

    return Instance(
        n_tasks=n_tasks,
        n_data=n_data,
        task_edges=np.asarray(task_edges, dtype=np.int64).reshape(-1, 2),
        producer=np.asarray(producer, dtype=np.int64),
        cons_indptr=cons_indptr,
        cons_idx=cons_idx,
        in_indptr=in_indptr,
        in_idx=in_idx,
        out_indptr=out_indptr,
        out_idx=out_idx,
        proc_time=proc_time,
        data_size=data_size.astype(np.float64),
        mem_cap=mem_cap,
        access_time=access_time,
        mem_level=mem_level,
        data_mem_ok=data_mem_ok,
        name=name,
    )


def _draw_sizes(rng: np.random.Generator, n: int,
                data_size_range: tuple[int, int]) -> np.ndarray:
    return rng.integers(data_size_range[0], data_size_range[1] + 1,
                        size=n).astype(np.float64)


# --------------------------------------------------------------------------- #
# the paper recipe, vectorized                                                 #
# --------------------------------------------------------------------------- #
@register_family(
    "random_layered",
    description="paper Table-II recipe: random layered DAG, blocks carry "
                "most dependencies",
)
def random_layered(
    rng: np.random.Generator,
    *,
    n_tasks: int | None = None,
    n_data: int | None = None,
    edges_per_task: float = 8.0,
    data_size_range: tuple[int, int] = (1, 15000),
    name: str = "random",
    **platform,
) -> Instance:
    """The paper's benchmark recipe (Table II), wired with array ops.

    tasks ∈ [200, 300], data blocks ∈ [500, 700], edges ≈ 8 × tasks,
    2 high-speed + 8 general cores, T_in : T_proc : T_out ≈ 7 : 15 : 5,
    fast : slow access-time 1 : 1.2, data sizes ∈ [1, 15000], slow tier ∞.
    """
    if n_tasks is None:
        n_tasks = int(rng.integers(200, 301))
    if n_data is None:
        n_data = int(rng.integers(500, 701))
    if n_tasks < 2:
        raise ValueError("recipe needs at least two tasks")

    # --- DAG wiring, all-at-once --------------------------------------------
    # Data blocks carry most dependencies; direct task→task edges add the rest.
    target_edges = int(edges_per_task * n_tasks)
    n_initial = max(1, n_data // 20)         # ~5% initial inputs (D at t=0)
    producer = np.full(n_data, -1, dtype=np.int64)
    producer[n_initial:] = rng.integers(0, max(1, n_tasks - 1),
                                        size=n_data - n_initial)
    out_pairs = np.stack([producer[n_initial:],
                          np.arange(n_initial, n_data)], axis=1)
    # consumers: 1–3 per block, drawn uniformly from (producer, n_tasks)
    n_cons = rng.integers(1, 4, size=n_data)
    lo = np.where(producer < 0, 0, producer + 1)
    cand = lo[:, None] + (rng.random((n_data, 3))
                          * (n_tasks - lo)[:, None]).astype(np.int64)
    cand = np.minimum(cand, n_tasks - 1)
    live = np.arange(3)[None, :] < n_cons[:, None]
    d_of = np.broadcast_to(np.arange(n_data)[:, None], cand.shape)
    # dedupe (d, c) pairs exactly like the loop's per-datum np.unique
    flat = np.unique(d_of[live] * n_tasks + cand[live])
    cons_pairs = np.stack([flat // n_tasks, flat % n_tasks], axis=1)

    n_data_edges = len(cons_pairs) + len(out_pairs)
    n_task_edges = max(0, target_edges - n_data_edges)
    a = rng.integers(0, n_tasks - 1, size=n_task_edges)
    b = a + 1 + (rng.random(n_task_edges) * (n_tasks - a - 1)).astype(np.int64)
    task_edges = np.stack([a, np.minimum(b, n_tasks - 1)], axis=1)

    data_size = _draw_sizes(rng, n_data, data_size_range)
    return _assemble(
        rng, n_tasks=n_tasks, n_data=n_data, task_edges=task_edges,
        producer=producer, cons_pairs=cons_pairs, out_pairs=out_pairs,
        data_size=data_size, name=name, **platform,
    )


# --------------------------------------------------------------------------- #
# tree families (Eyraud-Dubois et al.)                                         #
# --------------------------------------------------------------------------- #
_DEPTH_SCALES = {"flat": 1.0, "shrink": 0.7, "grow": 1.3}


def _tree_shape(n_tasks: int, fanout: int):
    """Regular ``fanout``-ary tree: parent index and depth per node."""
    assert n_tasks >= 2 and fanout >= 1
    idx = np.arange(1, n_tasks)
    parent = (idx - 1) // fanout
    depth = np.zeros(n_tasks, dtype=np.int64)
    if fanout == 1:
        depth = np.arange(n_tasks, dtype=np.int64)
    else:
        # level l occupies the fanout^l nodes after level l-1's block
        start, l = 1, 1
        while start < n_tasks:
            depth[start : start + fanout ** l] = l
            start += fanout ** l
            l += 1
    return parent, depth


def _depth_sizes(rng: np.random.Generator, depth: np.ndarray,
                 profile: str, data_size_range: tuple[int, int]) -> np.ndarray:
    try:
        scale = _DEPTH_SCALES[profile]
    except KeyError:
        raise ValueError(
            f"depth_profile must be one of {sorted(_DEPTH_SCALES)}, "
            f"got {profile!r}") from None
    base = _draw_sizes(rng, len(depth), data_size_range)
    return np.maximum(1.0, base * scale ** depth)


@register_family(
    "out_tree",
    description="root-to-leaves task tree; block sizes follow a depth "
                "profile (flat/shrink/grow)",
    defaults={"n_tasks": 63, "fanout": 2, "depth_profile": "shrink"},
)
def out_tree(
    rng: np.random.Generator,
    *,
    n_tasks: int = 63,
    fanout: int = 2,
    depth_profile: str = "shrink",
    data_size_range: tuple[int, int] = (1, 15000),
    name: str | None = None,
    **platform,
) -> Instance:
    """Out-tree: each non-root task consumes the block its parent produced."""
    parent, depth = _tree_shape(n_tasks, fanout)
    # block e (e = child - 1): produced by parent[e], consumed by child
    children = np.arange(1, n_tasks)
    n_edges = n_tasks - 1
    producer = np.concatenate([[-1], parent]).astype(np.int64)  # block 0: root input
    cons_pairs = np.stack(
        [np.concatenate([[0], 1 + np.arange(n_edges)]),
         np.concatenate([[0], children])], axis=1)
    out_pairs = np.stack([parent, 1 + np.arange(n_edges)], axis=1)
    block_depth = np.concatenate([[0], depth[children]])
    data_size = _depth_sizes(rng, block_depth, depth_profile, data_size_range)
    return _assemble(
        rng, n_tasks=n_tasks, n_data=n_edges + 1,
        task_edges=np.zeros((0, 2), np.int64), producer=producer,
        cons_pairs=cons_pairs, out_pairs=out_pairs, data_size=data_size,
        name=name or f"out_tree[n{n_tasks},f{fanout},{depth_profile}]",
        **platform,
    )


@register_family(
    "in_tree",
    description="leaves-to-root reduction tree; leaves consume initial "
                "inputs, every node feeds its parent",
    defaults={"n_tasks": 63, "fanout": 2, "depth_profile": "grow"},
)
def in_tree(
    rng: np.random.Generator,
    *,
    n_tasks: int = 63,
    fanout: int = 2,
    depth_profile: str = "grow",
    data_size_range: tuple[int, int] = (1, 15000),
    name: str | None = None,
    **platform,
) -> Instance:
    """In-tree (reduction): each non-root task's block is consumed by its
    parent; leaf tasks consume initial input blocks present at t=0."""
    parent, depth = _tree_shape(n_tasks, fanout)
    children = np.arange(1, n_tasks)
    n_edges = n_tasks - 1
    has_child = np.zeros(n_tasks, dtype=bool)
    has_child[parent] = True
    leaves = np.nonzero(~has_child)[0]
    # blocks: [edge blocks (child -> parent)] + [leaf input blocks]
    producer = np.concatenate([children, np.full(len(leaves), -1)]).astype(np.int64)
    cons_pairs = np.stack(
        [np.concatenate([np.arange(n_edges), n_edges + np.arange(len(leaves))]),
         np.concatenate([parent, leaves])], axis=1)
    out_pairs = np.stack([children, np.arange(n_edges)], axis=1)
    block_depth = np.concatenate([depth[children], depth[leaves]])
    # "grow" means the reduction concentrates volume toward the root: invert
    # the depth axis so shallow (near-root) blocks carry the larger sizes
    inv = depth.max() - block_depth
    data_size = _depth_sizes(rng, inv, depth_profile, data_size_range)
    return _assemble(
        rng, n_tasks=n_tasks, n_data=n_edges + len(leaves),
        task_edges=np.zeros((0, 2), np.int64), producer=producer,
        cons_pairs=cons_pairs, out_pairs=out_pairs, data_size=data_size,
        name=name or f"in_tree[n{n_tasks},f{fanout},{depth_profile}]",
        **platform,
    )


# --------------------------------------------------------------------------- #
# DSP-style structured graphs                                                  #
# --------------------------------------------------------------------------- #
@register_family(
    "fft",
    description="FFT-butterfly DAG: log2(width) stages, every task consumes "
                "its two butterfly predecessors",
    defaults={"width": 8},
)
def fft(
    rng: np.random.Generator,
    *,
    width: int = 8,
    stages: int | None = None,
    data_size_range: tuple[int, int] = (1, 15000),
    name: str | None = None,
    **platform,
) -> Instance:
    """FFT butterfly: task ``(l, i)`` consumes blocks ``(l-1, i)`` and
    ``(l-1, i XOR 2^(l-1))``; level 0 consumes ``width`` initial inputs."""
    if width < 2 or (width & (width - 1)) != 0:
        raise ValueError("width must be a power of 2")
    max_stages = int(np.log2(width))
    if stages is None:
        stages = max_stages
    if not 1 <= stages <= max_stages:
        raise ValueError(
            f"fft stages must be in [1, log2(width)={max_stages}], got {stages}"
            " — the butterfly exchange distance doubles per stage")
    n_tasks = (stages + 1) * width

    def tid(l, i):
        return l * width + i

    cols = np.arange(width)
    # initial inputs: block i consumed by task (0, i)
    init_cons = np.stack([cols, tid(0, cols)], axis=1)
    cons, outs, prod = [init_cons], [], [np.full(width, -1, dtype=np.int64)]
    for l in range(stages):
        base = width + l * width          # block ids of this level's outputs
        blocks = base + cols
        prod.append(tid(l, cols))
        outs.append(np.stack([tid(l, cols), blocks], axis=1))
        # consumers: (l+1, i) and (l+1, i ^ 2^l)
        cons.append(np.stack([blocks, tid(l + 1, cols)], axis=1))
        cons.append(np.stack([blocks, tid(l + 1, cols ^ (1 << l))], axis=1))
    n_data = width * (stages + 1)
    data_size = _draw_sizes(rng, n_data, data_size_range)
    return _assemble(
        rng, n_tasks=n_tasks, n_data=n_data,
        task_edges=np.zeros((0, 2), np.int64),
        producer=np.concatenate(prod),
        cons_pairs=np.concatenate(cons, axis=0),
        out_pairs=np.concatenate(outs, axis=0) if outs
        else np.zeros((0, 2), np.int64),
        data_size=data_size,
        name=name or f"fft[w{width},s{stages}]",
        **platform,
    )


@register_family(
    "stencil",
    description="1-D stencil sweep: steps x width grid, each task consumes "
                "its 2*radius+1 neighbors from the previous row",
    defaults={"width": 16, "steps": 6, "radius": 1},
)
def stencil(
    rng: np.random.Generator,
    *,
    width: int = 16,
    steps: int = 6,
    radius: int = 1,
    data_size_range: tuple[int, int] = (1, 15000),
    name: str | None = None,
    **platform,
) -> Instance:
    """Series-parallel stencil layers: task ``(k, i)`` consumes blocks
    ``(k-1, i-radius .. i+radius)`` (clamped at the borders)."""
    if width < 1 or steps < 2 or radius < 0:
        raise ValueError("stencil needs width >= 1, steps >= 2, radius >= 0")
    n_tasks = steps * width
    cols = np.arange(width)

    def tid(k, i):
        return k * width + i

    # initial inputs: block i consumed by task (0, i)
    cons = [np.stack([cols, tid(0, cols)], axis=1)]
    outs, prod = [], [np.full(width, -1, dtype=np.int64)]
    for k in range(steps - 1):
        base = width + k * width
        blocks = base + cols
        prod.append(tid(k, cols))
        outs.append(np.stack([tid(k, cols), blocks], axis=1))
        for o in range(-radius, radius + 1):
            tgt = np.clip(cols + o, 0, width - 1)
            cons.append(np.stack([base + tgt, tid(k + 1, cols)], axis=1))
    cons_all = np.concatenate(cons, axis=0)
    # border clamping duplicates (block, consumer) pairs — dedupe like the
    # layered recipe does
    flat = np.unique(cons_all[:, 0] * n_tasks + cons_all[:, 1])
    cons_all = np.stack([flat // n_tasks, flat % n_tasks], axis=1)
    n_data = width * steps
    data_size = _draw_sizes(rng, n_data, data_size_range)
    return _assemble(
        rng, n_tasks=n_tasks, n_data=n_data,
        task_edges=np.zeros((0, 2), np.int64),
        producer=np.concatenate(prod),
        cons_pairs=cons_all,
        out_pairs=np.concatenate(outs, axis=0),
        data_size=data_size,
        name=name or f"stencil[w{width},t{steps},r{radius}]",
        **platform,
    )
