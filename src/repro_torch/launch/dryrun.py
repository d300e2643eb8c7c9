"""Multi-pod dry run: run one train, prefill or decode step of every
(architecture × shape × mesh) cell against the production meshes under a
fake process group of the mesh's size and ``FakeTensorMode``, as rank 0 of
the mesh, and record its memory, cost and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--force]

Nothing is allocated and no device is touched: parameters, optimizer
state, caches and inputs are DTensor stand-ins on fake tensors
(``launch.specs``), collectives go to torch's fake backend
(``torch.testing._internal.distributed.fake_pg``, which torch's own memory
estimators use), and the hand-written kernels take their shape-only
implementations (``kernels.fake``).  The record keeps the reference's keys:

* ``memory_analysis``: ``argument_size_in_bytes`` (this rank's shards of
  the state and the batch), ``output_size_in_bytes`` (of the step's
  outputs that are new tensors: logits, caches, metrics), and
  ``temp_size_in_bytes`` (``peak_bytes`` less the arguments), with
  ``peak_bytes`` the peak of ``MemTracker``'s total;
* ``cost_analysis``: ``flops`` of the ops rank 0 runs, by
  ``FlopCounterMode``'s formulas (the kernels' own from ``kernels.fake``),
  and ``bytes accessed``, the sum of each dispatched op's input and output
  bytes.  This count is unfused: every elementwise op reads and writes its
  operands in full, where a compiler would fuse them;
* ``collectives``: per kind (the reference's names), the count
  (``CommDebugMode``), the result bytes, and the wire bytes per device by
  the reference's ring formulas (``parse_collectives``);
* ``n_devices`` and ``status``.

Records are cached as JSON under ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from ..configs.base import SHAPE_CELLS
from ..configs.registry import ARCH_IDS, get_config
from ..sharding import set_mesh
from .mesh import make_mesh, production_shape
from .specs import (CELLS, argument_bytes, arch_rules, cache_specs, input_specs,
                    model_stand_in, train_state_specs)

__all__ = ["lower_cell", "run_cell", "main", "LONG_OK", "OPTIMIZER_OF", "RESULTS_DIR",
           "wire_bytes", "fake_world"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")

# long_500k requires sub-quadratic decode state (see DESIGN.md §5)
LONG_OK = {"recurrentgemma-2b", "mamba2-780m", "mixtral-8x7b"}
# memory-constrained flagship uses factored optimizer states
OPTIMIZER_OF = {"llama3-405b": "adafactor"}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_KIND_OF = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
            "all-gather", "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
            "reduce-scatter", "all_to_all_single": "all-to-all"}


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes per device of one collective with ``nbytes`` of result
    over a group of ``n`` (ring algorithms, the reference's formulas):
    all-gather out×(n−1)/n, reduce-scatter out×(n−1), all-reduce
    2×size×(n−1)/n, all-to-all size×(n−1)/n, permute size."""
    n = max(2, n)
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    """Bytes of the tensors in an op's arguments or outputs (one level of
    lists, as ops take them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(v.numel() * v.element_size() for v in x if isinstance(v, torch.Tensor))
    return 0


def _accounting_mode():
    """A dispatch mode over rank 0's local ops (it lets DTensor desugar
    into them first): flops by ``FlopCounterMode``'s registry, the bytes of
    each op's inputs and outputs (views move none), and the functional
    collectives' result bytes and group sizes."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    facts: dict = {}    # op -> (flop formula, moves bytes, collective kind)

    def facts_of(func):
        if func not in facts:
            kind = _KIND_OF.get(func.overloadpacket.__name__) \
                if func.namespace == "_c10d_functional" else None
            facts[func] = (flop_registry.get(func.overloadpacket), not func.is_view, kind)
        return facts[func]

    class Accounting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.result = {k: 0.0 for k in _COLLECTIVES}
            self.wire = {k: 0.0 for k in _COLLECTIVES}
            self.counts = {k: 0 for k in _COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula, moves, kind = facts_of(func)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if moves:
                self.bytes += sum(map(_nbytes, args)) + sum(map(_nbytes, kwargs.values())) \
                    + _nbytes(out)
            if kind is not None:
                group = next(a for a in reversed(args) if isinstance(a, str))
                n = _resolve_process_group(group).size()
                nbytes = _nbytes(out)
                self.result[kind] += nbytes
                self.wire[kind] += wire_bytes(kind, nbytes, n)
                self.counts[kind] += 1
            return out

    return Accounting()


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0 (a group of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def lower_cell(arch: str, cell_name: str, *, multi_pod: bool, scan_group: int | None = None,
               extra_tag: str = "", cfg_override=None, optimizer: str | None = None,
               moe_ep: bool = False, param_dtype=None, carry_seq_tp: bool = False,
               mesh_shape: tuple[int, ...] | None = None, remat_policy=None):
    """Set up one (arch × cell × mesh): the fake world and mesh, the rules,
    the stand-ins and the step.  Returns (run, meta, mesh, args), where
    ``run()`` takes the step once and returns its outputs and ``args`` is
    what the step is handed (state or parameters, cache, batch).  Must be
    called inside a ``FakeTensorMode``.  ``mesh_shape`` replaces the
    production shape (same axis names); ``remat_policy`` is a train step's
    residency plan (``models.remat.Residency``; None: layer carries only)."""
    from ..runtime.optimizer import adafactor, adamw
    from ..runtime.serve import make_prefill_step, make_serve_step
    from ..runtime.train import make_train_step

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    cell = CELLS[cell_name]
    shape, axes = production_shape(multi_pod=multi_pod)
    shape = tuple(mesh_shape) if mesh_shape is not None else shape
    n = 1
    for s in shape:
        n *= s
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():       # the mesh's rank table is a real tensor
        fake_world(n)
        mesh = make_mesh(shape, axes, device_type="cpu")
    rules = arch_rules(cfg, cell, mesh, moe_ep=moe_ep, carry_seq_tp=carry_seq_tp)
    set_mesh(mesh)
    opt_name = optimizer or OPTIMIZER_OF.get(arch, "adamw")
    batch = input_specs(cfg, cell, mesh, rules)
    if cell.kind == "train":
        state, model = train_state_specs(cfg, mesh, rules, optimizer=opt_name)
        master = opt_name.endswith("_master")
        opt = (adafactor(master_fp32=master) if opt_name.removesuffix("_master") == "adafactor"
               else adamw(master_fp32=master))
        step = make_train_step(cfg, opt, model, rules=rules, scan_group=scan_group,
                               remat_policy=remat_policy)
        args = (state, batch)

        def run():
            return step(state, batch)
    elif cell.kind == "prefill":
        model = model_stand_in(cfg, mesh, rules, param_dtype=param_dtype)
        step = make_prefill_step(cfg, max_len=cell.seq_len, device="cpu", rules=rules)
        args = (dict(model.named_parameters()), batch)

        def run():
            with torch.no_grad():
                return step(model, batch)
    else:  # decode
        model = model_stand_in(cfg, mesh, rules, param_dtype=param_dtype)
        cache = cache_specs(cfg, cell, mesh, rules)
        step = make_serve_step(cfg, device="cpu", rules=rules)
        args = (dict(model.named_parameters()), cache, batch)

        def run():
            with torch.no_grad():
                return step(model, cache, batch["tokens"], cell.seq_len - 1)
    meta = {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
            "mesh": dict(zip(axes, shape)), "optimizer": opt_name, "scan_group": scan_group,
            "remat_policy": repr(remat_policy) if remat_policy is not None else None,
            "tag": extra_tag}
    return run, meta, mesh, args


def _out_bytes(out, args) -> int:
    """Bytes of the step's outputs that are not its arguments (updated in
    place) — logits, a new cache, metrics."""
    held = {id(t) for t in _tensors(args)}
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(out if not hasattr(out, "__dataclass_fields__") else ()):
        if id(t) not in held:
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def analyse(run, args, n_devices: int) -> dict:
    """Take the step under the accounting modes: memory, cost, collectives."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    acc, comm, mem = _accounting_mode(), CommDebugMode(), MemTracker()
    t0 = time.time()
    with acc, comm, mem:          # the accounting below the others (it sees local ops)
        out = run()
    seconds = time.time() - t0
    peak = sum(v.get("Total", 0) if isinstance(v, dict) else int(v)
               for v in mem.get_tracker_snapshot("peak").values())
    arg = argument_bytes(args) + (4 if any(hasattr(a, "opt_state") for a in args) else 0)
    if isinstance(out, tuple) and len(out) == 2 and hasattr(out[0], "opt_state"):
        out = out[1]                                   # train: the metrics
    return {
        "time_step_s": round(seconds, 2),
        "memory_analysis": {"argument_size_in_bytes": int(arg),
                            "output_size_in_bytes": int(_out_bytes(out, args)),
                            "temp_size_in_bytes": int(max(0, peak - arg)),
                            "peak_bytes": int(peak)},
        "cost_analysis": {"flops": float(acc.flops), "bytes accessed": float(acc.bytes)},
        "collectives": {"result_bytes": acc.result, "wire_bytes": acc.wire,
                        "counts": acc.counts,
                        "comm_debug_counts": {str(k): int(v)
                                              for k, v in comm.get_comm_counts().items()},
                        "total_wire_bytes": float(sum(acc.wire.values()))},
        "n_devices": n_devices,
    }


@contextlib.contextmanager
def _dtensor_under_fake():
    """Three DTensor paths that assume real tensors, set right for the dry
    run (restored after):

    * a ``_StridedShard``'s (a sharded dim flattened inside another, as
      views in a backward make) shard sizes come from an index tensor built
      with ``torch.arange`` and read back, which ``FakeTensorMode`` would
      fake: that index math runs on real tensors;
    * under a fake mode DTensor takes itself to be tracing and plans every
      candidate redistribution anew, uncached, and for a tensor dim sharded
      over two mesh dims it searches for the least-cost plan (minutes a
      step on a 3-D mesh): the plans, pure functions of the two specs, are
      cached, and made greedily, one mesh dim at a time, as DTensor plans
      plain placements.  The counted collectives are the greedy plan's;
    * DTensor infers an op's output shape by running the op on fake tensors
      of the global shapes, the first time it meets the op's signature: that
      runs with the accounting modes off, else rank 0 would be charged the
      global op's bytes and flops once per signature (a 29 GB MLP hidden of
      qwen2.5-14b ``train_4k`` on 16 x 16, and ~46 times the flops of a
      2-layer llama3-405b step, in the first step of a process only)."""
    import functools

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    undo = []
    shapes = ShardingPropagator.__dict__.get("_propagate_tensor_meta_non_cached")
    if shapes is not None:
        def shapes_unaccounted(self, op_schema):
            with _disable_current_modes():
                return shapes(self, op_schema)

        ShardingPropagator._propagate_tensor_meta_non_cached = shapes_unaccounted
        undo.append(lambda: setattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                                    shapes))
    try:
        from torch.distributed.tensor.placement_types import _StridedShard

        orig = _StridedShard.__dict__.get("local_shard_size_and_offset")
    except ImportError:
        orig = None
    if orig is not None:
        def real(self, *args, **kwargs):
            with unset_fake_temporarily():
                return orig(self, *args, **kwargs)

        _StridedShard.local_shard_size_and_offset = real
        undo.append(lambda: setattr(_StridedShard, "local_shard_size_and_offset", orig))
    planner = getattr(_redistribute, "DTensorRedistributePlanner", None)
    search = getattr(planner, "generate_graph_based_transform_infos", None)
    if search is not None and hasattr(planner, "generate_greedy_transform_infos"):
        planner.generate_graph_based_transform_infos = \
            lambda self, src, dst, *_: self.generate_greedy_transform_infos(src, dst)
        undo.append(lambda: setattr(planner, "generate_graph_based_transform_infos", search))
    plan = getattr(_redistribute, "_gen_transform_infos_non_cached", None)
    if plan is not None:
        _redistribute._gen_transform_infos_non_cached = functools.lru_cache(None)(plan)
        undo.append(lambda: setattr(_redistribute, "_gen_transform_infos_non_cached", plan))
    try:
        yield
    finally:
        for fn in undo:
            fn()


def run_cell(arch: str, cell_name: str, *, multi_pod: bool, out_dir: str = RESULTS_DIR,
             force: bool = False, scan_group: int | None = None, tag: str = "",
             **lower_kw) -> dict:
    """Dry-run one cell (cached as JSON in ``out_dir`` unless ``force``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    os.makedirs(out_dir, exist_ok=True)
    mp = "2pod" if multi_pod else "1pod"
    if lower_kw.get("mesh_shape") is not None:
        mp = "x".join(map(str, lower_kw["mesh_shape"]))
    fname = os.path.join(out_dir, f"{arch}__{cell_name}__{mp}{('__' + tag) if tag else ''}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)

    record: dict = {"arch": arch, "cell": cell_name, "mesh": mp, "tag": tag}
    if cell_name == "long_500k" and arch not in LONG_OK:
        record["status"] = "skipped"
        record["reason"] = "pure full-attention arch: 500k decode state is quadratic (DESIGN.md §5)"
        with open(fname, "w") as f:
            json.dump(record, f, indent=1)
        return record

    t0 = time.time()
    try:
        with _dtensor_under_fake(), FakeTensorMode(), contextlib.ExitStack() as stack:
            stack.callback(set_mesh, None)
            run, meta, mesh, args = lower_cell(arch, cell_name, multi_pod=multi_pod,
                                               scan_group=scan_group, extra_tag=tag, **lower_kw)
            record.update(meta)
            t_lower = time.time() - t0
            record.update(analyse(run, args, mesh.size()))
        record["status"] = "ok"
        record["time_lower_s"] = round(t_lower, 2)
        ma, ca = record["memory_analysis"], record["cost_analysis"]
        print(f"[{arch} × {cell_name} × {mp}] OK  setup={t_lower:.1f}s "
              f"step={record['time_step_s']:.1f}s args={ma['argument_size_in_bytes']:.3e} "
              f"peak={ma['peak_bytes']:.3e} flops={ca['flops']:.3e} "
              f"bytes={ca['bytes accessed']:.3e} "
              f"wire={record['collectives']['total_wire_bytes']:.3e}")
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-12000:]
        print(f"[{arch} × {cell_name} × {mp}] FAIL {type(e).__name__}: {e}")
    with open(fname, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--cell", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2×16×16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--scan-group", type=int, default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = []
    if args.all:
        for arch in ARCH_IDS:
            for cell in SHAPE_CELLS:
                for mp in meshes:
                    jobs.append((arch, cell.name, mp))
    else:
        if not (args.arch and args.cell):
            ap.error("--arch/--cell or --all")
        jobs = [(args.arch, args.cell, mp) for mp in meshes]

    n_ok = n_fail = n_skip = 0
    for arch, cell, mp in jobs:
        rec = run_cell(arch, cell, multi_pod=mp, force=args.force,
                       scan_group=args.scan_group, tag=args.tag)
        s = rec.get("status")
        n_ok += s == "ok"
        n_fail += s == "error"
        n_skip += s == "skipped"
    print(f"dry-run summary: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
