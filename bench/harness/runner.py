"""One run of one cell: the kind of traffic fills a record, the metric
readers read it, and the result line is assembled.

``run_cell`` leaves out only the look for a chip (``bench/run.py`` makes
it), so a test can drive a whole run on the CPU at a small size.
"""
from __future__ import annotations

import sys

import torch

from . import spec
from .arch import arch_of
from .record import Record
from .trace import top_by_name

# top-level modules that must not be loaded: JAX and the JAX package the port
# was made from (names compared whole: the port is ``repro_torch``)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(names=None) -> list:
    """The foreign top-level names among ``names`` (the loaded modules')."""
    return sorted({m.split(".", 1)[0] for m in (sys.modules if names is None else names)}
                  & set(FOREIGN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root=spec.ROOT) -> tuple[dict, Record]:
    """Run cell ``name`` once; the result line (a dict) and the record."""
    cell = spec.cell(name, root)
    rec = Record(name=name, config=cell.config, traffic=cell.traffic,
                 arch=arch_of(cell.config), limits=cell.limits)
    spec.kind(cell.traffic["kind"]).run(rec, seed, seconds, trace, device, t_start)
    return line(cell, rec, trace, device), rec


def line(cell: spec.Cell, rec: Record, trace: bool, device) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
                "memory_peak_bytes": int(rec.device["memory_peak_bytes"])}
    else:
        info = {"platform": dev.type, "kind": dev.type, "count": 1, "memory_peak_bytes": 0}
    out = {"correct": rec.correct, "attempted": len(rec.units),
           "failed": sum(not u.ok for u in rec.units), "metrics": metrics, "device": info}
    if trace and rec.trace is not None:
        info["busy_s"], info["window_s"] = rec.trace.busy_s, rec.trace.window_s
        out["breakdown"] = {
            "device_ops": top_by_name((n[:160], (e - s) / 1e6) for n, s, e in rec.trace.kernels),
            "idle_gaps": top_by_name((n[:160], sec) for n, sec in rec.trace.gaps)}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    return out
