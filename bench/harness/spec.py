"""The benchmark's parts, found by the names in ``BENCHMARK.json``.

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``bench/traffic/<traffic>.json``, run by the kind of
  traffic it names, ``bench/kinds/<kind>.py``;
* a metric, end-to-end or per-layer: its reader, ``bench/metrics/<name>.py``
  (a function ``read(record)`` that returns the value, or None where it
  finds nothing to read);
* a cell's limits for ``correct``: ``bench/cells/<workload>.json``.

Adding a configuration, a mix, a metric or a cell is adding such files and
entries; no file of the harness changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1
    root: Path


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """Workload ``name`` with its configuration, traffic mix, limits and
    metrics."""
    root = Path(root)
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the workloads are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "bench" / "cells" / f"{name}.json").read_text())["limits"]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read(record)`` of metric ``name``."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    return _load_file(path, "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def kind(name: str):
    """The module that runs traffic of kind ``name`` (``bench/kinds``)."""
    return importlib.import_module(f"bench.kinds.{name}")
