"""A small copy of the benchmark for the CPU tests: the real metric readers,
the cells' real limits, and each cell's configuration at the port's smoke
size (its ``get_smoke_config``: 4 layers, width 128, float32) under a short
traffic mix of the same kind."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench.harness import spec

SMOKE = {"num_hidden_layers": 4, "hidden_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 4, "head_dim": 32, "intermediate_size": 256,
         "vocab_size": 512, "torch_dtype": "float32", "port_variant": "smoke"}
TRAIN = {"batch": 2, "seq": 64, "planner": "greedy", "checked_steps": 3, "profile_steps": 1}
PREFILL = {"lengths": [48, 64, 80, 96], "profile_requests": 4, "checked_requests": 3}


def smoke_config(config: dict) -> dict:
    out = {**config, **SMOKE}
    if out.get("num_local_experts"):
        out["num_local_experts"], out["num_experts_per_tok"] = 4, 2
    if "attention_multiplier" in out:
        out["attention_multiplier"] = 32 ** -0.5
    return out


def make_root(tmp: Path, root: Path = spec.ROOT) -> Path:
    """A benchmark tree under ``tmp`` whose cells are the real ones at the
    smoke size; returns its root."""
    bench = spec.load(root)
    for sub in ("metrics", "cells"):
        shutil.copytree(root / "bench" / sub, tmp / "bench" / sub)
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir(parents=True)
    for c in bench["configs"]:
        config = smoke_config(json.loads((root / c["file"]).read_text()))
        (tmp / c["file"]).write_text(json.dumps(config))
    for w in bench["workloads"]:
        path = root / "bench" / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic.update(TRAIN if traffic["kind"] == "train" else PREFILL)
        (tmp / "bench" / "traffic" / path.name).write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
