"""The benchmark's parts are found by name, ``BENCHMARK.json`` keeps to its
contract, and a configuration, a traffic mix, a metric and a cell are added
by new files and entries alone."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from bench.harness import spec
from bench.harness.arch import arch_of
from bench.harness.record import Record, Unit
from bench.harness.runner import line

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "head_dim", "num_experts_per_tok",
          "moe_intermediate_size", "num_attention_heads", "num_key_value_heads")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(workload):
    cell = spec.cell(workload)
    assert cell.config["name"] == next(w for w in BENCH["workloads"]
                                       if w["name"] == workload)["config"]
    assert spec.kind(cell.traffic["kind"]).run
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    arch_of(cell.config)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(config.get("departures", {})) == set(config["reduced"])
        assert not set(c["reduced"]) & set(WIDTHS)
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and (
                "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_mix_config_and_metric_are_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell, added as
    files and BENCHMARK.json entries under a copy of the tree, are found;
    every file that was there before is unchanged."""
    for sub in ("configs", "traffic", "metrics", "cells"):
        shutil.copytree(spec.ROOT / "bench" / sub, tmp_path / "bench" / sub)
    before = _digest(tmp_path / "bench")
    bench = json.loads(json.dumps(BENCH))

    config = json.loads((spec.ROOT / "bench/configs/qwen2.5-14b.json").read_text())
    config.update(name="qwen2.5-14b-copy", num_hidden_layers=24)
    (tmp_path / "bench/configs/qwen2.5-14b-copy.json").write_text(json.dumps(config))
    traffic = json.loads((spec.ROOT / "bench/traffic/prefill.longdoc.json").read_text())
    traffic["lengths"] = [1024, 2048]
    (tmp_path / "bench/traffic/prefill.short.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/metrics/requests_done.py").write_text(
        "def read(rec):\n    return float(sum(u.ok for u in rec.units))\n")
    (tmp_path / "bench/cells/qwen2.5-14b-copy.prefill.short.json").write_text(
        json.dumps({"limits": {"token_gap": 1.0}}))
    bench["configs"].append({"name": "qwen2.5-14b-copy", "source": "https://example.org/x",
                             "file": "bench/configs/qwen2.5-14b-copy.json",
                             "reduced": ["rms_norm_eps", "num_hidden_layers"], "why": "a test"})
    bench["workloads"].append({"name": "qwen2.5-14b-copy.prefill.short",
                               "config": "qwen2.5-14b-copy", "traffic": "prefill.short",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "serve entry",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["qwen2.5-14b-copy.prefill.short"]})
    for m in bench["end_to_end"]:
        if "qwen2.5-14b.prefill.longdoc" in m.get("workloads", ()):
            m["workloads"].append("qwen2.5-14b-copy.prefill.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("qwen2.5-14b-copy.prefill.short", tmp_path)
    assert cell.config["num_hidden_layers"] == 24 and cell.traffic["lengths"] == [1024, 2048]
    assert [m["name"] for m in cell.per_layer] == ["requests_done"]
    rec = Record(name=cell.name, config=cell.config, traffic=cell.traffic,
                 arch=arch_of(cell.config), limits=cell.limits)
    rec.units = [Unit(0.0, 0.5, 1024, 1, 1024), Unit(0.5, 1.5, 2048, 1, 2048)]
    rec.window_s = 1.5
    rec.check("token_gap", 0.0, cell.limits["token_gap"])
    out = line(cell, rec, True, "cpu")
    assert out["metrics"] == {"requests_done": {"value": 2.0, "unit": "requests"}}
    out = line(cell, rec, False, "cpu")
    assert out["metrics"]["prefill_tokens_per_s"]["value"] == pytest.approx(3072 / 1.5)
    after = _digest(tmp_path / "bench")
    assert all(after[k] == v for k, v in before.items())


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = spec.cell("granite-moe-1b-a400m.train.2x4096")
    rec = Record(name=cell.name, config=cell.config, traffic=cell.traffic,
                 arch=arch_of(cell.config), limits=cell.limits)
    out = line(cell, rec, True, "cpu")
    assert out["metrics"] == {} and out["correct"] is False
