"""Nothing the benchmark runs loads JAX or the JAX package ``repro`` (top-level
names compared whole, since the port is ``repro_torch``), the reference
loads nothing of the port, and a run without the devices it asks for, or
without the program, prints no result."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from bench.harness import runner, spec

ROOT = spec.ROOT
BENCH = ROOT / "bench"


def _imports(path: Path) -> set:
    """Top-level names of the absolute imports of one file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_the_reference_and_what_it_reads_import_nothing_of_the_program():
    files = list((BENCH / "reference").glob("*.py")) + [BENCH / "harness" / "arch.py",
                                                       BENCH / "harness" / "weights.py"]
    for f in files:
        assert not _imports(f) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, f
    # the reference reaches the harness only through those two modules
    for f in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 2:
                assert node.module in ("harness", "harness.arch"), (f, node.module)
                assert all(a.name in ("weights", "Arch") for a in node.names), f


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "import bench.run\n"
        "from bench.harness import runner, spec\n"
        "import bench.kinds.train, bench.kinds.prefill, bench.control\n"
        "import repro_torch.launch.train, repro_torch.launch.model_serve\n"
        "for b in spec.load()['end_to_end'] + spec.load()['per_layer']:\n"
        "    spec.metric_reader(b['name'])\n"
        "print(json.dumps(runner.foreign_modules()))\n" % (str(ROOT), str(ROOT / "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_foreign_names_are_compared_whole():
    assert runner.foreign_modules(["repro_torch", "repro_torch.launch", "jaxtyping",
                                   "flaxen.x", "torch"]) == []
    assert runner.foreign_modules(["repro.core.api", "jax.numpy", "jaxlib", "flax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _run(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "qwen2.5-14b.prefill.longdoc", "--seed", "2147483999",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=120)


def test_without_the_devices_a_run_prints_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """A directory of only BENCHMARK.json and the benchmark's files: the run
    (past the look for a chip) stops at the program's import."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = [%r]\n"
            "from bench.harness import runner\n"
            "print(runner.run_cell('qwen2.5-14b.prefill.longdoc', 1, 1.0, False, 'cpu',"
            " time.perf_counter()))\n" % str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'repro_torch'" in out.stderr
