"""The port stands alone: importing and running it (the solvers, the
device-resident search and its instance packing, the suites, the fault
layer and the solve service among them) pulls in neither JAX nor the
reference package, and no source file of it names either."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
import repro_torch
import repro_torch.core.device_search
import repro_torch.faults
import repro_torch.faults.inject
import repro_torch.instances.batch
import repro_torch.instances.suites
import repro_torch.serve
import repro_torch.kernels.ops
import repro_torch.kernels.ssd
import repro_torch.launch.model_serve
import repro_torch.models
import repro_torch.models.blocks
from repro_torch import solve, Budget
from repro_torch.core import random_instance
inst = random_instance(0, n_tasks=24, n_data=50)
rep = solve(inst, "tabu_multiwalk", walks=2, budget=Budget(max_iters=3),
            torch_device="cpu")
assert rep.makespan > 0
rep = solve(inst, "tabu_device", walks=2, budget=Budget(max_iters=3), torch_device="cpu")
assert rep.extras["backend"] == "device"
import asyncio
from repro_torch.serve import EngineConfig, SolveService
async def served():
    svc = SolveService(config=EngineConfig(backend="numpy"))
    await svc.start()
    rid = await svc.submit(inst, Budget(max_iters=3), seed=1, walks=2)
    rr = await svc.result(rid)
    await svc.shutdown()
    return rr
rr = asyncio.run(served())
assert rr.metrics["backend"] == "numpy" and rr.report.makespan > 0
ids = repro_torch.launch.model_serve.serve_main(
    ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "70", "--gen", "3"])
assert ids.shape == (2, 3)
ids = repro_torch.launch.model_serve.serve_main(
    ["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--batch", "2",
     "--prompt-len", "70", "--gen", "3"])
assert ids.shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_import_solve_and_serve_leave_jax_and_repro_unloaded():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_SLICE = """
import os, sys, tempfile
import repro_torch.faults.checkpoint as ck
import repro_torch.configs.qwen2_5_14b
import repro_torch.configs.codeqwen1_5_7b
import repro_torch.configs.qwen1_5_32b
from repro_torch.configs import get_config
from repro_torch.core import random_instance
from repro_torch.core.device_search import DeviceConfig, device_multiwalk
from repro_torch.core.greedy import construct_greedy
from repro_torch.core.tabu import TSParams
from repro_torch.launch.model_serve import serve_main
assert [get_config(a).n_layers for a in ("qwen2.5-14b", "codeqwen1.5-7b", "qwen1.5-32b")] \\
    == [48, 32, 64]
inst = random_instance(0, n_tasks=24, n_data=50)
params = TSParams(max_iters=4, torch_device="cpu")
got = []
full = device_multiwalk(inst, [construct_greedy(inst, "slack_first", rng=0)], params,
                        config=DeviceConfig(sync_every=2), on_checkpoint=got.append)
path = ck.save(got[0], os.path.join(tempfile.mkdtemp(), "c.npz"))
res = device_multiwalk(inst, [], params, config=DeviceConfig(sync_every=2),
                       resume_from=ck.load(path))
assert res.history == full.history
ids = serve_main(["--arch", "qwen2.5-14b", "--smoke", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "16", "--gen", "3"])
assert ids.shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_checkpoint_and_the_qwen_configs_leave_jax_and_repro_unloaded():
    """This slice's modules (faults.checkpoint and the three global-attention
    configs), imported and run: a crash-resume round trip through a file and
    a qwen2.5-14b smoke serve."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_SLICE], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_TRAIN = """
import sys, tempfile
import repro_torch.plan
import repro_torch.plan.planner
import repro_torch.runtime
import repro_torch.runtime.checkpoint
import repro_torch.runtime.elastic
import repro_torch.runtime.optimizer
import repro_torch.launch.train
import repro_torch.models.remat
import repro_torch.kernels.replay
import repro_torch.configs.llama3_405b
import repro_torch.configs.mixtral_8x7b
import repro_torch.configs.granite_moe_1b_a400m
import repro_torch.configs.whisper_medium
import repro_torch.configs.internvl2_26b
from repro_torch.instances import generate
assert generate("residency", 0).n_tasks > 0 and generate("pipeline", 0).n_tasks > 0
state = repro_torch.launch.train.train_main(
    ["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu", "--steps", "3",
     "--batch", "2", "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
     "--ckpt-dir", tempfile.mkdtemp()])
assert state.step == 3
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_training_and_the_planner_leave_jax_and_repro_unloaded():
    """This slice's modules (the planner, the training runtime, the trainer
    launcher, the residency lowering and the five configs now held as data),
    imported and run: a smoke training run that plans, checkpoints and
    recovers from an injected failure."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_TRAIN], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_SSM_TRAIN = """
import sys
import tempfile
import repro_torch.kernels.ssd as ssd
from repro_torch.launch.train import train_main
assert {"ssd_chunked_bwd", "ssd_chunked_bwd_torch", "ssd_chunked_torch_grad"} <= set(ssd.__all__)
state = train_main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "72", "--ckpt-every", "2", "--fail-at", "3",
                    "--ckpt-dir", tempfile.mkdtemp()])
assert state.step == 3
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_the_ssm_training_leaves_jax_and_repro_unloaded():
    """K4's backward (``kernels.ssd``'s new names) and mamba2-780m's smoke
    training through the launcher, with a recovery, import neither JAX nor
    the reference."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_SSM_TRAIN], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_SERVED = """
import sys
import repro_torch.models.encdec
import repro_torch.models.blocks
from repro_torch.launch.model_serve import serve_main
for arch in ("whisper-medium", "granite-moe-1b-a400m", "internvl2-26b", "mixtral-8x7b"):
    ids = serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "2"])
    assert ids.shape == (2, 2)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_the_encdec_moe_and_vision_archs_leave_jax_and_repro_unloaded():
    """This slice's modules (``models.encdec``, the MoE block), imported and
    run: a smoke serve of each arch it adds."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_SERVED], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_ANALYSIS = """
import sys
import repro_torch.analysis.cli
import repro_torch.analysis.lint
import repro_torch.analysis.rules
from repro_torch.analysis.cli import main
assert main(["selftest"]) == 0
assert main(["lint"]) == 0
assert main(["certify", "--suite", "smoke", "--max-iters", "2", "--backend", "torch",
             "--torch-device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_the_analysis_cli_leaves_jax_and_repro_unloaded():
    """This slice's modules (the linter, its rules and the CLI), imported
    and run: ``selftest``, ``lint`` over the port and ``certify`` through
    the torch backend on the CPU."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_ANALYSIS], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_PROBE_MULTI_DEVICE = """
import dataclasses, sys, tempfile
import repro_torch.sharding
import repro_torch.sharding.partitioning
import repro_torch.launch.mesh
import repro_torch.launch.specs
import repro_torch.launch.dryrun as dr
import repro_torch.runtime.pipeline
import repro_torch.kernels.fake
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_smoke_config
dr.CELLS["t"] = ShapeCell("t", 32, 4, "train")
rec = dr.run_cell("granite-moe-1b-a400m", "t", multi_pod=False, mesh_shape=(2, 2),
                  out_dir=tempfile.mkdtemp(), force=True,
                  cfg_override=get_smoke_config("granite-moe-1b-a400m"))
assert rec["status"] == "ok", rec.get("error")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_the_multi_device_layer_leaves_jax_and_repro_unloaded():
    """This slice's modules (``sharding``, ``launch.mesh``, ``launch.specs``,
    ``launch.dryrun``, ``runtime.pipeline``, ``kernels.fake``), imported and
    run: a smoke dry-run train cell on a fake 2 x 2 mesh."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE_MULTI_DEVICE], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_)"
    r"|from\s+repro\.)"
    # a module named by string (importlib.import_module, __import__, f-strings)
    r"|[\"'](jax|jaxlib|repro)(\.|[\"'])", re.M)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


# the tracer's span names (``repro.moe`` ...) are labels in a profiler's
# trace, not a module: the one line that spells their prefix is spared
_SPARED = {PORT / "tracing.py": 'PREFIX = "repro."\n'}


def test_no_port_source_imports_jax_or_repro():
    for path in _sources():
        text = path.read_text()
        if path in _SPARED:
            assert text.count(_SPARED[path]) == 1, path
            text = text.replace(_SPARED[path], "")
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"


def test_forbidden_pattern_spares_the_port_itself():
    assert _FORBIDDEN.search("import repro_torch\nfrom repro_torch.core import x\n") is None
    assert _FORBIDDEN.search("from repro.core import x\n")
    assert _FORBIDDEN.search("    import jax.numpy as jnp\n")
    assert _FORBIDDEN.search("import repro\n")
    assert _FORBIDDEN.search('mod = importlib.import_module(f"repro.configs.{name}")\n')
    assert _FORBIDDEN.search("importlib.import_module('jax')\n")
    assert _FORBIDDEN.search('x = __import__("repro")\n')
    assert _FORBIDDEN.search('importlib.import_module(f"{__package__}.x")\n') is None
    assert _FORBIDDEN.search('"repro_torch.core"\n') is None


def test_public_surface_matches_reference():
    import repro
    import repro_torch

    assert set(repro.__all__) == set(repro_torch.__all__)
    assert set(repro_torch.list_solvers()) == set(repro.list_solvers())


def test_the_service_and_the_sweep_default_to_the_card():
    """The new entry points go to the GPU unless asked for the CPU, through
    ``_device.resolve_device``: without a card they raise instead of
    carrying on on the host."""
    import inspect

    import torch

    from repro_torch import Budget
    from repro_torch.core import random_instance
    from repro_torch.instances import suites
    from repro_torch.serve import Engine, EngineConfig, WarmSpec

    assert EngineConfig().torch_device == "cuda"
    assert inspect.signature(suites.sweep).parameters["torch_device"].default == "cuda"
    if torch.cuda.is_available():
        return
    inst = random_instance(0, n_tasks=12, n_data=30)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine(EngineConfig()).warmup([WarmSpec(inst, 2, Budget(max_iters=1))])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        suites.sweep([inst], backend="device", budget=Budget(max_iters=1))
