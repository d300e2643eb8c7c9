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


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_)"
    r"|from\s+repro\.)"
    # a module named by string (importlib.import_module, __import__, f-strings)
    r"|[\"'](jax|jaxlib|repro)(\.|[\"'])", re.M)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_no_port_source_imports_jax_or_repro():
    for path in _sources():
        hit = _FORBIDDEN.search(path.read_text())
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
