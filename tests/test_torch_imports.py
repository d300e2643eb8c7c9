"""The port stands alone: importing and running it pulls in neither JAX nor
the reference package, and no source file of it names either."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
import repro_torch
from repro_torch import solve, Budget
from repro_torch.core import random_instance
inst = random_instance(0, n_tasks=24, n_data=50)
rep = solve(inst, "tabu_multiwalk", walks=2, budget=Budget(max_iters=3),
            torch_device="cpu")
assert rep.makespan > 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("LEAKED=" + ",".join(bad))
"""


def test_import_and_solve_leave_jax_and_repro_unloaded():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED=\n" in out.stdout + "\n", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_)"
    r"|from\s+repro\.)", re.M)


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


def test_public_surface_matches_reference():
    import repro
    import repro_torch

    assert set(repro.__all__) == set(repro_torch.__all__)
    ported = set(repro_torch.list_solvers())
    assert ported == set(repro.list_solvers()) - {"tabu_device"}
