"""Multi-rank runs for the port's distributed tests: a gloo process group of
N CPU ranks on ``localhost``, each rank a subprocess that imports the port
only, and the reference's multi-device runs in a subprocess with 8 host
devices (the device count is fixed before JAX starts)."""
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK_PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="tcp://localhost:" + os.environ["MASTER_PORT"],
                        rank=RANK, world_size=WORLD)
def result(obj):
    if RANK == 0:
        print("RESULT " + json.dumps(obj))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _result(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"no RESULT line in:\n{out[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def run_ranks(body: str, world: int = 8, timeout: int = 120, **env_extra):
    """Run ``body`` on ``world`` gloo ranks (``RANK``, ``WORLD``, ``result()``
    and ``dist`` in scope, the process group made) and return what rank 0
    passed to ``result``."""
    script = _RANK_PRELUDE + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    port = _free_port()
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(script)
    try:
        procs = []
        for r in range(world):
            env = _env()
            env.update({"RANK": str(r), "WORLD_SIZE": str(world), "MASTER_PORT": str(port)},
                       **{k: str(v) for k, v in env_extra.items()})
            procs.append(subprocess.Popen([sys.executable, f.name], env=env, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        bad = [(r, o, e) for r, (p, (o, e)) in enumerate(zip(procs, outs)) if p.returncode]
        assert not bad, "rank %d failed:\n%s\n%s" % (bad[0][0], bad[0][1][-2000:],
                                                     bad[0][2][-6000:])
        return _result(outs[0][0])
    finally:
        os.unlink(f.name)


def run_reference(body: str, timeout: int = 300):
    """Run ``body`` with JAX on 8 host devices and return its ``result()``."""
    script = ("import os\n"
              "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'\n"
              "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
              "import json\n"
              "def result(obj):\n    print('RESULT ' + json.dumps(obj))\n"
              + textwrap.dedent(body))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=_env(), timeout=timeout)
    assert out.returncode == 0, f"stdout:\n{out.stdout[-2000:]}\nstderr:\n{out.stderr[-6000:]}"
    return _result(out.stdout)
