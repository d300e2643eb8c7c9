"""Multi-rank runs for the port's distributed tests: a gloo process group of
N CPU ranks on ``localhost``, each rank a subprocess that imports the port
only, and the reference's multi-device runs in a subprocess with 8 host
devices (the device count is fixed before JAX starts).

:func:`strict_fold` emulates the view rule of torch 2.11's DTensor, where
a view that flattens a sharded dim into another raises (torch 2.13 tracks
such a dim as a ``_StridedShard``): ``run_ranks(..., strict_fold=1)`` and
:data:`STRICT_FOLD_PRELUDE` turn it on in a subprocess."""
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

FOLD_ERROR = "Attempted to flatten multiple dimensions, with dimension"


def _flattens(spec):
    """The ``Flatten`` commands in one output dim's rule (nested in splits)."""
    from torch.distributed.tensor._ops._view_ops import Flatten, Split

    if isinstance(spec, Flatten):
        yield spec
        for d in spec.input_dims:
            yield from _flattens(d)
    elif isinstance(spec, Split):
        yield from _flattens(spec.input_dim)


def install_strict_fold():
    """Have DTensor's view ops (``view``, ``_unsafe_view``, the squeezes:
    the strict ones) raise as torch 2.11's do where a ``Flatten`` takes a
    dim that is ``Shard`` on some mesh dim and is not the fold's leading
    dim.  Sharding propagation is cached by signature, so the propagator's
    caches (Python's, and the C++ dispatch's where torch has one) are
    cleared.  Returns the function that undoes it."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._ops import _view_ops

    inner = _view_ops.propagate_shape_and_sharding
    python_cache = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding

    def clear():
        python_cache.cache_clear()
        getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", lambda: None)()

    def checked(placements, shape, rule, mesh_sizes, strict_view=False):
        if strict_view:
            for cmd in rule:
                for fl in _flattens(cmd):
                    for d in fl.input_dims[1:]:
                        if any(type(p) is Shard and p.dim == d.input_dim for p in placements):
                            raise RuntimeError(
                                f"{FOLD_ERROR} {d.input_dim} being sharded. It cannot be "
                                "performed without redistribution, which is disallowed "
                                "by the current operator.")
        return inner(placements, shape, rule, mesh_sizes, strict_view)

    def undo():
        _view_ops.propagate_shape_and_sharding = inner
        clear()

    _view_ops.propagate_shape_and_sharding = checked
    clear()
    return undo


@contextlib.contextmanager
def strict_fold():
    """:func:`install_strict_fold` for the block."""
    undo = install_strict_fold()
    try:
        yield
    finally:
        undo()


# a subprocess's first lines: the emulation on for the rest of the process
STRICT_FOLD_PRELUDE = f"""
import sys
sys.path.insert(0, {TESTS!r})
import torch_dist_helpers
torch_dist_helpers.install_strict_fold()
"""

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


def run_ranks(body: str, world: int = 8, timeout: int = 120, strict_fold: int = 0,
              **env_extra):
    """Run ``body`` on ``world`` gloo ranks (``RANK``, ``WORLD``, ``result()``
    and ``dist`` in scope, the process group made) and return what rank 0
    passed to ``result``; with ``strict_fold`` under torch 2.11's view rule
    (:func:`strict_fold`)."""
    script = ((STRICT_FOLD_PRELUDE if strict_fold else "") + _RANK_PRELUDE
              + textwrap.dedent(body) + "\ndist.destroy_process_group()\n")
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
