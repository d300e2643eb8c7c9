"""DTensor's view rule on this machine's torch against the emulation of
torch 2.11's rule that the tests use (``tests/torch_dist_helpers.py``
``install_strict_fold``): each case views a (4, 8, 16) DTensor on a fake
2 x 2 ("data", "model") mesh, natively and then under the emulation, and
the JSON line says where each raised and whether the two agree.

    python tools/fold_probe.py

No device and no process group needed (a fake one is made).
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import torch_dist_helpers  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402


def cases(mesh) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    w = distribute_tensor(torch.randn(16, 12), mesh, [Replicate(), Replicate()])
    rows, seq, both = [Replicate(), Shard(1)], [Shard(0), Replicate()], [Shard(0), Shard(1)]
    return {
        "matmul_S1": (rows, lambda x: x @ w),
        "view_S1": (rows, lambda x: x.view(32, 16)),
        "reshape_S1": (rows, lambda x: x.reshape(32, 16)),
        "flatten_S1": (rows, lambda x: x.flatten(0, 1)),
        "matmul_S0S1": (both, lambda x: x @ w),
        "matmul_S0": (seq, lambda x: x @ w),
        "view_S0": (seq, lambda x: x.view(32, 16)),
        "flatten_last_S2": ([Replicate(), Shard(2)], lambda x: x.flatten(1, 2)),
    }


def run_all(mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, (placements, fn) in cases(mesh).items():
        x = distribute_tensor(torch.randn(4, 8, 16), mesh, placements)
        try:
            out[name] = "ok " + str(fn(x).placements)
        except Exception as e:      # noqa: BLE001  (the rule raises RuntimeError)
            out[name] = "raised " + str(e).splitlines()[0][:160]
    return out


def main() -> int:
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    native = run_all(mesh)
    undo = torch_dist_helpers.install_strict_fold()
    try:
        emulated = run_all(mesh)
    finally:
        undo()
    agree = {k: native[k].split()[0] == emulated[k].split()[0] for k in native}
    print(json.dumps({"torch": torch.__version__, "native": native, "emulated": emulated,
                      "agree": agree}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
