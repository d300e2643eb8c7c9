"""Decode time a step of two checkouts of the port on one card, in turns.

    git archive <parent commit> | tar -x -C build/parent
    python tools/decode_ab.py build/parent [--out ab.json]

For each arch (recurrentgemma-2b, mamba2-780m, granite-moe-1b-a400m) it
runs the parent checkout, this checkout, this checkout, the parent (each a
process of its own, its kernels built first from its own sources), and in
each process serves batch 4 of 4096-token prompts for 32 tokens at full
width (random weights from seed 0): one warm-up serve, then three whose
decode ms a step and prefill ms it prints, one JSON line per process.

    python tools/decode_ab.py --route-cost

times, in this checkout, the check that routes a fake tensor to the
kernels' shape-only ops (``kernels.fake.is_fake``) on a CUDA tensor: the
host time it adds to each kernel call.  Needs an NVIDIA GPU.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("recurrentgemma-2b", "mamba2-780m", "granite-moe-1b-a400m")
SERVE = r'''
import sys, json, torch
from repro_torch.configs import get_config
from repro_torch.launch.model_serve import make_batch, serve
from repro_torch.models import arch_init_params
arch = sys.argv[1]; cfg = get_config(arch)
gen = torch.Generator(device="cuda").manual_seed(0)
model = arch_init_params(cfg, gen, device="cuda")
batch = make_batch(cfg, 4, 4096, gen, "cuda")
serve(cfg, model, batch, 2, device="cuda")
res = [serve(cfg, model, batch, 32, device="cuda") for _ in range(3)]
print("RESULT " + json.dumps({"arch": arch, "decode_ms": [r.decode_ms_per_step for r in res],
                              "prefill_ms": [r.prefill_s * 1e3 for r in res]}))
'''

ROUTE_COST = r'''
import json, timeit, torch
from repro_torch.kernels.fake import is_fake
t = torch.zeros(1, device="cuda")
n = 10 ** 6
runs = [timeit.timeit(lambda: is_fake(t), number=n) / n * 1e9 for _ in range(5)]
print(json.dumps({"is_fake_ns_per_call": sorted(runs)[2], "runs_ns": runs, "calls": n}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="a checkout of the commit to compare with")
    ap.add_argument("--route-cost", action="store_true",
                    help="time the fake-tensor route check on a CUDA tensor instead")
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    args = ap.parse_args()
    if args.route_cost:
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        proc = subprocess.run([sys.executable, "-c", ROUTE_COST], capture_output=True, text=True,
                              cwd=ROOT, env=env, check=True)
        print(proc.stdout.strip(), flush=True)
        return 0
    if args.parent is None:
        ap.error("a parent checkout is needed without --route-cost")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    for root in trees.values():
        subprocess.run([sys.executable, "-c",
                        "from repro_torch.kernels import _build; _build.build()"],
                       env={**os.environ, "PYTHONPATH": os.path.join(root, "src")}, check=True,
                       cwd=root)
    out = []
    for arch in ARCHS:
        for name in ("parent", "change", "change", "parent"):
            root = trees[name]
            proc = subprocess.run([sys.executable, "-c", SERVE, arch], capture_output=True,
                                  text=True, cwd=root,
                                  env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            rec = json.loads(lines[-1][7:]) if lines else {"arch": arch,
                                                           "error": proc.stderr[-2000:]}
            rec["tree"] = name
            out.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
