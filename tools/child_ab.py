"""One ``chip_smoke.py`` child phase, run in turns on one card.

    git archive <parent commit> | tar -x -C build/parent
    python tools/child_ab.py train-moe --parent build/parent [--out ab.json]
    python tools/child_ab.py train-ssm --beside production [--out ab.json]

With ``--parent`` the child (``chip_smoke.py --train-moe``, ...) runs from
the parent checkout, this checkout, this checkout, the parent, each checkout's
kernels built first from its own sources.  With ``--beside NAME`` it runs in
this checkout alone, with one of ``chip_smoke.py``'s dry runs (``production``:
llama3-405b ``train_4k`` on 2 x 16 x 16; or a trained configuration's name,
``train_moe`` ...) in a process beside it, beside it again, then alone; the
dry run is started just before the child and ended with it.  Each run prints
one JSON line of its headline readings (``--out`` keeps every phase line):
its checkout, whether a dry run ran beside it, each phase's steady step, the
profiled step's busy time and idle share.  Needs an NVIDIA GPU.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(root: str) -> None:
    code = "from repro_torch.kernels import _build; _build.build()"
    subprocess.run([sys.executable, "-c", code],
                   env={**os.environ, "PYTHONPATH": os.path.join(root, "src")}, check=True,
                   cwd=root)


def dry_run_spec(name: str) -> str:
    """The JSON spec of ``chip_smoke.py``'s dry run ``name``."""
    code = ("import json, sys, chip_smoke as s; n = sys.argv[1]; print(json.dumps("
            "s.PRODUCTION_DRY_RUN if n == 'production' else s.calibration_specs()[n]))")
    return subprocess.run([sys.executable, "-c", code, name], capture_output=True, text=True,
                          check=True, cwd=ROOT).stdout.strip()


def run(root: str, flag: str, beside: str | None) -> dict:
    """The child ``flag`` from ``root``, with the dry run ``beside`` (a spec)
    in a process beside it if given; its phase lines."""
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    script = os.path.join(root, "chip_smoke.py")
    side = None if beside is None else subprocess.Popen(
        [sys.executable, script, "--dry-run", beside], cwd=root, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        proc = subprocess.run([sys.executable, script, flag], capture_output=True, text=True,
                              cwd=root, env=env, timeout=900)
    finally:
        if side is not None:
            side_alive = side.poll() is None
            side.kill()
            side.wait()
    phases = []
    for line in proc.stdout.splitlines()[:-1]:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "phase" in rec:
            phases.append(rec)
    out = {"exit": proc.returncode, "phases": phases}
    if side is not None:
        out["dry_run_alive_at_child_end"] = side_alive
    if proc.returncode != 0:
        out["error"] = proc.stderr[-2000:]
    return out


def summary(rec: dict) -> dict:
    """A run's headline readings: each phase's steady step, its profiled
    step's busy time and idle share, and the MoE block's time."""
    keep = {}
    for ph in rec["phases"]:
        prof = ph.get("device_profile_one_step") or {}
        keep[ph["phase"]] = {"step_ms_steady": ph.get("step_ms_steady"),
                             "device_busy_ms": prof.get("device_busy_ms"),
                             "device_idle_share": prof.get("device_idle_share"),
                             "moe": ph.get("moe")}
    return {k: v for k, v in rec.items() if k != "phases"} | {"readings": keep}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("child", help="the child, e.g. train-moe (chip_smoke.py --train-moe)")
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--parent", help="a checkout of the commit to compare with")
    which.add_argument("--beside", help="a dry run of chip_smoke.py to run beside the child")
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    args = ap.parse_args()
    flag = "--" + args.child
    if args.parent:
        trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
        turns = [(name, trees[name], None) for name in ("parent", "change", "change", "parent")]
    else:
        spec = dry_run_spec(args.beside)
        turns = [("change", ROOT, s) for s in (None, spec, spec, None)]
    for root in {root for _, root, _ in turns}:
        build(root)
    out = []
    for name, root, beside in turns:
        rec = {"tree": name, "beside": args.beside if beside else None,
               **run(root, flag, beside)}
        out.append(rec)
        print(json.dumps(summary(rec)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all(r["exit"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
