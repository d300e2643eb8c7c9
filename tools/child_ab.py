"""One ``chip_smoke.py`` child phase, run in turns on one card.

    git archive <parent commit> | tar -x -C build/parent
    python tools/child_ab.py train-moe --parent build/parent [--out ab.json]
    python tools/child_ab.py train-ssm --beside production [--out ab.json]
    python tools/child_ab.py train-ssm --beside training

With ``--parent`` the child (``chip_smoke.py --train-moe``, ...) runs from
the parent checkout, this checkout, this checkout, the parent, each checkout's
kernels built first from its own sources.  With ``--beside NAMES`` it runs in
this checkout alone, with ``chip_smoke.py``'s dry runs ``NAMES`` (comma-
separated: ``production``, llama3-405b ``train_4k`` on 2 x 16 x 16; a name of
``FOLD_DRY_RUNS``, such as ``qseq_production``; a trained configuration's
name, ``train_moe`` ...; or ``training``, every dry run the script runs
beside the training children) each in a process beside it, beside it again,
then alone; the dry runs are started just before the child and ended with
it.  Each run prints
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


def dry_run_specs(names: str) -> list:
    """The JSON specs of ``chip_smoke.py``'s dry runs ``names``."""
    code = ("import json, sys, chip_smoke as s\n"
            "named = {'production': s.PRODUCTION_DRY_RUN, **s.FOLD_DRY_RUNS,"
            " **s.calibration_specs()}\n"
            "training = ['production', *s.FOLD_DRY_RUNS]\n"
            "names = [m for n in sys.argv[1].split(',')"
            " for m in (training if n == 'training' else [n])]\n"
            "print(json.dumps([named[n] for n in names]))")
    out = subprocess.run([sys.executable, "-c", code, names], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    return [json.dumps(spec) for spec in json.loads(out)]


def run(root: str, flag: str, beside: list) -> dict:
    """The child ``flag`` from ``root``, with the dry runs ``beside`` (specs)
    each in a process beside it; its phase lines."""
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    script = os.path.join(root, "chip_smoke.py")
    sides = [subprocess.Popen([sys.executable, script, "--dry-run", spec], cwd=root, env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
             for spec in beside]
    try:
        proc = subprocess.run([sys.executable, script, flag], capture_output=True, text=True,
                              cwd=root, env=env, timeout=900)
    finally:
        sides_alive = [side.poll() is None for side in sides]
        for side in sides:
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
    if sides:
        out["dry_runs_alive_at_child_end"] = sides_alive
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
    which.add_argument("--beside", help="dry runs of chip_smoke.py to run beside the child "
                       "(comma-separated names, or 'training')")
    ap.add_argument("--out", default=None, help="also write the records here (JSON)")
    args = ap.parse_args()
    flag = "--" + args.child
    if args.parent:
        trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
        turns = [(name, trees[name], []) for name in ("parent", "change", "change", "parent")]
    else:
        specs = dry_run_specs(args.beside)
        turns = [("change", ROOT, s) for s in ([], specs, specs, [])]
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
