"""``python -m repro_torch.analysis`` / ``repro-torch-analysis`` — the
analysis CLI of the PyTorch port.

Three subcommands (DESIGN.md §12):

``lint [paths...]``
    Run the repo-discipline linter over the port (``src/repro_torch`` by
    default).  ``--ratchet`` compares unsuppressed findings against the
    committed ``.lint-ratchet-torch.json`` baseline and fails only on
    regressions; ``--update-baseline`` rewrites it.

``certify --suite smoke``
    Solve every instance of a registered suite and check each report
    against the independent ILP certificate checker.  ``--backend``
    selects the evaluation engine: scalar / numpy on the host, torch (the
    batched evaluator, its sweeps through the schedule-DP kernel K1) or
    device (the device-resident search, its round a captured CUDA graph
    that launches K1 and ``seq_cumsum``).  The last two run on
    ``--torch-device`` (``cuda`` by default; without a card they raise
    unless asked for ``cpu``).

``selftest``
    Deliberately inject one lint violation and one schedule corruption
    and verify both are caught — exits non-zero if either slips through,
    so CI can prove the tooling has teeth before trusting a green run.

All subcommands accept ``--json`` (machine-readable report on stdout)
and exit 0 on success / 1 on findings or violations / 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from .certify import certify_report, certify_solution
from .lint import (
    DEFAULT_BASELINE,
    lint_paths,
    lint_source,
    load_baseline,
    ratchet_regressions,
    write_baseline,
)

__all__ = ["build_parser", "main"]


# ------------------------------------------------------------------ #
# lint                                                               #
# ------------------------------------------------------------------ #
def _cmd_lint(args) -> int:
    report = lint_paths(args.paths or None, rules=None)
    payload = report.as_json()
    rc = 0
    if args.ratchet:
        baseline = load_baseline(args.baseline)
        regressions = ratchet_regressions(report, baseline)
        payload["ratchet"] = {"baseline": args.baseline or DEFAULT_BASELINE,
                              "regressions": regressions}
        rc = 1 if regressions else 0
    else:
        rc = 0 if report.ok else 1
    if args.update_baseline:
        path = write_baseline(report, args.baseline)
        payload["baseline_written"] = str(path)
        rc = 0
    if args.report:
        with open(args.report, "w") as f:
            json.dump(payload, f, indent=2)
    if args.json:
        print(json.dumps(payload, indent=2))
        return rc
    for f in report.findings:
        print(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
    n_sup = len(report.suppressed)
    print(f"{len(report.findings)} finding(s), {n_sup} suppressed, "
          f"{report.n_files} file(s)")
    if args.ratchet:
        for r in payload["ratchet"]["regressions"]:
            print(f"ratchet regression — {r}")
        if not payload["ratchet"]["regressions"]:
            print("ratchet: no regressions vs baseline")
    return rc


# ------------------------------------------------------------------ #
# certify                                                            #
# ------------------------------------------------------------------ #
def _cmd_certify(args) -> int:
    from ..core.api import Budget, solve
    from ..instances.suites import get_suite

    suite = get_suite(args.suite)
    instances = suite.build()
    budget = Budget(max_iters=args.max_iters, time_limit=args.time_limit)
    rows, n_bad = [], 0
    for inst in instances:
        if args.backend == "device":
            rep = solve(inst, "tabu_device", budget=budget, seed=args.seed,
                        walks=args.walks, torch_device=args.torch_device)
        else:
            rep = solve(inst, args.solver, budget=budget, seed=args.seed,
                        **({"backend": args.backend, "walks": args.walks,
                            "torch_device": args.torch_device}
                           if args.solver.startswith("tabu_") else {}))
        cert = certify_report(inst, rep)
        n_bad += 0 if cert.ok else 1
        rows.append({"instance": inst.name, "solver": rep.method,
                     "backend": args.backend, "makespan": rep.makespan,
                     "feasible": rep.feasible, "history": rep.history,
                     "n_exact_evals": rep.n_exact_evals,
                     "certificate": cert.as_json()})
        if not args.json:
            status = "ok" if cert.ok else f"FAILED ({cert.summary()})"
            print(f"{inst.name}: mk={rep.makespan:.2f} "
                  f"[{args.backend}] certificate {status}")
    payload = {"suite": args.suite, "backend": args.backend,
               "torch_device": args.torch_device, "solver": args.solver, "n_instances": len(instances),
               "n_failed": n_bad, "rows": rows}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(payload, f, indent=2)
    if args.json:
        print(json.dumps(payload, indent=2))
    elif n_bad == 0:
        print(f"{len(instances)} instance(s) certified on "
              f"backend={args.backend}")
    return 1 if n_bad else 0


# ------------------------------------------------------------------ #
# selftest                                                           #
# ------------------------------------------------------------------ #
_BAD_SNIPPET = '''\
import torch


def leaky(x: torch.Tensor, flag: torch.Tensor):
    if flag:            # RPR101: a tensor in a Python branch
        return x + 1.0
    return float(x)     # RPR102: host sync inside a captured function


def record(x, flag):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        leaky(x, flag)
    return graph
'''


def _selftest_lint() -> "tuple[bool, list[str]]":
    findings, _ = lint_source(_BAD_SNIPPET, "core/selftest_injected.py")
    rules = sorted({f.rule for f in findings})
    return ("RPR101" in rules and "RPR102" in rules), rules


def _selftest_certify() -> "tuple[bool, list[str]]":
    from ..core.api import Budget, solve
    from ..instances.registry import generate

    inst = generate("random_layered", n_tasks=10, n_data=8)
    rep = solve(inst, "greedy:slack_first", budget=Budget(max_iters=1))
    good = certify_solution(inst, rep.solution)
    if not good.ok:
        return False, ["known-good solution rejected: " + good.summary()]
    # corrupt: swap two tasks on one core against their precedence order
    bad = rep.solution.copy()
    for p, seq in enumerate(bad.proc_seq):
        if len(seq) >= 2:
            seq[0], seq[-1] = seq[-1], seq[0]
            break
    cert = certify_solution(inst, bad)
    return (not cert.ok), sorted(cert.kinds())


def _cmd_selftest(args) -> int:
    lint_ok, lint_rules = _selftest_lint()
    cert_ok, cert_kinds = _selftest_certify()
    payload = {
        "lint_detected": lint_ok, "lint_rules": lint_rules,
        "certify_detected": cert_ok, "certify_kinds": cert_kinds,
        "ok": lint_ok and cert_ok,
    }
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        print(f"lint injection: {'caught ' + str(lint_rules) if lint_ok else 'MISSED'}")
        print(f"certify injection: "
              f"{'caught ' + str(cert_kinds) if cert_ok else 'MISSED'}")
    return 0 if payload["ok"] else 1


# ------------------------------------------------------------------ #
# entry                                                              #
# ------------------------------------------------------------------ #
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch-analysis",
        description="certificate checker + repo-discipline linter")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="run the repo linter")
    lp.add_argument("paths", nargs="*", help="files/dirs (default: src/repro_torch)")
    lp.add_argument("--ratchet", action="store_true",
                    help="fail only on NEW findings vs the committed baseline")
    lp.add_argument("--update-baseline", action="store_true",
                    help="rewrite the ratchet baseline from this run")
    lp.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <repo>/{DEFAULT_BASELINE})")
    lp.add_argument("--report", default=None, help="write JSON report here")
    lp.add_argument("--json", action="store_true")
    lp.set_defaults(fn=_cmd_lint)

    cp = sub.add_parser("certify", help="solve a suite and certify reports")
    cp.add_argument("--suite", default="smoke")
    cp.add_argument("--solver", default="tabu_multiwalk")
    cp.add_argument("--backend", default="numpy",
                    choices=("scalar", "numpy", "torch", "device"))
    cp.add_argument("--torch-device", default="cuda",
                    help="where the torch and device backends run (cuda or cpu)")
    cp.add_argument("--walks", type=int, default=2)
    cp.add_argument("--seed", type=int, default=0)
    cp.add_argument("--max-iters", type=int, default=30)
    cp.add_argument("--time-limit", type=float, default=30.0)
    cp.add_argument("--report", default=None, help="write JSON report here")
    cp.add_argument("--json", action="store_true")
    cp.set_defaults(fn=_cmd_certify)

    st = sub.add_parser("selftest",
                        help="verify injected violations are caught")
    st.add_argument("--json", action="store_true")
    st.set_defaults(fn=_cmd_selftest)
    return ap


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
